"""The TAA options (``ops.taa.TAAConfig``), the channel-last
``taa_resolve`` and ``accumulate`` of the port against the JAX package's, on
the same numpy-seeded inputs (a smooth colour field, positions along the
camera rays, a camera that moved), to 1e-6; the defaults bit-equal to the
frame's TAA; and every option on row bands equal to the whole image's
rows."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_post import H, W, _gbuf_planes, _smooth_img
from tests.test_torch_restir_di import cam_dict
from zetaray_tpu.ops import taa as JTA
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import taa as TTA

torch.set_num_threads(1)

OPTIONS = list(itertools.product((True, False), repeat=3))  # clamp, catmull_rom, depth_dilate


def _inputs(shift=0.05):
    curr, hist = _smooth_img(13), _smooth_img(14)
    _nrm, depth, valid = _gbuf_planes(15)
    cam = JaxCamera.look_at((shift, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0, aspect=W / H)
    o, d = cam.generate_rays(W, H)
    pos = (np.asarray(o) + np.asarray(d) * depth.reshape(-1, 1)).T.reshape(3, H, W)
    prev = JaxCamera.look_at((shift + 0.03, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0,
                             aspect=W / H)
    return curr, hist, pos.astype(np.float32), valid, depth, prev


def _cfgs(opts, blend):
    clamp, catmull_rom, dilate = opts
    kw = dict(blend=blend, clamp=clamp, catmull_rom=catmull_rom, depth_dilate=dilate)
    return JTA.TAAConfig(**kw), TTA.TAAConfig(**kw)


@pytest.mark.parametrize("blend", [0.1, 0.5])
@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "clamp%d-cr%d-dilate%d" % o)
def test_taa_options_match_jax(opts, blend):
    curr, hist, pos, valid, depth, prev = _inputs()
    jcfg, tcfg = _cfgs(opts, blend)
    want = np.asarray(JTA.taa_resolve_p(
        jnp.asarray(curr), jnp.asarray(hist), jnp.asarray(pos), jnp.asarray(valid), prev,
        jcfg, depth=jnp.asarray(depth)))
    t = torch.from_numpy
    got = TTA.taa_resolve_p(t(curr), t(hist), t(pos), t(valid), camera_from_arrays(cam_dict(prev)),
                            t(depth), cfg=tcfg).numpy()
    assert not np.allclose(want, curr)  # history was blended in
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_defaults_are_the_frames_taa():
    curr, hist, pos, valid, depth, prev = _inputs(0.0)
    t = torch.from_numpy
    cam = camera_from_arrays(cam_dict(prev))
    a = TTA.taa_resolve_p(t(curr), t(hist), t(pos), t(valid), cam, t(depth))
    b = TTA.taa_resolve_p(t(curr), t(hist), t(pos), t(valid), cam, t(depth),
                          cfg=TTA.TAAConfig(0.1, True, True, True))
    assert TTA.TAAConfig() == TTA.TAAConfig(0.1, True, True, True)
    assert torch.equal(a, b)
    # no depth plane: no dilation, as depth_dilate=False
    c = TTA.taa_resolve_p(t(curr), t(hist), t(pos), t(valid), cam)
    d = TTA.taa_resolve_p(t(curr), t(hist), t(pos), t(valid), cam, t(depth),
                          cfg=TTA.TAAConfig(depth_dilate=False))
    assert torch.equal(c, d)


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "clamp%d-cr%d-dilate%d" % o)
def test_taa_options_on_row_bands(opts):
    """Three bands of 8 rows, each with a 1-row edge-clamped halo of the
    current planes and a 4-row halo of the history, as the sharded frame
    hands them over: the bands are the whole image's rows."""
    curr, hist, pos, valid, depth, prev = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                                           else x for x in _inputs())
    cam = camera_from_arrays(cam_dict(prev))
    cfg = _cfgs(opts, 0.1)[1]
    whole = TTA.taa_resolve_p(curr, hist, pos, valid, cam, depth, cfg=cfg)
    rows_of = lambda x, r0, r1, ax: x.index_select(ax, torch.clamp(torch.arange(r0, r1), 0, H - 1))
    for row0 in range(0, H, 8):
        ext, halo = 1, 4
        band = TTA.taa_resolve_p(
            rows_of(curr, row0 - ext, row0 + 8 + ext, 1),
            rows_of(hist, row0 - halo, row0 + 8 + halo, 1),
            rows_of(pos, row0 - ext, row0 + 8 + ext, 1),
            rows_of(valid, row0 - ext, row0 + 8 + ext, 0), cam,
            rows_of(depth, row0 - ext, row0 + 8 + ext, 0),
            row0=row0, height_full=H, hist_row0=row0 - halo, ext=ext, cfg=cfg)
        assert torch.equal(band, whole[:, row0 : row0 + 8])


@pytest.mark.parametrize("opts", [(True, True, True), (False, False, False), (True, False, True)])
def test_channel_last_taa_resolve_matches_jax(opts):
    curr, hist, pos, valid, _depth, prev = _inputs()
    jcfg, tcfg = _cfgs(opts, 0.2)
    cl = lambda x: np.ascontiguousarray(np.moveaxis(x, 0, -1))
    want = np.asarray(JTA.taa_resolve(jnp.asarray(cl(curr)), jnp.asarray(cl(hist)),
                                      jnp.asarray(cl(pos)), jnp.asarray(valid), prev, jcfg))
    t = torch.from_numpy
    got = TTA.taa_resolve(t(cl(curr)), t(cl(hist)), t(cl(pos)), t(valid),
                          camera_from_arrays(cam_dict(prev)), tcfg).numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("frame", [0, 1, 7])
def test_accumulate_matches_jax(frame):
    r = np.random.default_rng(frame)
    curr, acc = (r.uniform(0, 4, (H, W, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(JTA.accumulate(jnp.asarray(curr), jnp.asarray(acc), jnp.asarray(frame)))
    got = TTA.accumulate(torch.from_numpy(curr), torch.from_numpy(acc), torch.tensor(frame))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    got_int = TTA.accumulate(torch.from_numpy(curr), torch.from_numpy(acc), frame)
    assert torch.equal(got, got_int)
