"""Froxel inscattering (``ops/volumetrics.py``) of the PyTorch port against
the JAX package, and the checks of tests/test_volumetrics.py on the
procedural box.

``build_froxels`` is held at the default 24 x 16 x 32 grid with its 12,288
sun-shadow segments (B3's plain version here) and with a thick medium, to
rtol 1e-5: the froxel rays, the slice depths and the two cumulative sums
round alike up to XLA's fused dot products and its scan's order, which
move a value by ulps. ``apply_inscattering`` gets the JAX grid and the JAX
G-buffer and is held to rtol 1e-5.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.ops import volumetrics as JVL
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.accel.megakernel import gbuffer
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import volumetrics as TVL
from zetaray_tpu_torch.ops.sky import _BETA_M, _BETA_R, SkyParams
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

SUN = (0.2, 0.45, 0.87)  # in through the box's opening at +z
CAM = JaxCamera.look_at((0, 1, 3.5), (0, 1, 0), vfov_deg=45, aspect=1.0)
TCAM = camera_from_arrays(cam_dict(CAM))
# the default grid, and a thick medium over it
CFGS = {"default": {}, "thick": dict(density_scale=500.0, far=8.0)}


@pytest.fixture(scope="module")
def scenes():
    return scene_pair(cornell_box())


def _cfgs(name, **kw):
    return JVL.VolumetricsConfig(**CFGS[name], **kw), TVL.VolumetricsConfig(**CFGS[name], **kw)


def test_config_matches_the_reference():
    assert TVL.VolumetricsConfig() == TVL.VolumetricsConfig(**vars(JVL.VolumetricsConfig()))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_build_froxels_matches_jax(scenes, name):
    jdev, tdev = scenes
    cfg_j, cfg_t = _cfgs(name)
    want = JVL.build_froxels(jdev, CAM, JSkyParams(sun_dir=SUN), cfg_j)
    got = TVL.build_froxels(tdev, TCAM, SkyParams(sun_dir=SUN), cfg_t)
    for k in ("ls", "tr"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (32, 16, 24, 3)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-12)
    assert np.asarray(want["ls"])[-1].max() > 0  # the sun scatters in through the opening


def test_sun_segments_match_jax(scenes):
    """The 12,288 sun-shadow segments' blocked flags, one by one: the froxel
    grid with the shadows against the same grid without them."""
    jdev, tdev = scenes
    cfg_j, cfg_t = _cfgs("thick")
    sky_j, sky_t = JSkyParams(sun_dir=SUN), SkyParams(sun_dir=SUN)
    shadow = lambda fx, fx0: fx["ls"][-1].sum(-1) < fx0["ls"][-1].sum(-1)
    want = np.asarray(shadow(JVL.build_froxels(jdev, CAM, sky_j, cfg_j),
                             JVL.build_froxels(jdev, CAM, sky_j,
                                               dataclasses.replace(cfg_j, sun_shadows=False))))
    pos, _, _ = TVL.froxel_points(TCAM, cfg_t, "cpu")
    o, d = TVL.sun_segments(pos, sky_t)
    assert o.shape == d.shape == (12_288, 3)
    got = shadow(TVL.build_froxels(tdev, TCAM, sky_t, cfg_t),
                 TVL.build_froxels(tdev, TCAM, sky_t,
                                   dataclasses.replace(cfg_t, sun_shadows=False))).numpy()
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_apply_inscattering_matches_jax(scenes, name):
    jdev, _ = scenes
    cfg_j, cfg_t = _cfgs(name)
    fx = JVL.build_froxels(jdev, CAM, JSkyParams(sun_dir=SUN), cfg_j)
    o, d = CAM.generate_rays(32, 32)
    gb = jax_gbuffer(jdev, o, d, interpret=True)
    hdr = np.random.default_rng(3).uniform(0.0, 2.0, (3, 32, 32)).astype(np.float32)
    want = np.asarray(JVL.apply_inscattering(jnp.asarray(hdr), gb, CAM, fx, cfg_j, 32, 32))
    got = TVL.apply_inscattering(T(hdr), T(gb), TCAM, {k: T(v) for k, v in fx.items()}, cfg_t,
                                 32, 32).numpy()
    assert not np.allclose(want, hdr)  # the medium shows
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_froxel_monotonicity(scenes):
    _, tdev = scenes
    cfg = TVL.VolumetricsConfig(grid=(8, 8, 16), far=10.0, density_scale=500.0,
                                sun_shadows=False)
    fx = TVL.build_froxels(tdev, TCAM, SkyParams(sun_dir=(0.3, 0.9, 0.2)), cfg)
    tr, ls = fx["tr"].numpy(), fx["ls"].numpy()
    assert tr.shape == ls.shape == (16, 8, 8, 3)
    assert (np.diff(tr, axis=0) <= 1e-7).all() and (np.diff(ls, axis=0) >= -1e-7).all()
    assert (tr > 0).all() and (tr <= 1 + 1e-6).all() and (ls >= 0).all()


def test_transmittance_matches_closed_form(scenes):
    """A uniform medium (altitude ~ 0): Tr along the central ray is
    exp(-sigma_t * s) at every slice, to the 12% of its off-centre cosine."""
    _, tdev = scenes
    scale = 2000.0
    cfg = TVL.VolumetricsConfig(grid=(3, 3, 24), near=0.0, far=5.0, depth_exp=1.0,
                                density_scale=scale, sun_shadows=False, unit_to_km=1e-6)
    tr = TVL.build_froxels(tdev, TCAM, SkyParams(sun_dir=(0.0, 1.0, 0.0)), cfg)["tr"]
    got_tau = -np.log(np.maximum(tr.numpy()[:, 1, 1, :], 1e-30))
    edges = TVL._slice_depths(cfg, "cpu").numpy()
    sigma_t = (_BETA_R + _BETA_M) * scale * 1e-6
    np.testing.assert_allclose(got_tau, edges[1:, None] * sigma_t[None, :], rtol=0.12)


def test_sun_shadows_darken_the_box(scenes):
    """The box's ceiling blocks most of a sun straight above."""
    _, tdev = scenes
    sky = SkyParams(sun_dir=(0.0, 1.0, 0.0))
    base = dict(grid=(8, 8, 12), far=6.0, density_scale=500.0)
    ls = {sh: TVL.build_froxels(tdev, TCAM, sky, TVL.VolumetricsConfig(sun_shadows=sh, **base))
          ["ls"][-1].sum().item() for sh in (False, True)}
    assert ls[True] < 0.9 * ls[False]


def test_apply_inscattering_identity_when_empty(scenes):
    _, tdev = scenes
    cfg = TVL.VolumetricsConfig(grid=(4, 4, 8), density_scale=0.0, sun_shadows=False)
    gb = gbuffer(tdev, *TCAM.generate_rays(32, 32, device="cpu"))
    fx = TVL.build_froxels(tdev, TCAM, SkyParams(), cfg)
    out = TVL.apply_inscattering(torch.full((3, 32, 32), 0.5), gb, TCAM, fx, cfg, 32, 32)
    np.testing.assert_allclose(out.numpy(), 0.5, atol=1e-5)
