"""The JAX app's default frame, ``mode="restir_di"`` (ReSTIR DI with the
indirect light path-traced), with and without its sun and sky, and the GI
and PT frames with the sky (the JAX frame's SkyDI-lite: the sky behind
primary-miss pixels and the sun's light at the primary hits), PyTorch port
against ``render_frame_restir``.

Dense frames run the JAX side through its bounce kernels in interpret mode
(``megakernel_eligible``, ``trace_with_first_hit`` and ``trace_megakernel``
patched, as tests/test_torch_restir_gi.py and test_torch_restir_pt.py do),
under a jit made inside the patch, with the a-trous filter and TAA off; the
port starts each frame from the JAX state after the previous one, and
pixels agree to 1e-3 * (1 + |x|) on the share tests/test_torch_frame_gi.py
holds (97%). On the box split to 546 triangles and clustered by 128, both
packages trace with their wavefront (``trace_reference``) from the same
random streams and each chains its own frames: 98% of the pixels, as in
tests/test_torch_frame_clustered.py. The JAX side runs with
``band_rows=0``: the port has no banded gathers.
"""

import numpy as np
import jax
import pytest
import torch

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.render import frame as JF
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import cornell_box
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_frame import _camera, _port_frame, _seed, _state_dict
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_gi import patch_megakernel as patch_gi
from tests.test_torch_restir_pt import patch_megakernel as patch_pt
from tests.test_torch_scene import scene_pair, to_jax_cpu_scene

torch.set_num_threads(1)

RES = 32
SUN = (0.2, 0.45, 0.87)  # in through the box's opening at +z
BASE = dict(width=RES, height=RES, denoise=False, taa=False)
# name: (mode, PTConfig fields; "sky" a sun direction)
FRAMES = {
    "di_sky": ("restir_di", dict(max_bounces=4, sky=SUN)),  # the JAX app's --sun frame
    "di": ("restir_di", dict(max_bounces=4)),
    "gi_sky": ("restir_gi", dict(max_bounces=3, sky=SUN, path_regularization=True,
                                 firefly_clamp=10.0, stochastic_multi_bounce=True)),
    "pt_sky": ("restir_pt", dict(max_bounces=3, sky=SUN)),
}


def _cfgs(name, base=BASE):
    mode, pt = FRAMES[name]
    pt = dict(pt)
    sun = pt.pop("sky", None)
    return (JF.RenderConfig(band_rows=0, mode=mode, **base,
                            pt=JPT.PTConfig(**pt, sky=None if sun is None else
                                            JSkyParams(sun_dir=sun))),
            RenderConfig(mode=mode, **base,
                         pt=PTConfig(**pt, sky=None if sun is None else SkyParams(sun_dir=sun))))


def _share(got, want, tol=1e-3):
    want = np.asarray(want)
    return (np.abs(got - want) <= tol * (1.0 + np.abs(want))).all(-1).mean()


@pytest.fixture(scope="module")
def scenes():
    box = subdivide_scene(cornell_box(), 500)
    return {
        "dense": scene_pair(cornell_box()),
        "clustered": (JS.upload_scene(to_jax_cpu_scene(box), cluster_size=128),
                      TS.upload_scene(box, device="cpu", cluster_size=128)),
    }


@pytest.fixture(scope="module")
def jax_runs(scenes):
    """Two JAX frames of each dense FRAMES entry through the bounce kernels:
    {name: (outputs, states)}."""
    jdev, _ = scenes["dense"]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_gi(mp)
        patch_pt(mp)
        render = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))
        for name in FRAMES:
            cfg_j, _ = _cfgs(name)
            outs, states, state = [], [], None
            for k in range(2):
                out, state = render(jdev, _camera(k), jax.random.PRNGKey(k), cfg_j, state)
                outs.append({key: np.asarray(v) for key, v in out.items()})
                states.append(_state_dict(state))
            runs[name] = (outs, states)
    return runs


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_from_jax_state(scenes, jax_runs, name, k):
    """Frame k of each mode from the JAX state after frame k-1. The
    restir_di frame keeps no indirect reservoirs (zeros, as in JAX)."""
    _, tdev = scenes["dense"]
    outs, states = jax_runs[name]
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k > 0 else None
    out, new_state = _port_frame(tdev, k, state, _cfgs(name)[1])
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert hdr.shape == want.shape == (RES, RES, 3) and np.isfinite(hdr).all()
    assert _share(hdr, want) >= 0.97
    assert abs(hdr.mean() - want.mean()) <= 0.02 * want.mean()
    ind, ind_want = new_state.gi_reservoirs.numpy(), states[k]["gi_reservoirs"]
    if FRAMES[name][0] == "restir_di":
        assert not ind.any() and not ind_want.any()
    else:
        assert np.isclose(ind, ind_want, rtol=1e-3, atol=1e-5).all(0).mean() >= 0.97


def test_sky_changes_the_frames(scenes):
    """The sun and sky show in the JAX app's default frame: the primary-miss
    pixels that look above the horizon carry the sky's background (black
    without it), and the sun lights the floor through the opening. The GI
    and PT frames get the same background from their SkyDI-lite term."""
    _, tdev = scenes["dense"]
    sky_hdr = {}
    for name in ("di_sky", "di", "gi_sky", "pt_sky"):
        sky_hdr[name] = _port_frame(tdev, 0, None, _cfgs(name)[1])[0]["hdr"].numpy()
    o, d = _camera(0).generate_rays(RES, RES)
    gb = JMK.gbuffer(scenes["dense"][0], o, d, interpret=True)
    miss = np.asarray(gb[JMK.G.VALID]).reshape(RES, RES) < 0.5
    up = np.asarray(d[:, 1]).reshape(RES, RES) > 0.0
    assert (miss & up).sum() > 20
    assert (sky_hdr["di"][miss] == 0).all()
    assert (sky_hdr["di_sky"][miss & up].sum(-1) > 0).all()
    for name in ("gi_sky", "pt_sky"):
        np.testing.assert_allclose(sky_hdr[name][miss], sky_hdr["di_sky"][miss], rtol=1e-5)
    brighter = sky_hdr["di_sky"].sum(-1) > 1.5 * sky_hdr["di"].sum(-1) + 1e-3
    assert (brighter & ~miss).sum() > 50  # hits the sun lights


@pytest.mark.parametrize("name", ["di_sky", "gi_sky"])
def test_clustered_chained_frames_match_jax(scenes, name):
    """Two chained frames on the clustered box, each package chaining its
    own; paths from the wavefront tracer (B8/B9 on the card)."""
    jdev, tdev = scenes["clustered"]
    cfg_j, cfg_t = _cfgs(name)
    state_j = state_t = None
    for k in range(2):
        out_j, state_j = JF.render_frame_restir_jit(jdev, _camera(k), jax.random.PRNGKey(k),
                                                    cfg_j, state_j)
        out_t, state_t = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(k))),
                                             _seed(k), cfg_t, state_t)
        got = out_t["hdr"].numpy()
        assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
        assert _share(got, out_j["hdr"]) >= 0.98
        assert abs(got.mean() - np.asarray(out_j["hdr"]).mean()) <= 0.01 * got.mean()
