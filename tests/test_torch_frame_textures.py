"""Textured and cutout frames of the PyTorch port against the JAX package's
``render_frame_restir`` with the same texture bundle.

On ``procedural.textured_box`` (a checker base-colour map on the floor and
the back wall, a normal map, a metallic-roughness map, a striped emissive
map on the light), after the emissive power round trip of the JAX app
(``estimate_tri_power``/``apply_tri_powers``, carried to the port bit for
bit): the GI, ReSTIR PT and default ``restir_di`` frames. The JAX frame
runs its megakernel path in interpret mode (``megakernel_eligible``,
``trace_with_first_hit`` and ``trace_megakernel`` patched, as
tests/test_torch_frame_restir_di.py does): GI textures x2 between B4 and
B5, ``restir_di`` splits every bounce into B4, the fetch and B5, PT fetches
at x_rc and x3. On ``procedural.cutout_box`` (a MASK-mode panel) both
packages take the wavefront ``trace_reference`` with the cutout re-trace,
from the same random streams: GI, the default frame and plain PT.

The port renders frame k from the JAX state after frame k-1, with a-trous
and TAA off; pixels agree to 1e-3 * (1 + |x|) on the shares the untextured
frame tests hold for the same mode (97% through the bounce kernels, 98% on
the wavefront, 99% plain PT). The JAX side runs with ``band_rows=0``.
"""

import numpy as np
import jax
import pytest
import torch

from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import prelighting as JPL
from zetaray_tpu.render import frame as JF
from zetaray_tpu.scene import scene as JS
from zetaray_tpu.scene import textures as JT
from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays, scene_from_arrays
from zetaray_tpu_torch.ops.gbuffer_pack import unpack_normal
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame, render_frame_restir
from zetaray_tpu_torch.scene.procedural import cutout_box, textured_box
from zetaray_tpu_torch.scene.textures import textures_from_arrays
from tests.test_torch_frame import _camera, _seed, _state_dict
from tests.test_torch_frame_restir_di import _share
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_gi import patch_megakernel as patch_gi
from tests.test_torch_restir_pt import patch_megakernel as patch_pt
from tests.test_torch_scene import jax_scene_arrays, to_jax_cpu_scene
from tests.test_torch_textures import _jax_bundle_numpy

torch.set_num_threads(1)

RES = 32
BASE = dict(width=RES, height=RES, denoise=False, taa=False)
# name: (scene, mode, max_bounces, share of pixels)
FRAMES = {
    "textured_gi": ("textured", "restir_gi", 3, 0.97),
    "textured_pt": ("textured", "restir_pt", 3, 0.97),
    "textured_di": ("textured", "restir_di", 4, 0.97),
    "cutout_gi": ("cutout", "restir_gi", 3, 0.98),
    "cutout_di": ("cutout", "restir_di", 4, 0.98),
}


def _cfgs(name, **pt):
    _, mode, bounces, _ = FRAMES[name]
    return (JF.RenderConfig(band_rows=0, mode=mode, **BASE,
                            pt=JPT.PTConfig(max_bounces=bounces, **pt)),
            RenderConfig(mode=mode, **BASE, pt=PTConfig(max_bounces=bounces, **pt)))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{"textured" | "cutout": (JAX scene, port scene, JAX bundle, port
    bundle)}; the textured box after the JAX power round trip."""
    out = {}
    for kind, make in (("textured", textured_box), ("cutout", cutout_box)):
        jcpu = to_jax_cpu_scene(make(tmp_path_factory.mktemp(kind)))
        jdev = JS.upload_scene(jcpu)
        jtex = JT.load_scene_textures(jcpu)
        if kind == "textured":
            jdev = JPL.apply_tri_powers(jdev, *JPL.estimate_tri_power(jdev, jtex))
        out[kind] = (jdev, scene_from_arrays(jax_scene_arrays(jdev), device="cpu"), jtex,
                     textures_from_arrays(_jax_bundle_numpy(jtex), device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_runs(scenes):
    """Two chained JAX frames of each FRAMES entry: {name: (outputs,
    states)}. The textured frames through the bounce kernels (patched), the
    cutout frames on the wavefront the JAX frame picks for them. Eager: a
    jit compiles these frames slower than they run."""
    runs = {}
    for name, (kind, *_rest) in FRAMES.items():
        jdev, _, jtex, _ = scenes[kind]
        outs, states, state = [], [], None
        with pytest.MonkeyPatch.context() as mp:
            if kind == "textured":
                patch_gi(mp)
                patch_pt(mp)
            for k in range(2):
                out, state = JF.render_frame_restir(jdev, _camera(k), jax.random.PRNGKey(k),
                                                    _cfgs(name)[0], state, jtex)
                outs.append({key: np.asarray(v) for key, v in out.items()})
                states.append(_state_dict(state))
        runs[name] = (outs, states)
    return runs


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_from_jax_state(scenes, jax_runs, name, k):
    """Frame k from the JAX state after frame k-1 with the same bundle."""
    kind, mode, _, share = FRAMES[name]
    _, tdev, _, ttex = scenes[kind]
    outs, states = jax_runs[name]
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k > 0 else None
    out, new_state = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(k))), _seed(k),
                                         _cfgs(name)[1], state, textures=ttex)
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert hdr.shape == want.shape == (RES, RES, 3) and np.isfinite(hdr).all()
    assert _share(hdr, want) >= share
    assert abs(hdr.mean() - want.mean()) <= 0.02 * want.mean()
    ind, ind_want = new_state.gi_reservoirs.numpy(), states[k]["gi_reservoirs"]
    if mode != "restir_di":
        assert np.isclose(ind, ind_want, rtol=1e-3, atol=1e-5).all(0).mean() >= share
    # the textured G-buffer, packed: depth and instance rows, and the shading
    # normal (oct16; one step of it is 3e-5) as both packages decode it
    gb, gb_want = new_state.gbuf, torch.from_numpy(states[k]["gbuf"])
    assert torch.isclose(gb[1:], gb_want[1:], rtol=1e-5, atol=1e-5).all(0).float().mean() >= 0.99
    ns, ns_want = (torch.stack(unpack_normal(g)) for g in (gb, gb_want))
    assert ((ns - ns_want).abs() <= 1e-4).all(0).float().mean() >= 0.99


def test_textures_change_the_frames(scenes, jax_runs):
    """The bundle shows: each textured frame differs from the same frame
    without it, and is darker (the checker and the stripes)."""
    for name in ("textured_gi", "textured_pt", "textured_di"):
        kind = FRAMES[name][0]
        _, tdev, _, _ = scenes[kind]
        plain, _ = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(0))), _seed(0),
                                       _cfgs(name)[1], None)
        textured = jax_runs[name][0][0]["hdr"]
        assert textured.mean() < 0.95 * plain["hdr"].numpy().mean(), name


def test_cutout_plain_pt_matches_jax(scenes):
    """render_frame (mode="pt") traces a cutout scene with the wavefront on
    both sides, from the same random stream: 99% of the pixels."""
    jdev, tdev, _, _ = scenes["cutout"]
    cfg_j = JF.RenderConfig(width=RES, height=RES, band_rows=0, pt=JPT.PTConfig(max_bounces=3))
    out_j = JF.render_frame(jdev, _camera(0), jax.random.PRNGKey(0), cfg_j)
    out_t = render_frame(tdev, camera_from_arrays(cam_dict(_camera(0))), _seed(0),
                         RenderConfig(width=RES, height=RES, pt=PTConfig(max_bounces=3)))
    assert _share(out_t["hdr"].numpy(), out_j["hdr"]) >= 0.99


def test_textures_with_wops_are_refused(scenes):
    """The JAX split bounce launches B5 without the WoPS table: the port's
    split trace refuses textures with nee_mode="wops" rather than copy it."""
    _, tdev, _, ttex = scenes["textured"]
    cfg = RenderConfig(mode="restir_di", **BASE, pt=PTConfig(max_bounces=2, nee_mode="wops"))
    with pytest.raises(NotImplementedError, match="wops"):
        render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(0))), _seed(0), cfg, None,
                            textures=ttex)
