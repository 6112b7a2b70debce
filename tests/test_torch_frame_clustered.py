"""Frames on a clustered scene, PyTorch port against the JAX package.

A clustered scene traces its paths with the wavefront ``trace_reference``
in both packages (the bounce kernels sweep the whole triangle table), with
every closest hit through B8 and every shadow segment through B9; on the
CPU the port runs their plain versions and the JAX package its dense XLA
queries. The two draw the same random numbers (``uniform4`` with salts 1-3
and the alias table), so the images agree pixel for pixel but where a ray
meets an edge shared by two triangles, or where XLA's fused multiply-adds
move a value across a test: the shares below hold that margin. The scene
is the Cornell box split to 546 triangles and clustered by 128 slots; the
JAX frames run with ``band_rows=0`` (the port has no banded gathers). The
ReSTIR PT frames there take every ray query through B8 and trace their
suffixes with the wavefront tracer, in the sorted order of ``sort_suffix``
or without it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import restir_gi as JRG
from zetaray_tpu.ops import restir_pt as JRP
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.render import frame as JF
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import pathtracer as TPT
from zetaray_tpu_torch.ops import restir_gi as TRG
from zetaray_tpu_torch.ops import restir_pt as TRP
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render.frame import (
    RenderConfig, pick_rt, render_frame, render_frame_restir,
)
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import cornell_box
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_frame import _camera, _seed
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_scene import scene_pair, to_jax_cpu_scene

torch.set_num_threads(1)

RES = 32


@pytest.fixture(scope="module")
def scenes():
    """{"dense": the 36-triangle box, "clustered": the 546-triangle box in
    clusters of 128}, each as (JAX SceneBuffers, port SceneBuffers)."""
    box = subdivide_scene(cornell_box(), 500)
    return {
        "dense": scene_pair(cornell_box()),
        "clustered": (JS.upload_scene(to_jax_cpu_scene(box), cluster_size=128),
                      TS.upload_scene(box, device="cpu", cluster_size=128)),
    }


def _share(got, want, tol=1e-3):
    """Share of pixels [N, 3] whose channels agree to tol * (1 + |x|)."""
    want = np.asarray(want)
    return (np.abs(got - want) <= tol * (1.0 + np.abs(want))).all(-1).mean()


def _rays(k):
    o, d = _camera(k).generate_rays(RES, RES)
    return o, d, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))


@pytest.mark.parametrize("name", ["dense", "clustered"])
@pytest.mark.parametrize("bounces", [1, 2])
def test_trace_reference_matches_jax(scenes, name, bounces):
    jdev, tdev = scenes[name]
    o, d, o_t, d_t = _rays(1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JPT.trace_reference(jdev, o, d, key, JPT.PTConfig(max_bounces=bounces)))
    got = TPT.trace_reference(tdev, o_t, d_t, _seed(3), TPT.PTConfig(max_bounces=bounces))
    assert got.shape == (RES * RES, 3) and want.mean() > 0
    assert _share(got.numpy(), want) >= 0.99
    np.testing.assert_allclose(got.numpy().mean(), want.mean(), rtol=1e-3)
    _, sh0 = TPT.trace_reference(tdev, o_t, d_t, _seed(3), TPT.PTConfig(max_bounces=bounces),
                                 return_first_hit=True)
    assert 0.5 < sh0.valid.float().mean() < 1.0


def test_gi_initial_samples_match_jax(scenes):
    """The streaming branch of GI's initial samples: x2 and n2 from the
    trace's first hit, L2 from the rest of the path."""
    jdev, tdev = scenes["clustered"]
    o, d, _, _ = _rays(4)
    key = jax.random.PRNGKey(4)
    seed = _seed(4)
    pt = dict(max_bounces=2, min_emissive_bounce=2, min_nee_bounce=1)  # the frame's GI trace
    gb = jax_gbuffer(jdev, o, d)
    rt = pick_rt(RES * RES)
    want = np.asarray(JRG.initial_samples(jdev, gb, key, JPT.PTConfig(**pt), jnp.uint32(seed),
                                          rt=rt))
    got = TRG.initial_samples(tdev, T(gb), TPT.PTConfig(**pt), seed, rt).numpy()
    assert got.shape == want.shape == (16, RES * RES)
    assert (want[10] > 0).mean() > 0.5 and want[6:9].max() > 0
    agree = lambda rows, rtol: np.isclose(got[rows], want[rows], rtol=rtol, atol=1e-5).all(0)
    assert agree(slice(0, 6), 1e-4).mean() >= 0.99  # x2, n2
    assert agree(slice(None), 1e-3).mean() >= 0.98
    np.testing.assert_allclose(got[9].mean(), want[9].mean(), rtol=1e-3)


def test_chained_gi_frames_match_jax(scenes):
    """Two chained GI frames (bench.py's large-scene settings, max_bounces=2)
    with the a-trous filter and TAA off, each package chaining its own."""
    jdev, tdev = scenes["clustered"]
    base = dict(width=RES, height=RES, mode="restir_gi", denoise=False, taa=False)
    cfg_j = JF.RenderConfig(band_rows=0, pt=JPT.PTConfig(max_bounces=2), **base)
    cfg_t = RenderConfig(pt=TPT.PTConfig(max_bounces=2), **base)
    state_j = state_t = None
    for k in range(2):
        out_j, state_j = JF.render_frame_restir_jit(jdev, _camera(k), jax.random.PRNGKey(k),
                                                    cfg_j, state_j)
        out_t, state_t = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(k))),
                                             _seed(k), cfg_t, state_t)
        got = out_t["hdr"].numpy()
        assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
        assert _share(got, out_j["hdr"]) >= 0.98
    assert (state_t.gi_reservoirs[10] > 1).float().mean() > 0.3  # temporal GI reuse ran
    gi, gi_want = state_t.gi_reservoirs.numpy(), np.asarray(state_j.gi_reservoirs)
    assert np.isclose(gi, gi_want, rtol=1e-3, atol=1e-5).all(0).mean() >= 0.98


def test_plain_pt_frame_matches_jax(scenes):
    jdev, tdev = scenes["clustered"]
    base = dict(width=RES, height=RES, mode="pt")
    out_j = JF.render_frame_jit(jdev, _camera(1), jax.random.PRNGKey(1),
                                JF.RenderConfig(band_rows=0, pt=JPT.PTConfig(max_bounces=2),
                                                **base))
    out_t = render_frame(tdev, camera_from_arrays(cam_dict(_camera(1))), _seed(1),
                         RenderConfig(pt=TPT.PTConfig(max_bounces=2), **base))
    want = np.asarray(out_j["hdr"])
    assert want.mean() > 0
    assert _share(out_t["hdr"].numpy(), want) >= 0.99


SUN = (0.2, 0.45, 0.87)  # in through the box's opening at +z
# name: (max_bounces, the sun or None, ReSTIRPTConfig.sort_suffix). At 3
# bounces (bench.py's PT frame) the suffix past x3 gathers emission only and
# draws no random number; from 4 on its NEE draws by ray index, so the
# order of the suffix rays shows
PT_CASES = {"pt": (3, None, True), "pt_4": (4, None, True), "pt_sky_4": (4, SUN, True),
            "pt_unsorted_4": (4, None, False)}


@pytest.mark.parametrize("name", sorted(PT_CASES))
def test_chained_restir_pt_frames_match_jax(scenes, name):
    """Two chained ReSTIR PT frames (max_bounces 3 or 4) on the clustered box,
    each package chaining its own, with the a-trous filter and TAA off: the
    prefix, suffix and replay queries through B8 (the JAX package's stream
    query), the suffix past x3 through the wavefront tracer, whose random
    streams are keyed by ray index, so with ``sort_suffix`` both packages
    trace the suffix in the same stable order of (material, octant) keys.
    The JAX frames run eagerly."""
    jdev, tdev = scenes["clustered"]
    bounces, sun, sort = PT_CASES[name]
    base = dict(width=RES, height=RES, mode="restir_pt", denoise=False, taa=False)
    cfg_j = JF.RenderConfig(band_rows=0, **base, restir_pt=JRP.ReSTIRPTConfig(sort_suffix=sort),
                            pt=JPT.PTConfig(max_bounces=bounces, sky=None if sun is None else
                                            JSkyParams(sun_dir=sun)))
    cfg_t = RenderConfig(**base, restir_pt=TRP.ReSTIRPTConfig(sort_suffix=sort),
                         pt=TPT.PTConfig(max_bounces=bounces, sky=None if sun is None else
                                         SkyParams(sun_dir=sun)))
    state_j = state_t = None
    for k in range(2):
        out_j, state_j = JF.render_frame_restir(jdev, _camera(k), jax.random.PRNGKey(k), cfg_j,
                                                state_j)
        out_t, state_t = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(k))),
                                             _seed(k), cfg_t, state_t)
        got = out_t["hdr"].numpy()
        assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
        assert _share(got, out_j["hdr"]) >= 0.98
        assert abs(got.mean() - np.asarray(out_j["hdr"]).mean()) <= 0.01 * got.mean()
    assert (state_t.gi_reservoirs[TRP.PR.M] > 1).float().mean() > 0.3  # temporal PT reuse ran
    pt, pt_want = state_t.gi_reservoirs.numpy(), np.asarray(state_j.gi_reservoirs)
    assert np.isclose(pt, pt_want, rtol=1e-3, atol=1e-5).all(0).mean() >= 0.98
