"""The flagship GI frame, the ReSTIR PT frame and the JAX app's default
``restir_di`` frame on the materials box (``procedural.materials_box``: a
glass block and a clear-coated block), PyTorch port against
``render_frame_restir``; the GI frame also with ``full_target=True`` and
``packed_reuse=False`` in every ReSTIR config, and on the box split to
546 triangles and clustered by 128.

As in tests/test_torch_frame_restir_di.py: dense frames run the JAX side
through its bounce kernels in interpret mode (``megakernel_eligible``,
``trace_with_first_hit`` and ``trace_megakernel`` patched), under a jit
made inside the patch, with the a-trous filter and TAA off, the port
starting each frame from the JAX state after the previous one; on the
clustered box both packages trace with their wavefront
(``trace_reference``) and each chains its own frames. Glass flips a ray
where a threshold decides it (reflect or refract, total internal
reflection, the side test of a transmitted ray), and XLA fuses the
multiply-adds the port rounds one by one, so pixels agree on a share,
stated per test (measured: 97-99% at 1e-3 * (1 + |x|)), and the mean
within 2%.
"""

import numpy as np
import jax
import pytest
import torch

from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.ops import restir_gi as JRG
from zetaray_tpu.ops import restir_pt as JRP
from zetaray_tpu.render import frame as JF
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays
from zetaray_tpu_torch.ops import restir_di as TRD
from zetaray_tpu_torch.ops import restir_gi as TRG
from zetaray_tpu_torch.ops import restir_pt as TRP
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import materials_box
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_frame import _camera, _port_frame, _seed, _state_dict
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_gi import patch_megakernel as patch_gi
from tests.test_torch_restir_pt import patch_megakernel as patch_pt
from tests.test_torch_scene import scene_pair, to_jax_cpu_scene

torch.set_num_threads(1)

RES = 32
BASE = dict(width=RES, height=RES, denoise=False, taa=False)
OPT = dict(full_target=True, packed_reuse=False)
# name: (mode, max_bounces, with full_target/packed_reuse=False in every config)
FRAMES = {
    "gi": ("restir_gi", 3, False),
    "gi_options": ("restir_gi", 3, True),
    "pt": ("restir_pt", 3, False),
    "di": ("restir_di", 4, False),
}


def _cfgs(name, base=BASE):
    """(JAX RenderConfig, port RenderConfig) of FRAMES[name]."""
    mode, bounces, opts = FRAMES[name]
    kj = dict(restir=JRD.ReSTIRConfig(**OPT), restir_gi=JRG.ReSTIRGIConfig(**OPT),
              restir_pt=JRP.ReSTIRPTConfig(**OPT)) if opts else {}
    kt = dict(restir=TRD.ReSTIRConfig(**OPT), restir_gi=TRG.ReSTIRGIConfig(**OPT),
              restir_pt=TRP.ReSTIRPTConfig(**OPT)) if opts else {}
    return (JF.RenderConfig(band_rows=0, mode=mode, pt=JPT.PTConfig(max_bounces=bounces),
                            **base, **kj),
            RenderConfig(mode=mode, pt=PTConfig(max_bounces=bounces), **base, **kt))


def _share(got, want, tol=1e-3):
    want = np.asarray(want)
    return (np.abs(got - want) <= tol * (1.0 + np.abs(want))).all(-1).mean()


@pytest.fixture(scope="module")
def scenes():
    box = subdivide_scene(materials_box(), 500)
    return {
        "dense": scene_pair(materials_box()),
        "clustered": (JS.upload_scene(to_jax_cpu_scene(box), cluster_size=128),
                      TS.upload_scene(box, device="cpu", cluster_size=128)),
    }


def run_jax(jdev, names):
    """Two JAX frames of each FRAMES entry of ``names`` through the bounce
    kernels: {name: (outputs, states)}."""
    assert jdev.has_transmission and jdev.has_coat
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_gi(mp)
        patch_pt(mp)
        render = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))
        for name in names:
            cfg_j, _ = _cfgs(name)
            outs, states, state = [], [], None
            for k in range(2):
                out, state = render(jdev, _camera(k), jax.random.PRNGKey(k), cfg_j, state)
                outs.append({key: np.asarray(v) for key, v in out.items()})
                states.append(_state_dict(state))
            runs[name] = (outs, states)
    return runs


# the frames of this file; tests/test_torch_frame_materials_pt.py holds the
# others (two files, so that the test runner can spread them)
NAMES = ("gi", "gi_options")


@pytest.fixture(scope="module")
def jax_runs(scenes):
    return run_jax(scenes["dense"][0], NAMES)


# the share of pixels each frame must agree on: ReSTIR PT's merges weigh a
# replayed path by the pdfs of samples off the glass (PDFA, PDFS3), which
# an ulp moves by percents at roughness 0.05, so more of its picks flip
# (measured 95.0% and 93.8% in frames 0 and 1; the others 97-99%)
SHARE = {"pt": 0.93}


def check_frame(scenes, jax_runs, name, k):
    """Frame k from the JAX state after frame k-1: HDR on 96% of the
    pixels (``SHARE`` for PT), the mean within 2%, the indirect reservoirs
    on the same share."""
    _, tdev = scenes["dense"]
    outs, states = jax_runs[name]
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k > 0 else None
    out, new_state = _port_frame(tdev, k, state, _cfgs(name)[1])
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    share = SHARE.get(name, 0.96)
    assert hdr.shape == want.shape == (RES, RES, 3) and np.isfinite(hdr).all()
    assert _share(hdr, want) >= share
    assert abs(hdr.mean() - want.mean()) <= 0.02 * want.mean()
    ind, ind_want = new_state.gi_reservoirs.numpy(), states[k]["gi_reservoirs"]
    if FRAMES[name][0] == "restir_di":
        assert not ind.any() and not ind_want.any()
    else:
        close = np.isclose(ind, ind_want, rtol=1e-3, atol=1e-5, equal_nan=True)
        if name == "pt":  # the pdf rows of samples off the glass, as tests/test_torch_reuse_options.py
            for row in (TRP.PR.PDFA, TRP.PR.PDFS3):
                close[row] = np.isclose(ind[row], ind_want[row], rtol=0.1, atol=1e-5,
                                        equal_nan=True)
        assert close.all(0).mean() >= share


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_materials_frame_from_jax_state(scenes, jax_runs, name, k):
    """``check_frame`` of the GI frame and the GI frame with the reuse options."""
    check_frame(scenes, jax_runs, name, k)


def test_glass_and_coat_change_the_frame(scenes):
    """The materials show: against the same box with both blocks opaque
    (transmission and coat taken off), the glass and the coated block's
    pixels change, and the frame stays lit and finite."""
    import dataclasses

    from zetaray_tpu_torch.scene.procedural import materials_box as mb

    cpu = mb()
    m = cpu.materials
    opaque = dataclasses.replace(cpu, materials=dataclasses.replace(
        m, transmission=np.zeros_like(m.transmission), coat_weight=np.zeros_like(m.coat_weight)))
    _, tdev = scenes["dense"]
    odev = TS.upload_scene(opaque, device="cpu")
    assert not (odev.has_transmission or odev.has_coat)
    cfg = _cfgs("gi")[1]
    a = _port_frame(tdev, 0, None, cfg)[0]["hdr"].numpy()
    b = _port_frame(odev, 0, None, cfg)[0]["hdr"].numpy()
    assert np.isfinite(a).all() and a.mean() > 0
    assert (np.abs(a - b) > 1e-3 * (1 + np.abs(b))).any(-1).mean() > 0.05


def test_clustered_materials_gi_frames_match_jax(scenes):
    """Two chained GI frames (max_bounces=2) on the clustered materials box,
    each package chaining its own: 97% of the pixels, the GI reservoirs on
    97%."""
    jdev, tdev = scenes["clustered"]
    assert tdev.has_transmission and tdev.has_coat and tdev.cluster_aabb is not None
    base = dict(width=RES, height=RES, mode="restir_gi", denoise=False, taa=False)
    cfg_j = JF.RenderConfig(band_rows=0, pt=JPT.PTConfig(max_bounces=2), **base)
    cfg_t = RenderConfig(pt=PTConfig(max_bounces=2), **base)
    state_j = state_t = None
    for k in range(2):
        out_j, state_j = JF.render_frame_restir_jit(jdev, _camera(k), jax.random.PRNGKey(k),
                                                    cfg_j, state_j)
        out_t, state_t = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(k))),
                                             _seed(k), cfg_t, state_t)
        got = out_t["hdr"].numpy()
        assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
        assert _share(got, out_j["hdr"]) >= 0.97
        assert abs(got.mean() - out_j["hdr"].mean()) <= 0.02 * float(out_j["hdr"].mean())
    gi, gi_want = state_t.gi_reservoirs.numpy(), np.asarray(state_j.gi_reservoirs)
    assert np.isclose(gi, gi_want, rtol=1e-3, atol=1e-5).all(0).mean() >= 0.97
