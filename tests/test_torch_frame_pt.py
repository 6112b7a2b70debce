"""The ReSTIR PT frame and the plain path-traced frame of the PyTorch port
against the JAX package's ``render_frame_restir`` and ``render_frame``.

Pixelwise checks run the JAX frames through the bounce kernel in interpret
mode (``megakernel_eligible`` patched to True, as in
tests/test_torch_restir_pt.py), under a jit made inside the patch so that
no cached unpatched trace is reused, and, for ReSTIR PT, with the a-trous
filter and TAA off (the filter spreads one flipped sample over a 25-tap
neighbourhood four times over). With the flagship's a-trous and TAA on, the
port is held to the unpatched JAX frame on the CPU by the mean, since the
JAX wavefront tracer draws other random numbers. The JAX side runs with
``band_rows=0``: the port has no banded gathers.
"""

import numpy as np
import jax
import pytest
import torch

from zetaray_tpu.ops.pathtracer import PTConfig as JaxPTConfig
from zetaray_tpu.render import frame as JF
from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.restir_pt import PR
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_torch_frame import _camera, _port_frame, _seed, _state_dict
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_pt import _agree, patch_megakernel
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

RES = 32
PT_OFF = dict(width=RES, height=RES, mode="restir_pt", denoise=False, taa=False)
PT_FLAGSHIP = dict(width=RES, height=RES, mode="restir_pt", denoise=True, taa=True)


def _jax_cfg(base, bounces=3):
    return JF.RenderConfig(band_rows=0, pt=JaxPTConfig(max_bounces=bounces), **base)


def _port_cfg(base, bounces=3):
    return RenderConfig(pt=PTConfig(max_bounces=bounces), **base)


@pytest.fixture(scope="module")
def scenes():
    return scene_pair(cornell_box())


@pytest.fixture(scope="module")
def jax_pt_run(scenes):
    """Three JAX ReSTIR PT frames through the bounce kernel: (outputs, states)."""
    jdev, _ = scenes
    outs, states, state = [], [], None
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        render = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))
        for k in range(3):
            out, state = render(jdev, _camera(k), jax.random.PRNGKey(k), _jax_cfg(PT_OFF), state)
            outs.append({key: np.asarray(v) for key, v in out.items()})
            states.append(_state_dict(state))
    return outs, states


@pytest.mark.parametrize("k", [0, 1, 2])
def test_pt_frame_from_jax_state(scenes, jax_pt_run, k):
    """Start the port from the JAX state after frame k-1 (its 58-row PT
    reservoirs included), render frame k: at least 97% of pixels within
    1e-3 * (1 + |x|), and of the pre-spatial PT reservoirs."""
    _, tdev = scenes
    outs, states = jax_pt_run
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k > 0 else None
    if k > 0:  # the SRCSEED row crosses over bit for bit
        np.testing.assert_array_equal(state.gi_reservoirs[PR.SRCSEED].numpy().view(np.uint32),
                                      states[k - 1]["gi_reservoirs"][PR.SRCSEED].view(np.uint32))
    out, new_state = _port_frame(tdev, k, state, _port_cfg(PT_OFF))
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert hdr.shape == want.shape == (RES, RES, 3)
    close = np.abs(hdr - want) <= 1e-3 * (1.0 + np.abs(want))
    assert close.all(-1).mean() >= 0.97
    res, res_want = new_state.gi_reservoirs.numpy(), states[k]["gi_reservoirs"]
    assert res.shape == res_want.shape == (PR.ROWS, RES * RES)
    assert (res_want[PR.M] > 0).mean() > 0.5
    assert _agree(res, res_want, rtol=1e-3).mean() >= 0.97
    if k > 0:
        assert (res_want[PR.M] > 1).mean() > 0.3  # temporal PT reuse ran


def test_pt_flagship_chained_frames_mean(scenes):
    """Each package chains three ReSTIR PT frames with a-trous and TAA from
    nothing; the JAX frame traces its suffixes with its wavefront tracer
    (other random numbers), so the mean HDR is held to 3%."""
    jdev, tdev = scenes
    cfg_j, cfg_t = _jax_cfg(PT_FLAGSHIP), _port_cfg(PT_FLAGSHIP)
    state_j = state_t = None
    for k in range(3):
        out_j, state_j = JF.render_frame_restir_jit(jdev, _camera(k), jax.random.PRNGKey(k),
                                                    cfg_j, state_j)
        out_t, state_t = _port_frame(tdev, k, state_t, cfg_t)
        got, want = out_t["hdr"].numpy(), np.asarray(out_j["hdr"])
        assert np.isfinite(got).all()
        assert abs(got.mean() - want.mean()) <= 0.03 * want.mean(), (k, got.mean(), want.mean())
    assert (state_t.gi_reservoirs[PR.M] > 1).float().mean() > 0.3
    lit = RenderConfig(**{**PT_FLAGSHIP, "indirect": False})
    out_di, _ = _port_frame(tdev, 2, None, lit)
    assert got.mean() > 1.05 * out_di["hdr"].numpy().mean()  # the paths add light


def test_plain_pt_frame_matches_jax(scenes):
    """``render_frame`` with bench.py's plain PT settings (max_bounces=4)
    against the JAX ``render_frame`` through the bounce kernel: at least 99%
    of pixels within 1e-3 * (1 + |x|)."""
    jdev, tdev = scenes
    base = dict(width=RES, height=RES, mode="pt")
    k = 1
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        render = jax.jit(JF.render_frame, static_argnames=("cfg",))
        out_j = render(jdev, _camera(k), jax.random.PRNGKey(k), _jax_cfg(base, bounces=4))
    want = np.asarray(out_j["hdr"])
    out = render_frame(tdev, camera_from_arrays(cam_dict(_camera(k))), _seed(k),
                       _port_cfg(base, bounces=4))
    hdr = out["hdr"].numpy()
    assert hdr.shape == want.shape == (RES, RES, 3) and want.mean() > 0
    close = np.abs(hdr - want) <= 1e-3 * (1.0 + np.abs(want))
    assert close.all(-1).mean() >= 0.99
    ldr = out["ldr"].numpy()
    assert ldr.dtype == np.uint8
    assert (np.abs(ldr.astype(int) - np.asarray(out_j["ldr"])) <= 1).all(-1).mean() >= 0.99
