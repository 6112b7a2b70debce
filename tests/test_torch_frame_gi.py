"""The whole flagship frame (ReSTIR DI + ReSTIR GI) of the PyTorch port
against the JAX package's ``render_frame_restir``.

Pixelwise checks run the JAX frame through the bounce kernels in interpret
mode (``megakernel_eligible`` patched to True, as in
tests/test_torch_restir_gi.py), under a jit made inside the patch so that
no cached unpatched trace is reused, and with the a-trous filter and TAA
off: the filter spreads one flipped sample over a 25-tap neighbourhood
four times over. The flagship settings (a-trous and TAA on) are held to the
unpatched JAX frame on the CPU by their mean, since the JAX wavefront
tracer draws other random numbers. The JAX side runs with ``band_rows=0``:
the port has no banded gathers.
"""

import numpy as np
import jax
import pytest
import torch

from zetaray_tpu.ops.pathtracer import PTConfig as JaxPTConfig
from zetaray_tpu.render import frame as JF
from zetaray_tpu_torch.interop import frame_state_from_arrays
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import RenderConfig
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_torch_frame import _camera, _port_frame, _state_dict
from tests.test_torch_restir_gi import patch_megakernel
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

RES = 32
GI = dict(width=RES, height=RES, mode="restir_gi", denoise=False, taa=False)
FLAGSHIP = dict(width=RES, height=RES, mode="restir_gi", denoise=True, taa=True)


def _jax_cfg(base):
    return JF.RenderConfig(band_rows=0, pt=JaxPTConfig(max_bounces=3), **base)


def _port_cfg(base):
    return RenderConfig(pt=PTConfig(max_bounces=3), **base)


@pytest.fixture(scope="module")
def scenes():
    return scene_pair(cornell_box())


@pytest.fixture(scope="module")
def jax_gi_run(scenes):
    """Three JAX GI frames through the bounce kernels: (outputs, states)."""
    jdev, _ = scenes
    outs, states, state = [], [], None
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        render = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))
        for k in range(3):
            out, state = render(jdev, _camera(k), jax.random.PRNGKey(k), _jax_cfg(GI), state)
            outs.append({key: np.asarray(v) for key, v in out.items()})
            states.append(_state_dict(state))
    return outs, states


@pytest.mark.parametrize("k", [0, 1, 2])
def test_gi_frame_from_jax_state(scenes, jax_gi_run, k):
    """Start the port from the JAX state after frame k-1, render frame k."""
    _, tdev = scenes
    outs, states = jax_gi_run
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k > 0 else None
    out, new_state = _port_frame(tdev, k, state, _port_cfg(GI))
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert hdr.shape == want.shape == (RES, RES, 3)
    close = np.abs(hdr - want) <= 1e-3 * (1.0 + np.abs(want))
    assert close.all(-1).mean() >= 0.97
    gi, gi_want = new_state.gi_reservoirs.numpy(), states[k]["gi_reservoirs"]
    assert (gi_want[10] > 0).mean() > 0.5
    assert np.isclose(gi, gi_want, rtol=1e-3, atol=1e-5).all(0).mean() >= 0.97
    if k > 0:
        assert (gi_want[10] > 1).mean() > 0.3  # temporal GI reuse ran


def test_flagship_chained_frames_mean(scenes):
    """Each package chains three flagship frames from nothing; the JAX frame
    traces GI with its wavefront tracer (other random numbers), so the mean
    HDR is held to 3%. The port's GI reservoirs grow M by temporal reuse."""
    jdev, tdev = scenes
    cfg_j, cfg_t = _jax_cfg(FLAGSHIP), _port_cfg(FLAGSHIP)
    state_j = state_t = None
    for k in range(3):
        out_j, state_j = JF.render_frame_restir_jit(jdev, _camera(k), jax.random.PRNGKey(k),
                                                    cfg_j, state_j)
        out_t, state_t = _port_frame(tdev, k, state_t, cfg_t)
        got, want = out_t["hdr"].numpy(), np.asarray(out_j["hdr"])
        assert np.isfinite(got).all()
        assert abs(got.mean() - want.mean()) <= 0.03 * want.mean(), (k, got.mean(), want.mean())
    assert (state_t.gi_reservoirs[10] > 1).float().mean() > 0.3
    lit = RenderConfig(**{**FLAGSHIP, "indirect": False})
    out_di, _ = _port_frame(tdev, 2, None, lit)
    assert got.mean() > 1.05 * out_di["hdr"].numpy().mean()  # GI adds light
