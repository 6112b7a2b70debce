"""The temporal upscaler (``ops/upscale.py``: ``taau_resolve``, ``rcas_p``)
of the PyTorch port against the JAX package, and bench.py's
``upscale_256_to_512`` frame at display 64^2, render 32^2.

``taau_resolve`` runs on seeded planes: render 24x32, display 48x64, a
nonzero jitter, a camera moved between the frames, a last depth plane that
disagrees with the reprojection on a fifth of the texels, and a seeded lock
plane (locks form only where a sample's luminance leaves its own
neighbourhood's bilinear range, which a bilinear sample of the same image
never does, so without a lock plane passed in every lock is 0). The JAX
function resamples with dense matmuls, which XLA on the CPU may contract
into FMAs; the port gathers two taps and rounds each operation. So values
agree to rtol 1e-5, and the thresholds that decide a pixel outright (a
sampled validity above 0.99, the depth clip's tolerance, the lock test)
may flip a pixel: at most 0.1% of the display pixels may differ more.

The frame chain runs the JAX frame's GI through the bounce kernels in
interpret mode (as tests/test_torch_frame_gi.py does) with a-trous off, as
bench.py's frame has it, and starts the port from the JAX state (display-
res history, luminance locks, render-res reservoirs and G-buffer).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import upscale as JUP
from zetaray_tpu.render import frame as JF
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays
from zetaray_tpu_torch.ops import upscale as TUP
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_torch_frame import _camera, _seed, _state_dict
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_gi import patch_megakernel
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

HR, WR = 24, 32  # render resolution
H, W = 48, 64  # display resolution
JITTER = (0.3125, -0.2222)
RTOL, ATOL = 1e-5, 1e-6


def _smooth(seed, c, h, w):
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ph = r.uniform(0, 6.28, (c, 1, 1))
    return (0.6 + 0.4 * np.sin(x / 5.0 + ph) * np.cos(y / 7.0 - ph)).astype(np.float32)


def _inputs():
    """Seeded render-res planes, display-res history and lock, cameras."""
    r = np.random.default_rng(3)
    curr = _smooth(1, 3, HR, WR)
    curr[:, 5, 7] = 3.0  # a bright texel: a thin feature for the clamp
    cam = JaxCamera.look_at((0.0, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0, aspect=W / H)
    o, d = cam.generate_rays(WR, HR)
    depth = r.uniform(2.0, 4.0, (HR, WR)).astype(np.float32)
    pos = (np.asarray(o) + np.asarray(d) * depth.reshape(-1, 1)).T.reshape(3, HR, WR)
    valid = r.uniform(size=(HR, WR)) > 0.1
    prev = JaxCamera.look_at((0.04, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0, aspect=W / H)
    # the last depth plane: the reprojected depth, off by 30% on a fifth
    prev_depth = depth * np.where(r.uniform(size=(HR, WR)) < 0.2, 1.3, 1.0).astype(np.float32)
    return dict(curr=curr, hist=_smooth(2, 3, H, W), pos=pos.astype(np.float32), valid=valid,
                depth=depth, prev_depth=prev_depth,
                lock=r.uniform(0, 1, (H, W)).astype(np.float32), prev=prev)


CASES = {
    "first_frame": dict(),
    "history": dict(),
    "no_depth_clip": dict(depth_clip_tol=0.0),
    "depth_clip_0.1": dict(depth_clip_tol=0.1),
    "no_locks": dict(locks=False),
    "reactive_0.5": dict(reactive_scale=0.5),
    "no_clamp": dict(clamp=False),
}


def _close(got, want):
    return np.isclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_taau_resolve_matches_jax(name):
    x = _inputs()
    cfg_kw = CASES[name]
    hist = None if name == "first_frame" else x["hist"]
    want, want_lock = JUP.taau_resolve(
        jnp.asarray(x["curr"]), None if hist is None else jnp.asarray(hist),
        jnp.asarray(x["pos"]), jnp.asarray(x["valid"]), jnp.asarray(x["depth"]), x["prev"],
        JITTER, W, H, JUP.UpscaleConfig(**cfg_kw),
        prev_depth_lr=jnp.asarray(x["prev_depth"]), lock=jnp.asarray(x["lock"]),
    )
    t = lambda k: torch.from_numpy(x[k])
    got, got_lock = TUP.taau_resolve(
        t("curr"), None if hist is None else torch.from_numpy(hist), t("pos"), t("valid"),
        t("depth"), camera_from_arrays(cam_dict(x["prev"])), JITTER, W, H,
        TUP.UpscaleConfig(**cfg_kw), prev_depth_lr=t("prev_depth"), lock=t("lock"),
    )
    want = np.asarray(want)
    assert got.shape == want.shape == (3, H, W)
    assert _close(got.numpy(), want).all(0).mean() >= 0.999
    if hist is not None:
        assert not np.allclose(want, np.asarray(JUP.taau_resolve(
            jnp.asarray(x["curr"]), None, jnp.asarray(x["pos"]), jnp.asarray(x["valid"]),
            jnp.asarray(x["depth"]), x["prev"], JITTER, W, H)[0]))  # history blended in
    if want_lock is None:
        assert got_lock is None
    else:
        want_lock = np.asarray(want_lock)
        assert got_lock.shape == want_lock.shape == (H, W)
        assert _close(got_lock.numpy(), want_lock).mean() >= 0.999
        if hist is not None:
            assert (want_lock > 0).mean() > 0.3  # the locks followed their feature


@pytest.mark.parametrize("sharpness", [0.0, 0.5, 0.8])
def test_rcas_matches_jax(sharpness):
    r = np.random.default_rng(int(sharpness * 10))
    img = np.clip(_smooth(5, 3, H, W) + r.normal(0, 0.05, (3, H, W)), 0, 1).astype(np.float32)
    want = np.asarray(JUP.rcas_p(jnp.asarray(img), sharpness))
    got = TUP.rcas_p(torch.from_numpy(img), sharpness).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.allclose(want, img) == (sharpness == 0.0)


DISPLAY = 64
# bench.py's upscale_256_to_512 (bench.py:178-183) at display 64^2
UPSCALE = dict(width=DISPLAY, height=DISPLAY, mode="restir_gi", render_scale=0.5, taa=True)


def _cfgs():
    return (JF.RenderConfig(band_rows=0, pt=JPT.PTConfig(max_bounces=2),
                            upscale_cfg=JUP.UpscaleConfig(rcas_sharpness=0.8), **UPSCALE),
            RenderConfig(pt=PTConfig(max_bounces=2),
                         upscale_cfg=TUP.UpscaleConfig(rcas_sharpness=0.8), **UPSCALE))


@pytest.fixture(scope="module")
def jax_upscale_run():
    """Three chained JAX upscale frames through the bounce kernels."""
    jdev, tdev = scene_pair(cornell_box())
    outs, states, state = [], [], None
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        render = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))
        for k in range(3):
            out, state = render(jdev, _camera(k), jax.random.PRNGKey(k), _cfgs()[0],
                                state)
            outs.append({key: np.asarray(v) for key, v in out.items()})
            states.append(_state_dict(state))
    return jdev, tdev, outs, states


@pytest.mark.parametrize("k", [0, 1, 2])
def test_upscale_frame_from_jax_state(jax_upscale_run, k):
    """Frame k at display 64^2 from the JAX state after frame k-1: the
    display image, the lock plane and the render-res reservoirs."""
    _, tdev, outs, states = jax_upscale_run
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k > 0 else None
    if k > 0:
        assert tuple(state.history.shape) == (3, DISPLAY, DISPLAY)
        assert tuple(state.upscale_lock.shape) == (DISPLAY, DISPLAY)
        assert tuple(state.gbuf.shape[1:]) == (32 * 32,)
    out, new = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(k))),
                                   _seed(k), _cfgs()[1], state)
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert hdr.shape == want.shape == (DISPLAY, DISPLAY, 3) and np.isfinite(hdr).all()
    close = np.abs(hdr - want) <= 1e-3 * (1.0 + np.abs(want))
    assert close.all(-1).mean() >= 0.97
    ldr = out["ldr"].numpy()
    assert (np.abs(ldr.astype(int) - outs[k]["ldr"]) <= 1).all(-1).mean() >= 0.97
    np.testing.assert_allclose(new.upscale_lock.numpy(), states[k]["upscale_lock"], atol=1e-6)
    gi, gi_want = new.gi_reservoirs.numpy(), states[k]["gi_reservoirs"]
    assert gi.shape == gi_want.shape == (16, 32 * 32)
    assert np.isclose(gi, gi_want, rtol=1e-3, atol=1e-5).all(0).mean() >= 0.97


def test_upscale_chained_frames_mean():
    """Each package chains three upscale frames from nothing (the JAX GI on
    its wavefront tracer, other random numbers): the mean HDR within 3%,
    and RCAS changes the image."""
    jdev, tdev = scene_pair(cornell_box())
    cfg_j, cfg_t = _cfgs()
    state_j = state_t = None
    for k in range(3):
        out_j, state_j = JF.render_frame_restir_jit(jdev, _camera(k),
                                                    jax.random.PRNGKey(k), cfg_j, state_j)
        cam = camera_from_arrays(cam_dict(_camera(k)))
        last = state_t
        out_t, state_t = render_frame_restir(tdev, cam, _seed(k), cfg_t, state_t)
        got, want = out_t["hdr"].numpy(), np.asarray(out_j["hdr"])
        assert got.shape == (DISPLAY, DISPLAY, 3) and np.isfinite(got).all()
        assert abs(got.mean() - want.mean()) <= 0.03 * want.mean(), (k, got.mean(), want.mean())
    # RCAS acts on the display image after the tonemap only
    unsharp = dataclasses.replace(cfg_t, upscale_cfg=TUP.UpscaleConfig())
    out_u, _ = render_frame_restir(tdev, cam, _seed(2), unsharp, last)
    assert torch.equal(out_u["hdr"], out_t["hdr"])
    assert (out_u["ldr"] != out_t["ldr"]).any(-1).float().mean() > 0.05
