"""The thin-lens camera of the PyTorch port against the JAX package: the
concentric disk warp, ``Camera.generate_rays`` with lens uniforms, and a
plain path-traced frame and the JAX app's default frame at 32^2 through a
lens (``f_stop=2.8``, 50 mm, focus 3.5).

The port draws its lens uniforms from its own counter hash
(``render.frame._lens_u``: ``uniform4(pixel, 0, seed, 0x0D0F)``); the JAX
frame draws them with ``jax.random`` from its key, which the port's u32
frame seed cannot reproduce. So the frame tests hand the port the JAX
draw (``_lens_u`` patched) and compare pixel for pixel, with the shares
of tests/test_torch_frame_pt.py (plain PT, 99%) and
tests/test_torch_frame_restir_di.py (97%), the JAX side through its
bounce kernels in interpret mode. The warp and the rays agree to 1e-6: sin
and cos round differently by an ulp in XLA and in PyTorch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.core.sampling import square_to_disk_concentric as j_disk
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.render import frame as JF
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.core.sampling import square_to_disk_concentric
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render import frame as TF
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from tests.test_torch_frame import _seed
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_pt import patch_megakernel
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

RES = 32
LENS = dict(f_stop=2.8, focal_length_mm=50.0, focus_dist=3.5)


def _lens_camera(k):
    return JaxCamera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0,
                             **LENS).with_jitter(k)


def test_square_to_disk_concentric_matches_jax():
    r = np.random.default_rng(2)
    u = r.uniform(0, 1, (4096, 2)).astype(np.float32)
    u[0] = (0.5, 0.5)  # the centre: r = 0
    u[1] = (1.0, 0.5)
    u[2] = (0.5, 0.0)
    u[3] = (0.0, 0.0)
    want = np.asarray(j_disk(jnp.asarray(u)))
    got = square_to_disk_concentric(torch.from_numpy(u)).numpy()
    assert got.shape == (4096, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], [0.0, 0.0])
    assert (np.hypot(got[:, 0], got[:, 1]) <= 1.0 + 1e-6).all()


def test_generate_rays_with_lens_matches_jax():
    cam = _lens_camera(3)
    assert cam.lens_radius > 0.0
    u = np.random.default_rng(5).uniform(0, 1, (RES * RES, 2)).astype(np.float32)
    o_j, d_j = cam.generate_rays(RES, RES, lens_u=jnp.asarray(u))
    tcam = camera_from_arrays(cam_dict(cam))
    o, d = tcam.generate_rays(RES, RES, torch.from_numpy(u), device="cpu")
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6)
    o_pin, d_pin = tcam.generate_rays(RES, RES, device="cpu")  # no uniforms: the eye
    assert (o.numpy() != o_pin.numpy()).any(-1).mean() > 0.99
    assert np.allclose(o_pin.numpy(), np.asarray(cam.eye)[None])


def test_port_lens_uniforms():
    """The port's own draw: uniform4(pixel, 0, seed, 0x0D0F), in [0, 1),
    None for a pinhole."""
    from zetaray_tpu_torch.core.rng import uniform4

    tcam = camera_from_arrays(cam_dict(_lens_camera(0)))
    u = TF._lens_u(tcam, 77, 100, "cpu")
    want = uniform4(torch.arange(100), 0, 77, salt=0x0D0F)
    assert torch.equal(u, torch.stack([want[0], want[1]], -1))
    assert 0.0 <= u.min() and u.max() < 1.0
    pin = camera_from_arrays(cam_dict(JaxCamera.look_at(CAMERA_EYE, CAMERA_TARGET)))
    assert TF._lens_u(pin, 77, 100, "cpu") is None


def _jax_lens_u(monkeypatch, jcam, k):
    """Hand the port's frame the JAX frame's lens draw for frame k."""
    key = jax.random.PRNGKey(k)
    monkeypatch.setattr(TF, "_lens_u", lambda camera, seed, n, device: torch.from_numpy(
        np.array(JF._lens_u(jcam, key, n))).to(device))


@pytest.fixture(scope="module")
def scenes():
    return scene_pair(cornell_box())


@pytest.mark.parametrize("mode", ["pt", "restir_di"])
def test_lens_frame_matches_jax(scenes, monkeypatch, mode):
    jdev, tdev = scenes
    k = 1
    jcam = _lens_camera(k)
    base = dict(width=RES, height=RES, mode=mode)
    jcfg = JF.RenderConfig(band_rows=0, pt=JPT.PTConfig(max_bounces=4), **base)
    tcfg = TF.RenderConfig(pt=PTConfig(max_bounces=4), **base)
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        if mode == "pt":
            out_j = jax.jit(JF.render_frame, static_argnames=("cfg",))(
                jdev, jcam, jax.random.PRNGKey(k), jcfg)
        else:
            out_j, _ = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))(
                jdev, jcam, jax.random.PRNGKey(k), jcfg, None)
    want = np.asarray(out_j["hdr"])
    _jax_lens_u(monkeypatch, jcam, k)
    tcam = camera_from_arrays(cam_dict(jcam))
    if mode == "pt":
        out = TF.render_frame(tdev, tcam, _seed(k), tcfg)
    else:
        out, _ = TF.render_frame_restir(tdev, tcam, _seed(k), tcfg, None)
    hdr = out["hdr"].numpy()
    assert hdr.shape == want.shape == (RES, RES, 3) and want.mean() > 0
    close = np.abs(hdr - want) <= 1e-3 * (1.0 + np.abs(want))
    assert close.all(-1).mean() >= (0.99 if mode == "pt" else 0.97)
    assert (np.abs(out["ldr"].numpy().astype(int) - np.asarray(out_j["ldr"])) <= 1).all(
        -1).mean() >= 0.97
    # the lens changes the image: the same frame through a pinhole differs
    pin = camera_from_arrays(cam_dict(JaxCamera.look_at(
        CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0).with_jitter(k)))
    out_pin = (TF.render_frame(tdev, pin, _seed(k), tcfg) if mode == "pt"
               else TF.render_frame_restir(tdev, pin, _seed(k), tcfg, None)[0])
    assert (out_pin["hdr"].numpy() != hdr).any(-1).mean() > 0.3
