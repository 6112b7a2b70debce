"""Post chain of the PyTorch port against the JAX package: a-trous, TAA,
histogram exposure, AgX, sRGB and the u8 quantization, on the same
numpy-seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.ops import denoise as JDN
from zetaray_tpu.ops import post as JP
from zetaray_tpu.ops import taa as JTA
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch import native
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import denoise as TDN
from zetaray_tpu_torch.ops import post as TP
from zetaray_tpu_torch.ops import taa as TTA
from tests.test_torch_restir_di import cam_dict

torch.set_num_threads(1)

H, W = 24, 32


def _img(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return (r.lognormal(-1.0, 1.5, (3, H, W)) * scale).astype(np.float32)


def _smooth_img(seed):
    """A smooth colour field. TAA's reprojected coordinates agree with the
    JAX package's to float rounding (a few 1e-6 px); a noise image would
    turn that into large differences through the resampler's slopes, a
    rendered frame does not."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    ph = r.uniform(0, 6.28, (3, 1, 1))
    img = 0.6 + 0.4 * np.sin(x / 5.0 + ph) * np.cos(y / 7.0 - ph)
    return img.astype(np.float32)


def _gbuf_planes(seed):
    r = np.random.default_rng(seed)
    nrm = r.normal(size=(3, H, W))
    nrm[2] = np.abs(nrm[2]) + 2.0  # mostly agreeing normals
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    depth = r.uniform(2.0, 4.0, (H, W)).astype(np.float32)
    valid = r.uniform(size=(H, W)) > 0.1
    return nrm.astype(np.float32), depth, valid


def test_atrous_matches_jax():
    img = _img(1)
    nrm, depth, valid = _gbuf_planes(2)
    want = np.asarray(JDN.atrous_denoise_p(*(jnp.asarray(x) for x in (img, nrm, depth, valid))))
    got = TDN.atrous_denoise_p(*(torch.from_numpy(x) for x in (img, nrm, depth, valid))).numpy()
    assert not np.allclose(want, img)  # the filter did something
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_atrous_on_cpu_takes_the_plain_pass():
    """CPU tensors take the plain pass, with the validity as bool or float:
    no kernel launch."""
    img = torch.from_numpy(_img(1))
    nrm, depth, valid = (torch.from_numpy(x) for x in _gbuf_planes(2))
    before = native.launches["zr_atrous"]
    assert torch.equal(TDN.atrous_denoise_p(img, nrm, depth, valid),
                       TDN.atrous_denoise_plain(img, nrm, depth, valid))
    assert torch.equal(TDN.atrous_iteration_p(img, nrm, depth, valid.to(torch.float32), 2),
                       TDN.atrous_iteration_plain(img, nrm, depth, valid.to(torch.float32), 2))
    assert native.launches["zr_atrous"] == before


@pytest.mark.parametrize("shift", [0.0, 0.05])
def test_taa_matches_jax(shift):
    curr, hist = _smooth_img(3), _smooth_img(4)
    _nrm, depth, valid = _gbuf_planes(5)
    cam = JaxCamera.look_at((shift, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0, aspect=W / H)
    # world positions: points along each pixel's ray at its depth
    o, d = cam.generate_rays(W, H)
    pos = (np.asarray(o) + np.asarray(d) * depth.reshape(-1, 1)).T.reshape(3, H, W)
    prev = JaxCamera.look_at((shift + 0.03, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0,
                             aspect=W / H)
    want = np.asarray(JTA.taa_resolve_p(
        jnp.asarray(curr), jnp.asarray(hist), jnp.asarray(pos.astype(np.float32)),
        jnp.asarray(valid), prev, depth=jnp.asarray(depth),
    ))
    got = TTA.taa_resolve_p(
        torch.from_numpy(curr), torch.from_numpy(hist), torch.from_numpy(pos.astype(np.float32)),
        torch.from_numpy(valid), camera_from_arrays(cam_dict(prev)), torch.from_numpy(depth),
    ).numpy()
    assert not np.allclose(want, curr)  # history was blended in
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
def test_exposure_tonemap_srgb_match_jax(scale):
    img = _img(6, scale)
    img[:, :2] = 0.0  # black pixels stay out of the histogram
    e_want = float(JP.histogram_exposure_p(jnp.asarray(img)))
    e_got = float(TP.histogram_exposure_p(torch.from_numpy(img)))
    np.testing.assert_allclose(e_got, e_want, rtol=1e-5)
    x = img * np.float32(e_want)
    tm_want = np.array(JP.tonemap_agx_p(jnp.asarray(x)))
    tm_got = TP.tonemap_agx_p(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tm_got, tm_want, rtol=1e-5, atol=1e-6)
    s_want = np.array(JP.srgb_encode(jnp.asarray(tm_want)))
    s_got = TP.srgb_encode(torch.from_numpy(tm_want)).numpy()
    np.testing.assert_allclose(s_got, s_want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        TP.to_u8(torch.from_numpy(s_want)).numpy(), np.asarray(JP.to_u8(jnp.asarray(s_want)))
    )


def test_to_u8_rounds_half_to_even():
    x = (np.arange(0, 256, dtype=np.float32) + 0.5) / 255.0
    x = np.concatenate([x, [-1.0, 0.0, 1.0, 2.0]]).astype(np.float32)
    np.testing.assert_array_equal(
        TP.to_u8(torch.from_numpy(x)).numpy(), np.asarray(JP.to_u8(jnp.asarray(x)))
    )
