"""The display options of the PyTorch port against the JAX package: the
weighted-average exposure, every tonemapper of ``TONEMAPPERS_P`` (the Tony
McMapface LUT loader on a DDS file the test writes), the firefly filter
and the picked outline, on numpy-seeded inputs; then the JAX app's default
frame (``mode="restir_di"``) at 32^2 with each exposure mode and
tonemapper, and with the firefly filter.

Float work agrees to rtol 1e-5 (sums over the image in another order);
the LUT decode, the outline and the u8 images of equal inputs exactly. The
frames run the JAX side through its bounce kernels in interpret mode, as
tests/test_torch_frame_restir_di.py does, and hold the same shares of
pixels (97% within 1e-3 * (1 + |x|)). The tonemappers do not change the
HDR, so one JAX frame serves them all: the port's frame with each setting
is held to the JAX frame's own post chain (``_postprocess``) with that
setting on the JAX frame's HDR.
"""

import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.ops import denoise as JDN
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import post as JP
from zetaray_tpu.render import frame as JF
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import denoise as TDN
from zetaray_tpu_torch.ops import post as TP
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_torch_frame import _camera, _seed
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_pt import patch_megakernel
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

H, W = 24, 32
RTOL, ATOL = 1e-5, 1e-6


def _img(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return (r.lognormal(-1.0, 1.5, (3, H, W)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
@pytest.mark.parametrize("adapt", [False, True])
def test_weighted_avg_exposure_matches_jax(scale, adapt):
    img = _img(6, scale)
    img[:, :2] = 0.0  # black pixels stay out of the mean
    kw = dict(prev_avg=0.3, dt=1.0 / 60.0) if adapt else {}
    e_want, avg_want = JP.weighted_avg_exposure_p(jnp.asarray(img), **kw)
    e_got, avg_got = TP.weighted_avg_exposure_p(torch.from_numpy(img), **kw)
    assert e_got.dtype == torch.float32 and e_got.dim() == 0
    np.testing.assert_allclose(float(avg_got), float(avg_want), rtol=RTOL)
    np.testing.assert_allclose(float(e_got), float(e_want), rtol=RTOL)


@pytest.mark.parametrize("name", sorted(set(JP.TONEMAPPERS_P) - {"tony"}))
def test_tonemappers_match_jax(name):
    assert sorted(TP.TONEMAPPERS_P) == sorted(JP.TONEMAPPERS_P)
    x = _img(7)
    want = np.asarray(JP.TONEMAPPERS_P[name](jnp.asarray(x)))
    got = TP.TONEMAPPERS_P[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _dds_r9g9b9e5(path, texels: np.ndarray, d: int, h: int, w: int):
    """A DX10 3D DDS of R9G9B9E5_SHAREDEXP texels (u32 [d * h * w])."""
    hdr = bytearray(148)
    hdr[0:4] = b"DDS "
    struct.pack_into("<7I", hdr, 4, 124, 0x81007, h, w, 0, d, 1)
    struct.pack_into("<2I", hdr, 76, 32, 0x4)  # pixel format: size, DDPF_FOURCC
    hdr[84:88] = b"DX10"
    struct.pack_into("<5I", hdr, 128, 67, 4, 0, 1, 0)  # R9G9B9E5, TEXTURE3D
    path.write_bytes(bytes(hdr) + texels.astype("<u4").tobytes())


def _seeded_lut_file(path, n=8):
    r = np.random.default_rng(11)
    mant = r.integers(0, 512, (3, n ** 3), dtype=np.uint32)
    exp = r.integers(12, 16, n ** 3, dtype=np.uint32)
    texels = mant[0] | (mant[1] << 9) | (mant[2] << 18) | (exp << 27)
    texels[0] = 256 | (15 << 27)  # red = 256 * 2^(15 - 24) = 0.5, green = blue = 0
    _dds_r9g9b9e5(path, texels, n, n, n)


def test_load_lut_3d_matches_jax(tmp_path):
    path = tmp_path / "lut.dds"
    _seeded_lut_file(path)
    got = TP.load_lut_3d(path)
    want = JP.load_lut_3d(path)
    assert got.shape == want.shape == (8, 8, 8, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0, 0], [0.5, 0.0, 0.0])
    (tmp_path / "bad.dds").write_bytes(b"XXXX" + bytes(200))
    with pytest.raises(ValueError, match="not a DDS"):
        TP.load_lut_3d(tmp_path / "bad.dds")


def test_tonemap_tony_matches_jax(tmp_path):
    path = tmp_path / "lut.dds"
    _seeded_lut_file(path)
    lut = TP.load_lut_3d(path)
    x = _img(8, 2.0)
    x[:, 0, 0] = -1.0  # negative radiance clamps to 0
    want = np.asarray(JP.tonemap_tony_p(jnp.asarray(x), lut))
    got = TP.tonemap_tony_p(torch.from_numpy(x), lut).numpy()
    assert got.shape == (3, H, W)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.01


@pytest.mark.parametrize("factor", [2.0, 3.0])
def test_firefly_filter_matches_jax(factor):
    img = _img(9)
    img[:, 3, 4] *= 80.0  # fireflies, one on the border (the stencil wraps)
    img[:, 0, W - 1] *= 80.0
    want = np.asarray(JDN.firefly_filter_p(jnp.asarray(img), factor))
    got = TDN.firefly_filter_p(torch.from_numpy(img), factor).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[:, 3, 4].sum() < 0.5 * img[:, 3, 4].sum()
    assert got[:, 0, W - 1].sum() < 0.5 * img[:, 0, W - 1].sum()


@pytest.mark.parametrize("picked", [2, [2, 5], [0, 7]])
def test_picked_outline_matches_jax(picked):
    """Instance 0 fills the top-left corner and instance 7 a band along the
    bottom edge: their outlines wrap around to the opposite edges, as the
    JAX package's rolls do."""
    inst = np.full((H, W), 1.0, np.float32)
    inst[4:10, 6:14] = 2.0
    inst[12:20, 20:30] = 5.0
    inst[0:3, 0:3] = 0.0
    inst[H - 2:, 8:24] = 7.0
    inst[18, 2] = -1.0  # a miss
    ldr = np.random.default_rng(4).uniform(0, 1, (3, H, W)).astype(np.float32)
    want = np.asarray(JP.picked_outline_p(jnp.asarray(ldr), jnp.asarray(inst), picked))
    got = TP.picked_outline_p(torch.from_numpy(ldr), torch.from_numpy(inst), picked).numpy()
    np.testing.assert_array_equal(got, want)
    edge = (got != ldr).any(0)
    assert edge.sum() > 10
    if 0 in np.atleast_1d(picked):
        assert edge[H - 1].any() and edge[:, W - 1].any()  # wrapped around


@pytest.mark.parametrize("what", ["agx_look", "tonemapper"])
def test_unknown_display_settings_raise(what):
    if what == "agx_look":
        with pytest.raises(ValueError, match="unknown AgX look"):
            TP.tonemap_agx_p(torch.ones(3, 2, 2), "vivid")
    else:
        with pytest.raises(ValueError, match="unknown tonemapper"):
            RenderConfig(mode="restir_di", tonemapper="filmic").check_ported()


RES = 32
# the JAX app's default frame (app.py: restir_di, max_bounces=4, TAA)
BASE = dict(width=RES, height=RES, mode="restir_di", taa=True)
DISPLAY = [(em, tm) for em in ("histogram", "weighted_avg")
           for tm in sorted(set(JP.TONEMAPPERS_P) - {"tony"})]


def _share(got, want, tol=1e-3):
    return (np.abs(got - want) <= tol * (1.0 + np.abs(want))).all(-1).mean()


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX default frame at 32^2 (frame 1 of the drifting camera, no
    state) plain and with the firefly filter at 3 and the weighted-average
    exposure, through the bounce kernels."""
    jdev, tdev = scene_pair(cornell_box())
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        render = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))
        for name, extra in (("plain", {}),
                            ("firefly", dict(firefly_factor=3.0, exposure_mode="weighted_avg"))):
            cfg = JF.RenderConfig(band_rows=0, pt=JPT.PTConfig(max_bounces=4), **BASE, **extra)
            out, _ = render(jdev, _camera(1), jax.random.PRNGKey(1), cfg, None)
            outs[name] = {k: np.asarray(v) for k, v in out.items()}
    return tdev, outs


def _port(tdev, **extra):
    cfg = RenderConfig(pt=PTConfig(max_bounces=4), **BASE, **extra)
    out, _ = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(1))), _seed(1),
                                 cfg, None)
    return out["hdr"].numpy(), out["ldr"].numpy()


@pytest.mark.parametrize("exposure,tonemapper", DISPLAY)
def test_default_frame_display_options(jax_frames, exposure, tonemapper):
    tdev, outs = jax_frames
    hdr, ldr = _port(tdev, exposure_mode=exposure, tonemapper=tonemapper)
    want = outs["plain"]["hdr"]
    assert _share(hdr, want) >= 0.97
    cfg_j = JF.RenderConfig(pt=JPT.PTConfig(max_bounces=4), exposure_mode=exposure,
                            tonemapper=tonemapper, **BASE)
    ldr_want = np.asarray(JF._postprocess(jnp.asarray(want.transpose(2, 0, 1)), cfg_j))
    ldr_want = ldr_want.transpose(1, 2, 0)
    assert ldr.dtype == np.uint8 and ldr.shape == ldr_want.shape == (RES, RES, 3)
    assert (np.abs(ldr.astype(int) - ldr_want) <= 1).all(-1).mean() >= 0.97


def test_default_frame_with_firefly_filter(jax_frames):
    """firefly_factor=3 and the weighted-average exposure (path 3's first
    setting) against the JAX frame; the filter darkens the brightest pixels."""
    tdev, outs = jax_frames
    hdr, ldr = _port(tdev, firefly_factor=3.0, exposure_mode="weighted_avg")
    want = outs["firefly"]
    assert _share(hdr, want["hdr"]) >= 0.97
    assert (np.abs(ldr.astype(int) - want["ldr"]) <= 1).all(-1).mean() >= 0.97
    plain, _ = _port(tdev)
    lum = lambda x: x @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    assert lum(hdr).max() < lum(plain).max()
    assert (hdr != plain).any(-1).mean() > 0.0
