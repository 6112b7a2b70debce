"""Auto-exposure, tonemappers, sRGB encode and the picked outline, as the
JAX package's ``ops/post.py``.

Planar: images are [3, ...] channel-first. Divisions by constants go through
a tensor divisor (``ops.sky._div``), so the card rounds them as the CPU does.
"""

from __future__ import annotations

import functools
import struct
from pathlib import Path

import numpy as np
import torch

from ..parallel.halo import all_reduce_sum
from .sky import _div, _rdiv

# AgX fitted matrices (float32 values, as in the JAX package).
_AGX_MAT = np.array(
    [
        [0.842479062253094, 0.0423282422610123, 0.0423756549057051],
        [0.0784335999999992, 0.878468636469772, 0.0784336],
        [0.0792237451477643, 0.0791661274605434, 0.879142973793104],
    ],
    dtype=np.float32,
)
_AGX_MAT_INV = np.array(
    [
        [1.19687900512017, -0.0528968517574562, -0.0529716355144438],
        [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
        [-0.0990297440797205, -0.0989611768448433, 1.15107367264116],
    ],
    dtype=np.float32,
)
_AGX_MIN_EV = -12.47393
_AGX_MAX_EV = 4.026069


def luminance_p(img):
    """Rec.709 luminance over a leading channel axis [3, ...] -> [...]."""
    return 0.2126 * img[0] + 0.7152 * img[1] + 0.0722 * img[2]


def histogram_exposure_p(
    hdr: torch.Tensor, bins: int = 256, min_log_lum: float = -10.0,
    max_log_lum: float = 8.0, low_clip: float = 0.6, high_clip: float = 0.95,
    key_value: float = 0.18, shard=None,
) -> torch.Tensor:
    """Exposure scale from a percentile-clipped log-luminance histogram:
    the clipped geometric-mean luminance maps to ``key_value``. ``shard``
    (``parallel.halo.ShardCtx``): ``hdr`` is a row band, and the ranks'
    histograms are summed (whole counts, so exactly) before the clip."""
    lum = luminance_p(hdr.reshape(3, -1))
    ok = lum > 1e-8
    loglum = torch.clamp(torch.log2(torch.clamp_min(lum, 1e-8)), min_log_lum, max_log_lum)
    t = (loglum - min_log_lum) / (max_log_lum - min_log_lum)
    idx = torch.clamp((t * bins).to(torch.int64), 0, bins - 1)
    hist = torch.bincount(idx, weights=ok.to(torch.float32), minlength=bins).to(torch.float32)
    if shard is not None:
        hist = all_reduce_sum(hist, shard)
    cdf = torch.cumsum(hist, 0)
    total = cdf[-1]
    lo = low_clip * total
    hi = high_clip * total
    prev_cdf = cdf - hist
    w = torch.clamp_min(torch.minimum(cdf, hi) - torch.maximum(prev_cdf, lo), 0.0)
    centers = min_log_lum + (
        torch.arange(bins, dtype=torch.float32, device=hdr.device) + 0.5
    ) / bins * (max_log_lum - min_log_lum)
    mean_log = torch.sum(centers * w) / torch.clamp_min(torch.sum(w), 1e-6)
    return key_value / torch.clamp_min(torch.exp2(mean_log), 1e-8)


def weighted_avg_exposure_p(
    hdr: torch.Tensor, min_lum: float = 5e-3, max_lum: float = 4.0, lum_map_exp: float = 0.5,
    adaptation_rate: float = 1.0, dt=None, prev_avg=None, shard=None,
):
    """Weighted-average auto-exposure: luminance mapped to t = saturate((lum
    - min_lum) / range) ** lum_map_exp, the mean of t over the pixels with
    lum > 0 mapped back, optionally adapted from ``prev_avg`` over ``dt``
    seconds, then the photometric EV100 exposure (S = 100, K = 12.5, q =
    0.65). Returns (exposure, average luminance), both 0-d tensors.
    ``shard``: as for ``histogram_exposure_p``; the ranks' sums of t and
    counts are summed (the float sum in another order than the whole
    image's)."""
    dev = hdr.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    lum_range = max_lum - min_lum
    lum = luminance_p(hdr.reshape(3, -1))
    ok = lum > 0.0
    t = torch.clamp(_div(lum - min_lum, lum_range), 0.0, 1.0)
    t = torch.pow(torch.clamp_min(t, 1e-12), lum_map_exp)
    s = torch.sum(torch.where(ok, t, 0.0))
    cnt = torch.sum(ok.to(torch.float32))
    if shard is not None:
        s, cnt = all_reduce_sum(torch.stack([s, cnt]), shard)
    mean = s / torch.clamp_min(cnt, 1.0)
    result = torch.pow(torch.clamp_min(mean, 1e-12), 1.0 / lum_map_exp)
    result = result * lum_range + min_lum
    if prev_avg is not None and dt is not None:
        alpha = 1.0 - torch.exp(f32(-dt * 1000.0 * adaptation_rate))
        result = f32(prev_avg) + (result - f32(prev_avg)) * alpha
    s_iso, k_cal, q = 100.0, 12.5, 0.65
    ev100 = torch.log2(torch.clamp_min(_div(result * s_iso, k_cal), 1e-12))
    lum_max = (78.0 / (q * s_iso)) * torch.exp2(ev100)
    return _rdiv(1.0, torch.clamp_min(lum_max, 1e-12)), result


def _mat3(m: np.ndarray, c: torch.Tensor) -> torch.Tensor:
    """3x3 matrix (numpy float32) applied over the channel axis of [3, ...]."""
    return torch.stack([
        (float(m[i, 0]) * c[0] + float(m[i, 1]) * c[1]) + float(m[i, 2]) * c[2]
        for i in range(3)
    ])


def _agx_sigmoid(x):
    x2 = x * x
    x4 = x2 * x2
    return (
        15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
        + 0.4298 * x2 + 0.1191 * x - 0.00232
    )


_AGX_LOOKS = {"golden": (0.8, 0.8, 1.3), "punchy": (1.0, 1.35, 1.4)}  # slope, power, sat


def tonemap_agx_p(c: torch.Tensor, look: str = "none") -> torch.Tensor:
    """AgX display transform: linear rec709 [3, ...] -> [0, 1]. ``look``:
    "none", "golden" or "punchy"; any other raises ``ValueError``."""
    if look != "none" and look not in _AGX_LOOKS:
        raise ValueError(f"unknown AgX look: {look}")
    v = _mat3(_AGX_MAT, torch.clamp_min(c, 1e-10))
    ev = torch.clamp(torch.log2(v), _AGX_MIN_EV, _AGX_MAX_EV)
    v = _agx_sigmoid((ev - _AGX_MIN_EV) / (_AGX_MAX_EV - _AGX_MIN_EV))
    if look != "none":
        slope, power, sat = _AGX_LOOKS[look]
        lum = luminance_p(v)[None]
        v = torch.pow(torch.clamp_min(v * slope, 1e-10), power)
        v = lum + sat * (v - lum)
    return torch.clamp(_mat3(_AGX_MAT_INV, v), 0.0, 1.0)


def tonemap_neutral_p(c: torch.Tensor) -> torch.Tensor:
    """The JAX package's "neutral": c / (1 + luminance)."""
    return c / (1.0 + luminance_p(c)[None])


def tonemap_none(c: torch.Tensor) -> torch.Tensor:
    return torch.clamp(c, 0.0, 1.0)


# Tony McMapface: a 48^3 LUT shipped as a DX10 3D DDS in R9G9B9E5_SHAREDEXP.
# Its default place is inside the repository; the file is not shipped yet.
_TONY_LUT_PATH = Path(__file__).resolve().parents[2] / "assets" / "LUT" / "tony_mc_mapface.dds"


def load_lut_3d(path) -> np.ndarray:
    """DX10 3D DDS in R9G9B9E5_SHAREDEXP -> [D, H, W, 3] float32."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"DDS ":
        raise ValueError("not a DDS file")
    _, _, h, w, _, d, _ = struct.unpack_from("<7I", raw, 4)
    if struct.unpack_from("<4s", raw, 84)[0] != b"DX10":
        raise ValueError("3D LUT loader expects a DX10 header")
    dxgi, dim = struct.unpack_from("<2I", raw, 128)
    if dxgi != 67 or dim != 4:
        raise ValueError(f"expected R9G9B9E5 TEXTURE3D, got {dxgi}/{dim}")
    u = np.frombuffer(raw, np.uint32, count=d * h * w, offset=148)
    r = (u & 0x1FF).astype(np.float32)
    g = ((u >> 9) & 0x1FF).astype(np.float32)
    b = ((u >> 18) & 0x1FF).astype(np.float32)
    e = ((u >> 27) & 0x1F).astype(np.int32)
    scale = np.exp2(e.astype(np.float32) - 15.0 - 9.0)
    return np.stack([r * scale, g * scale, b * scale], -1).reshape(d, h, w, 3)


@functools.cache
def tony_lut(path=_TONY_LUT_PATH) -> np.ndarray:
    """The Tony McMapface LUT [48, 48, 48, 3], read once and cached."""
    return load_lut_3d(path)


def tonemap_tony_p(c: torch.Tensor, lut=None) -> torch.Tensor:
    """Tony McMapface: planar [3, ...] linear HDR -> [0, 1]: c / (c + 1)
    aligned to texel centres, trilinear through the LUT [D, D, D, 3]
    (depth slice blue, row green, column red)."""
    lut = torch.as_tensor(tony_lut() if lut is None else lut, dtype=torch.float32,
                          device=c.device)
    n = lut.shape[0]
    x = torch.clamp_min(c.reshape(3, -1), 0.0)
    t = x / (x + 1.0) * (n - 1.0)
    t0 = torch.floor(t)
    f = t - t0
    i0 = torch.clamp(t0.to(torch.int64), 0, n - 1)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    flat = lut.reshape(-1, 3)
    at = lambda bz, gy, rx: flat[(bz * n + gy) * n + rx]  # [N, 3]
    fr, fg, fb = f[0][:, None], f[1][:, None], f[2][:, None]
    out = torch.zeros((x.shape[1], 3), dtype=torch.float32, device=c.device)
    for dz, wz in ((i0[2], 1 - fb), (i1[2], fb)):
        for dy, wy in ((i0[1], 1 - fg), (i1[1], fg)):
            row = at(dz, dy, i0[0]) * (1 - fr) + at(dz, dy, i1[0]) * fr
            out = out + row * wy * wz
    return torch.clamp(out.T.reshape(c.shape), 0.0, 1.0)


TONEMAPPERS_P = {
    "none": tonemap_none,
    "neutral": tonemap_neutral_p,
    "agx": tonemap_agx_p,
    "agx_golden": lambda c: tonemap_agx_p(c, "golden"),
    "agx_punchy": lambda c: tonemap_agx_p(c, "punchy"),
    "tony": tonemap_tony_p,
}


def picked_outline_p(ldr, inst_img, picked, color=(1.0, 0.62, 0.1), threshold=0.5):
    """A Sobel outline of the picked instances over ``ldr`` [3, H, W]:
    ``inst_img`` [H, W] holds each pixel's instance id (the G.INST plane),
    ``picked`` an id or a sequence of ids. The stencil wraps around the
    image edges, as the JAX package's rolls do."""
    ids = np.atleast_1d(np.asarray(picked, np.float32))
    mask = torch.zeros(inst_img.shape, dtype=torch.float32, device=inst_img.device)
    for k in ids:
        mask = torch.maximum(mask, (torch.abs(inst_img - float(k)) < 0.5).to(torch.float32))
    sh = lambda dy, dx: torch.roll(mask, shifts=(dy, dx), dims=(0, 1))
    gx = sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1) - sh(-1, -1) - 2 * sh(0, -1) - sh(1, -1)
    gy = sh(1, -1) + 2 * sh(1, 0) + sh(1, 1) - sh(-1, -1) - 2 * sh(-1, 0) - sh(-1, 1)
    edge = torch.sqrt(gx * gx + gy * gy) > threshold
    col = torch.tensor(color, dtype=torch.float32, device=ldr.device)[:, None, None]
    return torch.where(edge[None], col, ldr)


def srgb_encode(c: torch.Tensor) -> torch.Tensor:
    """Linear [0, 1] -> sRGB [0, 1]."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-8), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def to_u8(c: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8)
