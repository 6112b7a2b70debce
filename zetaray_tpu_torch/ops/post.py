"""Auto-exposure, AgX tonemap and sRGB encode, as the JAX package's ``ops/post.py``.

Planar: images are [3, ...] channel-first.
"""

from __future__ import annotations

import numpy as np
import torch

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
    key_value: float = 0.18,
) -> torch.Tensor:
    """Exposure scale from a percentile-clipped log-luminance histogram:
    the clipped geometric-mean luminance maps to ``key_value``."""
    lum = luminance_p(hdr.reshape(3, -1))
    ok = lum > 1e-8
    loglum = torch.clamp(torch.log2(torch.clamp_min(lum, 1e-8)), min_log_lum, max_log_lum)
    t = (loglum - min_log_lum) / (max_log_lum - min_log_lum)
    idx = torch.clamp((t * bins).to(torch.int64), 0, bins - 1)
    hist = torch.bincount(idx, weights=ok.to(torch.float32), minlength=bins).to(torch.float32)
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


def tonemap_agx_p(c: torch.Tensor) -> torch.Tensor:
    """AgX display transform (default look): linear rec709 [3, ...] -> [0, 1]."""
    v = _mat3(_AGX_MAT, torch.clamp_min(c, 1e-10))
    ev = torch.clamp(torch.log2(v), _AGX_MIN_EV, _AGX_MAX_EV)
    v = _agx_sigmoid((ev - _AGX_MIN_EV) / (_AGX_MAX_EV - _AGX_MIN_EV))
    return torch.clamp(_mat3(_AGX_MAT_INV, v), 0.0, 1.0)


def srgb_encode(c: torch.Tensor) -> torch.Tensor:
    """Linear [0, 1] -> sRGB [0, 1]."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-8), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def to_u8(c: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8)
