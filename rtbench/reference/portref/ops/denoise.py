"""The firefly filter and the edge-aware a-trous wavelet filter, as the JAX
package's ``ops/denoise.py``.

Planar: img and normal [3, H, W], depth and validity [H, W]. The stencil
taps are circular rolls, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .post import luminance_p


@dataclass(frozen=True)
class ATrousConfig:
    iterations: int = 4
    sigma_color: float = 0.15
    sigma_normal: float = 64.0  # exponent on normal agreement
    sigma_depth: float = 1.0


_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _roll2(a, dy, dx):
    """Roll the last two (row, column) axes."""
    return torch.roll(a, shifts=(dy, dx), dims=(-2, -1))


def firefly_filter_p(img, factor: float = 3.0):
    """Scale down, hue kept, each pixel of img [3, H, W] whose luminance
    exceeds ``factor`` times that of the mean of its 8 neighbours (the
    centre left out, the image wrapped around)."""
    acc = torch.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                acc = acc + _roll2(img, dy, dx)
    lum = luminance_p(img)
    limit = factor * torch.clamp_min(luminance_p(acc / 8.0), 1e-4)
    scale = torch.where(lum > limit, limit / torch.clamp_min(lum, 1e-8), 1.0)
    return img * scale[None]


def atrous_iteration_p(out, normal, depth, vf, step: int, cfg: ATrousConfig = ATrousConfig()):
    """One a-trous pass at tap spacing ``step`` (vf = validity as float)."""
    lum_c = luminance_p(out)
    acc = torch.zeros_like(out)
    wacc = torch.zeros_like(depth)
    for j, wy in enumerate(_B3):
        for i, wx in enumerate(_B3):
            dy = (j - 2) * step
            dx = (i - 2) * step
            c_n = _roll2(out, dy, dx)
            n_n = _roll2(normal, dy, dx)
            d_n = _roll2(depth, dy, dx)
            v_n = _roll2(vf, dy, dx)
            w_col = torch.exp(-torch.abs(luminance_p(c_n) - lum_c) / cfg.sigma_color)
            n_dot = (n_n[0] * normal[0] + n_n[1] * normal[1]) + n_n[2] * normal[2]
            w_nrm = torch.clamp_min(n_dot, 0.0) ** cfg.sigma_normal
            w_dep = torch.exp(
                -torch.abs(d_n - depth) / (cfg.sigma_depth * torch.clamp_min(depth, 1e-3))
            )
            wgt = wy * wx * w_col * w_nrm * w_dep * v_n
            acc = acc + c_n * wgt[None]
            wacc = wacc + wgt
    return torch.where(
        ((vf > 0.5) & (wacc > 1e-6))[None], acc / torch.clamp_min(wacc, 1e-6)[None], out
    )


def atrous_denoise_p(img, normal, depth, valid, cfg: ATrousConfig = ATrousConfig()):
    """``cfg.iterations`` a-trous passes with doubling tap spacing."""
    out = img
    vf = valid.to(torch.float32)
    for it in range(cfg.iterations):
        out = atrous_iteration_p(out, normal, depth, vf, 1 << it, cfg)
    return out
