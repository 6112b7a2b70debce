"""Alias tables, Halton jitter and warps, as the JAX package's ``core/sampling.py``.

``build_alias_table`` and the Halton sequence run on the host in numpy;
``sample_alias``, ``square_to_triangle`` and ``square_to_disk_concentric``
run on tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def build_alias_table(weights: np.ndarray):
    """Vose O(n) alias method -> (prob f32, alias i32, pdf f32)."""
    w = np.asarray(weights, dtype=np.float64)
    n = w.shape[0]
    if n == 0:
        raise ValueError("alias table needs at least one weight")
    total = w.sum()
    if total <= 0:
        return (
            np.ones(n, dtype=np.float32),
            np.arange(n, dtype=np.int32),
            np.full(n, 1.0 / n, dtype=np.float32),
        )
    p = w * (n / total)
    prob = np.zeros(n, dtype=np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in large:
        prob[i] = 1.0
    for i in small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32), (w / total).astype(np.float32)


def sample_alias(prob: torch.Tensor, alias: torch.Tensor, u1, u2) -> torch.Tensor:
    """O(1) alias-table sample; returns int64 indices shaped like ``u1``."""
    n = prob.shape[0]
    k = torch.clamp_max((u1 * n).to(torch.int64), n - 1)
    return torch.where(u2 >= prob[k], alias[k].to(torch.int64), k)


def square_to_triangle(u1, u2):
    """Low-distortion square -> triangle barycentrics (b1, b2) (Heitz)."""
    flip = u2 > u1
    b1 = torch.where(flip, u1 * 0.5, u1 - u2 * 0.5)
    b2 = torch.where(flip, u2 - u1 * 0.5, u2 * 0.5)
    return b1, b2


def square_to_disk_concentric(u: torch.Tensor) -> torch.Tensor:
    """[..., 2] uniform square -> unit disk, concentric (Shirley) mapping."""
    a = 2.0 * u[..., 0] - 1.0
    b = 2.0 * u[..., 1] - 1.0
    cond = torch.abs(a) > torch.abs(b)
    r = torch.where(cond, a, b)
    safe = torch.where(r == 0.0, 1.0, r)
    phi = torch.where(cond, (math.pi / 4.0) * (b / safe),
                      (math.pi / 2.0) - (math.pi / 4.0) * (a / safe))
    phi = torch.where(r == 0.0, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def halton(index: int, dim: int = 0) -> float:
    """Radical-inverse Halton sample in [0, 1)."""
    base = _PRIMES[dim]
    f, r, i = 1.0, 0.0, int(index)
    while i > 0:
        f = f / base
        r = r + f * (i % base)
        i = i // base
    return r


def halton_jitter(frame: int) -> tuple[float, float]:
    """Per-frame sub-pixel jitter in [-0.5, 0.5)^2 (Halton 2, 3)."""
    i = (frame % 64) + 1
    return halton(i, 0) - 0.5, halton(i, 1) - 0.5
