"""SoA 3-vectors: a ``V3`` of three same-shaped tensors.

Mirrors the JAX package's ``core/vec3.py`` operation for operation (and in the same
order of float operations), so results match the JAX package to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def splat(s) -> V3:
    return V3(s, s, s)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def max_component(a: V3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def normalize(a: V3, eps: float = 1e-20) -> V3:
    return a * torch.rsqrt(torch.clamp_min(dot(a, a), eps))


def where(c, a: V3, b: V3) -> V3:
    return V3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y), torch.where(c, a.z, b.z))


def luminance(a: V3):
    return 0.2126 * a.x + 0.7152 * a.y + 0.0722 * a.z


def from_rows(m: torch.Tensor, r0: int) -> V3:
    """Rows r0..r0+2 of a [K, N] SoA matrix as a V3."""
    return V3(m[r0], m[r0 + 1], m[r0 + 2])


def aos3(a: V3, axis: int = -1) -> torch.Tensor:
    """V3 of [N] lanes -> [N, 3] (axis=-1) or [3, N] (axis=0)."""
    return torch.stack([a.x, a.y, a.z], axis)
