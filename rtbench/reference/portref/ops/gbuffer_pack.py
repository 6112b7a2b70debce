"""Packed temporal G-buffer, as the JAX package's ``ops/gbuffer_pack.py``.

Rows (float32; the normal's u32 bits are carried in a float32 row):
  TG.NORMAL  oct16x2-encoded shading normal
  TG.DEPTH   primary-hit t, 0 on a miss (depth > 0 doubles as validity)
  TG.INST    instance id as float (-1 = miss)
"""

from __future__ import annotations

import torch

from ..accel.megakernel import G
from ..core import packing as PK


class TG:
    NORMAL = 0
    DEPTH = 1
    INST = 2
    ROWS = 3


def pack_temporal(gb: torch.Tensor) -> torch.Tensor:
    """[G.ROWS, N] G-buffer -> [TG.ROWS, N] packed temporal planes."""
    ns = torch.stack([gb[G.NS], gb[G.NS + 1], gb[G.NS + 2]], -1)
    bits = PK.bits_f32(PK.oct_encode_u16x2(ns))
    valid = gb[G.VALID] > 0.5
    return torch.stack([bits, torch.where(valid, gb[G.DEPTH], 0.0), gb[G.INST]])


def unpack_normal(tg: torch.Tensor):
    """Packed rows -> (ns_x, ns_y, ns_z) decoded from oct16 snorm."""
    n = PK.oct_decode_u16x2(PK.f32_bits(tg[TG.NORMAL]))
    return n[..., 0], n[..., 1], n[..., 2]


def depth_valid(tg: torch.Tensor):
    """(depth, valid) from packed rows; misses have depth 0."""
    d = tg[TG.DEPTH]
    return d, d > 0.0


def temporal_geom_ok(prev_g, ns, depth_est, depth_tol: float, normal_tol: float):
    """Reuse test against gathered packed previous planes: the previous pixel
    was a hit, its depth is within ``depth_tol`` (relative) of the
    reprojected estimate and its decoded normal agrees with ``ns``."""
    nx, ny, nz = unpack_normal(prev_g)
    depth_prev, prev_valid = depth_valid(prev_g)
    depth_ok = torch.abs(depth_prev - depth_est) < depth_tol * torch.clamp_min(depth_est, 1e-3)
    return depth_ok & (ns.x * nx + ns.y * ny + ns.z * nz > normal_tol) & prev_valid
