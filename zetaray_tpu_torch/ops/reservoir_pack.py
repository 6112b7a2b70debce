"""Packed DI reservoirs for the reuse gathers, as the JAX package's ``ops/reservoir_pack.py``.

Layout (8 rows of u32, bit-identical to the JAX package):

  0-2  y_pos.xyz f32 bits
  3    oct16(y_ng)
  4    half2(le.xy)
  5    half(le.z) | two_sided << 16
  6    W f32 bits
  7    M u16 | half(phat) << 16
"""

from __future__ import annotations

import torch

from ..core import packing as P
from ..core.rows import stack_rows

DI_PACKED_ROWS = 8
_F16_MAX = 65504.0


def _clip(x):
    return torch.clamp(x, -_F16_MAX, _F16_MAX)


def _h(x):
    """float32 -> f16 bits (clamped to the finite f16 range), as int64."""
    return P.f16_bits(_clip(x))


def pack_di(res: torch.Tensor) -> torch.Tensor:
    """[16, N] DI reservoir rows -> [8, N] uint32."""
    two = (res[12] > 0.5).to(torch.int64)
    ng = torch.stack([res[3], res[4], res[5]], -1)
    m = torch.clamp(res[10], 0.0, 65535.0).to(torch.int64)
    rows = [
        P.f32_bits(res[0]), P.f32_bits(res[1]), P.f32_bits(res[2]),
        P.oct_encode_u16x2(ng),
        P.pack_f16x2(_clip(res[6]), _clip(res[7])),
        _h(res[8]) | (two << 16),
        P.f32_bits(res[11]),
        m | (_h(res[13]) << 16),
    ]
    return torch.stack(rows, 0).to(torch.uint32)


def unpack_di(p: torch.Tensor, rows: int = 16) -> torch.Tensor:
    """[8, N] packed -> [rows, N] float32 (w_sum and the pad rows zero)."""
    p = p.to(torch.int64)
    ng = P.oct_decode_u16x2(p[3])
    le_x, le_y = P.unpack_f16x2(p[4])
    return stack_rows(rows, {
        0: P.bits_f32(p[0]), 1: P.bits_f32(p[1]), 2: P.bits_f32(p[2]),
        3: ng[..., 0], 4: ng[..., 1], 5: ng[..., 2],
        6: le_x, 7: le_y, 8: P.f16_bits_to_f32(p[5] & 0xFFFF),
        10: (p[7] & 0xFFFF).to(torch.float32),
        11: P.bits_f32(p[6]),
        12: ((p[5] >> 16) & 1).to(torch.float32),
        13: P.f16_bits_to_f32((p[7] >> 16) & 0xFFFF),
    })
