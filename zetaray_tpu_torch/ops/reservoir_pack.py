"""Packed reservoirs for the reuse gathers, as the JAX package's ``ops/reservoir_pack.py``.

Layouts (rows of u32, bit-identical to the JAX package):

DI / GI (8 rows):              PT (30 rows):
  0-2  y_pos.xyz f32 bits        0-2   x_rc.xyz f32       15-17 x3.xyz f32
  3    oct16(y_ng)               3     oct16(n_rc)        18    oct16(n3)
  4    half2(le.xy)              4     half2(le.xy)       19    half2(le3.xy)
  5    half(le.z) | two << 16    5     half2(le.z, dist)  20    half2(le3.z, r3)
  6    W f32 bits                6     oct16(w_s)         21    rgb8(b3) | m3 u8 << 24
  7    M u16 | half(phat) << 16  7     half2(ls.xy)       22    oct16(ws3)
                                 8     half2(ls.z, rough) 23    half2(ls3.xy)
                                 9     rgb8(base) | metal u8 << 24
                                 10    W f32              24    half(ls3.z)
                                 11    M                  25    pdfs3 f32
                                 12    srcpix u24 | has3 << 24
                                 13    srcseed (the row's bits)
                                 14    pdfa f32           26-29 half2 pairs: rc and
                                                          x3 trans, coat, eta

The PT replay state (rows 12-25) travels raw, so a reservoir's generating
pixel and seed survive the round trip exactly.
"""

from __future__ import annotations

import torch

from ..core import packing as P
from ..core.rows import stack_rows

DI_PACKED_ROWS = 8
PT_PACKED_ROWS = 30
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


def _h2(a, b):
    """Two float32 rows -> one u32 word of finite-clamped halfs."""
    return P.pack_f16x2(_clip(a), _clip(b))


def _oct(res, row):
    return P.oct_encode_u16x2(torch.stack([res[row], res[row + 1], res[row + 2]], -1))


def _rgb8_u8(res, row, metal_row):
    base = torch.stack([res[row], res[row + 1], res[row + 2]], -1)
    metal = torch.round(torch.clamp(res[metal_row], 0.0, 1.0) * 255.0).to(torch.int64)
    return P.pack_rgb8(base) | (metal << 24)


def pack_pt(res: torch.Tensor) -> torch.Tensor:
    """[PR.ROWS, N] ReSTIR PT reservoir rows -> [30, N] uint32."""
    from .restir_pt import PR

    srcpix = torch.clamp(res[PR.SRCPIX], 0.0, float((1 << 24) - 1)).to(torch.int64)
    has3 = (res[PR.HAS3] > 0.5).to(torch.int64)
    f = P.f32_bits
    rows = [
        f(res[PR.X]), f(res[PR.X + 1]), f(res[PR.X + 2]),
        _oct(res, PR.N),
        _h2(res[PR.LE], res[PR.LE + 1]),
        _h2(res[PR.LE + 2], res[PR.DIST]),
        _oct(res, PR.WS),
        _h2(res[PR.LS], res[PR.LS + 1]),
        _h2(res[PR.LS + 2], res[PR.ROUGH]),
        _rgb8_u8(res, PR.BASE, PR.METAL),
        f(res[PR.W]),
        torch.clamp(res[PR.M], 0.0, 65535.0).to(torch.int64),
        srcpix | (has3 << 24),
        f(res[PR.SRCSEED]),
        f(res[PR.PDFA]),
        f(res[PR.X3]), f(res[PR.X3 + 1]), f(res[PR.X3 + 2]),
        _oct(res, PR.N3),
        _h2(res[PR.LE3], res[PR.LE3 + 1]),
        _h2(res[PR.LE3 + 2], res[PR.R3]),
        _rgb8_u8(res, PR.B3, PR.M3),
        _oct(res, PR.WS3),
        _h2(res[PR.LS3], res[PR.LS3 + 1]),
        _h(res[PR.LS3 + 2]),
        f(res[PR.PDFS3]),
        _h2(res[PR.TRANS], res[PR.COATW]),
        _h2(res[PR.ETA], res[PR.COATR]),
        _h2(res[PR.TRANS3], res[PR.COATW3]),
        _h2(res[PR.ETA3], res[PR.COATR3]),
    ]
    return torch.stack(rows, 0).to(torch.uint32)


def unpack_pt(p: torch.Tensor) -> torch.Tensor:
    """[30, N] packed -> [PR.ROWS, N] float32 (w_sum and phat zero)."""
    from .restir_pt import PR

    p = p.to(torch.int64)
    vals = {}

    def put3(row, v):
        vals[row], vals[row + 1], vals[row + 2] = v[..., 0], v[..., 1], v[..., 2]

    def halfs(word, row_a, row_b):
        vals[row_a], vals[row_b] = P.unpack_f16x2(word)

    def rgb8_u8(word, row, metal_row):
        put3(row, P.unpack_rgb8(word))
        vals[metal_row] = ((word >> 24) & 0xFF).to(torch.float32) / 255.0

    for k in range(3):
        vals[PR.X + k] = P.bits_f32(p[k])
        vals[PR.X3 + k] = P.bits_f32(p[15 + k])
    put3(PR.N, P.oct_decode_u16x2(p[3]))
    halfs(p[4], PR.LE, PR.LE + 1)
    halfs(p[5], PR.LE + 2, PR.DIST)
    put3(PR.WS, P.oct_decode_u16x2(p[6]))
    halfs(p[7], PR.LS, PR.LS + 1)
    halfs(p[8], PR.LS + 2, PR.ROUGH)
    rgb8_u8(p[9], PR.BASE, PR.METAL)
    vals[PR.W] = P.bits_f32(p[10])
    vals[PR.M] = p[11].to(torch.float32)
    vals[PR.SRCPIX] = (p[12] & 0xFFFFFF).to(torch.float32)
    vals[PR.HAS3] = ((p[12] >> 24) & 1).to(torch.float32)
    vals[PR.SRCSEED] = P.bits_f32(p[13])
    vals[PR.PDFA] = P.bits_f32(p[14])
    put3(PR.N3, P.oct_decode_u16x2(p[18]))
    halfs(p[19], PR.LE3, PR.LE3 + 1)
    halfs(p[20], PR.LE3 + 2, PR.R3)
    rgb8_u8(p[21], PR.B3, PR.M3)
    put3(PR.WS3, P.oct_decode_u16x2(p[22]))
    halfs(p[23], PR.LS3, PR.LS3 + 1)
    vals[PR.LS3 + 2] = P.f16_bits_to_f32(p[24] & 0xFFFF)
    vals[PR.PDFS3] = P.bits_f32(p[25])
    halfs(p[26], PR.TRANS, PR.COATW)
    halfs(p[27], PR.ETA, PR.COATR)
    halfs(p[28], PR.TRANS3, PR.COATW3)
    halfs(p[29], PR.ETA3, PR.COATR3)
    return stack_rows(PR.ROWS, vals, n=p.shape[1])
