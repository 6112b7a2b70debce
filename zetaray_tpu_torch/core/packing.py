"""Bit-exact packed formats, as the JAX package's ``core/packing.py``.

Packed words are int64 tensors holding u32 values (PyTorch's uint32 lacks
``+`` and ``>>`` on the CPU); callers store them as ``torch.uint32``.
"""

from __future__ import annotations

import torch


def oct_encode(n: torch.Tensor) -> torch.Tensor:
    """Unit vector [..., 3] -> octahedral [..., 2] in [-1, 1]."""
    a = torch.abs(n)
    l1 = (a[..., 0:1] + a[..., 1:2]) + a[..., 2:3]
    v = n[..., :2] / l1
    neg_z = n[..., 2:3] < 0.0
    sign = torch.where(v >= 0.0, 1.0, -1.0)
    flipped = (1.0 - torch.abs(v.flip(-1))) * sign
    return torch.where(neg_z, flipped, v)


def oct_decode(e: torch.Tensor) -> torch.Tensor:
    """Octahedral [..., 2] -> unit vector [..., 3]."""
    x, y = e[..., 0], e[..., 1]
    z = 1.0 - torch.abs(x) - torch.abs(y)
    t = torch.clamp_min(-z, 0.0)
    x = x + torch.where(x >= 0.0, -t, t)
    y = y + torch.where(y >= 0.0, -t, t)
    v = torch.stack([x, y, z], -1)
    nrm = torch.sqrt((v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]) + v[..., 2:3] * v[..., 2:3])
    return v / nrm


def oct_encode_u16x2(n: torch.Tensor) -> torch.Tensor:
    """Unit vector [..., 3] -> u32 word (two snorm16 octahedral components)."""
    e = oct_encode(n)
    q = torch.round(torch.clamp(e, -1.0, 1.0) * 32767.0).to(torch.int64)
    return (q[..., 0] & 0xFFFF) | ((q[..., 1] & 0xFFFF) << 16)


def oct_decode_u16x2(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`oct_encode_u16x2` -> [..., 3]."""
    p = p.to(torch.int64)
    qx = p & 0xFFFF
    qy = (p >> 16) & 0xFFFF
    qx = torch.where(qx >= 32768, qx - 65536, qx)
    qy = torch.where(qy >= 32768, qy - 65536, qy)
    e = torch.stack([qx, qy], -1).to(torch.float32) / 32767.0
    return oct_decode(e)


def f16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> IEEE half bits (round to nearest even) as int64."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def f16_bits_to_f32(bits16: torch.Tensor) -> torch.Tensor:
    b = bits16.to(torch.int64) & 0xFFFF
    b = torch.where(b >= 32768, b - 65536, b)
    return b.to(torch.int16).view(torch.float16).to(torch.float32)


def pack_f16x2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float tensors -> one u32 word of two IEEE halfs."""
    return f16_bits(a) | (f16_bits(b) << 16)


def unpack_f16x2(p: torch.Tensor):
    p = p.to(torch.int64)
    return f16_bits_to_f32(p & 0xFFFF), f16_bits_to_f32((p >> 16) & 0xFFFF)


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its u32 bit pattern as int64."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def bits_f32(p: torch.Tensor) -> torch.Tensor:
    """u32 bit patterns (int64 or uint32) -> float32."""
    p = p.to(torch.int64) & 0xFFFFFFFF
    p = torch.where(p >= 2**31, p - 2**32, p)
    return p.to(torch.int32).view(torch.float32)


def pack_rgb8(c: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0, 1] -> u32 word 0x00BBGGRR (int64)."""
    q = torch.round(torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.int64)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)


def unpack_rgb8(p: torch.Tensor) -> torch.Tensor:
    """u32 word -> [..., 3] float32 in [0, 1]."""
    p = p.to(torch.int64)
    q = torch.stack([p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF], -1)
    return q.to(torch.float32) / 255.0
