"""The packed vertex format on the host, as the JAX package's
``scene/packed.py``: each vertex {position f32x3, normal oct16 snorm in a
u32, uv as two halfs in a u32, tangent oct16 snorm in a u32}.

``load_scene`` and ``edit.add_instance`` round-trip normals and uvs through
this format, so shading sees the quantized values; ``pack_vertex_buffer``
is the at-rest layout. Bit-equal to the JAX functions on the same inputs.
"""

from __future__ import annotations

import numpy as np


def oct_encode_np(n: np.ndarray) -> np.ndarray:
    """Unit vectors [..., 3] -> octahedral [..., 2] in [-1, 1]."""
    n = np.asarray(n, np.float32)
    l1 = np.abs(n).sum(-1, keepdims=True)
    v = n[..., :2] / l1
    flipped = (1.0 - np.abs(v[..., ::-1])) * np.where(v >= 0.0, 1.0, -1.0)
    return np.where(n[..., 2:3] < 0.0, flipped, v).astype(np.float32)


def oct_decode_np(e: np.ndarray) -> np.ndarray:
    x, y = e[..., 0].astype(np.float32), e[..., 1].astype(np.float32)
    z = 1.0 - np.abs(x) - np.abs(y)
    t = np.maximum(-z, 0.0)
    x = x + np.where(x >= 0.0, -t, t)
    y = y + np.where(y >= 0.0, -t, t)
    v = np.stack([x, y, z], -1)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def oct_encode_u16x2_np(n: np.ndarray) -> np.ndarray:
    """[..., 3] unit vectors -> u32 (two snorm16 components)."""
    e = oct_encode_np(n)
    q = np.round(np.clip(e, -1.0, 1.0) * 32767.0).astype(np.int32)
    return (q[..., 0] & 0xFFFF).astype(np.uint32) | ((q[..., 1] & 0xFFFF).astype(np.uint32) << 16)


def oct_decode_u16x2_np(p: np.ndarray) -> np.ndarray:
    qx = (p & np.uint32(0xFFFF)).astype(np.int32)
    qy = ((p >> np.uint32(16)) & np.uint32(0xFFFF)).astype(np.int32)
    qx = np.where(qx >= 32768, qx - 65536, qx)
    qy = np.where(qy >= 32768, qy - 65536, qy)
    return oct_decode_np(np.stack([qx, qy], -1).astype(np.float32) / 32767.0)


def uv_pack_half2_np(uv: np.ndarray) -> np.ndarray:
    """[..., 2] float32 -> u32 (two IEEE halfs)."""
    h = uv.astype(np.float16).view(np.uint16).astype(np.uint32)
    return h[..., 0] | (h[..., 1] << 16)


def uv_unpack_half2_np(p: np.ndarray) -> np.ndarray:
    lo = (p & np.uint32(0xFFFF)).astype(np.uint16).view(np.float16)
    hi = ((p >> np.uint32(16)) & np.uint32(0xFFFF)).astype(np.uint16).view(np.float16)
    return np.stack([lo, hi], -1).astype(np.float32)


def quantize_normals(n: np.ndarray) -> np.ndarray:
    """Normals round-tripped through oct16 snorm (zero-length ones become +z)."""
    if len(n) == 0:
        return n.astype(np.float32)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    safe = np.where(lens > 1e-12, n / np.maximum(lens, 1e-12), [0.0, 0.0, 1.0])
    return oct_decode_u16x2_np(oct_encode_u16x2_np(safe))


def quantize_uvs(uv: np.ndarray) -> np.ndarray:
    """UVs round-tripped through half2."""
    if len(uv) == 0:
        return uv.astype(np.float32)
    return uv_unpack_half2_np(uv_pack_half2_np(np.asarray(uv, np.float32)))


def pack_vertex_buffer(pos, normal, uv, tangent=None):
    """The vertex struct as a structured array: pos f32x3, normal oct16x2
    u32, uv half2 u32, tangent oct16x2 u32 (zero without ``tangent``)."""
    n = len(pos)
    dt = np.dtype([("pos", np.float32, 3), ("normal", np.uint32), ("uv", np.uint32),
                   ("tangent", np.uint32)])
    out = np.zeros(n, dt)
    out["pos"] = pos
    out["normal"] = oct_encode_u16x2_np(normal)
    out["uv"] = uv_pack_half2_np(np.asarray(uv, np.float32))
    if tangent is not None:
        out["tangent"] = oct_encode_u16x2_np(tangent)
    return out


def unpack_vertex_buffer(buf):
    """(positions, normals, uvs, tangents) of a ``pack_vertex_buffer`` array."""
    return (
        buf["pos"].astype(np.float32),
        oct_decode_u16x2_np(buf["normal"]),
        uv_unpack_half2_np(buf["uv"]),
        oct_decode_u16x2_np(buf["tangent"]),
    )
