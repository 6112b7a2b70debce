"""Counter-based pcg4d hash (Jarzynski & Olano, JCGT 2020).

Bit-identical to the JAX package's ``core/rng.py``. PyTorch's ``uint32`` has no
``+`` or ``>>`` on the CPU, so the lanes are carried as ``int64`` holding
values in [0, 2^32) and every step is reduced modulo 2^32. Products are
split into 16-bit halves so that no intermediate leaves the int64 range.
The frame seed is a plain u32 integer (the JAX package derives it from a
PRNG key with ``seed_from_key``), or a tensor of them.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
BOUNCE_SALT = 0x9E37  # fourth pcg4d counter of a path bounce's uniforms
WOPS_SALT = 0x905A  # fourth pcg4d counter of a bounce's WoPS NEE uniforms


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for values in [0, 2^32); no int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def pcg4d_lanes(a, b, c, d):
    """pcg4d on four same-shaped int64 tensors of u32 values -> four."""
    a = (_mul32(a, 1664525) + 1013904223) & _M32
    b = (_mul32(b, 1664525) + 1013904223) & _M32
    c = (_mul32(c, 1664525) + 1013904223) & _M32
    d = (_mul32(d, 1664525) + 1013904223) & _M32
    x = (a + _mul32(b, d)) & _M32
    y = (b + _mul32(c, x)) & _M32
    z = (c + _mul32(x, y)) & _M32
    w = (d + _mul32(y, z)) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    return x, y, z, w


def to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """u32 values -> [0, 1) float32 from the top 24 bits (exact in f32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform4(pixel: torch.Tensor, bounce: int, frame_seed, salt: int = 0):
    """Four [N] float32 uniforms per pixel id, as in the JAX package.

    ``frame_seed`` is a u32 integer, or a tensor of per-pixel u32 seeds
    (int64 values, or int32 holding the bits) such as a reservoir's stored
    generating seed."""
    p = pixel.to(torch.int64) & _M32
    full = lambda v: torch.full_like(p, int(v) & _M32)
    if isinstance(frame_seed, torch.Tensor):
        seeds = frame_seed.to(torch.int64).expand_as(p) & _M32
    else:
        seeds = full(frame_seed)
    x, y, z, w = pcg4d_lanes(p, full(bounce), seeds, full(salt))
    return to_unit_float(x), to_unit_float(y), to_unit_float(z), to_unit_float(w)


def bounce_uniforms(n: int, bounce: int, seed: int, device="cpu",
                    wops: bool = False, pix0: int = 0) -> torch.Tensor:
    """[5, N] float32 uniforms of one path bounce from one pcg4d per ray
    (ray id pix0 + i, bounce, seed, BOUNCE_SALT; ``pix0`` the global id of
    a row band's first ray, 0 unsharded): the top 24 bits of each of the
    four outputs (light pick and three BSDF-sample uniforms), then the
    Russian-roulette uniform built from the low bytes of the first three.
    With ``wops``, [8, N]: then the top 24 bits of the first three outputs
    of a second pcg4d (salt WOPS_SALT): WoPS NEE's alias test and the two
    uniforms of its point on the triangle."""
    pix = (torch.arange(n, dtype=torch.int64, device=device) + int(pix0)) & _M32
    full = lambda v: torch.full_like(pix, int(v) & _M32)
    r = pcg4d_lanes(pix, full(bounce), full(seed), full(BOUNCE_SALT))
    lo = (r[0] & 0xFF) | ((r[1] & 0xFF) << 8) | ((r[2] & 0xFF) << 16)
    u_rr = lo.to(torch.float32) * (1.0 / 16777216.0)
    rows = [*(to_unit_float(x) for x in r), u_rr]
    if wops:
        r2 = pcg4d_lanes(pix, full(bounce), full(seed), full(WOPS_SALT))
        rows += [to_unit_float(x) for x in r2[:3]]
    return torch.stack(rows, 0)
