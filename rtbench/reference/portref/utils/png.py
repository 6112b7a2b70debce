"""A small PNG writer and reader (8-bit RGB and RGBA), numpy and zlib only.

The port's own copy of the JAX package's ``utils/png.py``: the texture
loader (``scene.textures.load_texture``) and the alpha atlas of a cutout
scene read base-color maps through it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(img: np.ndarray) -> bytes:
    """img: [H, W, 3|4] uint8 -> PNG file bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes [H, W, 3|4] uint8, not {img.dtype} {img.shape}")
    h, w, c = img.shape
    color_type = 2 if c == 3 else 6
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3|4] uint8."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """[H, W, 3|4] uint8 of an 8-bit RGB or RGBA PNG whose rows use filter 0
    (none) or 2 (up), as ``write_png`` writes them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    off = 8
    w = h = c = None
    idat = b""
    while off < len(data):
        (length,) = struct.unpack_from(">I", data, off)
        tag = data[off + 4 : off + 8]
        body = data[off + 8 : off + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack_from(">IIBB", body)
            if depth != 8 or color_type not in (2, 6):
                raise NotImplementedError(f"{path}: PNG depth {depth}, color type {color_type}")
            c = 3 if color_type == 2 else 4
        elif tag == b"IDAT":
            idat += body
        off += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c + 1
    out = np.empty((h, w, c), np.uint8)
    prev = np.zeros(w * c, np.uint16)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        filt = row[0]
        cur = np.frombuffer(row[1:], np.uint8).astype(np.uint16)
        if filt == 2:  # up
            cur = (cur + prev) & 0xFF
        elif filt != 0:
            raise NotImplementedError(f"{path}: PNG filter {filt}")
        out[y] = cur.astype(np.uint8).reshape(w, c)
        prev = cur
    return out
