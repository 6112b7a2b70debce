"""The port's BCn decoder and DDS loader against the JAX package's.

``native.decode_bcn`` (csrc/host/bcdec.cpp, built with g++ into the
package's _build/) must give the JAX decoder's texels bit for bit: on 4,096
random blocks of every format (BC6H's float texels compared as bits) and on
the hand-encoded BC7 and BC6H blocks of ``tests/test_bc67.py``; and
``scene.textures.load_dds`` / ``load_texture`` must give the JAX mips bit
for bit on DDS files written here: DX10 headers (sRGB and linear), legacy
fourcc headers, odd sizes, full mip chains and one-level files.
"""

import struct

import numpy as np
import pytest

from tests.test_bc67 import BitWriter, _bc6h_mode11_solid, _bc7_mode6_solid
from zetaray_tpu import native as JN
from zetaray_tpu.scene import textures as JT
from zetaray_tpu_torch import native as TN
from zetaray_tpu_torch.scene import textures as TT

FORMATS = ["BC1", "BC2", "BC3", "BC4", "BC5", "BC7", "BC6H", "BC6H_SF"]
DXGI = {"BC1": 71, "BC1_SRGB": 72, "BC3": 77, "BC4": 80, "BC5": 83, "BC6H": 95,
        "BC6H_SF": 96, "BC7": 98, "BC7_SRGB": 99}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fmt", FORMATS)
def test_random_blocks_match_jax(fmt):
    rng = np.random.default_rng(1000 + FORMATS.index(fmt))
    data = rng.integers(0, 256, 4096 * TN.BCN_BLOCK_BYTES[fmt], dtype=np.uint8).tobytes()
    _same(TN.decode_bcn(fmt, data, 256, 256), JN.decode_bcn(fmt, data, 256, 256))
    # a size that is not a multiple of the block: edge blocks cropped
    n = ((13 + 3) // 4) * ((7 + 3) // 4) * TN.BCN_BLOCK_BYTES[fmt]
    _same(TN.decode_bcn(fmt, data[:n], 13, 7), JN.decode_bcn(fmt, data[:n], 13, 7))


def _bc7_gradient():
    w = BitWriter()
    w.put(1 << 6, 7)
    for _c in range(4):
        w.put(0, 7)
        w.put(127, 7)
    w.put(0, 1)
    w.put(1, 1)
    w.put(0, 3)
    for i in range(1, 16):
        w.put(i, 4)
    return w.block()


def _bc7_mode5_rotation():
    w = BitWriter()
    w.put(1 << 5, 6)
    w.put(1, 2)
    for _c in range(3):
        w.put(0x50 >> 1, 7)
        w.put(0x50 >> 1, 7)
    w.put(0xC6, 8)
    w.put(0xC6, 8)
    w.put(0, 1)
    for _ in range(15):
        w.put(0, 2)
    w.put(0, 1)
    for _ in range(15):
        w.put(0, 2)
    return w.block()


@pytest.mark.parametrize("fmt, block", [
    ("BC7", _bc7_mode6_solid((100, 200, 54, 254))),
    ("BC7", _bc7_gradient()),
    ("BC7", _bc7_mode5_rotation()),
    ("BC7", b"\x00" * 16),
    ("BC6H", _bc6h_mode11_solid(0)),
    ("BC6H", _bc6h_mode11_solid(512)),
    ("BC6H", _bc6h_mode11_solid(1023)),
])
def test_hand_encoded_blocks_match_jax(fmt, block):
    _same(TN.decode_bcn(fmt, block, 4, 4), JN.decode_bcn(fmt, block, 4, 4))


def test_decoder_refuses_what_jax_refuses():
    with pytest.raises(NotImplementedError):
        TN.decode_bcn("BC9", b"\0" * 16, 4, 4)
    with pytest.raises(ValueError, match="need 16 bytes"):
        TN.decode_bcn("BC7", b"\0" * 8, 4, 4)


def test_library_is_built_into_build_dir():
    path = TN.build_bcn()
    assert path.parent == TN.BUILD_DIR and path.name.startswith("libbcdec_")
    # the host source is no CUDA source: the kernels' hash does not read it
    assert not any(p.parent.name == "host" for p in TN.sources())


def write_dds(path, fmt_key, width, height, levels, rng, fourcc=None):
    """A DDS file of ``levels`` mips of random blocks: a DX10 header with
    the DXGI format of ``fmt_key``, or the legacy ``fourcc``."""
    fmt = fmt_key.replace("_SRGB", "")
    blob, w, h = bytearray(), width, height
    for _ in range(levels):
        n = ((w + 3) // 4) * ((h + 3) // 4) * TN.BCN_BLOCK_BYTES[fmt]
        blob += rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        w, h = max(1, w // 2), max(1, h // 2)
    hdr = bytearray(128)
    hdr[0:4] = b"DDS "
    struct.pack_into("<4I", hdr, 4, 124, 0x1007 | 0x20000, height, width)
    struct.pack_into("<I", hdr, 28, levels)
    struct.pack_into("<I", hdr, 76, 32)
    hdr[84:88] = fourcc or b"DX10"
    if fourcc is None:
        hdr += struct.pack("<5I", DXGI[fmt_key], 3, 0, 1, 0)
    path.write_bytes(bytes(hdr) + bytes(blob))
    return path


def _full_chain(w, h):
    return int(np.floor(np.log2(max(w, h)))) + 1


@pytest.mark.parametrize("fmt_key, size, fourcc", [
    ("BC7_SRGB", (64, 64), None),
    ("BC7", (37, 21), None),
    ("BC1_SRGB", (50, 18), None),
    ("BC3", (16, 16), None),
    ("BC4", (9, 30), None),
    ("BC5", (32, 8), None),
    ("BC6H", (24, 40), None),
    ("BC6H_SF", (13, 13), None),
    ("BC1", (48, 20), b"DXT1"),
    ("BC2", (17, 33), b"DXT3"),
    ("BC3", (64, 32), b"DXT5"),
])
def test_load_dds_matches_jax(tmp_path, fmt_key, size, fourcc):
    rng = np.random.default_rng(sum(size) + len(fmt_key))
    p = write_dds(tmp_path / "t.dds", fmt_key, *size, _full_chain(*size), rng, fourcc)
    for srgb in (None, True, False):
        got, want = TT.load_dds(p, srgb=srgb), JT.load_dds(p, srgb=srgb)
        assert len(got) == len(want) == _full_chain(*size)
        for g, w in zip(got, want):
            _same(g, np.asarray(w))
    for srgb in (True, False):
        got, want = TT.load_texture(p, srgb=srgb), JT.load_texture(p, srgb=srgb)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, np.asarray(w))


def test_one_level_dds_gets_box_filtered_chain(tmp_path):
    rng = np.random.default_rng(7)
    p = write_dds(tmp_path / "one.dds", "BC7_SRGB", 32, 32, 1, rng)
    got, want = TT.load_texture(p), JT.load_texture(p)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _same(g, np.asarray(w))


def test_unsupported_dds_raises(tmp_path):
    rng = np.random.default_rng(3)
    p = write_dds(tmp_path / "x.dds", "BC1", 8, 8, 1, rng, fourcc=b"ATI2")
    with pytest.raises(NotImplementedError, match="fourcc"):
        TT.load_texture(p)
    assert JT.load_texture(p) is None  # the JAX loader falls back to the factors


@pytest.mark.parametrize("fmt", ["bc1", "bc7"])
def test_dds_textured_box_bundle_matches_jax(tmp_path, fmt):
    """textured_box with its checker as a BC1 or BC7 DDS file (solid 4 x 4
    blocks): the port's bundle equals JAX's bit for bit, and the checker's
    squares survive the encoding."""
    from tests.test_torch_scene import to_jax_cpu_scene
    from tests.test_torch_textures import _assert_bundles_equal, _jax_bundle_numpy
    from zetaray_tpu_torch.scene.procedural import TEX_CHECKER, textured_box

    cpu = textured_box(tmp_path, base_format=fmt)
    assert cpu.texture_paths[TEX_CHECKER].endswith(f"checker_{fmt}.dds")
    got = TT.load_scene_textures(cpu, device="cpu")
    _assert_bundles_equal(got, _jax_bundle_numpy(JT.load_scene_textures(to_jax_cpu_scene(cpu))))
    png = TT.load_texture(tmp_path / "checker.png")[0]
    dds = got["base"][TEX_CHECKER][0].numpy()
    assert len(got["base"][TEX_CHECKER]) == 7  # one level: a box-filtered chain
    np.testing.assert_array_equal(dds[..., 0] > 0.5, png[..., 0] > 0.5)
    np.testing.assert_allclose(dds[..., :3], png[..., :3], atol=0.02)
