"""Textures, as the JAX package's ``scene/textures.py``: DDS (BC1-BC7 and
BC6H through the host's BCn decoder, ``native.decode_bcn``) and PNG maps
decoded on the host into linear-float RGBA mip chains, and their fetch on
the device.

Host side: ``load_texture`` reads a DDS file (``load_dds``: its own mips, or
a box-filtered chain where it holds one level) or a PNG (through
``utils.png``, then ``build_mips``); ``load_scene_textures`` decodes
every map a scene's materials reference into the bundle
``{"base" | "normal" | "mr" | "emissive": {tex_index: [mips]}, "ids":
{slot: int32 [M]}}`` (each slot's texture index per material, -1 for none),
one decode per (path, colour space).

Device side: ``sample_bilinear`` (wrap addressing) and ``sample_trilinear``
(ray-cone mip level ``lam``), ``apply_texture_maps`` at the primary hits
(base colour, metallic-roughness with G = roughness and B = metallic,
emissive, and the normal map in the triangle's tangent frame) and
``base_color_at`` at the path vertices past them.

The JAX ``sample_trilinear`` samples every level of the chain and keeps the
one a ray needs with ``where``, so its launches grow with the number of
levels. Here a chain is packed once into one flat [sum H*W, 4] table with a
[L, 3] table of (width, height, offset) per level (``MipChain``), and a
fetch gathers the four taps of the two levels a ray blends, ``floor(lam)``
and the one above it, in one indexing of that table: the same values, in
the same float operations, at a cost that does not depend on the number of
levels. Each texture index is still one ``where`` over all the rays, as in
JAX, so a pixel takes the same texture.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import native

# texture slots: (bundle key, material field, decoded as sRGB)
SLOTS = (
    ("base", "base_color_tex", True),
    ("normal", "normal_tex", False),
    ("mr", "metallic_roughness_tex", False),
    ("emissive", "emissive_tex", True),
)


# DDS: the DXGI formats (DX10 header) and legacy fourccs of BC-compressed maps
_DXGI_TO_BC = {
    70: "BC1", 71: "BC1", 72: "BC1",
    73: "BC2", 74: "BC2", 75: "BC2",
    76: "BC3", 77: "BC3", 78: "BC3",
    79: "BC4", 80: "BC4", 81: "BC4",
    82: "BC5", 83: "BC5", 84: "BC5",
    94: "BC6H", 95: "BC6H", 96: "BC6H_SF",
    97: "BC7", 98: "BC7", 99: "BC7",
}
_DXGI_SRGB = {72, 75, 78, 99}
_FOURCC_TO_BC = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3"}


def _srgb_to_linear(rgb):
    return np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)


def load_dds(path, srgb: bool | None = None) -> list[np.ndarray]:
    """A BC-compressed DDS file -> its float32 linear RGBA mips [[H, W, 4],
    ...], every level the file holds. ``srgb``: decode the colour as sRGB
    (True) or linear (False); None trusts the DXGI format (legacy fourcc
    headers carry no colour space and read linear). BC6H decodes to float
    HDR. An unsupported format raises ``NotImplementedError``."""
    data = Path(path).read_bytes()
    if data[:4] != b"DDS ":
        raise ValueError(f"{path}: not a DDS file")
    height, width = struct.unpack_from("<2I", data, 12)
    (mip_count,) = struct.unpack_from("<I", data, 28)
    fourcc = data[84:88]
    off, fmt_srgb = 128, False
    if fourcc == b"DX10":
        (dxgi,) = struct.unpack_from("<I", data, 128)
        off = 148
        if dxgi not in _DXGI_TO_BC:
            raise NotImplementedError(f"{path}: DDS DXGI format {dxgi} unsupported")
        fmt, fmt_srgb = _DXGI_TO_BC[dxgi], dxgi in _DXGI_SRGB
    elif fourcc in _FOURCC_TO_BC:
        fmt = _FOURCC_TO_BC[fourcc]
    else:
        raise NotImplementedError(f"{path}: DDS fourcc {fourcc!r} unsupported")
    srgb = fmt_srgb if srgb is None else srgb
    mips = []
    w, h = width, height
    for _ in range(max(1, mip_count)):
        # a level below the block size still takes one whole block
        nbytes = ((w + 3) // 4) * ((h + 3) // 4) * native.BCN_BLOCK_BYTES[fmt]
        raw = native.decode_bcn(fmt, data[off : off + nbytes], w, h)
        img = raw.astype(np.float32) / 255.0 if raw.dtype == np.uint8 else raw
        if srgb:
            img = img.copy()
            img[..., :3] = _srgb_to_linear(img[..., :3])
        mips.append(img)
        off += nbytes
        w, h = max(1, w // 2), max(1, h // 2)
    return mips


def build_mips(img: np.ndarray, max_levels: int = 16) -> list[np.ndarray]:
    """Box-filtered mip chain of img [H, W, C] down to 1x1."""
    mips = [img]
    cur = img
    while (cur.shape[0] > 1 or cur.shape[1] > 1) and len(mips) < max_levels:
        h, w = cur.shape[:2]
        h2, w2 = max(1, h // 2), max(1, w // 2)
        t = cur[: h2 * 2, : w2 * 2]
        cur = 0.25 * (t[0::2, 0::2] + t[1::2, 0::2] + t[0::2, 1::2] + t[1::2, 1::2])
        mips.append(cur.astype(np.float32))
    return mips


def load_texture(path, srgb: bool = True) -> list[np.ndarray] | None:
    """A DDS or PNG file -> its float32 linear RGBA mips [[H, W, 4], ...],
    or None where the file does not exist. ``srgb``: decode the colour as
    sRGB (base colour, emissive); False for data maps (normal,
    metallic-roughness), which a DDS file then reads linear whatever its
    format says. A DDS file of one level gets a box-filtered chain. Any
    other format raises ``NotImplementedError``."""
    p = Path(path)
    if not p.exists():
        return None
    suffix = p.suffix.lower()
    if suffix == ".dds":
        mips = load_dds(p, srgb=None if srgb else False)
        return build_mips(mips[0]) if len(mips) == 1 else mips
    if suffix != ".png":
        raise NotImplementedError(f"{p}: only DDS and PNG textures are read")
    from ..utils.png import read_png

    img = read_png(str(p)).astype(np.float32) / 255.0
    if img.shape[2] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
    if srgb:
        img[..., :3] = _srgb_to_linear(img[..., :3])
    return build_mips(img)


class MipChain(list):
    """A texture's mip levels, [H, W, 4] float32 tensors from the finest
    down: a list, as in the JAX bundle, that also holds its levels packed
    for ``sample_trilinear`` (``packed``: flat [sum H*W, 4] and levels
    [L, 3] int64 of (width, height, offset)), packed once when it is made.
    Its levels are not changed after. A chain with an empty level (see
    ``_pack_levels``) holds None and is refused where it is sampled."""

    def __init__(self, levels):
        super().__init__(levels)
        self.packed = None if any(m.numel() == 0 for m in self) else _pack_levels(self)


def _pack_levels(mips):
    if any(m.numel() == 0 for m in mips):
        # build_mips of an image that is not square ends in empty levels,
        # as in the JAX package, whose fetch then fails too
        raise ValueError(f"a mip chain with an empty level: {[tuple(m.shape) for m in mips]}")
    flat = torch.cat([m.reshape(-1, 4) for m in mips]).contiguous()
    rows, off = [], 0
    for m in mips:
        h, w = m.shape[:2]
        rows.append((w, h, off))
        off += h * w
    return flat, torch.tensor(rows, dtype=torch.int64, device=flat.device)


def _chain(mips, device) -> MipChain:
    return MipChain(torch.from_numpy(np.array(m, np.float32)).to(device) for m in mips)


def load_scene_textures(cpu_scene, device=None, workers: int = 4) -> dict:
    """Decode every texture the materials of ``cpu_scene`` reference into
    the bundle ``{"base" | "normal" | "mr" | "emissive": {tex_index:
    MipChain}, "ids": {slot: int32 [M] tensor}}`` on ``device`` (default:
    the card; ``native.default_device``). ``ids[slot][m]`` is material m's
    texture index in that slot, -1 for none. A (path, colour space) is
    decoded once, on up to ``workers`` threads, and its chain shared by
    every slot and material that names it; a missing file leaves its index
    out of the slot, as in JAX."""
    device = native.default_device(device)
    mats = cpu_scene.materials
    paths = cpu_scene.texture_paths or []
    slot_ids, keys = {}, []
    for slot, attr, srgb in SLOTS:
        ids = getattr(mats, attr, None)
        if ids is None:
            ids = np.full(len(mats.metallic), -1, np.int32)
        slot_ids[slot] = np.asarray(ids, np.int32)
        for i in sorted({int(x) for x in slot_ids[slot] if int(x) >= 0}):
            if i < len(paths) and paths[i] and (str(paths[i]), srgb) not in keys:
                keys.append((str(paths[i]), srgb))
    if workers > 1 and len(keys) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            decoded = list(ex.map(lambda k: load_texture(k[0], srgb=k[1]), keys))
    else:
        decoded = [load_texture(p, srgb=s) for p, s in keys]
    cache = {k: None if m is None else _chain(m, device) for k, m in zip(keys, decoded)}
    out = {"ids": {s: torch.from_numpy(v).to(device) for s, v in slot_ids.items()}}
    for slot, _attr, srgb in SLOTS:
        table = {}
        for i in sorted({int(x) for x in slot_ids[slot] if int(x) >= 0}):
            if i < len(paths) and paths[i] and cache.get((str(paths[i]), srgb)) is not None:
                table[i] = cache[(str(paths[i]), srgb)]
        out[slot] = table
    return out


def textures_from_arrays(bundle: dict, device=None) -> dict:
    """A JAX texture bundle with numpy mips (``np.asarray`` of each level)
    -> the port's bundle on ``device`` (default: the card), bit for bit.
    Takes the full bundle (slot dicts and ``ids``) or the flat
    ``{tex_index: [H, W, 4] or [mips]}`` base-colour dict."""
    device = native.default_device(device)
    as_list = lambda t: t if isinstance(t, (list, tuple)) else [t]
    if "ids" not in bundle:
        return {int(i): _chain(as_list(t), device) for i, t in bundle.items()}
    out = {"ids": {s: torch.from_numpy(np.asarray(v, np.int32)).to(device)
                   for s, v in bundle["ids"].items()}}
    for slot, _attr, _srgb in SLOTS:
        out[slot] = {int(i): _chain(as_list(m), device)
                     for i, m in bundle.get(slot, {}).items()}
    return out


def _packed(mips):
    return getattr(mips, "packed", None) or _pack_levels(mips)


def _bilinear_levels(flat, levels, uv):
    """Bilinear fetch with wrap addressing of uv [N, 2] from the levels
    ``levels`` [..., N, 3] (width, height, offset) of a packed chain:
    [..., N, 4]. The float operations of the JAX ``sample_bilinear``."""
    wh = levels[..., :2]
    p = uv * wh.to(torch.float32) - 0.5
    p0 = torch.floor(p)
    f = p - p0
    fu, fv = f[..., 0:1], f[..., 1:2]
    i0 = torch.remainder(p0.to(torch.int64), wh)
    i1 = torch.remainder(i0 + 1, wh)
    w, off = levels[..., 0], levels[..., 2]
    row0 = off + i0[..., 1] * w
    row1 = off + i1[..., 1] * w
    texel = torch.stack([row0 + i0[..., 0], row0 + i1[..., 0], row1 + i0[..., 0],
                         row1 + i1[..., 0]], -1)
    # single floats by flat index: on the card PyTorch gathers 16-byte rows
    # (flat[texel]) far slower than elements
    channel = torch.arange(4, dtype=torch.int64, device=flat.device)
    t00, t10, t01, t11 = torch.take(flat, texel[..., None] * 4 + channel).unbind(-2)
    return (t00 * (1 - fu) * (1 - fv) + t10 * fu * (1 - fv) + t01 * (1 - fu) * fv
            + t11 * fu * fv)


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch of tex [H, W, 4] at uv [N, 2], wrap addressing: [N, 4]."""
    h, w, _ = tex.shape
    levels = torch.tensor([w, h, 0], dtype=torch.int64, device=uv.device).expand(uv.shape[0], 3)
    return _bilinear_levels(tex.reshape(-1, 4), levels, uv)


def sample_trilinear(mips, uv: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Trilinear fetch across a mip chain (a list of [H, W, 4] levels, or a
    ``MipChain``) at uv [N, 2] and continuous level lam [N], clipped to the
    chain: [N, 4]. Gathers level floor(lam) and the one above it (the last
    level twice) and blends them by the fraction."""
    n_mips = len(mips)
    flat, table = _packed(mips)
    lam = torch.clamp(lam, 0.0, n_mips - 1.0)
    lo_f = torch.floor(lam)
    frac = (lam - lo_f)[:, None]
    lo = lo_f.to(torch.int64).clamp(0, n_mips - 1)  # NaN stays in the chain
    s = _bilinear_levels(flat, table[torch.stack([lo, (lo + 1).clamp_max(n_mips - 1)])], uv)
    return s[0] * (1.0 - frac) + s[1] * frac


def _cone_mip(gb, tex_w: int, tex_h: int, spread_angle: float):
    """The ray-cone mip level at the primary hits: cone width t * spread,
    texel footprint width * uv density * resolution, log2."""
    from ..accel.megakernel import G

    width_ws = gb[G.DEPTH] * spread_angle
    footprint = width_ws * gb[G.UVDENS] * float(max(tex_w, tex_h))
    return torch.log2(torch.clamp_min(footprint, 1e-6))


def _level(gb, mips, spread_angle, n):
    if len(mips) > 1:
        return _cone_mip(gb, mips[0].shape[1], mips[0].shape[0], spread_angle)
    return torch.zeros((n,), dtype=torch.float32, device=gb.device)


def _with_rows(gbuf, r0: int, rows) -> torch.Tensor:
    out = gbuf.clone()
    out[r0 : r0 + rows.shape[0]] = rows
    return out


def apply_textures_to_gbuffer(gbuf, textures: dict, spread_angle: float = 0.0):
    """The G-buffer [G.ROWS, N] with the textures applied: the bundle of
    ``load_scene_textures`` (``apply_texture_maps``) or the flat
    ``{tex_index: tex or [mips]}`` base-colour dict, picked by G.TEXID."""
    if not textures:
        return gbuf
    if "ids" in textures:
        return apply_texture_maps(gbuf, textures, spread_angle)
    base = {i: (t if isinstance(t, (list, tuple)) else [t]) for i, t in textures.items()}
    return _apply_base(gbuf, base, spread_angle, by_texid=True)


def _apply_base(gbuf, table, spread_angle, by_texid=False, mat_tex=None):
    from ..accel.megakernel import G

    if not table:
        return gbuf
    n = gbuf.shape[1]
    uv = gbuf[G.UV : G.UV + 2].T
    base = gbuf[G.BASE : G.BASE + 3]
    for idx, mips in sorted(table.items()):
        mask = gbuf[G.TEXID] == float(idx) if by_texid else mat_tex == idx
        rgba = sample_trilinear(mips, uv, _level(gbuf, mips, spread_angle, n))
        base = torch.where(mask[None, :], base * rgba[:, :3].T, base)
    return _with_rows(gbuf, G.BASE, base)


def apply_texture_maps(gbuf, texmaps: dict, spread_angle: float = 0.0):
    """Texturing at the primary hits, G-buffer [G.ROWS, N] in and out: base
    colour, metallic-roughness (G = roughness, B = metallic) and emissive
    multiply their factors; the normal map (level 0) tilts the shading
    normal in the triangle's tangent frame (tangent orthonormalised
    against it, z at least 0.1), and keeps it where the tilted normal would
    fall below the geometric surface (dot < 1e-4). Ray-cone trilinear mips
    for the three colour maps; the texture of each slot is picked through
    ``texmaps["ids"][slot]`` by the pixel's G.MATID."""
    from ..accel.megakernel import G
    from ..core import vec3 as v3

    ids = texmaps["ids"]
    n = gbuf.shape[1]
    matid = torch.clamp_min(gbuf[G.MATID].to(torch.int32), 0).long()
    uv = gbuf[G.UV : G.UV + 2].T
    valid = gbuf[G.VALID] > 0.5

    def slot_tex(slot):
        return torch.as_tensor(ids[slot], device=gbuf.device)[matid]

    gbuf = _apply_base(gbuf, texmaps["base"], spread_angle, mat_tex=slot_tex("base"))

    if texmaps["mr"]:
        mr_tex = slot_tex("mr")
        metal, rough = gbuf[G.METAL], gbuf[G.ROUGH]
        for idx, mips in sorted(texmaps["mr"].items()):
            mask = valid & (mr_tex == idx)
            rgba = sample_trilinear(mips, uv, _level(gbuf, mips, spread_angle, n))
            rough = torch.where(mask, rough * rgba[:, 1], rough)
            metal = torch.where(mask, metal * rgba[:, 2], metal)
        gbuf = _with_rows(gbuf, G.METAL, torch.stack([metal, rough]))

    if texmaps["emissive"]:
        em_tex = slot_tex("emissive")
        em = gbuf[G.EMISS : G.EMISS + 3]
        for idx, mips in sorted(texmaps["emissive"].items()):
            mask = valid & (em_tex == idx)
            rgba = sample_trilinear(mips, uv, _level(gbuf, mips, spread_angle, n))
            em = torch.where(mask[None, :], em * rgba[:, :3].T, em)
        gbuf = _with_rows(gbuf, G.EMISS, em)

    if texmaps["normal"]:
        n_tex = slot_tex("normal")
        ns = v3.from_rows(gbuf, G.NS)
        ng = v3.from_rows(gbuf, G.NG)
        t_raw = v3.from_rows(gbuf, G.TANG)
        t_ortho = v3.normalize(t_raw - ns * v3.dot(t_raw, ns), eps=1e-12)
        b = v3.cross(ns, t_ortho)
        new_ns = ns
        zero = torch.zeros((n,), dtype=torch.float32, device=gbuf.device)
        for idx, mips in sorted(texmaps["normal"].items()):
            mask = valid & (n_tex == idx)
            rgba = sample_trilinear(mips, uv, zero)
            nx = rgba[:, 0] * 2.0 - 1.0
            ny = rgba[:, 1] * 2.0 - 1.0
            nz = torch.clamp_min(rgba[:, 2] * 2.0 - 1.0, 0.1)
            cand = v3.normalize(t_ortho * nx + b * ny + ns * nz)
            cand = v3.where(v3.dot(cand, ng) < 1e-4, ns, cand)
            new_ns = v3.where(mask, cand, new_ns)
        gbuf = _with_rows(gbuf, G.NS, v3.aos3(new_ns, 0))

    return gbuf


def base_color_at(textures, uv, texid, cone_width, uvdens):
    """The base-colour texture factor at path vertices, rows [3, N], or None
    without base-colour textures: uv [N, 2], texid [N] the vertex's
    base-colour texture index (-1 for none), cone_width [N] the ray cone's
    accumulated world-space width, uvdens [N] sqrt(uv area / world area).
    Ones where a vertex has no texture. Takes the bundle or the flat dict."""
    if not textures:
        return None
    if "ids" in textures:
        table = textures["base"]
    else:
        table = {i: (t if isinstance(t, (list, tuple)) else [t]) for i, t in textures.items()}
    if not table:
        return None
    n = uv.shape[0]
    out = torch.ones((3, n), dtype=torch.float32, device=uv.device)
    for idx, mips in sorted(table.items()):
        mask = texid == float(idx)
        if len(mips) > 1:
            footprint = cone_width * uvdens * float(max(mips[0].shape[0], mips[0].shape[1]))
            lam = torch.log2(torch.clamp_min(footprint, 1e-6))
        else:
            lam = torch.zeros((n,), dtype=torch.float32, device=uv.device)
        rgba = sample_trilinear(mips, uv, lam)
        out = torch.where(mask[None, :], rgba[:, :3].T, out)
    return out


def base_color_at_hits(textures, sh, cone_width):
    """``base_color_at`` at the hits of an ``accel.intersect.ShadedHit``:
    rows [3, N] or None. Each hit's uv from its barycentrics, its texture
    from its A.TEXID attribute (none at a miss), the cone's width given."""
    from ..accel.intersect import hit_uv
    from .scene import A

    at = sh.attrs
    return base_color_at(textures, torch.stack(hit_uv(sh), -1),
                         torch.where(sh.valid, at[A.TEXID], -1.0), cone_width, at[A.UVDENS])
