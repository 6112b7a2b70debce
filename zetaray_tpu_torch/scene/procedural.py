"""A procedural Cornell box built with numpy (no asset needed).

The box spans x in [-1.02, 1], y in [0, 1.99], z in [-1.04, 0.99]
(``ROOM``; the measured Cornell box is not quite square either). A square
box centred on the camera axis (``SYMMETRIC_ROOM``) puts its outer edges
on pixel diagonals, where a hit or a miss is decided by the last bit of
the edge test, so two correct intersectors can disagree on those pixels;
the tests use it only to bound that. It is open at +z, with
a red left wall, a green right wall, a short diffuse box, a tall
glossy box and one downward-facing, one-sided emissive quad under the
ceiling. The camera ``look_at((0, 1, 3.5), (0, 1, 0), vfov 45)`` -- the
framing the JAX package's Cornell glTF is rendered with -- sees the whole
box. ``subdivide_to`` bisects triangles (longest edge first) up to exactly
that many triangles, so the kernels can be exercised at the dense path's
size (8192). ``multi_light_box`` adds emissive wall triangles of unequal
power, for the alias step of WoPS NEE (the box's two light triangles have
equal power, so their alias table never redirects a pick).
``materials_box`` makes the tall block glass and puts the short block on a
clear-coated white, for the transmission and coat lobes.

``textured_box`` and ``cutout_box`` write PNG maps built with numpy into a
directory the caller names and reference them through ``texture_paths``:
the first a checker base-colour map on the floor and the back wall, a
normal map on the short block, a metallic-roughness map on the tall one
and an emissive map of dark stripes on the light; the second a MASK-mode
panel in front of the back wall, transparent on its left half (cutoff
0.5). They are separate scenes because a cutout scene leaves the bounce
kernels for the wavefront path trace, so it could not exercise the
texture fetch between B4 and B5. ``textured_box(..., base_format="bc1" or
"bc7")`` writes its checker as a BC-compressed DDS file instead
(``write_dds_solid``), for the BCn decoder's path.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .scene import CpuScene, MaterialsSoA
from ..utils.png import write_png

CAMERA_EYE = (0.0, 1.0, 3.5)
CAMERA_TARGET = (0.0, 1.0, 0.0)
CAMERA_VFOV = 45.0

WHITE, RED, GREEN, LIGHT, GLOSSY = range(5)
COATED = 5  # materials_box's short block: WHITE under a clear coat
ROOM = (-1.02, 1.0, 1.99, -1.04, 0.99)  # x0, x1, y1, z0, z1 (the floor is y = 0)
SYMMETRIC_ROOM = (-1.0, 1.0, 2.0, -1.0, 1.0)


def _materials() -> MaterialsSoA:
    m = 5
    base = np.array(
        [[0.725, 0.71, 0.68], [0.63, 0.065, 0.05], [0.14, 0.45, 0.091],
         [0.78, 0.78, 0.78], [0.725, 0.71, 0.68]], np.float32,
    )
    emissive = np.zeros((m, 3), np.float32)
    emissive[LIGHT] = (17.0, 12.0, 4.0)
    return MaterialsSoA(
        base_color=base,
        metallic=np.zeros(m, np.float32),
        roughness=np.array([0.9, 0.9, 0.9, 1.0, 0.25], np.float32),
        emissive=emissive,
        ior=np.full(m, 1.5, np.float32),
        transmission=np.zeros(m, np.float32),
        coat_weight=np.zeros(m, np.float32),
        coat_roughness=np.zeros(m, np.float32),
        double_sided=np.array([True, True, True, False, True]),
        base_color_tex=np.full(m, -1, np.int32),
        normal_tex=np.full(m, -1, np.int32),
        metallic_roughness_tex=np.full(m, -1, np.int32),
        emissive_tex=np.full(m, -1, np.int32),
        alpha_cutoff=np.zeros(m, np.float32),
    )


def _grow(m: MaterialsSoA, copies) -> MaterialsSoA:
    """``m`` with copies of its materials ``copies`` appended."""
    return MaterialsSoA(**{f.name: np.concatenate([getattr(m, f.name), getattr(m, f.name)[copies]])
                           for f in dataclasses.fields(m)})


def _quad(c, n, u_dir, a, b):
    """Quad centred at c with unit normal n, half extents a along u_dir and
    b along n x u_dir. Returns 4 corners wound so that the triangles
    (0, 1, 2), (0, 2, 3) have geometric normal n."""
    c, n, u = (np.asarray(x, np.float64) for x in (c, n, u_dir))
    u = u * a
    v = np.cross(n, u_dir) * b
    return np.stack([c - u - v, c + u - v, c + u + v, c - u + v])


def _box(center, half, angle_deg):
    """Six outward quads of a box rotated about +y."""
    t = np.radians(angle_deg)
    rx = np.array([np.cos(t), 0.0, -np.sin(t)])
    rz = np.array([np.sin(t), 0.0, np.cos(t)])
    y = np.array([0.0, 1.0, 0.0])
    hx, hy, hz = half
    c = np.asarray(center, np.float64)
    return [
        _quad(c + rx * hx, rx, y, hy, hz), _quad(c - rx * hx, -rx, y, hy, hz),
        _quad(c + y * hy, y, rx, hx, hz), _quad(c - y * hy, -y, rx, hx, hz),
        _quad(c + rz * hz, rz, y, hy, hx), _quad(c - rz * hz, -rz, y, hy, hx),
    ]


def _base_quads(room, short=WHITE):
    X0, X1, Y1, Z0, Z1 = room
    x, y, z = np.eye(3)
    cx, cz = 0.5 * (X0 + X1), 0.5 * (Z0 + Z1)
    hx, hy, hz = 0.5 * (X1 - X0), 0.5 * Y1, 0.5 * (Z1 - Z0)
    quads = [
        (_quad((cx, 0, cz), y, z, hz, hx), WHITE),  # floor
        (_quad((cx, Y1, cz), -y, z, hz, hx), WHITE),  # ceiling
        (_quad((cx, hy, Z0), z, y, hy, hx), WHITE),  # back wall
        (_quad((X0, hy, cz), x, y, hy, hz), RED),  # left wall
        (_quad((X1, hy, cz), -x, y, hy, hz), GREEN),  # right wall
        (_quad((-0.005, 1.98, -0.03), -y, z, 0.19, 0.235), LIGHT),
    ]
    quads += [(q, short) for q in _box((0.33, 0.3, 0.37), (0.3, 0.3, 0.3), -17.0)]
    quads += [(q, GLOSSY) for q in _box((-0.35, 0.6, -0.3), (0.3, 0.6, 0.3), 17.0)]
    return quads


def _bisect(p, n, uv, idx):
    """Split triangles ``idx`` at the midpoint of their longest edge.
    p, n: [T, 3, 3] corners; uv: [T, 3, 2]. Returns the new arrays."""
    pa, pb, pc = p[idx, 0], p[idx, 1], p[idx, 2]
    lens = np.stack([
        np.linalg.norm(pb - pa, axis=-1), np.linalg.norm(pc - pb, axis=-1),
        np.linalg.norm(pa - pc, axis=-1),
    ], -1)
    e = np.argmax(lens, -1)  # 0: ab, 1: bc, 2: ca
    # rotate corners so the longest edge is (k0, k1); winding is kept
    rot = np.stack([e, (e + 1) % 3, (e + 2) % 3], -1)
    take = lambda arr: np.take_along_axis(arr[idx], rot[:, :, None], 1)
    rp, rn, ruv = take(p), take(n), take(uv)
    mid = lambda arr: 0.5 * (arr[:, 0] + arr[:, 1])
    mp, mn, muv = mid(rp), mid(rn), mid(ruv)
    mn = mn / np.maximum(np.linalg.norm(mn, axis=-1, keepdims=True), 1e-20)

    def halves(arr, m):
        first = np.stack([arr[:, 0], m, arr[:, 2]], 1)
        second = np.stack([m, arr[:, 1], arr[:, 2]], 1)
        return first, second

    keep = np.ones(p.shape[0], bool)
    keep[idx] = False
    out = []
    for arr, m in ((p, mp), (n, mn), (uv, muv)):
        first, second = halves(take(arr), m)
        out.append(np.concatenate([arr[keep], first, second]))
    return out, keep


def cornell_box(subdivide_to: int | None = None, room=ROOM) -> CpuScene:
    """The procedural Cornell box (36 triangles, or ``subdivide_to``)."""
    return _box_scene(subdivide_to, room, _materials(), WHITE)


def _box_scene(subdivide_to, room, materials: MaterialsSoA, short: int,
               quads=None) -> CpuScene:
    """The box's triangles on ``materials``, the short block on material
    ``short``; or the (corners, material) ``quads`` given."""
    corners, mats = [], []
    for q, m in (_base_quads(room, short) if quads is None else quads):
        corners += [q[[0, 1, 2]], q[[0, 2, 3]]]
        mats += [m, m]
    p = np.stack(corners)  # [T, 3, 3]
    mat = np.asarray(mats, np.int32)
    g = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    n = np.repeat(g[:, None], 3, 1)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    uv = np.stack([quad_uv[[0, 1, 2]], quad_uv[[0, 2, 3]]] * (len(mats) // 2))

    if subdivide_to is not None:
        if subdivide_to < p.shape[0]:
            raise ValueError(f"subdivide_to={subdivide_to} is below {p.shape[0]} triangles")
        while p.shape[0] < subdivide_to:
            t = p.shape[0]
            k = min(t, subdivide_to - t)
            area = np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)
            idx = np.sort(np.argsort(-area, kind="stable")[:k])
            (p, n, uv), keep = _bisect(p, n, uv, idx)
            mat = np.concatenate([mat[keep], mat[idx], mat[idx]])

    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    em_mask = materials.emissive[mat].max(axis=-1) > 0.0
    return CpuScene(
        v0=f32(p[:, 0]), v1=f32(p[:, 1]), v2=f32(p[:, 2]),
        n0=f32(n[:, 0]), n1=f32(n[:, 1]), n2=f32(n[:, 2]),
        uv0=f32(uv[:, 0]), uv1=f32(uv[:, 1]), uv2=f32(uv[:, 2]),
        mat_id=mat,
        materials=materials,
        emissive_tris=np.nonzero(em_mask)[0].astype(np.int32),
        inst_id=np.zeros(p.shape[0], np.int32),
        inst_names=["cornell_box"],
    )


def repeated_box(copies: int, subdivide_to: int | None = None) -> CpuScene:
    """The box (``cornell_box(subdivide_to)``) with each triangle repeated
    ``copies`` times in a row: every hit ties between the copies, so the tie
    rule decides it, and clusters split the copies up."""
    box = cornell_box(subdivide_to)
    rep = lambda x: np.repeat(x, copies, axis=0)
    fields = {f: rep(getattr(box, f)) for f in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0",
                                                "uv1", "uv2", "mat_id", "inst_id")}
    em = (box.emissive_tris[:, None] * copies + np.arange(copies)).ravel().astype(np.int32)
    return dataclasses.replace(box, **fields, emissive_tris=em)


# radiance of the wall triangles multi_light_box makes emissive (two-sided)
WALL_LIGHTS = ((6.0, 6.0, 6.0), (1.0, 3.0, 8.0), (8.0, 2.0, 1.0))


def multi_light_box(subdivide_to: int | None = None) -> CpuScene:
    """The box (``cornell_box(subdivide_to)``) with the first triangle of the
    back, left and right walls turned into two-sided lights of the
    radiances ``WALL_LIGHTS``: five emissive triangles of unequal power."""
    box = cornell_box(subdivide_to)
    z0 = ROOM[3]
    back = (box.mat_id == WHITE) & (np.abs((box.v0 + box.v1 + box.v2)[:, 2] / 3.0 - z0) < 1e-4)
    walls = [back, box.mat_id == RED, box.mat_id == GREEN]
    n0 = box.materials.base_color.shape[0]
    materials = _grow(box.materials, [WHITE] * len(WALL_LIGHTS))
    materials.emissive[n0:] = np.asarray(WALL_LIGHTS, np.float32)
    materials.double_sided[n0:] = True
    mat = box.mat_id.copy()
    for j, sel in enumerate(walls):
        mat[np.nonzero(sel)[0][0]] = n0 + j
    em = np.nonzero(materials.emissive[mat].max(axis=-1) > 0.0)[0].astype(np.int32)
    return dataclasses.replace(box, mat_id=mat, materials=materials, emissive_tris=em)


def materials_box(subdivide_to: int | None = None) -> CpuScene:
    """The box (``cornell_box(subdivide_to)``'s triangles) with the tall
    block glass (``GLOSSY``: transmission 1, roughness 0.05, ior 1.5) and
    the short block on ``COATED``, the walls' white under a clear coat
    (weight 1, roughness 0.1): every lobe of the BSDF, and rays that enter
    and leave a solid."""
    m = _grow(_materials(), [WHITE])
    m.transmission[GLOSSY] = 1.0
    m.roughness[GLOSSY] = 0.05
    m.ior[GLOSSY] = 1.5
    m.coat_weight[COATED] = 1.0
    m.coat_roughness[COATED] = 0.1
    return _box_scene(subdivide_to, ROOM, m, COATED)


# textured_box's materials past the box's five
CHECKER, BUMPY, MR_BLOCK = 5, 6, 7
# its maps: texture_paths indices
TEX_CHECKER, TEX_NORMAL, TEX_MR, TEX_EMISSIVE = range(4)
TEX_SIZE = 64  # texels a side of every map
CHECKER_SRGB = (255, 128)  # the checker's two squares (8 a side), sRGB
PANEL = 5  # cutout_box's masked panel
PANEL_Z = -0.85  # the panel's plane, in front of the back wall (z = -1.04)
PANEL_RECT = (-0.8, 0.8, 0.3, 1.7)  # x0, x1, y0, y1; transparent for x < 0


def _tex_maps() -> list[np.ndarray]:
    """textured_box's four maps, [TEX_SIZE, TEX_SIZE, 3|4] uint8 in
    texture_paths order: the checker, the normal map (stripes along u
    tilted +-0.35 along the tangent), the metallic-roughness map (G
    roughness 1 or 0.38, B metallic 0 or 1, in a 4 x 4 checker) and the
    emissive map (stripes along u, full and sRGB 48)."""
    i = np.arange(TEX_SIZE)
    cells = lambda k: ((i[:, None] * k // TEX_SIZE) + (i[None, :] * k // TEX_SIZE)) % 2
    checker = np.where(cells(8)[..., None] == 0, CHECKER_SRGB[0], CHECKER_SRGB[1])
    stripe = (i[None, :] * 8 // TEX_SIZE) % 2 == 0
    tilt = np.where(stripe, 0.35, -0.35) * np.ones((TEX_SIZE, 1))
    nrm = np.stack([tilt, np.zeros_like(tilt), np.sqrt(1.0 - tilt * tilt)], -1)
    normal = np.round((nrm * 0.5 + 0.5) * 255.0)
    mr = np.zeros((TEX_SIZE, TEX_SIZE, 3))
    mr[..., 1] = np.where(cells(4) == 0, 255, 96)
    mr[..., 2] = np.where(cells(4) == 0, 0, 255)
    emissive = np.where(stripe, 255, 48)[..., None] * np.ones((TEX_SIZE, TEX_SIZE, 3))
    return [np.broadcast_to(checker, (TEX_SIZE, TEX_SIZE, 3)), normal, mr, emissive]


def _write_maps(tex_dir, names, maps) -> list[str]:
    paths = []
    for name, img in zip(names, maps):
        path = str(Path(tex_dir) / name)
        write_png(path, np.ascontiguousarray(img, np.uint8))
        paths.append(path)
    return paths


_DDS_DXGI_SRGB = {"BC1": 72, "BC7": 99}  # BC1_UNORM_SRGB, BC7_UNORM_SRGB


def write_dds_solid(path, img: np.ndarray, fmt: str) -> Path:
    """An sRGB DDS file (DX10 header, one level) of ``img`` [H, W, 3]
    uint8, H and W multiples of 4, whose 4 x 4 blocks are each of one
    colour, encoded as solid blocks: BC1 both endpoints the colour in
    RGB565 (it decodes to the 565 colour expanded back to 8 bits), BC7 mode
    6 both endpoints the colour with alpha 255 (mode 6 keeps one low bit
    for the four channels, so each channel's low bit becomes alpha's 1: 128
    decodes as 129). A block of two colours raises."""
    h, w, _ = img.shape
    if h % 4 or w % 4 or fmt not in _DDS_DXGI_SRGB:
        raise ValueError(f"write_dds_solid: {fmt} of {h} x {w}")
    blocks = img.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    if (blocks != blocks[:, :1]).any():
        raise ValueError("write_dds_solid: a 4 x 4 block holds two colours")
    out = bytearray()
    for r, g, b in blocks[:, 0].tolist():
        if fmt == "BC1":
            c = ((r * 31 + 127) // 255) << 11 | ((g * 63 + 127) // 255) << 5 | (b * 31 + 127) // 255
            out += int(c).to_bytes(2, "little") * 2 + bytes(4)  # indices 0: color0
        else:  # BC7 mode 6: bit 6 set, then 7-bit endpoints and the p-bits
            bits = 1 << 6
            pos = 7
            for v in (r, g, b, 255):
                bits |= ((v >> 1) | (v >> 1) << 7) << pos  # endpoints 0 and 1
                pos += 14
            bits |= 0b11 << pos  # p-bits 1: low bit 1 on both endpoints
            out += int(bits).to_bytes(16, "little")  # indices 0: endpoint 0
    hdr = bytearray(128)
    hdr[0:4] = b"DDS "
    hdr[4:20] = np.asarray([124, 0x1007, h, w], "<u4").tobytes()
    hdr[28:32] = np.asarray([1], "<u4").tobytes()
    hdr[76:80] = np.asarray([32], "<u4").tobytes()
    hdr[84:88] = b"DX10"
    dx10 = np.asarray([_DDS_DXGI_SRGB[fmt], 3, 0, 1, 0], "<u4").tobytes()
    path = Path(path)
    path.write_bytes(bytes(hdr) + dx10 + bytes(out))
    return path


def textured_box(tex_dir, subdivide_to: int | None = None,
                 base_format: str = "png") -> CpuScene:
    """The box (``cornell_box(subdivide_to)``'s triangles) with textures,
    its maps written as PNG files into ``tex_dir`` (the checker, with
    ``base_format`` "bc1" or "bc7", as a DDS file of that format instead,
    ``write_dds_solid``): the floor and the back
    wall on ``CHECKER`` (the walls' white under a checker base-colour map),
    the short block on ``BUMPY`` (white under a normal map), the tall block
    on ``MR_BLOCK`` (the glossy white, metallic and roughness factors 1,
    under a metallic-roughness map) and the light under an emissive map of
    dark stripes."""
    m = _grow(_materials(), [WHITE, WHITE, GLOSSY])
    m.base_color_tex[CHECKER] = TEX_CHECKER
    m.normal_tex[BUMPY] = TEX_NORMAL
    m.metallic_roughness_tex[MR_BLOCK] = TEX_MR
    m.metallic[MR_BLOCK] = 1.0
    m.roughness[MR_BLOCK] = 1.0
    m.emissive_tex[LIGHT] = TEX_EMISSIVE
    quads = _base_quads(ROOM, BUMPY)
    for k in (0, 2):  # the floor and the back wall
        quads[k] = (quads[k][0], CHECKER)
    quads = [(q, MR_BLOCK if mat == GLOSSY else mat) for q, mat in quads]
    box = _box_scene(subdivide_to, ROOM, m, BUMPY, quads)
    maps = _tex_maps()
    paths = _write_maps(tex_dir, ("checker.png", "normal.png", "mr.png", "emissive.png"), maps)
    if base_format != "png":
        fmt = base_format.upper()
        paths[TEX_CHECKER] = str(write_dds_solid(Path(tex_dir) / f"checker_{base_format}.dds",
                                                 np.ascontiguousarray(maps[0], np.uint8), fmt))
    return dataclasses.replace(box, texture_paths=paths)


def cutout_box(tex_dir, subdivide_to: int | None = None) -> CpuScene:
    """The box (``cornell_box``'s materials) with a double-sided panel
    ``PANEL`` in the plane z = PANEL_Z over PANEL_RECT, in front of the back
    wall: an orange MASK-mode material (cutoff 0.5) whose base-colour map,
    written as a PNG file into ``tex_dir``, is white with alpha 0 on its
    left half (u < 0.5, x < 0) and 1 on its right half."""
    m = _grow(_materials(), [WHITE])
    m.base_color[PANEL] = (0.9, 0.5, 0.2)
    m.roughness[PANEL] = 0.8
    m.base_color_tex[PANEL] = 0
    m.alpha_cutoff[PANEL] = 0.5
    x0, x1, y0, y1 = PANEL_RECT
    panel = np.array([[x0, y0, PANEL_Z], [x1, y0, PANEL_Z], [x1, y1, PANEL_Z],
                      [x0, y1, PANEL_Z]], np.float64)  # uv (0,0) (1,0) (1,1) (0,1)
    box = _box_scene(subdivide_to, ROOM, m, WHITE, _base_quads(ROOM) + [(panel, PANEL)])
    mask = np.full((TEX_SIZE, TEX_SIZE, 4), 255, np.uint8)
    mask[:, : TEX_SIZE // 2, 3] = 0
    return dataclasses.replace(box, texture_paths=_write_maps(tex_dir, ("mask.png",), [mask]))


# animated_box's tall block: its centre (the node's rest translation) and
# its keys, seconds -> translation offset and turn about +y (degrees)
TALL_CENTER = (-0.35, 0.6, -0.3)
ANIM_TIMES = (0.0, 1.0, 2.0)
ANIM_OFFSETS = ((0.0, 0.0, 0.0), (0.15, 0.0, 0.1), (0.0, 0.0, 0.0))
ANIM_TURNS = (0.0, 35.0, 0.0)


def write_gltf(path, doc: dict, blob: bytes) -> Path:
    """Write a glTF document whose one buffer holds ``blob``: a ``.glb``
    (its BIN chunk) or a ``.gltf`` (a ``data:`` URI), by ``path``'s suffix."""
    import base64
    import json
    import struct

    path = Path(path)
    doc = dict(doc, buffers=[{"byteLength": len(blob)}])
    if path.suffix == ".glb":
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        bin_ = blob + b"\0" * (-len(blob) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_)
        path.write_bytes(struct.pack("<III", 0x46546C67, 2, total)
                         + struct.pack("<II", len(js), 0x4E4F534A) + js
                         + struct.pack("<II", len(bin_), 0x004E4942) + bin_)
    else:
        uri = "data:application/octet-stream;base64," + base64.b64encode(blob).decode()
        doc["buffers"][0]["uri"] = uri
        path.write_text(json.dumps(doc))
    return path


def animated_box(path) -> Path:
    """The box as an animated glTF file at ``path`` (``.gltf`` with a
    ``data:`` buffer, or ``.glb``): node "room" holds the walls, the light and
    the short block (a primitive a material), node "tall_block" the tall
    block in its own frame about ``TALL_CENTER``, and the animation "move"
    drives that node with LINEAR translation and rotation channels over
    ``ANIM_TIMES`` (to ``ANIM_OFFSETS`` and ``ANIM_TURNS``, back at 2 s).
    ``scene.load_scene`` gives the box's 36 triangles, the tall block's
    twelve last, as instance 1."""
    mats = _materials()
    quads = _base_quads(ROOM)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    center = np.asarray(TALL_CENTER, np.float64)
    blob, views, accessors = bytearray(), [], []

    def add(arr, comp, kind):
        arr = np.ascontiguousarray(arr)
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes})
        blob.extend(arr.tobytes())
        blob.extend(b"\0" * (-len(blob) % 4))
        acc = {"bufferView": len(views) - 1, "componentType": comp, "count": int(arr.shape[0]),
               "type": kind}
        if kind == "VEC3" and comp == 5126:
            acc.update(min=arr.min(0).tolist(), max=arr.max(0).tolist())
        accessors.append(acc)
        return len(accessors) - 1

    def prims(sel, origin):
        out = []
        for m in sorted({mat for q, mat in sel}):
            corners = [q[[0, 1, 2]] for q, mat in sel if mat == m]
            corners += [q[[0, 2, 3]] for q, mat in sel if mat == m]
            p = np.concatenate(corners) - origin
            g = np.cross(p[1::3] - p[0::3], p[2::3] - p[0::3])
            g /= np.linalg.norm(g, axis=-1, keepdims=True)
            half = len(corners) // 2
            uv = np.concatenate([np.tile(quad_uv[[0, 1, 2]], (half, 1)),
                                 np.tile(quad_uv[[0, 2, 3]], (half, 1))])
            out.append({"attributes": {"POSITION": add(p.astype(np.float32), 5126, "VEC3"),
                                       "NORMAL": add(np.repeat(g, 3, 0).astype(np.float32),
                                                     5126, "VEC3"),
                                       "TEXCOORD_0": add(uv, 5126, "VEC2")},
                        "indices": add(np.arange(len(p), dtype=np.uint16), 5123, "SCALAR"),
                        "material": int(m)})
        return out

    room = prims([(q, m) for q, m in quads if m != GLOSSY], np.zeros(3))
    tall = prims([(q, m) for q, m in quads if m == GLOSSY], center)
    times = add(np.asarray(ANIM_TIMES, np.float32), 5126, "SCALAR")
    trans = add((center + np.asarray(ANIM_OFFSETS)).astype(np.float32), 5126, "VEC3")
    half_turn = np.radians(ANIM_TURNS) / 2
    quats = np.stack([np.zeros(3), np.sin(half_turn), np.zeros(3), np.cos(half_turn)], 1)
    rot = add(quats.astype(np.float32), 5126, "VEC4")
    materials = []
    for k in range(mats.base_color.shape[0]):
        m = {"pbrMetallicRoughness": {
                 "baseColorFactor": [*map(float, mats.base_color[k]), 1.0],
                 "metallicFactor": float(mats.metallic[k]),
                 "roughnessFactor": float(mats.roughness[k])},
             "doubleSided": bool(mats.double_sided[k])}
        strength = float(mats.emissive[k].max())
        if strength > 0:
            m["emissiveFactor"] = [float(x) / strength for x in mats.emissive[k]]
            m["extensions"] = {"KHR_materials_emissive_strength": {"emissiveStrength": strength}}
        materials.append(m)
    doc = {
        "asset": {"version": "2.0"},
        "bufferViews": views, "accessors": accessors, "materials": materials,
        "meshes": [{"primitives": room}, {"primitives": tall}],
        "nodes": [{"mesh": 0, "name": "room"},
                  {"mesh": 1, "name": "tall_block", "translation": center.tolist()}],
        "scenes": [{"nodes": [0, 1]}], "scene": 0,
        "animations": [{"name": "move",
                        "samplers": [{"input": times, "output": trans, "interpolation": "LINEAR"},
                                     {"input": times, "output": rot, "interpolation": "LINEAR"}],
                        "channels": [{"sampler": 0, "target": {"node": 1, "path": "translation"}},
                                     {"sampler": 1, "target": {"node": 1, "path": "rotation"}}]}],
    }
    return write_gltf(path, doc, bytes(blob))
