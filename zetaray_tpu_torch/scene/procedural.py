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
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .scene import CpuScene, MaterialsSoA

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


def _box_scene(subdivide_to, room, materials: MaterialsSoA, short: int) -> CpuScene:
    """The box's triangles on ``materials``, the short block on material ``short``."""
    corners, mats = [], []
    for q, m in _base_quads(room, short):
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
    m = box.materials
    n0 = m.base_color.shape[0]
    k = len(WALL_LIGHTS)
    grow = {f.name: np.concatenate([getattr(m, f.name), getattr(m, f.name)[[WHITE] * k]])
            for f in dataclasses.fields(m)}
    grow["emissive"][n0:] = np.asarray(WALL_LIGHTS, np.float32)
    grow["double_sided"][n0:] = True
    mat = box.mat_id.copy()
    for j, sel in enumerate(walls):
        mat[np.nonzero(sel)[0][0]] = n0 + j
    materials = MaterialsSoA(**grow)
    em = np.nonzero(materials.emissive[mat].max(axis=-1) > 0.0)[0].astype(np.int32)
    return dataclasses.replace(box, mat_id=mat, materials=materials, emissive_tris=em)


def materials_box(subdivide_to: int | None = None) -> CpuScene:
    """The box (``cornell_box(subdivide_to)``'s triangles) with the tall
    block glass (``GLOSSY``: transmission 1, roughness 0.05, ior 1.5) and
    the short block on ``COATED``, the walls' white under a clear coat
    (weight 1, roughness 0.1): every lobe of the BSDF, and rays that enter
    and leave a solid."""
    m = _materials()
    grow = {f.name: np.concatenate([getattr(m, f.name), getattr(m, f.name)[[WHITE]]])
            for f in dataclasses.fields(m)}
    grow["transmission"][GLOSSY] = 1.0
    grow["roughness"][GLOSSY] = 0.05
    grow["ior"][GLOSSY] = 1.5
    grow["coat_weight"][COATED] = 1.0
    grow["coat_roughness"][COATED] = 0.1
    return _box_scene(subdivide_to, ROOM, MaterialsSoA(**grow), COATED)
