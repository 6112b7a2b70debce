"""A many-light hall of Sponza's size and triangle count, written as a glTF file.

A closed hall 30 m (x) by 12 m (y) by 14 m (z), the floor at y = 0: floor,
ceiling and four walls; two colonnades of 8 pillars along x (at z = -4 and
+4); an upper gallery slab at about 5 m behind each colonnade, with a
balustrade on its inner edge; a dais at the +x end, five blocks on the
floor and three banners on the +x wall. That is ``BASE_TRIANGLES`` = 254
triangles, every one split 1 -> 4 ``split_rounds`` times, as
``cornell_split`` splits the box (five rounds: 260,096).

It is lit by ``LAMPS`` = 256 lamps, each a closed octahedron of radius
``LAMP_RADIUS`` (8 outward emissive triangles, one-sided), kept whole and
written after the hall: 2,048 emissive triangles, 262,144 triangles in all
at five rounds. 128 lamps hang along the colonnades, on both sides of each
at two heights; 128 hang over the nave in a jittered 16 x 8 grid 4 to 9 m
up. Each lamp has its own material: one of three tints (warm, neutral,
cool) and a strength (``KHR_materials_emissive_strength``) from
``STRENGTH_RANGE``, log-uniform, so that the lamps' powers span 30 times.

The layout's jitter, tints and strengths come from ``LAYOUT_SEED``, a
constant: the configuration fixes the scene, the run's seed does not move
it. Materials are plain glTF factors: diffuse walls, pillars, trim and
cloth in four albedos, a floor at roughness 0.3.

Parameters (a configuration's ``scene``): ``split_rounds``.

The file holds one node and one mesh: a primitive a hall material (its
triangles in split order), then a primitive a lamp. Corners are not
indexed (per-corner normals, the face's, and uvs); the buffer is a ``.bin``
file beside the ``.gltf``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from rtb import spec

HALL = (-15.0, 15.0, 12.0, -7.0, 7.0)  # x0, x1, y1, z0, z1
WALL, PILLAR, FLOOR, TRIM, CLOTH = range(5)
BASE = [(0.62, 0.58, 0.52), (0.55, 0.53, 0.50), (0.35, 0.33, 0.30), (0.72, 0.70, 0.66),
        (0.50, 0.12, 0.08)]
ROUGHNESS = [0.9, 0.9, 0.3, 0.9, 0.9]
BASE_TRIANGLES = 254
LAMPS = 256
LAMP_RADIUS = 0.15
LAMP_BASE = (0.8, 0.8, 0.8)
TINTS = ((1.0, 0.75, 0.45), (1.0, 0.95, 0.9), (0.6, 0.75, 1.0))  # warm, neutral, cool
STRENGTH_RANGE = (5.0, 150.0)
LAYOUT_SEED = 0x1A4B
PILLAR_X = tuple(-10.5 + 3.0 * i for i in range(8))
PILLAR_Z = 4.0
PILLAR_HALF = 0.4
GALLERY_Y = (4.85, 5.15)  # the slab's bottom and top
GALLERY_Z = 4.6  # the slab's inner edge (|z|)


def _cs():
    return spec.scene_generator("cornell_split")


def _box(lo, hi, bottom=True, top=True):
    """The outward quads of an axis-aligned box; ``bottom``/``top``: keep
    the faces at y = lo / y = hi."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    c, h = 0.5 * (lo + hi), 0.5 * (hi - lo)
    x, y, z = np.eye(3)
    quad = _cs()._quad
    faces = [quad(c + x * h[0], x, y, h[1], h[2]), quad(c - x * h[0], -x, y, h[1], h[2]),
             quad(c + z * h[2], z, y, h[1], h[0]), quad(c - z * h[2], -z, y, h[1], h[0])]
    if top:
        faces.append(quad(c + y * h[1], y, x, h[0], h[2]))
    if bottom:
        faces.append(quad(c - y * h[1], -y, x, h[0], h[2]))
    return faces


def _quads():
    """(corners [4, 3], material) of the hall's 127 quads."""
    x0, x1, y1, z0, z1 = HALL
    x, y, z = np.eye(3)
    quad = _cs()._quad
    cx, cz = 0.5 * (x0 + x1), 0.5 * (z0 + z1)
    hx, hy, hz = 0.5 * (x1 - x0), 0.5 * y1, 0.5 * (z1 - z0)
    out = [
        (quad((cx, 0.0, cz), y, z, hz, hx), FLOOR),
        (quad((cx, y1, cz), -y, z, hz, hx), WALL),  # ceiling
        (quad((x0, hy, cz), x, y, hy, hz), WALL),
        (quad((x1, hy, cz), -x, y, hy, hz), WALL),
        (quad((cx, hy, z0), z, y, hy, hx), WALL),
        (quad((cx, hy, z1), -z, y, hy, hx), WALL),
    ]
    p = PILLAR_HALF
    for s in (-1.0, 1.0):  # the colonnades: pillars from the floor to the ceiling
        for px in PILLAR_X:
            pz = s * PILLAR_Z
            out += [(q, PILLAR) for q in _box((px - p, 0.0, pz - p), (px + p, y1, pz + p),
                                              bottom=False, top=False)]
    for s in (-1.0, 1.0):  # the galleries and their balustrades
        za, zb = sorted((s * GALLERY_Z, s * (z1 - 1e-3)))
        out += [(q, TRIM) for q in _box((x0 + 1e-3, GALLERY_Y[0], za),
                                        (x1 - 1e-3, GALLERY_Y[1], zb))]
        za, zb = sorted((s * (GALLERY_Z + 0.05), s * (GALLERY_Z + 0.15)))
        out += [(q, TRIM) for q in _box((x0 + 1e-3, GALLERY_Y[1], za),
                                        (x1 - 1e-3, GALLERY_Y[1] + 1.0, zb))]
    out += [(q, TRIM) for q in _box((12.0, 0.0, -3.0), (14.5, 0.5, 3.0), bottom=False)]  # dais
    for lo, hi in (((-6.0, 0.0, -1.5), (-4.8, 0.9, -0.6)), ((-2.0, 0.0, 0.8), (-0.6, 1.2, 2.0)),
                   ((2.5, 0.0, -2.2), (3.5, 0.6, -1.0)), ((6.0, 0.0, 0.2), (7.6, 1.5, 1.1)),
                   ((9.0, 0.0, -1.2), (10.0, 0.8, -0.2))):  # blocks
        out += [(q, CLOTH) for q in _box(lo, hi, bottom=False)]
    for bz in (-4.0, 0.0, 4.0):  # banners in front of the +x wall, facing the hall
        out.append((quad((x1 - 0.1, 8.0, bz), -x, y, 2.5, 0.8), CLOTH))
    return out


def lamp_layout():
    """(centres [LAMPS, 3], tint index [LAMPS], strength [LAMPS]) of the
    lamps, the colonnades' first, from ``LAYOUT_SEED``."""
    rng = np.random.default_rng(LAYOUT_SEED)
    xs = np.linspace(-13.5, 13.5, 16)
    centres = [(lx, ly, s * (PILLAR_Z + side * 0.9)) for s in (-1.0, 1.0) for side in (-1.0, 1.0)
               for ly in (3.5, 8.0) for lx in xs]
    cell_x, cell_z = 28.0 / 16, 5.2 / 8
    for i in range(16):
        for j in range(8):
            jx, jz = rng.uniform(-0.3, 0.3, 2)
            centres.append((-14.0 + (i + 0.5 + jx) * cell_x, rng.uniform(4.0, 9.0),
                            -2.6 + (j + 0.5 + jz) * cell_z))
    tint = rng.integers(0, len(TINTS), LAMPS)
    lo, hi = np.log(STRENGTH_RANGE[0]), np.log(STRENGTH_RANGE[1])
    # log-uniform, stratified so that the weakest lamp has the range's
    # lower end and the strongest its upper end
    strength = np.exp(lo + (hi - lo) * rng.permutation(LAMPS) / (LAMPS - 1))
    return np.asarray(centres, np.float64), tint.astype(np.int32), strength


def _octahedron(c, r):
    """[8, 3, 3] outward-wound triangles of an octahedron at c."""
    x, y, z = np.eye(3) * r
    tris = []
    for sx in (x, -x):
        for sz in (z, -z):
            for sy in (y, -y):
                t = [sx, sy, sz]
                if np.dot(np.cross(t[1] - t[0], t[2] - t[0]), sx + sy + sz) < 0:
                    t = [sx, sz, sy]
                tris.append(np.asarray(t) + c)
    return np.asarray(tris)


def triangles(split_rounds: int) -> dict:
    """The hall: corners p0..p2 [T, 3], normals n0..n2 [T, 3], uvs uv0..uv2
    [T, 2] (float32) and the material of each triangle [T] (the lamps'
    ``len(BASE) + lamp``), the split hall first and the lamps last."""
    cs = _cs()
    corners, mats = [], []
    for q, m in _quads():
        corners += [q[[0, 1, 2]], q[[0, 2, 3]]]
        mats += [m, m]
    assert len(mats) == BASE_TRIANGLES
    p = np.stack(corners)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    uv = np.stack([quad_uv[[0, 1, 2]], quad_uv[[0, 2, 3]]] * (len(mats) // 2))
    centres, _, _ = lamp_layout()
    lamp = np.concatenate([_octahedron(c, LAMP_RADIUS) for c in centres])
    lamp_uv = np.zeros((lamp.shape[0], 3, 2))
    lamp_mat = np.repeat(np.arange(LAMPS) + len(BASE), 8)

    def columns(p, uv):
        g = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        g /= np.linalg.norm(g, axis=-1, keepdims=True)
        f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
        return [f32(c) for c in (p[:, 0], p[:, 1], p[:, 2], g, g, g, uv[:, 0], uv[:, 1],
                                 uv[:, 2])]

    split = columns(p, uv)
    mat_split = np.asarray(mats, np.int32)
    for _ in range(split_rounds):
        for k in (0, 3, 6):
            split[k : k + 3] = cs._split4(*split[k : k + 3])
        mat_split = np.tile(mat_split, 4)
    out = [np.concatenate([a, b]) for a, b in zip(split, columns(lamp, lamp_uv))]
    names = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
    tris = dict(zip(names, out))
    tris["mat"] = np.concatenate([mat_split, lamp_mat]).astype(np.int32)
    return tris


def materials() -> list[dict]:
    """The hall's five materials, then a material a lamp."""
    out = [{"pbrMetallicRoughness": {"baseColorFactor": [*BASE[k], 1.0], "metallicFactor": 0.0,
                                     "roughnessFactor": ROUGHNESS[k]},
            "doubleSided": True} for k in range(len(BASE))]
    _, tint, strength = lamp_layout()
    for t, s in zip(tint, strength):
        out.append({"pbrMetallicRoughness": {"baseColorFactor": [*LAMP_BASE, 1.0],
                                             "metallicFactor": 0.0, "roughnessFactor": 1.0},
                    "doubleSided": False, "emissiveFactor": list(TINTS[t]),
                    "extensions": {"KHR_materials_emissive_strength": {
                        "emissiveStrength": float(s)}}})
    return out


def write(directory, params: dict) -> Path:
    """Write the hall of ``params`` (``split_rounds``) as ``scene.gltf`` and
    ``scene.bin`` into ``directory``; returns the ``.gltf`` path."""
    tris = triangles(int(params["split_rounds"]))
    mats = materials()
    blob, views, accessors, prims = bytearray(), [], [], []

    def add(arr, comp, kind, bounds=False):
        arr = np.ascontiguousarray(arr)
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes})
        blob.extend(arr.tobytes())
        blob.extend(b"\0" * (-len(blob) % 4))
        acc = {"bufferView": len(views) - 1, "componentType": comp, "count": int(arr.shape[0]),
               "type": kind}
        if bounds:
            acc.update(min=arr.min(0).tolist(), max=arr.max(0).tolist())
        accessors.append(acc)
        return len(accessors) - 1

    corners = lambda key: np.stack([tris[f"{key}0"], tris[f"{key}1"], tris[f"{key}2"]], 1)
    pos, nrm, uv = corners("p"), corners("n"), corners("uv")
    for m in range(len(mats)):
        sel = tris["mat"] == m
        k = int(sel.sum())
        prims.append({"attributes": {
            "POSITION": add(pos[sel].reshape(-1, 3), 5126, "VEC3", bounds=True),
            "NORMAL": add(nrm[sel].reshape(-1, 3), 5126, "VEC3"),
            "TEXCOORD_0": add(uv[sel].reshape(-1, 2), 5126, "VEC2")},
            "indices": add(np.arange(3 * k, dtype=np.uint32), 5125, "SCALAR"),
            "material": m})
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "scene.bin").write_bytes(bytes(blob))
    doc = {"asset": {"version": "2.0"}, "extensionsUsed": ["KHR_materials_emissive_strength"],
           "buffers": [{"byteLength": len(blob), "uri": "scene.bin"}],
           "bufferViews": views, "accessors": accessors, "materials": mats,
           "meshes": [{"primitives": prims}], "nodes": [{"mesh": 0, "name": "lamp_hall"}],
           "scenes": [{"nodes": [0]}], "scene": 0}
    path = directory / "scene.gltf"
    path.write_text(json.dumps(doc))
    return path
