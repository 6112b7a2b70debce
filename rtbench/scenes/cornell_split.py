"""The procedural Cornell box, split 1 -> 4 per round, written as a glTF file.

A frozen numpy copy of the port's ``scene/procedural.py`` (the box of
``cornell_box()`` and the materials of ``materials_box()``) and of
``scene/subdivide.py``'s midpoint split: every triangle but the two
emissive ones is split ``split_rounds`` times; the emissive triangles stay
whole and go last. Six rounds give the box's 34 other triangles x 4^6 + 2 =
139,266 triangles, the port's 139,266-triangle box. The midpoint splits keep
the rendered surfaces, so the image is the 36-triangle box's, while every
ray query walks a scene above the port's dense limit (8192 triangles).

Parameters (a configuration's ``scene``):
  variant: "box" (diffuse walls, a diffuse short block, a glossy tall
    block) or "materials" (the tall block glass: transmission 1, roughness
    0.05, ior 1.5; the short block white under a clear coat, weight 1,
    roughness 0.1), written with KHR_materials_transmission, _ior and
    _clearcoat;
  split_rounds: the 1 -> 4 rounds.

The file holds one node and one mesh with a primitive per material (its
triangles in split order, non-indexed corners with per-corner normals and
uvs); its buffer is a ``.bin`` file beside it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOM = (-1.02, 1.0, 1.99, -1.04, 0.99)  # x0, x1, y1, z0, z1 (the floor is y = 0)
WHITE, RED, GREEN, LIGHT, GLOSSY, COATED = range(6)
BASE = [(0.725, 0.71, 0.68), (0.63, 0.065, 0.05), (0.14, 0.45, 0.091), (0.78, 0.78, 0.78),
        (0.725, 0.71, 0.68), (0.725, 0.71, 0.68)]
ROUGHNESS = [0.9, 0.9, 0.9, 1.0, 0.25, 0.9]
DOUBLE_SIDED = [True, True, True, False, True, True]
LIGHT_RADIANCE = (17.0, 12.0, 4.0)


def _materials(variant: str) -> list[dict]:
    """The glTF materials of ``variant``: the box's five, and for
    "materials" the coated white as a sixth, the tall block glass."""
    n = 5 if variant == "box" else 6
    out = []
    for k in range(n):
        m = {"pbrMetallicRoughness": {"baseColorFactor": [*BASE[k], 1.0], "metallicFactor": 0.0,
                                      "roughnessFactor": ROUGHNESS[k]},
             "doubleSided": DOUBLE_SIDED[k]}
        if k == LIGHT:
            strength = max(LIGHT_RADIANCE)
            m["emissiveFactor"] = [x / strength for x in LIGHT_RADIANCE]
            m["extensions"] = {"KHR_materials_emissive_strength": {"emissiveStrength": strength}}
        out.append(m)
    if variant == "materials":
        glass = out[GLOSSY]
        glass["pbrMetallicRoughness"]["roughnessFactor"] = 0.05
        glass["extensions"] = {"KHR_materials_transmission": {"transmissionFactor": 1.0},
                               "KHR_materials_ior": {"ior": 1.5}}
        out[COATED]["extensions"] = {"KHR_materials_clearcoat": {
            "clearcoatFactor": 1.0, "clearcoatRoughnessFactor": 0.1}}
    elif variant != "box":
        raise ValueError(f"unknown variant {variant!r}: 'box' or 'materials'")
    return out


def _quad(c, n, u_dir, a, b):
    """Quad centred at c with unit normal n, half extents a along u_dir and
    b along n x u_dir; corners wound so (0, 1, 2), (0, 2, 3) face n."""
    c, n, u = (np.asarray(x, np.float64) for x in (c, n, u_dir))
    u = u * a
    v = np.cross(n, u_dir) * b
    return np.stack([c - u - v, c + u - v, c + u + v, c - u + v])


def _block(center, half, angle_deg):
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


def _quads(short: int):
    """(corners [4, 3], material) of the box's walls, light and blocks."""
    x0, x1, y1, z0, z1 = ROOM
    x, y, z = np.eye(3)
    cx, cz = 0.5 * (x0 + x1), 0.5 * (z0 + z1)
    hx, hy, hz = 0.5 * (x1 - x0), 0.5 * y1, 0.5 * (z1 - z0)
    quads = [
        (_quad((cx, 0, cz), y, z, hz, hx), WHITE),  # floor
        (_quad((cx, y1, cz), -y, z, hz, hx), WHITE),  # ceiling
        (_quad((cx, hy, z0), z, y, hy, hx), WHITE),  # back wall
        (_quad((x0, hy, cz), x, y, hy, hz), RED),  # left wall
        (_quad((x1, hy, cz), -x, y, hy, hz), GREEN),  # right wall
        (_quad((-0.005, 1.98, -0.03), -y, z, 0.19, 0.235), LIGHT),
    ]
    quads += [(q, short) for q in _block((0.33, 0.3, 0.37), (0.3, 0.3, 0.3), -17.0)]
    quads += [(q, GLOSSY) for q in _block((-0.35, 0.6, -0.3), (0.3, 0.6, 0.3), 17.0)]
    return quads


def _split4(a0, a1, a2):
    """One midpoint subdivision of per-corner data: 3 x [T, K] -> 3 x [4T, K]."""
    m01 = 0.5 * (a0 + a1)
    m12 = 0.5 * (a1 + a2)
    m20 = 0.5 * (a2 + a0)
    return (np.concatenate([a0, m01, m20, m01]), np.concatenate([m01, a1, m12, m12]),
            np.concatenate([m20, m12, a2, m20]))


def triangles(variant: str, split_rounds: int) -> dict:
    """The split box: corners p0..p2 [T, 3], normals n0..n2 [T, 3], uvs
    uv0..uv2 [T, 2] (float32) and the material of each triangle [T],
    the split triangles first and the emissive ones last."""
    corners, mats = [], []
    for q, m in _quads(WHITE if variant == "box" else COATED):
        corners += [q[[0, 1, 2]], q[[0, 2, 3]]]
        mats += [m, m]
    p = np.stack(corners)
    mat = np.asarray(mats, np.int32)
    g = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    uv = np.stack([quad_uv[[0, 1, 2]], quad_uv[[0, 2, 3]]] * (len(mats) // 2))
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    cols = [f32(c) for c in (p[:, 0], p[:, 1], p[:, 2], g, g, g, uv[:, 0], uv[:, 1], uv[:, 2])]
    em = mat == LIGHT
    held = [c[em] for c in cols]
    split = [c[~em] for c in cols]
    mat_split = mat[~em]
    for _ in range(split_rounds):
        for k in (0, 3, 6):
            split[k : k + 3] = _split4(*split[k : k + 3])
        mat_split = np.tile(mat_split, 4)
    out = [np.concatenate([a, b]) for a, b in zip(split, held)]
    for k in (3, 4, 5):
        out[k] = (out[k] / np.maximum(np.linalg.norm(out[k], axis=-1, keepdims=True), 1e-20)
                  ).astype(np.float32)
    names = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
    tris = dict(zip(names, out))
    tris["mat"] = np.concatenate([mat_split, mat[em]]).astype(np.int32)
    return tris


def write(directory, params: dict) -> Path:
    """Write the scene of ``params`` (``variant``, ``split_rounds``) as
    ``scene.gltf`` and ``scene.bin`` into ``directory``; returns the
    ``.gltf`` path."""
    variant = params["variant"]
    tris = triangles(variant, int(params["split_rounds"]))
    materials = _materials(variant)
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
    for m in range(len(materials)):
        sel = tris["mat"] == m
        if not sel.any():
            continue
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
    used = sorted({e for m in materials for e in m.get("extensions", {})})
    doc = {"asset": {"version": "2.0"}, "extensionsUsed": used,
           "buffers": [{"byteLength": len(blob), "uri": "scene.bin"}],
           "bufferViews": views, "accessors": accessors, "materials": materials,
           "meshes": [{"primitives": prims}], "nodes": [{"mesh": 0, "name": "cornell_box"}],
           "scenes": [{"nodes": [0]}], "scene": 0}
    path = directory / "scene.gltf"
    path.write_text(json.dumps(doc))
    return path
