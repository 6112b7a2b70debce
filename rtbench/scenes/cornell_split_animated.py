"""The split Cornell box of ``cornell_split`` with its tall block on a node
of its own, which a glTF clip moves.

The triangles are ``cornell_split.triangles(variant, split_rounds)``. Node
0 ("room") holds all but the tall block's (a primitive a material); node 1
("tall_block") holds the tall block's, the material GLOSSY, in the block's
own frame: their corners less ``TALL_CENTER`` (as float32, the node's rest
translation). At t = 0 the loader's world triangles are the static box's:
in its order for the "box" variant (the room's materials, then the block's,
which is the last material), the block's corners to within a float32
rounding of the translation there and back, every other value equal.

The clip "move" (animation 0) is the port's ``procedural.animated_box``
clip, copied as data: LINEAR translation and rotation channels on node 1
with keys at ``ANIM_TIMES`` (0, 1 and 2 s), the block moved by
``ANIM_OFFSETS`` from its rest translation and turned by ``ANIM_TURNS``
degrees about +y; at 2 s it is back at rest, so a looped clip has no jump.

Parameters (a configuration's ``scene``): ``variant`` and ``split_rounds``
as ``cornell_split``'s. Six rounds give 139,266 triangles, 49,152 of them
the tall block's (12 x 4^6). The buffer is a ``.bin`` file beside the
``.gltf``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from rtb import spec

TALL_CENTER = (-0.35, 0.6, -0.3)
ANIM_TIMES = (0.0, 1.0, 2.0)
ANIM_OFFSETS = ((0.0, 0.0, 0.0), (0.15, 0.0, 0.1), (0.0, 0.0, 0.0))
ANIM_TURNS = (0.0, 35.0, 0.0)


def write(directory, params: dict) -> Path:
    """Write the scene of ``params`` (``variant``, ``split_rounds``) as
    ``scene.gltf`` and ``scene.bin`` into ``directory``; returns the
    ``.gltf`` path."""
    base = spec.scene_generator("cornell_split")
    variant = params["variant"]
    tris = base.triangles(variant, int(params["split_rounds"]))
    materials = base._materials(variant)
    center = np.float32(TALL_CENTER).astype(np.float64)
    blob, views, accessors = bytearray(), [], []

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

    def prims(mats, origin):
        out = []
        for m in mats:
            sel = tris["mat"] == m
            if not sel.any():
                continue
            p = (pos[sel].reshape(-1, 3).astype(np.float64) - origin).astype(np.float32)
            out.append({"attributes": {
                "POSITION": add(p, 5126, "VEC3", bounds=True),
                "NORMAL": add(nrm[sel].reshape(-1, 3), 5126, "VEC3"),
                "TEXCOORD_0": add(uv[sel].reshape(-1, 2), 5126, "VEC2")},
                "indices": add(np.arange(3 * int(sel.sum()), dtype=np.uint32), 5125, "SCALAR"),
                "material": m})
        return out

    room = prims([m for m in range(len(materials)) if m != base.GLOSSY], np.zeros(3))
    tall = prims([base.GLOSSY], center)
    times = np.asarray(ANIM_TIMES, np.float32)
    t_acc = add(times, 5126, "SCALAR")
    accessors[t_acc].update(min=[float(times[0])], max=[float(times[-1])])
    trans = add((center + np.asarray(ANIM_OFFSETS)).astype(np.float32), 5126, "VEC3")
    half_turn = np.radians(ANIM_TURNS) / 2
    quats = np.stack([np.zeros(3), np.sin(half_turn), np.zeros(3), np.cos(half_turn)], 1)
    rot = add(quats.astype(np.float32), 5126, "VEC4")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "scene.bin").write_bytes(bytes(blob))
    used = sorted({e for m in materials for e in m.get("extensions", {})})
    doc = {"asset": {"version": "2.0"}, "extensionsUsed": used,
           "buffers": [{"byteLength": len(blob), "uri": "scene.bin"}],
           "bufferViews": views, "accessors": accessors, "materials": materials,
           "meshes": [{"primitives": room}, {"primitives": tall}],
           "nodes": [{"mesh": 0, "name": "room"},
                     {"mesh": 1, "name": "tall_block", "translation": center.tolist()}],
           "scenes": [{"nodes": [0, 1]}], "scene": 0,
           "animations": [{"name": "move",
                           "samplers": [{"input": t_acc, "output": trans,
                                         "interpolation": "LINEAR"},
                                        {"input": t_acc, "output": rot,
                                         "interpolation": "LINEAR"}],
                           "channels": [{"sampler": 0,
                                         "target": {"node": 1, "path": "translation"}},
                                        {"sampler": 1,
                                         "target": {"node": 1, "path": "rotation"}}]}]}
    path = directory / "scene.gltf"
    path.write_text(json.dumps(doc))
    return path
