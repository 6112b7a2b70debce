"""A dependency-free glTF 2.0 loader, as the JAX package's ``scene/gltf.py``.

Parses the JSON and the binary buffers (a ``data:`` URI, an external file,
or the BIN chunk of a ``.glb``), resolves accessors (interleaved and
normalized ones too), walks the default scene's node hierarchy, and returns
each mesh instance's primitives with its world matrix, the PBR materials
with the extensions KHR_materials_emissive_strength, _ior, _transmission
and _clearcoat, the texture paths (decoded later by ``scene.textures``),
the retained node records and the animation channels with their samplers
resolved (``scene.animation``).

Only TRIANGLES primitives are read; morph-target (``weights``) channels are
skipped.
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..core import transforms as T

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_SIZES = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


@dataclass
class GltfMaterial:
    name: str = ""
    base_color: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    base_color_tex: int = -1
    metallic: float = 1.0
    roughness: float = 1.0
    metallic_roughness_tex: int = -1
    normal_tex: int = -1
    emissive_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emissive_tex: int = -1
    emissive_strength: float = 1.0
    ior: float = 1.5
    transmission: float = 0.0
    coat_weight: float = 0.0
    coat_roughness: float = 0.0
    coat_ior: float = 1.5
    alpha_mode: str = "OPAQUE"  # OPAQUE | MASK | BLEND
    alpha_cutoff: float = 0.5
    double_sided: bool = False


@dataclass
class GltfPrimitive:
    positions: np.ndarray  # [V, 3] f32, node-local space
    normals: np.ndarray | None  # [V, 3]
    uvs: np.ndarray | None  # [V, 2]
    tangents: np.ndarray | None  # [V, 4]
    indices: np.ndarray  # [I] u32
    material: int  # -1 = default


@dataclass
class GltfInstance:
    mesh_prims: list[GltfPrimitive]
    world: np.ndarray  # 4x4
    name: str = ""
    node: int = -1  # source node index (animation retarget)


@dataclass
class GltfNode:
    """Retained node record for animation (reference: SceneCore's
    array-of-levels scene graph, SceneCore.h:310-320)."""

    parent: int  # -1 = scene root
    translation: np.ndarray  # [3]
    rotation: np.ndarray  # [4] quaternion xyzw
    scale: np.ndarray  # [3]
    matrix: np.ndarray | None  # static 4x4 local (TRS ignored if set)
    name: str = ""


@dataclass
class GltfChannel:
    """One animation channel: keyframed TRS property of one node
    (reference: SceneCore animation update task, SceneCore.cpp:102)."""

    node: int
    path: str  # "translation" | "rotation" | "scale"
    times: np.ndarray  # [K] f32 seconds, ascending
    # LINEAR/STEP: [K, C]; CUBICSPLINE: [K, 3, C] (in-tangent, value, out)
    values: np.ndarray
    interpolation: str  # "LINEAR" | "STEP" | "CUBICSPLINE"


@dataclass
class GltfAnimation:
    name: str
    channels: list[GltfChannel]

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if len(c.times)),
                   default=0.0)


@dataclass
class GltfDoc:
    instances: list[GltfInstance]
    materials: list[GltfMaterial]
    textures: list[str]  # resolved image URIs/paths (decode deferred)
    nodes: list[GltfNode] = field(default_factory=list)
    animations: list[GltfAnimation] = field(default_factory=list)
    traversal: list[int] = field(default_factory=list)  # parent-before-child


def _read_buffer(buf: dict, base_dir: Path, glb_bin: bytes | None) -> bytes:
    uri = buf.get("uri")
    if uri is None:
        assert glb_bin is not None, "buffer without uri outside GLB"
        return glb_bin
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    return (base_dir / uri).read_bytes()


def _read_accessor(doc: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    n_comp = _TYPE_SIZES[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    count = acc["count"]
    if "bufferView" not in acc:
        out = np.zeros((count, n_comp), dtype)
    else:
        bv = doc["bufferViews"][acc["bufferView"]]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0) or n_comp * dtype.itemsize
        if stride == n_comp * dtype.itemsize:
            out = np.frombuffer(
                data, dtype=dtype, count=count * n_comp, offset=start
            ).reshape(count, n_comp)
        else:  # interleaved
            raw = np.frombuffer(
                data, dtype=np.uint8, count=(count - 1) * stride + n_comp * dtype.itemsize,
                offset=start,
            )
            strided = np.lib.stride_tricks.as_strided(
                raw, shape=(count, n_comp * dtype.itemsize), strides=(stride, 1)
            )
            out = strided.copy().view(dtype).reshape(count, n_comp)
    if acc.get("normalized") and dtype.kind in "iu":
        maxv = float(np.iinfo(dtype).max)
        out = out.astype(np.float32) / maxv
        if dtype.kind == "i":
            # glTF snorm decode: max(value/maxv, -1) so e.g. int8 -128 maps
            # to exactly -1.0 (spec 3.6.2.2), not -1.008
            out = np.maximum(out, -1.0)
    return out


def _parse_material(m: dict) -> GltfMaterial:
    out = GltfMaterial(name=m.get("name", ""))
    pbr = m.get("pbrMetallicRoughness", {})
    out.base_color = np.asarray(
        pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
    )
    out.base_color_tex = pbr.get("baseColorTexture", {}).get("index", -1)
    out.metallic = float(pbr.get("metallicFactor", 1.0))
    out.roughness = float(pbr.get("roughnessFactor", 1.0))
    out.metallic_roughness_tex = pbr.get("metallicRoughnessTexture", {}).get(
        "index", -1
    )
    out.normal_tex = m.get("normalTexture", {}).get("index", -1)
    out.emissive_factor = np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32)
    out.emissive_tex = m.get("emissiveTexture", {}).get("index", -1)
    out.alpha_mode = m.get("alphaMode", "OPAQUE")
    out.alpha_cutoff = float(m.get("alphaCutoff", 0.5))
    out.double_sided = bool(m.get("doubleSided", False))
    ext = m.get("extensions", {})
    out.emissive_strength = float(
        ext.get("KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0)
    )
    out.ior = float(ext.get("KHR_materials_ior", {}).get("ior", 1.5))
    out.transmission = float(
        ext.get("KHR_materials_transmission", {}).get("transmissionFactor", 0.0)
    )
    cc = ext.get("KHR_materials_clearcoat", {})
    out.coat_weight = float(cc.get("clearcoatFactor", 0.0))
    out.coat_roughness = float(cc.get("clearcoatRoughnessFactor", 0.0))
    return out


def load_gltf(path: str | Path) -> GltfDoc:
    path = Path(path)
    raw = path.read_bytes()
    glb_bin = None
    if raw[:4] == b"glTF":  # GLB container
        _, _, length = struct.unpack_from("<III", raw, 0)
        off = 12
        doc = None
        while off < length:
            clen, ctype = struct.unpack_from("<II", raw, off)
            chunk = raw[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                glb_bin = bytes(chunk)
            off += 8 + clen
        assert doc is not None
    else:
        doc = json.loads(raw)

    base_dir = path.parent
    buffers = [_read_buffer(b, base_dir, glb_bin) for b in doc.get("buffers", [])]
    materials = [_parse_material(m) for m in doc.get("materials", [])]

    textures: list[str] = []
    for tex in doc.get("textures", []):
        src = tex.get("source", -1)
        uri = ""
        if src >= 0:
            img = doc["images"][src]
            uri = img.get("uri", img.get("name", ""))
        textures.append(str(base_dir / uri) if uri and not uri.startswith("data:") else uri)

    # Parse mesh primitives lazily per mesh index.
    mesh_cache: dict[int, list[GltfPrimitive]] = {}

    def get_mesh(mi: int) -> list[GltfPrimitive]:
        if mi in mesh_cache:
            return mesh_cache[mi]
        prims = []
        for prim in doc["meshes"][mi].get("primitives", []):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            nrm = (
                _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else None
            )
            uv = (
                _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else None
            )
            tan = (
                _read_accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32)
                if "TANGENT" in attrs
                else None
            )
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1)
                idx = idx.astype(np.uint32)
            else:
                idx = np.arange(pos.shape[0], dtype=np.uint32)
            prims.append(
                GltfPrimitive(
                    positions=pos,
                    normals=nrm,
                    uvs=uv,
                    tangents=tan,
                    indices=idx,
                    material=prim.get("material", -1),
                )
            )
        mesh_cache[mi] = prims
        return prims

    # Walk node hierarchy of the default scene.
    nodes = doc.get("nodes", [])
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{"nodes": list(range(len(nodes)))}])
    roots = scenes[scene_idx].get("nodes", [])
    instances: list[GltfInstance] = []

    # Retained node records (animation): base TRS + parent links, in
    # parent-before-child traversal order so world recompute is one pass.
    node_recs = [
        GltfNode(
            parent=-1,
            translation=np.asarray(n.get("translation", [0, 0, 0]), np.float64),
            rotation=np.asarray(n.get("rotation", [0, 0, 0, 1]), np.float64),
            scale=np.asarray(n.get("scale", [1, 1, 1]), np.float64),
            matrix=(
                np.asarray(n["matrix"], np.float64).reshape(4, 4).T
                if "matrix" in n else None
            ),
            name=n.get("name", f"node{i}"),
        )
        for i, n in enumerate(nodes)
    ]
    traversal: list[int] = []

    def walk(ni: int, parent: np.ndarray, parent_idx: int):
        node = nodes[ni]
        rec = node_recs[ni]
        rec.parent = parent_idx
        traversal.append(ni)
        if rec.matrix is not None:
            local = rec.matrix
        else:
            local = T.trs_to_mat4(
                node.get("translation"), node.get("rotation"), node.get("scale")
            )
        world = parent @ local
        if "mesh" in node:
            instances.append(
                GltfInstance(
                    mesh_prims=get_mesh(node["mesh"]),
                    world=world,
                    name=node.get("name", f"node{ni}"),
                    node=ni,
                )
            )
        for ci in node.get("children", []):
            walk(ci, world, ni)

    for r in roots:
        walk(r, np.eye(4), -1)

    # Animations: keyframed node TRS channels (samplers resolved inline).
    animations: list[GltfAnimation] = []
    for ai, anim in enumerate(doc.get("animations", [])):
        samplers = anim.get("samplers", [])
        channels: list[GltfChannel] = []
        for ch in anim.get("channels", []):
            tgt = ch.get("target", {})
            path = tgt.get("path")
            ni = tgt.get("node", -1)
            if ni < 0 or path not in ("translation", "rotation", "scale"):
                continue  # weights (morph targets) unsupported
            smp = samplers[ch["sampler"]]
            times = _read_accessor(doc, buffers, smp["input"]).reshape(-1)
            times = times.astype(np.float32)
            vals = _read_accessor(doc, buffers, smp["output"]).astype(np.float32)
            interp = smp.get("interpolation", "LINEAR")
            if interp == "CUBICSPLINE":
                vals = vals.reshape(len(times), 3, -1)
            channels.append(
                GltfChannel(node=ni, path=path, times=times, values=vals,
                            interpolation=interp)
            )
        animations.append(
            GltfAnimation(name=anim.get("name", f"anim{ai}"), channels=channels)
        )

    return GltfDoc(
        instances=instances, materials=materials, textures=textures,
        nodes=node_recs, animations=animations, traversal=traversal,
    )
