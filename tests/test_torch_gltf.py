"""glTF loading, the packed vertex format, the host transforms and instance
edits of the PyTorch port against the JAX package, on glTF files the tests
write themselves (``animated_gltf``: a ``.gltf`` with a ``data:`` buffer or
a ``.glb``; ``procedural.animated_box``: the box with a moving tall block).

Tolerances: the parsed documents, the flattened scenes (the quantized
normals and uvs bit for bit), the packed formats and the edits are equal;
the float64 transforms too (the same numpy operations).
"""

import dataclasses

import numpy as np
import pytest

from zetaray_tpu.core import transforms as JT
from zetaray_tpu.scene import edit as JE
from zetaray_tpu.scene import gltf as JG
from zetaray_tpu.scene import packed as JP
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.core import transforms as TT
from zetaray_tpu_torch.scene import edit as TE
from zetaray_tpu_torch.scene import gltf as TG
from zetaray_tpu_torch.scene import packed as TP
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import animated_box, write_gltf
from tests.test_torch_scene import to_jax_cpu_scene


def animated_gltf(path):
    """A small animated scene written to ``path`` (``.gltf`` or ``.glb``),
    after tests/test_animation.py's: a floor quad, a light quad, a "flag"
    quad whose node has a LINEAR translation, a CUBICSPLINE rotation and a
    STEP scale channel, and a matrix node with a child. The flag's mesh
    interleaves positions and normals (byteStride 24) and stores its uvs as
    normalized uint16; one material carries textures, MASK mode and the
    ior, transmission and clearcoat extensions."""
    pos = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    uv16 = np.array([[0, 0], [65535, 0], [65535, 65535], [0, 32768]], np.uint16)
    times = np.array([0.0, 1.0, 2.5], np.float32)
    trans = np.array([[0, 1, 0], [1, 1, 0], [1, 1.5, -0.5]], np.float32)
    s, c = np.sin(np.pi / 8), np.cos(np.pi / 8)
    rot = np.zeros((3, 3, 4), np.float32)  # (in-tangent, value, out-tangent) a key
    rot[:, 1] = [[0, 0, 0, 1], [0, s, 0, c], [s, 0, 0, c]]
    rot[:, 0] = [[0, 0.1, 0, 0], [0.05, 0, 0.1, 0], [0, 0, 0, 0]]
    rot[:, 2] = [[0, 0.2, 0, 0], [0, 0, -0.1, 0], [0, 0, 0, 0]]
    scale = np.array([[1, 1, 1], [2, 1, 1], [1, 1, 3]], np.float32)
    blob, views, acc = bytearray(), [], []

    def view(data, stride=0):
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        if stride:
            views[-1]["byteStride"] = stride
        blob.extend(data)
        blob.extend(b"\0" * (-len(blob) % 4))
        return len(views) - 1

    def accessor(v, comp, count, kind, offset=0, normalized=False):
        acc.append({"bufferView": v, "componentType": comp, "count": count, "type": kind,
                    "byteOffset": offset, **({"normalized": True} if normalized else {})})
        return len(acc) - 1

    inter = view(np.concatenate([pos, nrm], 1).tobytes(), stride=24)
    a_pos = accessor(view(pos.tobytes()), 5126, 4, "VEC3")
    a_soup = accessor(view(pos[[0, 1, 2, 0, 2, 3]].tobytes()), 5126, 6, "VEC3")
    a_ipos = accessor(inter, 5126, 4, "VEC3")
    a_inrm = accessor(inter, 5126, 4, "VEC3", offset=12)
    a_idx = accessor(view(idx.tobytes()), 5123, 6, "SCALAR")
    a_uv = accessor(view(uv16.tobytes()), 5123, 4, "VEC2", normalized=True)
    a_t = accessor(view(times.tobytes()), 5126, 3, "SCALAR")
    a_tr = accessor(view(trans.tobytes()), 5126, 3, "VEC3")
    a_rot = accessor(view(rot.tobytes()), 5126, 9, "VEC4")
    a_sc = accessor(view(scale.tobytes()), 5126, 3, "VEC3")
    mat4 = TT.trs_to_mat4([0.2, 0.0, -1.0], [0, 0, np.sin(0.3), np.cos(0.3)], [1.5, 1.5, 1.5])
    doc = {
        "asset": {"version": "2.0"},
        "bufferViews": views, "accessors": acc,
        "images": [{"uri": "base.png"}, {"uri": "normal.png"}],
        "textures": [{"source": 0}, {"source": 1}],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": a_pos}, "indices": a_idx,
                             "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": a_pos}, "indices": a_idx,
                             "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": a_ipos, "NORMAL": a_inrm,
                                            "TEXCOORD_0": a_uv}, "indices": a_idx,
                             "material": 2}]},
            {"primitives": [{"attributes": {"POSITION": a_soup}}]},  # no indices, no material
        ],
        "materials": [
            {"name": "white", "pbrMetallicRoughness": {
                "baseColorFactor": [0.8, 0.8, 0.8, 1], "metallicFactor": 0,
                "roughnessFactor": 0.8}},
            {"name": "light", "emissiveFactor": [1, 0.5, 0.25], "doubleSided": True,
             "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 10.0}}},
            {"name": "flag", "alphaMode": "MASK", "alphaCutoff": 0.4,
             "pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "metallicRoughnessTexture": {"index": 1}},
             "normalTexture": {"index": 1},
             "extensions": {"KHR_materials_ior": {"ior": 1.33},
                            "KHR_materials_transmission": {"transmissionFactor": 0.5},
                            "KHR_materials_clearcoat": {"clearcoatFactor": 0.7,
                                                        "clearcoatRoughnessFactor": 0.2}}},
        ],
        "nodes": [
            {"mesh": 0, "name": "floor", "rotation": [-0.7071068, 0, 0, 0.7071068],
             "scale": [4, 4, 1]},
            {"mesh": 1, "name": "light", "translation": [0, 2, 0],
             "rotation": [0.7071068, 0, 0, 0.7071068]},
            {"mesh": 2, "name": "flag", "translation": [0, 1, 0]},
            {"name": "group", "matrix": mat4.T.ravel().tolist(), "children": [4]},
            {"mesh": 3, "name": "child", "translation": [0, 0.5, 0]},
        ],
        "scenes": [{"nodes": [0, 1, 2, 3]}], "scene": 0,
        "animations": [{"name": "wave", "samplers": [
            {"input": a_t, "output": a_tr, "interpolation": "LINEAR"},
            {"input": a_t, "output": a_rot, "interpolation": "CUBICSPLINE"},
            {"input": a_t, "output": a_sc, "interpolation": "STEP"},
        ], "channels": [
            {"sampler": 0, "target": {"node": 2, "path": "translation"}},
            {"sampler": 1, "target": {"node": 2, "path": "rotation"}},
            {"sampler": 2, "target": {"node": 4, "path": "scale"}},
            {"sampler": 0, "target": {"node": 2, "path": "weights"}},  # skipped
        ]}],
    }
    return write_gltf(path, doc, bytes(blob))


FILES = {"gltf": lambda d: animated_gltf(d / "scene.gltf"),
         "glb": lambda d: animated_gltf(d / "scene.glb"),
         "box": lambda d: animated_box(d / "box.gltf"),
         "box_glb": lambda d: animated_box(d / "box.glb")}


def assert_same(got, want, where="doc"):
    """Recursive equality of the two packages' glTF records: the same
    dataclass fields, arrays equal in dtype, shape and value."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, where
        for n in names:
            assert_same(getattr(got, n), getattr(want, n), f"{where}.{n}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name", sorted(FILES))
def test_load_gltf_matches_jax(tmp_path, name):
    path = FILES[name](tmp_path)
    got, want = TG.load_gltf(path), JG.load_gltf(path)
    assert_same(got, want)
    assert got.animations and got.instances
    if name in ("gltf", "glb"):
        flag = got.instances[2].mesh_prims[0]
        assert flag.uvs[1, 0] == 1.0 and flag.normals is not None  # normalized, interleaved
        assert [c.interpolation for c in got.animations[0].channels] == [
            "LINEAR", "CUBICSPLINE", "STEP"]  # the weights channel skipped
        assert got.materials[2].alpha_mode == "MASK" and got.materials[2].coat_weight == 0.7


@pytest.mark.parametrize("name", sorted(FILES))
def test_load_scene_matches_jax(tmp_path, name):
    """Equal arrays, the quantized normals and uvs bit for bit, from a path
    and from a parsed document, with and without the worker threads."""
    path = FILES[name](tmp_path)
    want = JS.load_scene(str(path))
    for got in (TS.load_scene(path), TS.load_scene(TG.load_gltf(path), workers=1)):
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if f.name == "materials":
                assert_same(g, w, "materials")
            elif isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, f.name
                np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), f.name)
            else:
                assert g == w, f.name
    assert got.num_tris == want.num_tris > 0 and got.emissive_tris.size > 0


def test_default_material_and_transforms_match_jax():
    """The material table of no materials and every host transform, on
    random inputs: equal in float64."""
    assert_same(TS._materials_soa([]), JS._materials_soa([]))
    r = np.random.default_rng(4)
    for _ in range(20):
        q = r.normal(size=4)
        t, s = r.normal(size=3), r.uniform(0.2, 3.0, size=3) * r.choice([-1, 1], 3)
        np.testing.assert_array_equal(TT.quat_to_mat3(q), JT.quat_to_mat3(q))
        m3 = JT.quat_to_mat3(q)
        np.testing.assert_array_equal(TT.mat3_to_quat(m3), JT.mat3_to_quat(m3))
        m4 = JT.trs_to_mat4(t, q, s)
        np.testing.assert_array_equal(TT.trs_to_mat4(t, q, s), m4)
        for a, b in zip(TT.decompose_srt(m4), JT.decompose_srt(m4)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(TT.normal_matrix(m4), JT.normal_matrix(m4))
        p = r.normal(size=(7, 3))
        np.testing.assert_array_equal(TT.transform_points(m4, p), JT.transform_points(m4, p))
        np.testing.assert_array_equal(TT.transform_dirs(m4, p), JT.transform_dirs(m4, p))
    np.testing.assert_array_equal(TT.quat_to_mat3([0, 0, 0, 0]), np.eye(3))
    np.testing.assert_array_equal(TT.trs_to_mat4(), JT.trs_to_mat4())


def test_packed_formats_match_jax():
    """oct16 and half2 encodes and decodes, the quantizers and the vertex
    buffer, bit for bit, on random unit and zero vectors and uvs."""
    r = np.random.default_rng(9)
    n = r.normal(size=(513, 3)).astype(np.float32)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 0, 0]]
    unit = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    uv = r.uniform(-4, 4, size=(513, 2)).astype(np.float32)
    bits = lambda x: np.asarray(x).view(np.uint8)
    for fn, arg in ((TP.oct_encode_np, unit[4:]), (TP.oct_encode_u16x2_np, unit[4:]),
                    (TP.quantize_normals, n), (TP.quantize_normals, n[:0]),
                    (TP.uv_pack_half2_np, uv), (TP.quantize_uvs, uv),
                    (TP.quantize_uvs, uv[:0])):
        np.testing.assert_array_equal(bits(fn(arg)), bits(getattr(JP, fn.__name__)(arg)),
                                      fn.__name__)
    enc = JP.oct_encode_u16x2_np(unit[4:])
    np.testing.assert_array_equal(bits(TP.oct_decode_u16x2_np(enc)),
                                  bits(JP.oct_decode_u16x2_np(enc)))
    np.testing.assert_array_equal(bits(TP.oct_decode_np(JP.oct_encode_np(unit[4:]))),
                                  bits(JP.oct_decode_np(JP.oct_encode_np(unit[4:]))))
    np.testing.assert_array_equal(bits(TP.uv_unpack_half2_np(JP.uv_pack_half2_np(uv))),
                                  bits(JP.uv_unpack_half2_np(JP.uv_pack_half2_np(uv))))
    for tang in (None, unit[4:]):
        got = TP.pack_vertex_buffer(uv[4:, :1].repeat(3, 1), unit[4:], uv[4:], tang)
        want = JP.pack_vertex_buffer(uv[4:, :1].repeat(3, 1), unit[4:], uv[4:], tang)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(bits(got), bits(want))
        for a, b in zip(TP.unpack_vertex_buffer(got), JP.unpack_vertex_buffer(want)):
            np.testing.assert_array_equal(bits(a), bits(b))


def _same_cpu_scene(got, want):
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "materials":
            assert_same(g, w, "materials")
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, f.name)
            assert g.dtype == w.dtype, f.name
        else:
            assert g == w, f.name


def test_instance_edits_match_jax(tmp_path):
    """add_instance (a new material and an existing one, with and without
    normals and uvs, under a world matrix) and remove_instance (by name
    and by index, the name kept as a tombstone) equal JAX's, and the edited
    scene uploads; what is not there raises as in JAX."""
    cpu = TS.load_scene(animated_box(tmp_path / "box.gltf"))
    jcpu = to_jax_cpu_scene(cpu)
    r = np.random.default_rng(2)
    pos, nrm, uvs = r.normal(size=(6, 3)), r.normal(size=(6, 3)), r.uniform(size=(6, 2))
    idx = np.array([[0, 1, 2], [3, 4, 5], [0, 2, 4]])
    world = JT.trs_to_mat4([0.1, 0.5, 0.0], [0, 0.3, 0, 0.95], [0.5, 0.5, 0.5])
    mat = dict(name="glow", emissive_factor=np.array([1.0, 1.0, 0.5], np.float32),
               emissive_strength=4.0)
    got = TE.add_instance(cpu, pos, idx, world, TG.GltfMaterial(**mat), name="added",
                          normals=nrm, uvs=uvs)
    want = JE.add_instance(jcpu, pos, idx, world, JG.GltfMaterial(**mat), name="added",
                           normals=nrm, uvs=uvs)
    _same_cpu_scene(got, want)
    assert got.num_tris == cpu.num_tris + 3 and len(got.emissive_tris) == 5
    got = TE.add_instance(got, pos, idx.ravel(), material=1)
    want = JE.add_instance(want, pos, idx.ravel(), material=1)
    _same_cpu_scene(got, want)
    for which in ("tall_block", 0, "added"):
        _same_cpu_scene(TE.remove_instance(got, which), JE.remove_instance(want, which))
    removed = TE.remove_instance(got, "tall_block")
    assert removed.inst_names[1] == "<removed:tall_block>" and (removed.inst_id != 1).all()
    assert TS.upload_scene(removed, device="cpu").num_tris == removed.num_tris
    for bad, err in (("nope", KeyError), (7, IndexError), (1, KeyError)):
        with pytest.raises(err):
            TE.remove_instance(removed if bad == 1 else got, bad)
    with pytest.raises(IndexError):
        TE.add_instance(cpu, pos, idx, material=99)
