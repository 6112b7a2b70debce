"""The benchmark's frozen scene writers against the port as it is today: the
same 139,266 triangles as ``subdivide_scene(cornell_box(), 100_000)`` and
``materials_box``'s, and the same arrays after a glTF round trip through
the port's loader; the animated writer's rest pose is the static box."""

import numpy as np
import pytest
from rtb import spec

from zetaray_tpu_torch.scene.animation import AnimationRig
from zetaray_tpu_torch.scene.gltf import load_gltf
from zetaray_tpu_torch.scene.procedural import cornell_box, materials_box
from zetaray_tpu_torch.scene.scene import load_scene
from zetaray_tpu_torch.scene.subdivide import subdivide_scene

MATERIAL_FIELDS = ("base_color", "metallic", "roughness", "emissive", "ior", "transmission",
                   "coat_weight", "coat_roughness", "double_sided")


@pytest.mark.parametrize("variant,make", [("box", cornell_box), ("materials", materials_box)])
def test_writer_is_the_ports_split_box(tmp_path, variant, make):
    gen = spec.scene_generator("cornell_split")
    tris = gen.triangles(variant, 6)
    port = subdivide_scene(make(), 100_000)
    assert tris["mat"].shape[0] == port.num_tris == 139_266
    for ours, theirs in (("p0", "v0"), ("p1", "v1"), ("p2", "v2"), ("n0", "n0"), ("n1", "n1"),
                         ("n2", "n2"), ("uv0", "uv0"), ("uv1", "uv1"), ("uv2", "uv2"),
                         ("mat", "mat_id")):
        assert np.array_equal(tris[ours], getattr(port, theirs)), ours

    loaded = load_scene(str(gen.write(tmp_path, {"variant": variant, "split_rounds": 6})))
    # the file holds a primitive a material, in material order
    order = np.concatenate([np.nonzero(tris["mat"] == m)[0] for m in range(tris["mat"].max() + 1)])
    assert loaded.num_tris == 139_266
    for ours, theirs in (("p0", "v0"), ("p1", "v1"), ("p2", "v2"), ("mat", "mat_id")):
        assert np.array_equal(tris[ours][order], getattr(loaded, theirs)), ours
    assert np.array_equal(np.sort(loaded.emissive_tris), np.nonzero(tris["mat"][order] == 3)[0])
    for f in MATERIAL_FIELDS:
        a, b = getattr(loaded.materials, f), getattr(port.materials, f)
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)


def test_animated_writer_is_the_split_box_at_rest(tmp_path):
    """At t = 0 the animated file's world triangles are the static box's, in
    its order; the tall block's (the last material) to a float32 rounding
    of its node's translation there and back. Two nodes, one 2 s clip."""
    params = {"variant": "box", "split_rounds": 4}
    static = load_scene(str(spec.scene_generator("cornell_split").write(tmp_path / "s", params)))
    path = spec.scene_generator("cornell_split_animated").write(tmp_path / "a", params)
    doc = load_gltf(str(path))
    moved = load_scene(doc)
    tall = static.mat_id == spec.scene_generator("cornell_split").GLOSSY
    assert moved.num_tris == static.num_tris == 8706 and tall.sum() == 12 * 4**4
    assert np.array_equal(moved.inst_id, tall.astype(np.int32))
    for f in ("v0", "v1", "v2"):
        a, b = getattr(moved, f), getattr(static, f)
        assert np.array_equal(a[~tall], b[~tall]), f
        np.testing.assert_allclose(a[tall], b[tall], rtol=0, atol=1.2e-7, err_msg=f)
    for f in ("n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_id"):
        assert np.array_equal(getattr(moved, f), getattr(static, f)), f
    assert np.array_equal(moved.emissive_tris, static.emissive_tris)
    assert len(doc.nodes) == 2 and len(doc.animations) == 1
    rig = AnimationRig(doc, 0)
    assert rig.duration == 2.0 and set(rig.by_node) == {1}
    np.testing.assert_array_equal(rig.instance_worlds(0.0), rig.rest_worlds)
    np.testing.assert_allclose(rig.instance_worlds(2.0, loop=False), rig.rest_worlds, atol=1e-7)
