"""The benchmark's frozen scene writer against the port as it is today: the
same 139,266 triangles as ``subdivide_scene(cornell_box(), 100_000)`` and
``materials_box``'s, and the same arrays after a glTF round trip through
the port's loader."""

import numpy as np
import pytest
from rtb import spec

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
