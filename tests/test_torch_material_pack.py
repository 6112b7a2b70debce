"""Packed material records (``scene.material_pack``) of the port against
the JAX package's: the eight words of every material bit-equal on the
procedural box, the materials box (glass and a clear coat) and the textured
box (texture ids, a metallic-roughness map, an emissive map); the round
trip; and the encoding of invalid texture ids."""

import numpy as np
import pytest

from tests.test_torch_scene import to_jax_cpu_scene
from zetaray_tpu.scene import material_pack as JM
from zetaray_tpu_torch.scene import material_pack as TM
from zetaray_tpu_torch.scene.procedural import cornell_box, materials_box, textured_box


def _scene(name, tmp_path):
    if name == "textured_box":
        return textured_box(tmp_path)
    return {"cornell_box": cornell_box, "materials_box": materials_box}[name]()


@pytest.mark.parametrize("name", ["cornell_box", "materials_box", "textured_box"])
def test_pack_matches_jax(tmp_path, name):
    cpu = _scene(name, tmp_path)
    got = TM.pack_materials(cpu.materials)
    want = JM.pack_materials(to_jax_cpu_scene(cpu).materials)
    assert got.dtype == np.uint32 and got.shape == (cpu.materials.base_color.shape[0], 8)
    np.testing.assert_array_equal(got, want)
    t_un, j_un = TM.unpack_materials(got), JM.unpack_materials(want)
    assert t_un.keys() == j_un.keys()
    for k in t_un:
        assert t_un[k].dtype == j_un[k].dtype, k
        np.testing.assert_array_equal(t_un[k], j_un[k], err_msg=k)


@pytest.mark.parametrize("name", ["cornell_box", "materials_box", "textured_box"])
def test_round_trip(tmp_path, name):
    m = _scene(name, tmp_path).materials
    out = TM.unpack_materials(TM.pack_materials(m))
    np.testing.assert_allclose(out["base_color"], np.clip(m.base_color, 0, 1), atol=1 / 255.0)
    np.testing.assert_allclose(out["roughness"], np.clip(m.roughness, 0, 1), atol=1 / 255.0)
    np.testing.assert_allclose(out["coat_weight"], np.clip(m.coat_weight, 0, 1), atol=1 / 255.0)
    np.testing.assert_allclose(out["ior"], m.ior, atol=2e-4)
    np.testing.assert_array_equal(out["base_color_tex"], m.base_color_tex)
    for k in ("normal_tex", "metallic_roughness_tex", "emissive_tex"):
        want = getattr(m, k)
        np.testing.assert_array_equal(out[k], np.full(len(m.ior), -1) if want is None else want)
    np.testing.assert_array_equal(out["double_sided"], m.double_sided)
    em = np.asarray(m.emissive, np.float32)
    rel = np.abs(out["emissive"] - em) / np.maximum(em.max(-1, keepdims=True), 1e-3)
    assert rel.max() < 1 / 128.0
    np.testing.assert_array_equal(out["metallic"] > 0.5, np.asarray(m.metallic) >= 0.9)
    np.testing.assert_array_equal(out["transmissive"], np.asarray(m.transmission) >= 0.5)


def test_invalid_texture_ids():
    class M:
        base_color = np.array([[0.5, 0.2, 0.1], [0.1, 0.9, 0.3]], np.float32)
        metallic = np.array([0.0, 1.0], np.float32)
        roughness = np.array([0.4, 0.2], np.float32)
        emissive = np.zeros((2, 3), np.float32)
        ior = np.array([1.5, 2.0], np.float32)
        transmission = np.array([0.0, 0.0], np.float32)
        coat_weight = np.array([0.0, 0.5], np.float32)
        coat_roughness = np.array([0.0, 0.1], np.float32)
        double_sided = np.array([False, True])
        base_color_tex = np.array([-1, 3], np.int32)
        normal_tex = np.array([-1, -5], np.int32)
        metallic_roughness_tex = None
        emissive_tex = np.array([-1, 70000], np.int32)
        alpha_cutoff = np.array([0.0, 0.5], np.float32)

    got = TM.pack_materials(M)
    np.testing.assert_array_equal(got, JM.pack_materials(M))
    assert int(got[0, 1] & 0xFFFF) == TM.INVALID_ID
    assert int(got[1, 2] & 0xFFFF) == TM.INVALID_ID  # any negative id is invalid
    assert int(got[0, 3] & 0xFFFF) == TM.INVALID_ID  # no map table at all
    out = TM.unpack_materials(got)
    assert out["base_color_tex"].tolist() == [-1, 3]
    assert out["normal_tex"].tolist() == [-1, -1]
    assert out["metallic_roughness_tex"].tolist() == [-1, -1]
    assert out["emissive_tex"][1] == 70000 & 0xFFFF  # 16 bits, as the reference keeps
    assert out["alpha_mode"].tolist() == [0, 1]
