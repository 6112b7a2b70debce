"""Scene upload and light sets of the PyTorch port against the JAX package.

Also holds the helpers the other ``test_torch_*`` files share: the same
host scene uploaded by both packages.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.megakernel import build_light_sets as jax_light_sets
from zetaray_tpu.core.rng import seed_from_key
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.accel.megakernel import build_light_sets
from zetaray_tpu_torch.interop import scene_from_arrays
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_intersect import _random_scene

torch.set_num_threads(1)


def to_jax_cpu_scene(cpu: TS.CpuScene) -> JS.CpuScene:
    """The port's host scene as the JAX package's CpuScene (same fields)."""
    mats = JS.MaterialsSoA(**dataclasses.asdict(cpu.materials))
    kw = {f.name: getattr(cpu, f.name) for f in dataclasses.fields(cpu)}
    kw["materials"] = mats
    return JS.CpuScene(**kw)


def to_port_cpu_scene(cpu: JS.CpuScene) -> TS.CpuScene:
    mats = TS.MaterialsSoA(**{
        f.name: getattr(cpu.materials, f.name)
        for f in dataclasses.fields(TS.MaterialsSoA)
    })
    kw = {f.name: getattr(cpu, f.name) for f in dataclasses.fields(TS.CpuScene)}
    kw["materials"] = mats
    return TS.CpuScene(**kw)


def jax_scene_arrays(dev: JS.SceneBuffers) -> dict:
    return {
        f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
        for f in dataclasses.fields(dev)
        for v in [getattr(dev, f.name)]
    }


def scene_pair(cpu: TS.CpuScene):
    """(JAX SceneBuffers, port SceneBuffers) of one host scene."""
    return JS.upload_scene(to_jax_cpu_scene(cpu)), TS.upload_scene(cpu, device="cpu")


def frame_seed(k: int) -> int:
    return int(seed_from_key(jax.random.PRNGKey(k)))


SCENES = {
    "cornell": lambda: cornell_box(),
    "random300": lambda: to_port_cpu_scene(_random_scene(np.random.default_rng(7), 300)),
}

TABLES = ["woop", "tri_attrs", "em_attrs", "em_prob", "em_alias", "em_pdf", "em_area",
          "em_tri", "em_of_tri", "v0", "e1", "e2", "ng", "n0", "uv0", "mat_id", "inst_id",
          "em_power", "world_lo", "world_hi"]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_upload_matches_jax(name):
    jdev, tdev = scene_pair(SCENES[name]())
    assert tdev.num_tris == jdev.num_tris
    assert tdev.num_emissives == jdev.num_emissives
    for k in TABLES:
        want = np.asarray(getattr(jdev, k))
        got = getattr(tdev, k).numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=k)


def test_interop_scene_roundtrip():
    jdev, tdev = scene_pair(cornell_box())
    conv = scene_from_arrays(jax_scene_arrays(jdev), device="cpu")
    for k in TABLES:
        np.testing.assert_array_equal(getattr(conv, k).numpy(), getattr(tdev, k).numpy())


def test_subdivided_box_fills_dense_path():
    cpu = cornell_box(subdivide_to=TS.CLUSTER_THRESHOLD)
    assert cpu.num_tris == TS.CLUSTER_THRESHOLD
    area = cornell_box().areas().sum()
    np.testing.assert_allclose(cpu.areas().sum(), area, rtol=1e-5)
    assert len(cpu.emissive_tris) > 2
    assert TS.upload_scene(cpu, device="cpu").cluster_aabb is None
    # one triangle more and the upload takes the clustered path
    big = TS.upload_scene(cornell_box(subdivide_to=TS.CLUSTER_THRESHOLD + 1), device="cpu")
    assert big.cluster_aabb is not None and big.cluster_size == TS.CLUSTER_SIZE


@pytest.mark.parametrize("k", [0, 5])
def test_light_sets_match_jax(k):
    jdev, tdev = scene_pair(cornell_box(subdivide_to=600))
    seed = frame_seed(k)
    want = np.asarray(jax_light_sets(jdev, jnp.uint32(seed)))
    got = build_light_sets(tdev, seed).numpy()
    assert got.shape == want.shape == (64, 16, 128)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
