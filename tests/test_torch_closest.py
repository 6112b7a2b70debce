"""Closest hit with attributes (kernel B7) of the PyTorch port against the
JAX package's ``closest_hit_pallas`` in interpret mode.

On the CPU the port runs B7's plain version (tests/test_torch_cuda.py holds
the CUDA kernel against it on the card). The hit triangle and its attribute
row match exactly; t, u and v match to 1e-5 (relative and absolute): the
Pallas kernel forms the Woop coordinates with a dot product that XLA on the
CPU rounds as fused multiply-adds, where the port rounds each operation
(ROADMAP §C).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.intersect import intersect_closest_shaded_dense
from zetaray_tpu.accel.pallas_kernels import _pick_tiles, closest_hit_pallas
from zetaray_tpu_torch.accel import intersect as XI
from zetaray_tpu_torch.accel.megakernel import closest_hit_plain
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_torch_intersect import _camera_rays, _random_rays
from tests.test_torch_scene import SCENES, scene_pair

torch.set_num_threads(1)


def _pallas(jdev, o, d, **kw):
    out = closest_hit_pallas(jdev.woop.reshape(4, 3, -1), jdev.tri_attrs, jnp.asarray(o),
                             jnp.asarray(d), interpret=True, **kw)
    return [np.asarray(x) for x in out]


def _check(got: XI.ShadedHit, want):
    t, tri, u, v, attrs = want
    np.testing.assert_array_equal(got.tri.numpy(), tri)
    np.testing.assert_array_equal(got.attrs.numpy(), attrs.T)
    for g, w in ((got.t, t), (got.u, u), (got.v, v)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    miss = tri < 0
    assert (got.t.numpy()[miss] == 3.0e38).all() and (got.u.numpy()[miss] == 0).all()


@pytest.mark.parametrize("name,rays,t_max", [
    ("cornell", "camera", None), ("random300", "random", None), ("random300", "random", 2.0),
])
def test_closest_plain_matches_pallas(name, rays, t_max):
    """Camera rays on the box (128 padded triangles, one tie chunk) and
    random rays on 300 random triangles (384 padded, one chunk of 384)."""
    jdev, tdev = scene_pair(SCENES[name]())
    o, d = _camera_rays() if rays == "camera" else _random_rays(11, n=1024)
    kw = {} if t_max is None else {"t_max": t_max}
    want = _pallas(jdev, o, d, **kw)
    tp = tdev.woop.shape[1] // 3
    assert XI.tie_chunk(tp) == _pick_tiles(o.shape[0], tp)[1]
    got = XI.closest_hit_plain_shaded(tdev.woop, tdev.tri_attrs, torch.from_numpy(o),
                                      torch.from_numpy(d), t_max=t_max or XI.INF)
    assert 0.1 < (got.tri >= 0).float().mean() < 1.0
    _check(got, want)
    # the wrapper takes the plain version for CPU tensors; the scene query too
    via_wrapper = XI.closest_hit(tdev, torch.from_numpy(o), torch.from_numpy(d),
                                 t_max=t_max or XI.INF)
    assert all(torch.equal(a, b) for a, b in zip(via_wrapper, got))
    if t_max is None:
        via_scene = XI.intersect_closest_shaded(tdev, torch.from_numpy(o), torch.from_numpy(d))
        assert all(torch.equal(a, b) for a, b in zip(via_scene, got))


def test_closest_matches_the_dense_xla_query():
    """The JAX ReSTIR PT's dense query (an einsum and argmin, the lowest
    index on ties) finds the same hits on at least 99% of the box's camera
    rays. It rounds its Woop coordinates in yet another order, so a ray that
    grazes the edge between two walls may land on the other one."""
    jdev, tdev = scene_pair(cornell_box())
    o, d = _camera_rays()
    want = intersect_closest_shaded_dense(jdev, jnp.asarray(o), jnp.asarray(d))
    got = XI.intersect_closest_shaded(tdev, torch.from_numpy(o), torch.from_numpy(d))
    same = got.tri.numpy() == np.asarray(want.tri)
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(got.attrs.numpy()[:, same], np.asarray(want.attrs)[same].T)
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tile", [128, 256, 384, 512])
def test_tie_chunk_mirrors_pick_tiles(tile):
    for tp in (128, 256, 384, 640, 768, 1024, 8192):
        assert XI.tie_chunk(tp) == _pick_tiles(tile, tp)[1]


def test_tie_rule_within_a_384_chunk():
    """Triangle 10 duplicated at index 200: both lie in the one 384-wide
    chunk of a 300-triangle table, so B7 (like the Pallas kernel) returns
    200 wherever the pair is hit first, while the 128-wide rule of B1 and
    the bounce kernels keeps 10 (200 sits in its second chunk)."""
    cpu = SCENES["random300"]()
    k, dup = 10, 200
    fields = {f: getattr(cpu, f).copy() for f in ("v0", "v1", "v2", "n0", "n1", "n2")}
    for a in fields.values():
        a[dup] = a[k]
    jdev, tdev = scene_pair(dataclasses.replace(cpu, **fields))
    assert XI.tie_chunk(tdev.woop.shape[1] // 3) == 384
    r = np.random.default_rng(5)
    centre = (cpu.v0[k] + cpu.v1[k] + cpu.v2[k]) / 3.0
    nrm = np.cross(cpu.v1[k] - cpu.v0[k], cpu.v2[k] - cpu.v0[k])
    nrm /= np.linalg.norm(nrm)
    side = np.where(r.random(512) < 0.5, 1.0, -1.0)[:, None]
    o = (centre + side * (0.05 * nrm + r.normal(0, 0.01, (512, 3)))).astype(np.float32)
    d = (centre + r.normal(0, 0.02, (512, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = _pallas(jdev, o, d)
    got = XI.closest_hit_plain_shaded(tdev.woop, tdev.tri_attrs, torch.from_numpy(o),
                                      torch.from_numpy(d))
    _check(got, want)
    pair = np.isin(want[1], (k, dup))
    assert pair.mean() > 0.5
    assert (want[1][pair] == dup).all()
    _, tri128, _, _ = closest_hit_plain(tdev.woop, torch.from_numpy(o), torch.from_numpy(d))
    assert (tri128.numpy()[pair] == k).all()
