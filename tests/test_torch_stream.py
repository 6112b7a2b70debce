"""The clustered scene path of the PyTorch port against the JAX package:
subdivision, the BVH build, the clustered upload, the trees the streaming
kernels walk, and the plain versions of those kernels, B8 (closest hit) and
B9 (any hit).

The JAX streaming kernels run in interpret mode. On the CPU the port runs
B8's and B9's plain versions: the dense sweep over every slot, with tie
groups of one cluster for B8 (tests/test_torch_cuda.py holds the CUDA
kernels against them on the card). The hit slot and its attribute row match
exactly wherever the two pick the same slot; t, u and v match to 1e-5, as
XLA on the CPU rounds the Woop and Moller-Trumbore dot products as fused
multiply-adds where the port rounds each operation. Exact ties (a ray
through an edge shared by two triangles) may go either way: the JAX kernel
keeps the first cluster it visits front to back, the port the lowest.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import bvh as JB
from zetaray_tpu.accel import stream as JST
from zetaray_tpu.scene import scene as JS
from zetaray_tpu.scene.subdivide import subdivide_scene as jax_subdivide
from zetaray_tpu_torch.accel import bvh as TB
from zetaray_tpu_torch.accel import intersect as XI
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.accel import stream as ST
from zetaray_tpu_torch.interop import scene_from_arrays
from zetaray_tpu_torch.ops import pathtracer as PT
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import cornell_box, repeated_box
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_stream import _soup
from tests.test_torch_rehearsal import (  # noqa: F401  (host_build, host_kernels: fixtures)
    _segments, host_build, host_kernels, host_stream_closest, host_stream_occlusion,
)
from tests.test_torch_intersect import _camera_rays
from tests.test_torch_scene import TABLES, jax_scene_arrays, to_jax_cpu_scene, to_port_cpu_scene

torch.set_num_threads(1)

C = 128  # forced cluster size, as tests/test_stream.py clusters its soup

CPU_SCENES = {
    "box546": lambda: subdivide_scene(cornell_box(), 500),
    "soup": lambda: to_port_cpu_scene(_soup(np.random.default_rng(3))),
}
WALK = ("walk_nodes", "leaf_slot")


@pytest.fixture(scope="module", params=sorted(CPU_SCENES))
def clustered(request):
    """(name, JAX SceneBuffers, port SceneBuffers), clustered by C slots."""
    cpu = CPU_SCENES[request.param]()
    jdev = JS.upload_scene(to_jax_cpu_scene(cpu), cluster_size=C)
    tdev = TS.upload_scene(cpu, device="cpu", cluster_size=C)
    return request.param, jdev, tdev


def _rays(name):
    """Camera rays on the box; on the soup, rays from above it spread over
    it (tests/test_stream.py's rays, 2048 of them)."""
    if name == "box546":
        return _camera_rays(32)
    r = np.random.default_rng(5)
    o = np.tile(np.array([[0.0, 0.0, 12.0]], np.float32), (2048, 1))
    d = r.normal(size=(2048, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("target", [500, 8193])
def test_subdivide_matches_jax(target):
    """1 -> 4 splits with the emissive triangles kept whole at the tail:
    546 and 8706 triangles from the 36-triangle box."""
    box = cornell_box()
    got = subdivide_scene(box, target)
    want = jax_subdivide(to_jax_cpu_scene(box), target)
    assert got.num_tris == {500: 546, 8193: 8706}[target]
    for f in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_id", "inst_id",
              "emissive_tris"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert len(got.emissive_tris) == len(box.emissive_tris)


def test_build_bvh_matches_jax():
    cpu = CPU_SCENES["soup"]()
    got = TB.build_bvh(cpu.v0, cpu.v1, cpu.v2, leaf_size=32)
    want = JB.build_bvh(cpu.v0, cpu.v1, cpu.v2, leaf_size=32)
    for f in ("lo", "hi", "left", "right", "first", "count", "perm"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for a, b in zip(got.cluster_aabbs(), want.cluster_aabbs()):
        np.testing.assert_array_equal(a, b)


def test_clustered_upload_matches_jax(clustered):
    """Every table entry for entry, the cluster boxes, the emissive remap."""
    name, jdev, tdev = clustered
    assert tdev.num_tris == jdev.num_tris and tdev.num_emissives == jdev.num_emissives
    assert tdev.cluster_size == C
    for k in TABLES + ["cluster_aabb"]:
        np.testing.assert_array_equal(getattr(tdev, k).numpy(), np.asarray(getattr(jdev, k)),
                                      err_msg=k)
    m = tdev.cluster_aabb.shape[0]
    assert tdev.woop.shape[1] == 3 * m * C
    # the emissive triangles keep their rows through the reordering
    cpu = CPU_SCENES[name]()
    src = cpu.v0[cpu.emissive_tris]
    np.testing.assert_array_equal(tdev.v0.numpy()[tdev.em_tri.numpy()[:len(src)]], src)


def test_cluster_size_option():
    """None clusters above 8192 triangles, 0 never, C > 0 always."""
    small, big = CPU_SCENES["box546"](), subdivide_scene(cornell_box(), 8193)
    assert TS.upload_scene(small, device="cpu").cluster_aabb is None
    assert TS.upload_scene(big, device="cpu", cluster_size=0).cluster_aabb is None
    auto = TS.upload_scene(big, device="cpu")
    assert auto.cluster_size == TS.CLUSTER_SIZE == 256
    assert auto.woop.shape[1] // 3 == 256 * auto.cluster_aabb.shape[0]
    with pytest.raises(ValueError):
        TS.upload_scene(small, device="cpu", cluster_size=100)


def _check_cluster_tree(tree, box):
    """One leaf per cluster; every node box holds its children's boxes and
    each leaf's box its cluster's. Returns (left, right, leaf)."""
    lo, hi = tree["tree_lo"], tree["tree_hi"]
    left, right, cl = tree["tree_left"], tree["tree_right"], tree["tree_cluster"]
    leaf = cl >= 0
    assert sorted(cl[leaf]) == list(range(box.shape[0]))
    assert ((left < 0) == leaf).all() and ((right < 0) == leaf).all()
    assert (lo[leaf] < box[cl[leaf], 0:3]).all() and (hi[leaf] > box[cl[leaf], 3:6]).all()
    inner = np.nonzero(~leaf)[0]
    for kids in (left[inner], right[inner]):
        assert (lo[inner] <= lo[kids]).all() and (hi[inner] >= hi[kids]).all()
    assert lo.dtype == np.float32 and left.dtype == np.int32 and cl.dtype == np.int32
    return left, right, leaf


def test_cluster_tree(clustered):
    """The tree over the clusters that the walks' tree is built on: one leaf
    per cluster; every node box holds its children's boxes and each leaf's
    box its cluster's; the cluster tree's inner nodes head the walks'
    tree."""
    _, _, tdev = clustered
    box = tdev.cluster_aabb.numpy()
    tree = TB.cluster_tree(box)
    _, _, leaf = _check_cluster_tree(tree, box)
    # walk node k < the inner nodes holds inner node k's children's boxes
    top = np.nonzero(~leaf)[0]
    f = tdev.walk_nodes.numpy()[:, :12].view(np.float32)
    for side, kids in enumerate((tree["tree_left"][top], tree["tree_right"][top])):
        np.testing.assert_array_equal(f[: top.shape[0], 4 * side], tree["tree_lo"][kids, 0])
        np.testing.assert_array_equal(f[: top.shape[0], 9 + 2 * side], tree["tree_hi"][kids, 2])


def test_cluster_tree_depth_is_checked(host_kernels):
    """A cluster tree's depth is checked only as part of the walks' stack
    (``walk_stack`` against WALK_STACK_MAX; test_walk_tree_depth_is_checked):
    the box bisected to 80 triangles, each repeated 100 times, in 80
    clusters of 128 slots put in a chain, a cluster tree 79 deep (deeper
    than the 64 that B9's own walk once allowed), uploads, and B8 and B9
    built for the host walk it as their plain versions answer."""
    scene = TS.upload_scene(repeated_box(100, 80), device="cpu", cluster_size=C)
    box = scene.cluster_aabb.numpy()
    chain = TS.with_cluster_tree(scene, TB.chain_tree(box))
    left, right, _ = _check_cluster_tree(TB.chain_tree(box), box)
    assert box.shape[0] == 80 and TB._depth(left, right).max() == 79
    assert 79 < chain.walk_stack <= TB.WALK_STACK_MAX
    o, seg, d = _segments(5, 300)
    t, tri = host_stream_closest(chain, o, d)
    t_p, tri_p = ST.stream_closest_plain(chain, o, d)
    assert torch.equal(tri, tri_p) and torch.equal(t, t_p)
    assert 0.5 < (tri_p >= 0).float().mean() < 1.0
    for dirs, t_max in ((seg, 1.0 - 1e-3), (d, 0.5)):
        got = host_stream_occlusion(chain, o, dirs, 1e-3, t_max)
        assert torch.equal(got, ST.occlusion_stream_plain(chain, o, dirs, 1e-3, t_max))
        assert 0 < got.sum() < got.numel()


def test_interop_carries_a_clustered_scene(clustered):
    """A clustered JAX scene (its TPU-only stream tables ignored) becomes
    the port's own upload of the same host scene, trees and B8's
    leaf-ordered rows included."""
    _, jdev, tdev = clustered
    got = scene_from_arrays(jax_scene_arrays(jdev), device="cpu")
    assert got.cluster_size == C and got.num_tris == tdev.num_tris
    for k in TABLES + ["cluster_aabb", *WALK]:
        assert torch.equal(getattr(got, k), getattr(tdev, k)), k
    assert torch.equal(got.leaf_rows(), tdev.leaf_rows())
    assert got.walk_stack == tdev.walk_stack


def _walk_children(scene):
    """B8's tree as (node, side, lo [3], hi [3], ref) for every child of
    every node, and the rows below each ref {ref: rows}."""
    nodes = scene.walk_nodes.numpy()
    f = nodes[:, :12].view(np.float32)
    kids = []
    for k in range(nodes.shape[0]):
        for side in (0, 1):
            lo = np.array([f[k, 4 * side], f[k, 4 * side + 2], f[k, 8 + 2 * side]])
            hi = np.array([f[k, 4 * side + 1], f[k, 4 * side + 3], f[k, 9 + 2 * side]])
            kids.append((k, side, lo, hi, int(nodes[k, 12 + side])))
    below = {}

    def rows(ref):
        if ref not in below:
            if ref < 0:
                first, count = (~ref) >> 4, (~ref) & 15
                below[ref] = list(range(first, first + count))
            else:
                below[ref] = rows(int(nodes[ref, 12])) + rows(int(nodes[ref, 13]))
        return below[ref]

    rows(0 if nodes.shape[0] else -1)
    for *_, ref in kids:
        rows(ref)
    return kids, below


def test_walk_tree_leaves(clustered):
    """B8's tree: every real slot lies in exactly one leaf of at most
    LEAF_SIZE rows and no pad slot in any; each child box holds the
    vertices of every triangle below it, after padding and outward
    rounding; and the rows are the Woop rows of their slots."""
    name, _, tdev = clustered
    slot = tdev.leaf_slot.numpy()
    kids, below = _walk_children(tdev)
    leaf_rows = sorted(r for *_, ref in kids if ref < 0 for r in below[ref])
    assert leaf_rows == list(range(slot.shape[0]))
    assert max(len(below[ref]) for *_, ref in kids if ref < 0) <= TB.LEAF_SIZE
    real = np.nonzero((tdev.woop.reshape(12, -1) != 0).any(0).numpy())[0]
    assert sorted(slot) == list(real) and real.shape[0] == CPU_SCENES[name]().num_tris
    assert (slot // C == np.sort(slot) // C).all()  # rows stay grouped by cluster
    v0 = tdev.v0.numpy().astype(np.float64)
    corners = np.stack([v0, v0 + tdev.e1.numpy(), v0 + tdev.e2.numpy()])  # [3, Tp, 3]
    for _, _, lo, hi, ref in kids:
        pts = corners[:, slot[below[ref]]].reshape(-1, 3)
        assert (lo < pts.min(0)).all() and (hi > pts.max(0)).all()
    assert tdev.walk_nodes.dtype == torch.int32 and tdev.walk_nodes.shape[1] == 16
    assert torch.equal(tdev.leaf_rows(), tdev.woop_rows()[tdev.leaf_slot.long()])


def test_walk_tree_depth_is_checked(clustered, monkeypatch):
    """The stack B8's walk can need (one entry for each inner node above
    the node it visits, cluster tree and sub-tree together) is counted at
    build into ``walk_stack`` and checked against WALK_STACK_MAX."""
    _, _, tdev = clustered
    tree = TB.cluster_tree(tdev.cluster_aabb.numpy())
    args = (tree, C, *(getattr(tdev, k).numpy() for k in ("woop", "v0", "e1", "e2")))
    got = TB.walk_tree(*args)
    assert np.array_equal(got["walk_nodes"], tdev.walk_nodes.numpy())
    assert got["walk_stack"] == tdev.walk_stack
    assert tdev.walk_stack == max(_ancestors(tdev).values())
    monkeypatch.setattr(TB, "WALK_STACK_MAX", tdev.walk_stack - 1)
    with pytest.raises(ValueError, match="stack"):
        TB.walk_tree(*args)


def _ancestors(scene):
    """{leaf ref: how many inner nodes of B8's tree lie above it}."""
    nodes = scene.walk_nodes.numpy()
    out, todo = {}, [(0, 0)]
    while todo:
        k, depth = todo.pop()
        for ref in nodes[k, 12:14].tolist():
            if ref >= 0:
                todo.append((ref, depth + 1))
            else:
                out[ref] = max(out.get(ref, 0), depth + 1)
    return out


def test_chain_tree_is_deep_and_valid(clustered):
    """chain_tree: one leaf per cluster, every node box holds its children's
    boxes, M - 1 deep; a scene given it walks a tree with the stack its
    depth needs, over the same rows."""
    _, _, tdev = clustered
    box = tdev.cluster_aabb.numpy()
    m = box.shape[0]
    tree = TB.chain_tree(box)
    chain = TS.with_cluster_tree(tdev, tree)
    left, right, _ = _check_cluster_tree(tree, box)
    assert tree["tree_cluster"].shape[0] == 2 * m - 1
    assert TB._depth(left, right).max() == m - 1
    assert chain.walk_stack == max(_ancestors(chain).values()) > tdev.walk_stack
    assert torch.equal(chain.leaf_slot.sort().values, tdev.leaf_slot.sort().values)


def test_leaf_rows_follow_the_woop_table(clustered):
    """leaf_rows() is made at first use, kept while woop is unchanged, and
    made again after an in-place edit of woop."""
    _, _, tdev = clustered
    scene = dataclasses.replace(tdev, woop=tdev.woop.clone())
    rows = scene.leaf_rows()
    assert scene.leaf_rows() is rows
    scene.woop.mul_(2.0)
    moved = scene.leaf_rows()
    assert moved is not rows and torch.equal(moved, 2.0 * rows)


# The share of hit rays on which the port and JAX pick the same slot: on
# the subdivided box every wall is a mesh of shared edges (1 ray of 930
# differs there), on the soup edges are rarely shared.
MIN_SAME = {"box546": 0.995, "soup": 0.999}


def _check_ties(name, got_t, got_tri, want_t, want_tri):
    """Same slot on at least MIN_SAME of the hit rays; where the slots
    differ, the same t (an exact tie on a shared edge)."""
    hit = want_tri >= 0
    np.testing.assert_array_equal(got_tri >= 0, hit)
    same = got_tri == want_tri
    assert same[hit].mean() >= MIN_SAME[name]
    np.testing.assert_allclose(got_t[~same], want_t[~same], rtol=1e-5, atol=1e-5)
    return hit, same


def test_stream_closest_plain_matches_jax(clustered):
    """B8's plain version and both epilogues against the JAX stream kernel:
    the same slot on every hit ray but exact edge ties, t/u/v to 1e-5,
    attribute rows exact where the slot agrees."""
    name, jdev, tdev = clustered
    o, d = _rays(name)
    w3 = jdev.woop.reshape(4, 3, -1)
    want = [np.asarray(x) for x in JST.closest_hit_stream(
        w3, jdev.woop_stream, jdev.cluster_aabb, jnp.asarray(o), jnp.asarray(d),
        interpret=True)]
    t, tri, u, v = ST.closest_hit_stream(tdev, _t(o), _t(d))
    assert tri.dtype == torch.int32
    hit, same = _check_ties(name, t.numpy(), tri.numpy(), want[0], want[1])
    assert 0.1 < hit.mean() < 1.0
    for g, w in ((t, want[0]), (u, want[2]), (v, want[3])):
        np.testing.assert_allclose(g.numpy()[same], w[same], rtol=1e-5, atol=1e-5)
    # the raw t is the kernel's own Woop t
    t_raw, tri_raw = ST.stream_closest(tdev, _t(o), _t(d))
    assert torch.equal(tri_raw, tri) and torch.equal(t_raw, t)

    want_s = [np.asarray(x) for x in JST.closest_hit_stream_shaded(
        jdev.stream_attrs, jdev.woop_stream, jdev.cluster_aabb, jnp.asarray(o), jnp.asarray(d),
        interpret=True)]
    sh = ST.closest_hit_stream_shaded(tdev, _t(o), _t(d))
    assert torch.equal(sh.tri, tri)
    _, same = _check_ties(name, sh.t.numpy(), sh.tri.numpy(), want_s[0], want_s[1])
    for g, w in ((sh.t, want_s[0]), (sh.u, want_s[2]), (sh.v, want_s[3])):
        np.testing.assert_allclose(g.numpy()[same], w[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sh.attrs.numpy()[:, same], want_s[4][same].T)
    miss = ~hit
    assert (sh.t.numpy()[miss] == MK.INF).all() and (sh.u.numpy()[miss] == 0).all()
    assert (sh.attrs.numpy()[:, miss] == 0).all() and (sh.tri.numpy()[miss] == -1).all()
    # the scene query dispatches to the streaming path
    via_scene = XI.intersect_closest_shaded(tdev, _t(o), _t(d))
    assert all(torch.equal(a, b) for a, b in zip(via_scene, sh))


@pytest.mark.parametrize("t_range", [(1e-4, MK.INF), (1e-3, 9.0)])
def test_occlusion_stream_plain_matches_jax(clustered, t_range):
    """B9's plain version against the JAX stream kernel on every ray."""
    name, jdev, tdev = clustered
    o, d = _rays(name)
    t_min, t_max = t_range
    want = np.asarray(JST.occlusion_stream(jdev.woop_stream, jdev.cluster_aabb, jnp.asarray(o),
                                           jnp.asarray(d), t_min=t_min, t_max=t_max,
                                           interpret=True))
    got = ST.occlusion_stream(tdev, _t(o), _t(d), t_min, t_max)
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(XI.intersect_occluded(tdev, _t(o), _t(d), t_min, t_max), got)


def test_stream_tie_rule():
    """One triangle copied to a higher slot of its own cluster and to a slot
    of a later cluster: the plain B8 returns the highest slot of the lowest
    cluster wherever the copies are hit first."""
    tdev = TS.upload_scene(CPU_SCENES["soup"](), device="cpu", cluster_size=C)
    k, dup_in, dup_out = 5, C - 1, 3 * C + 7  # slot C-1 of cluster 0, a slot of cluster 3
    woop = tdev.woop.clone().reshape(4, 3, -1)
    for j in (dup_in, dup_out):
        woop[:, :, j] = woop[:, :, k]
    scene = dataclasses.replace(tdev, woop=woop.reshape(4, -1))
    r = np.random.default_rng(5)
    v0 = tdev.v0[k].numpy()
    centre = v0 + (tdev.e1[k].numpy() + tdev.e2[k].numpy()) / 3.0
    nrm = tdev.ng[k].numpy()
    side = np.where(r.random(512) < 0.5, 1.0, -1.0)[:, None]
    o = (centre + side * (0.05 * nrm + r.normal(0, 0.01, (512, 3)))).astype(np.float32)
    d = (centre + r.normal(0, 0.01, (512, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _, tri = ST.stream_closest(scene, _t(o), _t(d))
    _, tri_orig = ST.stream_closest(tdev, _t(o), _t(d))
    pair = tri_orig.numpy() == k
    assert pair.mean() > 0.5
    assert (tri.numpy()[pair] == dup_in).all()
    # with the in-cluster copy gone, the later cluster's copy still loses
    woop[:, :, dup_in] = 0.0
    _, tri2 = ST.stream_closest(dataclasses.replace(tdev, woop=woop.reshape(4, -1)), _t(o),
                                _t(d))
    assert (tri2.numpy()[pair] == k).all()


def test_dense_entry_points_refuse_a_clustered_scene():
    """The dense kernels' scene-level entry points sweep the whole table and
    raise on a clustered scene; the path tracer takes the wavefront tracer."""
    tdev = TS.upload_scene(CPU_SCENES["box546"](), device="cpu", cluster_size=C)
    o, d = (_t(x) for x in _camera_rays(4))
    cfg = PT.PTConfig(max_bounces=1)
    st = MK.initial_state(o, d)
    surf = torch.zeros((MK.SURF_ROWS, o.shape[0]))
    sets = MK.build_light_sets(tdev, 3)
    calls = {
        "trace_megakernel": lambda: MK.trace_megakernel(tdev, o, d, 3, cfg),
        "trace_with_first_hit": lambda: MK.trace_with_first_hit(tdev, o, d, 3, cfg, 16),
        "bounce_trace": lambda: MK.bounce_trace(tdev, st, 0, cfg, True),
        "bounce_shade": lambda: MK.bounce_shade(tdev, st, surf, sets, 0, 3, cfg, True, 16),
        "bounce": lambda: MK.bounce(tdev, st, sets, 0, 3, cfg, False, True, 16),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match=name):
            call()
    rad = PT.trace(tdev, o, d, 3, cfg)
    assert rad.shape == (o.shape[0], 3) and torch.isfinite(rad).all()
