"""The refit of an uploaded scene, PyTorch port against the JAX package's
``refit_scene``, and the refit of the walk tree that kernels B8 and B9
traverse, which only the port has.

The scenes are the animated box of ``procedural.animated_box`` (its tall
block instance 1), dense and split to 546 triangles and clustered by 128
slots, refit to poses of its animation. Against the JAX refit: 5e-5
(absolute and relative) on ``woop``, ``tri_attrs``, ``em_attrs``,
``v0``/``e1``/``e2``, the world bounds and ``cluster_aabb``; both build the
Woop rows with a float32 adjugate, so a refit is held to the JAX refit and
not to a float64 upload (an identity refit differs from the upload by
about 5e-5, as tests/test_animation.py notes). The walk tree is held
exactly: an identity refit gives the nodes a host ``walk_tree`` builds over
the same topology and cluster boxes, bit for bit; after a motion every
triangle lies strictly inside every box above it, and B8 and B9 built for
the host (tests/test_torch_rehearsal.py) walking the refit tree equal
their plain versions, where the upload's stale boxes lose hits.
"""

import numpy as np
import pytest
import torch

from zetaray_tpu.scene import refit as JR
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.accel import bvh as TB
from zetaray_tpu_torch.accel import stream as ST
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.animation import AnimationRig
from zetaray_tpu_torch.scene.gltf import load_gltf
from zetaray_tpu_torch.scene.procedural import animated_box
from zetaray_tpu_torch.scene.refit import refit_scene, woop_pack
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_rehearsal import (  # noqa: F401  (host_build, host_kernels: fixtures)
    _segments, host_build, host_kernels, host_stream_closest, host_stream_occlusion,
)
from tests.test_torch_scene import to_jax_cpu_scene

torch.set_num_threads(1)

C = 128
TOL = 5e-5
FIELDS = ("woop", "tri_attrs", "em_attrs", "v0", "e1", "e2", "ng", "n0", "n1", "n2",
          "world_lo", "world_hi", "cluster_aabb")


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """(rig, {"dense"|"clustered": (JAX upload, port upload)})."""
    doc = load_gltf(animated_box(tmp_path_factory.mktemp("refit") / "box.gltf"))
    cpu = TS.load_scene(doc)
    split = subdivide_scene(cpu, 500)
    scenes = {
        "dense": (JS.upload_scene(to_jax_cpu_scene(cpu)), TS.upload_scene(cpu, device="cpu")),
        "clustered": (JS.upload_scene(to_jax_cpu_scene(split), cluster_size=C),
                      TS.upload_scene(split, device="cpu", cluster_size=C)),
    }
    return AnimationRig(doc), scenes


@pytest.mark.parametrize("t", [0.5, 1.0, 1.7])
@pytest.mark.parametrize("kind", ["dense", "clustered"])
def test_refit_matches_jax(box, kind, t):
    rig, scenes = box
    jdev, tdev = scenes[kind]
    dp, dn = rig.deltas(t)
    want, got = JR.refit_scene(jdev, dp, dn), refit_scene(tdev, dp, dn)
    for k in FIELDS:
        w = getattr(want, k)
        if w is None:
            assert getattr(got, k) is None and kind == "dense", k
            continue
        g = getattr(got, k).numpy()
        assert g.shape == np.asarray(w).shape and g.dtype == np.float32, k
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL, err_msg=k)
    tall = tdev.inst_id == 1
    assert not torch.allclose(got.v0[tall], tdev.v0[tall])  # the block moved
    assert torch.equal(got.v0[~tall], tdev.v0[~tall])  # the room did not
    # what a refit keeps: the alias table, the areas, the UV density, materials
    for k in ("em_prob", "em_alias", "em_pdf", "em_area", "em_power", "inst_id", "mat_id"):
        assert torch.equal(getattr(got, k), getattr(tdev, k)), k
    keep = [c for c in range(TS.A.WIDTH) if not (TS.A.NG <= c < TS.A.N2 + 3
                                                 or TS.A.TANG <= c < TS.A.TANG + 3)]
    assert torch.equal(got.tri_attrs[:, keep], tdev.tri_attrs[:, keep])


def test_woop_pack_degenerate_triangles_miss():
    """A zero-area triangle gets an all-zero Woop transform (every ray
    misses it), as in the upload and the JAX refit."""
    v0 = torch.tensor([[0.0, 0, 0], [1, 2, 3]])
    e1 = torch.tensor([[1.0, 0, 0], [0, 0, 0]])
    e2 = torch.tensor([[0.0, 1, 0], [0, 0, 0]])
    w = woop_pack(v0, e1, e2).reshape(4, 3, 2)
    assert (w[..., 1] == 0).all() and (w[..., 0] != 0).any()
    np.testing.assert_allclose(w.numpy(), np.asarray(JR.woop_pack(v0.numpy(), e1.numpy(),
                                                                  e2.numpy())).reshape(4, 3, 2))


def _host_walk(scene, cluster_aabb):
    """walk_tree built on the host over ``scene``'s topology (its cluster
    tree, as uploaded) with the cluster boxes ``cluster_aabb``."""
    tree = TB.cluster_tree(scene.cluster_aabb.numpy())
    left, right, cl = tree["tree_left"], tree["tree_right"], tree["tree_cluster"]
    box = cluster_aabb.numpy()
    lo, hi = np.zeros((cl.shape[0], 3), np.float32), np.zeros((cl.shape[0], 3), np.float32)
    for k in range(cl.shape[0] - 1, -1, -1):  # children come after their parent
        if cl[k] >= 0:
            lo[k], hi[k] = box[cl[k], 0:3], box[cl[k], 3:6]
        else:
            lo[k], hi[k] = np.minimum(lo[left[k]], lo[right[k]]), np.maximum(hi[left[k]],
                                                                             hi[right[k]])
    tables = (getattr(scene, k).numpy() for k in ("woop", "v0", "e1", "e2"))
    return TB.walk_tree(TB._tree(box, lo, hi, left, right, cl), scene.cluster_size, *tables)


def test_identity_refit_rebuilds_the_walk_tree_exactly(box):
    """With identity deltas the triangles do not move, so the refit's walk
    nodes are the host build's over the refit cluster boxes bit for bit,
    the sub-trees' rows the upload's; the topology is kept."""
    _, scenes = box
    _, tdev = scenes["clustered"]
    n = int(tdev.inst_id.max()) + 2
    dp = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    got = refit_scene(tdev, dp, np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)))
    assert torch.equal(got.v0, tdev.v0) and torch.equal(got.e1, tdev.e1)
    want = _host_walk(got, got.cluster_aabb)
    np.testing.assert_array_equal(got.walk_nodes.numpy(), want["walk_nodes"])
    np.testing.assert_array_equal(got.walk_nodes[tdev.walk_top:].numpy(),
                                  tdev.walk_nodes[tdev.walk_top:].numpy())
    for k in ("leaf_slot", "walk_span", "walk_cluster_order"):
        assert torch.equal(getattr(got, k), getattr(tdev, k)), k
    assert got.walk_stack == tdev.walk_stack and got.walk_top == tdev.walk_top
    np.testing.assert_array_equal(want["leaf_slot"], tdev.leaf_slot.numpy())
    assert tdev.walk_top == tdev.cluster_aabb.shape[0] - 1  # the cluster tree's inner nodes


def _child_boxes(nodes):
    """lo, hi [K, 2, 3] of each node's two children."""
    f = nodes[:, :12].view(np.float32)
    lo = np.stack([np.stack([f[:, 4 * s], f[:, 4 * s + 2], f[:, 8 + 2 * s]], 1) for s in (0, 1)], 1)
    hi = np.stack([np.stack([f[:, 4 * s + 1], f[:, 4 * s + 3], f[:, 9 + 2 * s]], 1)
                   for s in (0, 1)], 1)
    return lo, hi


@pytest.mark.parametrize("t", [0.5, 1.0])
def test_refit_walk_tree_contains_the_moved_triangles(box, t):
    """After a motion: the corners of every leaf triangle (summed in
    float64, as the walk's Woop test sees them) lie strictly inside every
    box above them, the cluster tree's and the sub-tree's; every child box
    lies inside its parent's, exactly within the cluster tree and within
    each sub-tree, and where a sub-tree hangs below its cluster's box within
    the difference of their pads (the two grow by TREE_PAD_REL of
    coordinates a pad apart, as at upload). The upload's boxes do not hold
    the moved block."""
    rig, scenes = box
    _, tdev = scenes["clustered"]
    got = refit_scene(tdev, *rig.deltas(t))
    nodes = got.walk_nodes.numpy()
    lo, hi = _child_boxes(nodes)
    slot = got.leaf_slot.numpy()
    v0 = got.v0.numpy().astype(np.float64)
    corners = np.stack([v0, v0 + got.e1.numpy(), v0 + got.e2.numpy()])[:, slot]  # [3, R, 3]
    top = got.walk_top
    scale = float(np.abs(got.cluster_aabb[:, :6].numpy()).max())
    slack = 2 * TB.TREE_PAD_REL * TB.TREE_PAD_REL * scale + np.spacing(np.float32(scale))
    seen = np.zeros(slot.shape[0], bool)

    def visit(ref, lo_up, hi_up):
        """Check the rows below ``ref`` against every box above them."""
        if ref < 0:
            first, count = (~ref) >> 4, (~ref) & 15
            pts = corners[:, first : first + count].reshape(-1, 3)
            assert (pts > lo_up).all() and (pts < hi_up).all()
            seen[first : first + count] = True
            return
        for side in (0, 1):
            b_lo, b_hi = lo[ref, side], hi[ref, side]
            visit(int(nodes[ref, 12 + side]), np.maximum(lo_up, b_lo), np.minimum(hi_up, b_hi))

    visit(0, np.full(3, -np.inf), np.full(3, np.inf))
    assert seen.all()
    for k in range(nodes.shape[0]):
        for side in (0, 1):
            r = int(nodes[k, 12 + side])
            if r < 0:
                continue
            tol = slack if (k < top) != (r < top) else 0.0
            assert (lo[r] >= lo[k, side] - tol).all() and (hi[r] <= hi[k, side] + tol).all()
    stale_lo, stale_hi = _child_boxes(tdev.walk_nodes.numpy())
    assert not all((stale_lo[k] <= lo[k]).all() and (stale_hi[k] >= hi[k]).all()
                   for k in range(nodes.shape[0]))


def test_host_walks_on_the_refit_tree_match_plain(box, host_kernels):
    """B8 and B9 built for the host, walking the refit tree, equal their
    plain versions (the dense sweep over the refit Woop rows) on camera-like
    rays and shadow segments; walking the upload's boxes over the moved
    rows instead loses hits."""
    from tests.test_torch_intersect import _camera_rays

    rig, scenes = box
    _, tdev = scenes["clustered"]
    got = refit_scene(tdev, *rig.deltas(1.0))
    o, d = (torch.from_numpy(np.ascontiguousarray(x)) for x in _camera_rays(24))
    o2, seg, d2 = _segments(8, 400)
    t_p, tri_p = ST.stream_closest_plain(got, o, d)
    t_k, tri_k = host_stream_closest(got, o, d)
    assert torch.equal(tri_k, tri_p) and torch.equal(t_k, t_p)
    moved = (got.inst_id[tri_p.clamp_min(0).long()] == 1) & (tri_p >= 0)
    assert moved.sum() > 20  # the block moved where the rays find it
    for dirs, t_max in ((seg, 1.0 - 1e-3), (d2, 1e30)):
        want = ST.occlusion_stream_plain(got, o2, dirs, 1e-3, t_max)
        assert torch.equal(host_stream_occlusion(got, o2, dirs, 1e-3, t_max), want)
        assert 0 < want.sum() < want.numel()
    from dataclasses import replace

    stale = replace(got, walk_nodes=tdev.walk_nodes)
    _, tri_s = host_stream_closest(stale, o, d)
    assert not torch.equal(tri_s, tri_p)


def test_refit_gives_a_new_scene_with_fresh_row_caches(box):
    """The refit leaves the uploaded scene and its cached rows as they
    were; the new scene's rows are its own Woop table's."""
    rig, scenes = box
    _, tdev = scenes["clustered"]
    before = tdev.leaf_rows().clone()
    got = refit_scene(tdev, *rig.deltas(0.5))
    assert torch.equal(tdev.leaf_rows(), before)
    assert torch.equal(got.leaf_rows(), got.woop_rows()[got.leaf_slot.long()])
    assert not torch.equal(got.leaf_rows(), before)
    assert got.alpha_tex is None and got.has_cutout is False
