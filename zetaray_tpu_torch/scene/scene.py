"""Flattened scene arrays and their upload to tensors.

The counterpart of the JAX package's ``scene/scene.py`` (glass and coated
materials included: ``has_transmission`` and ``has_coat`` are computed from
the materials; MASK-mode materials get the alpha atlas ``alpha_tex`` and
``has_cutout``): the same ``CpuScene`` field
names on the host and the same table layouts on the device -- Woop
unit-triangle transforms ``[4, 3*Tp]``, the per-triangle attribute table
``A`` and the emissive table ``EA``, with the triangle and emissive counts
padded to multiples of 128 exactly as the JAX package pads them, so the two
uploads agree entry for entry.

Above ``CLUSTER_THRESHOLD`` triangles the upload is clustered as in the JAX
package: the triangles are reordered into BVH leaves of ``CLUSTER_SIZE``
slots (cluster k owns slots ``[k*C, (k+1)*C)`` of every table), and the
scene carries the cluster boxes, the traversal tree over them that the
any-hit kernel B9 walks, and the tree that the closest-hit kernel B8 walks:
the same tree with a sub-tree of small leaves over each cluster's real
slots (``accel.bvh``, ``accel.stream``). The JAX package's
TPU-only stream layouts (``woop_stream``, ``stream_attrs``) and its
two-phase distance cap (``stream_tcap``) have no counterpart.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from .. import native
from ..core import transforms as T
from ..core.sampling import build_alias_table
from ..utils.stats import spanned
from .gltf import GltfDoc, GltfMaterial, load_gltf
from .light_build import emissive_powers

LANE = 128
# Scenes above CLUSTER_THRESHOLD triangles are reordered into BVH-leaf
# clusters of CLUSTER_SIZE slots for the streaming traversal (accel.stream).
CLUSTER_SIZE = 256
CLUSTER_THRESHOLD = 8192
ALPHA_RES = 256  # the alpha atlas's resolution


@dataclass
class MaterialsSoA:
    base_color: np.ndarray  # [M, 3]
    metallic: np.ndarray  # [M]
    roughness: np.ndarray  # [M]
    emissive: np.ndarray  # [M, 3] factor * strength
    ior: np.ndarray  # [M]
    transmission: np.ndarray  # [M]
    coat_weight: np.ndarray  # [M]
    coat_roughness: np.ndarray  # [M]
    double_sided: np.ndarray  # [M] bool
    base_color_tex: np.ndarray  # [M] int32, -1 = none
    normal_tex: np.ndarray | None = None
    metallic_roughness_tex: np.ndarray | None = None
    emissive_tex: np.ndarray | None = None
    alpha_cutoff: np.ndarray | None = None  # [M]; > 0 only for MASK mode


@dataclass
class CpuScene:
    """Host-side flattened world-space triangle soup."""

    v0: np.ndarray  # [T, 3]
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray  # [T, 3] vertex normals
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # [T, 2]
    uv1: np.ndarray
    uv2: np.ndarray
    mat_id: np.ndarray  # [T] int32
    materials: MaterialsSoA
    emissive_tris: np.ndarray  # [E] int32
    inst_id: np.ndarray | None = None  # [T] int32
    inst_names: list | None = None
    texture_paths: list | None = None

    def __post_init__(self):
        if self.inst_id is None:
            self.inst_id = np.zeros(self.v0.shape[0], np.int32)
        if self.inst_names is None:
            self.inst_names = ["<anon>"]

    @property
    def num_tris(self) -> int:
        return int(self.v0.shape[0])

    def geometric_normals(self) -> np.ndarray:
        n = np.cross(self.v1 - self.v0, self.v2 - self.v0)
        l = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(l, 1e-20)

    def areas(self) -> np.ndarray:
        return 0.5 * np.linalg.norm(np.cross(self.v1 - self.v0, self.v2 - self.v0), axis=-1)

    def aabb(self):
        lo = np.minimum(np.minimum(self.v0.min(0), self.v1.min(0)), self.v2.min(0))
        hi = np.maximum(np.maximum(self.v0.max(0), self.v1.max(0)), self.v2.max(0))
        return lo, hi


_DEFAULT_MATERIAL = GltfMaterial(name="__default", metallic=0.0, roughness=1.0)


def _materials_soa(mats: list[GltfMaterial]) -> MaterialsSoA:
    """glTF materials -> the material table (the default one if none)."""
    if not mats:
        mats = [_DEFAULT_MATERIAL]
    return MaterialsSoA(
        base_color=np.stack([m.base_color[:3] for m in mats]).astype(np.float32),
        metallic=np.array([m.metallic for m in mats], np.float32),
        roughness=np.array([m.roughness for m in mats], np.float32),
        emissive=np.stack([m.emissive_factor * m.emissive_strength for m in mats]
                          ).astype(np.float32),
        ior=np.array([m.ior for m in mats], np.float32),
        transmission=np.array([m.transmission for m in mats], np.float32),
        coat_weight=np.array([m.coat_weight for m in mats], np.float32),
        coat_roughness=np.array([m.coat_roughness for m in mats], np.float32),
        double_sided=np.array([m.double_sided for m in mats], bool),
        base_color_tex=np.array([m.base_color_tex for m in mats], np.int32),
        normal_tex=np.array([m.normal_tex for m in mats], np.int32),
        metallic_roughness_tex=np.array([m.metallic_roughness_tex for m in mats], np.int32),
        emissive_tex=np.array([m.emissive_tex for m in mats], np.int32),
        alpha_cutoff=np.array([m.alpha_cutoff if m.alpha_mode == "MASK" else 0.0 for m in mats],
                              np.float32),
    )


# Held around the BLAS calls of ``_flatten_prim``: numpy's OpenBLAS (0.3.27
# on the hosts measured) now and then returns another product when threads
# call its dgemm while others run numpy work, so ``load_scene``'s workers
# take turns there (the products are tiny; the gathers run in parallel).
_BLAS = threading.Lock()


def _flatten_prim(world, nrm_m, inst_idx, prim):
    """One primitive -> its world-space triangle corners, normals, uvs,
    material and instance ids (geometric normals where it has none)."""
    with _BLAS:
        pos = T.transform_points(world, prim.positions.astype(np.float64))
        nrm = None if prim.normals is None else prim.normals.astype(np.float64) @ nrm_m.T
    idx = prim.indices.reshape(-1, 3).astype(np.int64)
    if nrm is not None:
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
    if nrm is not None:
        n0, n1, n2 = nrm[a], nrm[b], nrm[c]
    else:
        g = np.cross(pos[b] - pos[a], pos[c] - pos[a])
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-20)
        n0 = n1 = n2 = g
    if prim.uvs is not None:
        uv0, uv1, uv2 = prim.uvs[a], prim.uvs[b], prim.uvs[c]
    else:
        uv0 = uv1 = uv2 = np.zeros((idx.shape[0], 2), np.float32)
    mid = prim.material if prim.material >= 0 else 0
    return (pos[a], pos[b], pos[c], n0, n1, n2, uv0, uv1, uv2,
            np.full(idx.shape[0], mid, np.int32), np.full(idx.shape[0], inst_idx, np.int32))


@spanned("setup:load_scene")
def load_scene(path, workers: int = 4) -> CpuScene:
    """A glTF file (or an already parsed ``GltfDoc``, as when an
    ``AnimationRig`` is built from the same document) -> the flattened
    world-space ``CpuScene``, as the JAX ``load_scene``: the primitives of
    each instance in document order (flattened on ``workers`` threads,
    concatenated in submission order), normals round-tripped through oct16
    and uvs through half2 (``packed``), ``inst_id`` the instance of each
    triangle. PNG maps in ``texture_paths`` feed
    ``textures.load_scene_textures``."""
    from concurrent.futures import ThreadPoolExecutor

    from .packed import quantize_normals, quantize_uvs

    doc = path if isinstance(path, GltfDoc) else load_gltf(path)
    mats = list(doc.materials) if doc.materials else [_DEFAULT_MATERIAL]
    inst_names, tasks = [], []
    for inst_idx, inst in enumerate(doc.instances):
        inst_names.append(inst.name)
        nrm_m = T.normal_matrix(inst.world)
        tasks += [(inst.world, nrm_m, inst_idx, prim) for prim in inst.mesh_prims]
    if workers > 1 and len(tasks) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            flat = list(ex.map(lambda t: _flatten_prim(*t), tasks))
    else:
        flat = [_flatten_prim(*t) for t in tasks]
    v0s, v1s, v2s, n0s, n1s, n2s, uv0s, uv1s, uv2s, mids, iids = (
        [f[i] for f in flat] for i in range(11))
    cat = lambda xs, dt=np.float32: np.concatenate(xs).astype(dt)
    mat_id = cat(mids, np.int32)
    materials = _materials_soa(mats)
    em_mask = materials.emissive[mat_id].max(axis=-1) > 0.0
    qn = lambda xs: quantize_normals(cat(xs))
    qu = lambda xs: quantize_uvs(cat(xs))
    return CpuScene(
        v0=cat(v0s), v1=cat(v1s), v2=cat(v2s),
        n0=qn(n0s), n1=qn(n1s), n2=qn(n2s),
        uv0=qu(uv0s), uv1=qu(uv1s), uv2=qu(uv2s),
        mat_id=mat_id, inst_id=cat(iids, np.int32), inst_names=inst_names,
        texture_paths=doc.textures, materials=materials,
        emissive_tris=np.nonzero(em_mask)[0].astype(np.int32),
    )


class A:
    """Per-triangle attribute table columns (tri_attrs [Tp, A.WIDTH])."""

    NG = 0
    N0 = 3
    N1 = 6
    N2 = 9
    UV0 = 12
    UV1 = 14
    UV2 = 16
    BASE = 18
    METAL = 21
    ROUGH = 22
    EMISS = 23
    IOR = 26
    TRANS = 27
    DOUBLE = 28
    MATID = 29
    EM_PDF_AREA = 30
    TEXID = 31
    COATW = 32
    COATR = 33
    TANG = 34
    UVDENS = 37
    ACUT = 38
    ATEX = 39
    INSTID = 40
    WIDTH = 48


class EA:
    """Emissive table columns (em_attrs [Ep, EA.WIDTH])."""

    V0 = 0
    E1 = 3
    E2 = 6
    NG = 9
    LE = 12
    PDF_AREA = 15
    TWO_SIDED = 16
    WIDTH = 24


@dataclass(frozen=True)
class SceneBuffers:
    """Device-side scene, the JAX ``SceneBuffers`` without its TPU-only
    stream layouts. The cluster fields are None on a dense scene;
    ``alpha_tex`` is None unless ``has_cutout``."""

    woop: torch.Tensor  # [4, 3*Tp] float32
    tri_attrs: torch.Tensor  # [Tp, A.WIDTH]
    em_attrs: torch.Tensor  # [Ep, EA.WIDTH]
    v0: torch.Tensor  # [Tp, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    ng: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # [Tp, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor  # [Tp] int32
    inst_id: torch.Tensor  # [Tp] int32
    num_tris: int
    mat_base_color: torch.Tensor
    mat_metallic: torch.Tensor
    mat_roughness: torch.Tensor
    mat_emissive: torch.Tensor
    mat_ior: torch.Tensor
    mat_transmission: torch.Tensor
    mat_coat_weight: torch.Tensor
    mat_coat_roughness: torch.Tensor
    mat_double_sided: torch.Tensor  # [M] bool
    em_tri: torch.Tensor  # [Ep] int32
    em_prob: torch.Tensor
    em_alias: torch.Tensor  # [Ep] int32
    em_pdf: torch.Tensor
    em_area: torch.Tensor
    em_of_tri: torch.Tensor  # [Tp] int32
    em_power: torch.Tensor  # scalar
    num_emissives: int
    has_transmission: bool
    has_coat: bool
    has_cutout: bool
    world_lo: torch.Tensor  # [3]
    world_hi: torch.Tensor
    cluster_aabb: torch.Tensor | None = None  # [M, 8] lo.xyz, hi.xyz, pad
    cluster_size: int | None = None  # C: cluster k owns slots [k*C, (k+1)*C)
    # the tree B8 and B9 walk (accel.bvh.walk_tree): the tree over the clusters
    # with a sub-tree over each cluster's real slots below it
    walk_nodes: torch.Tensor | None = None  # [K, 16] int32, one node a row
    leaf_slot: torch.Tensor | None = None  # [R] int32 the slot of each leaf-ordered row
    walk_stack: int | None = None  # the most stack entries a walk can need
    # what refit.refit_scene recomputes the walk's boxes from (accel.bvh.walk_tree):
    # each child's span, of walk_cluster_order in the first walk_top nodes, else of rows
    walk_span: torch.Tensor | None = None  # [K, 4] int32 (a0, b0, a1, b1)
    walk_top: int | None = None
    walk_cluster_order: torch.Tensor | None = None  # [M] int32
    # the alpha atlas of the MASK-mode materials' base-colour maps [K, ALPHA_RES,
    # ALPHA_RES] (level 0's alpha, nearest resample); A.ATEX is a triangle's layer
    alpha_tex: torch.Tensor | None = None
    # woop_rows()'s and leaf_rows()'s caches: (woop's version counter, the rows)
    _woop_rows: tuple | None = field(default=None, init=False, repr=False, compare=False)
    _leaf_rows: tuple | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.woop.device

    def woop_rows(self) -> torch.Tensor:
        """``woop`` [4, 3*Tp] triangle by triangle, [Tp, 12]: per triangle the
        w, u and v rows of its Woop transform, each as (x, y, z, translation).
        The table that the sweep of kernels B3, B6 and B7 stages. Made at first
        use, and made again whenever ``woop`` was changed in place (its
        version counter moved), so the two tables never disagree; a write
        through a raw pointer does not move the counter."""
        return self._rows_cached("_woop_rows", None)

    def leaf_rows(self) -> torch.Tensor:
        """The rows of ``woop_rows()`` of the slots ``leaf_slot``, in leaf
        order, [R, 12]: the table kernels B8 and B9 read, gathered from
        ``woop`` (no dense copy is made), at first use and again whenever
        ``woop`` was changed in place. Only the rows follow ``woop``: the
        tree's boxes (``walk_nodes``) follow the triangles through
        ``refit.refit_scene``, which returns a new scene with them
        recomputed; its topology (``leaf_slot``, the refs, ``walk_stack``)
        is the upload's, so an edit that makes a pad slot real needs a
        fresh upload."""
        return self._rows_cached("_leaf_rows", self.leaf_slot.long())

    def _rows_cached(self, name: str, slots):
        cached = getattr(self, name)
        version = self.woop._version
        if cached is None or cached[0] != version:
            w = self.woop.reshape(4, 3, -1)[:, [2, 0, 1]]
            if slots is not None:
                w = w[:, :, slots]
            rows = w.permute(2, 1, 0).reshape(-1, 12).contiguous()
            object.__setattr__(self, name, (version, rows))
            cached = (version, rows)
        return cached[1]


def _woop_matrices(v0, v1, v2) -> np.ndarray:
    """World -> unit-triangle affine transforms packed [4, 3T] (see JAX)."""
    t = v0.shape[0]
    e1 = (v1 - v0).astype(np.float64)
    e2 = (v2 - v0).astype(np.float64)
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)
    dets = np.linalg.det(m)
    good = np.abs(dets) > 1e-18
    w = np.zeros((t, 3, 4), np.float64)
    if good.any():
        inv = np.linalg.inv(m[good])
        w[good, :, :3] = inv
        w[good, :, 3] = -np.einsum("tij,tj->ti", inv, v0[good].astype(np.float64))
    out = np.zeros((4, 3 * t), np.float32)
    for r in range(3):
        out[:, r * t : (r + 1) * t] = w[:, r, :].T.astype(np.float32)
    return out


def _pad_to(x: np.ndarray, n: int, value=0):
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), constant_values=value)


def _tangents_and_uv_density(cpu: CpuScene):
    """Per-triangle tangent (+u direction) and sqrt(uv area / world area)."""
    e1 = (cpu.v1 - cpu.v0).astype(np.float64)
    e2 = (cpu.v2 - cpu.v0).astype(np.float64)
    du1 = (cpu.uv1[:, 0] - cpu.uv0[:, 0]).astype(np.float64)
    dv1 = (cpu.uv1[:, 1] - cpu.uv0[:, 1]).astype(np.float64)
    du2 = (cpu.uv2[:, 0] - cpu.uv0[:, 0]).astype(np.float64)
    dv2 = (cpu.uv2[:, 1] - cpu.uv0[:, 1]).astype(np.float64)
    det = du1 * dv2 - du2 * dv1
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tang = (e1 * dv2[:, None] - e2 * dv1[:, None]) * inv[:, None]
    ng = np.cross(e1, e2)
    ng_l = np.linalg.norm(ng, axis=-1, keepdims=True)
    ng_u = ng / np.maximum(ng_l, 1e-20)
    alt = np.cross(ng_u, np.where(np.abs(ng_u[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]]))
    tang = np.where(ok[:, None], tang, alt)
    tang -= ng_u * np.sum(tang * ng_u, -1, keepdims=True)
    tl = np.linalg.norm(tang, axis=-1, keepdims=True)
    tang = np.where(tl > 1e-12, tang / np.maximum(tl, 1e-20), alt)
    world_area = 0.5 * ng_l[:, 0]
    uv_area = 0.5 * np.abs(det)
    uvdens = np.sqrt(uv_area / np.maximum(world_area, 1e-20))
    return tang.astype(np.float32), uvdens.astype(np.float32)


def _clusterize(cpu: CpuScene, c: int):
    """Reorder triangles into BVH-leaf clusters padded to ``c`` slots, as the
    JAX package does. Returns (the cluster-ordered CpuScene with degenerate
    pad triangles, cluster boxes [M, 8]). Cluster k is the k-th leaf in node
    order (``BVH.leaves``), not in the order of the leaves' first slots.
    Pad slots are zero-area triangles collapsed onto a vertex of their own
    cluster (every ray misses them, and the box does not grow), and are never
    emissive."""
    from ..accel.bvh import build_bvh

    bvh = build_bvh(cpu.v0, cpu.v1, cpu.v2, leaf_size=c)
    lo, hi, first, count = bvh.cluster_aabbs()
    m = lo.shape[0]
    t = cpu.num_tris
    slot_src = np.full(m * c, -1, np.int64)
    for k in range(m):
        slot_src[k * c : k * c + count[k]] = bvh.perm[first[k] : first[k] + count[k]]
    valid = slot_src >= 0

    def take(x, fill=0):
        out = np.full((m * c,) + x.shape[1:], fill, x.dtype)
        out[valid] = x[slot_src[valid]]
        return out

    inv = np.full(t, -1, np.int64)
    inv[slot_src[valid]] = np.nonzero(valid)[0]
    # slot k*c is always valid: leaves fill from the front and hold >= 1 triangle
    v0n, v1n, v2n = take(cpu.v0), take(cpu.v1), take(cpu.v2)
    fill = v0n[(np.arange(m * c) // c) * c]
    v0n[~valid] = fill[~valid]
    v1n[~valid] = fill[~valid]
    v2n[~valid] = fill[~valid]
    new = CpuScene(
        v0=v0n, v1=v1n, v2=v2n,
        n0=take(cpu.n0), n1=take(cpu.n1), n2=take(cpu.n2),
        uv0=take(cpu.uv0), uv1=take(cpu.uv1), uv2=take(cpu.uv2),
        mat_id=take(cpu.mat_id),
        inst_id=take(cpu.inst_id, fill=-1),
        inst_names=cpu.inst_names,
        texture_paths=cpu.texture_paths,
        materials=cpu.materials,
        emissive_tris=inv[cpu.emissive_tris].astype(np.int32),
    )
    aabb = np.zeros((m, 8), np.float32)
    aabb[:, 0:3] = lo
    aabb[:, 3:6] = hi
    return new, aabb


def _build_alpha_atlas(cpu: CpuScene):
    """The alpha atlas of the MASK-mode materials (cutoff > 0) that have a
    base-colour map: (atlas [K, ALPHA_RES, ALPHA_RES] float32 or None, the
    atlas layer of each material [M] int32, -1 for none). A layer is level
    0's alpha resampled to the nearest texel; materials that share a map
    share its layer."""
    from .textures import load_texture

    mats = cpu.materials
    n_mats = len(mats.metallic)
    slot_of_mat = np.full(n_mats, -1, np.int32)
    cutoffs = mats.alpha_cutoff
    if cutoffs is None or not (np.asarray(cutoffs) > 0).any():
        return None, slot_of_mat
    paths = cpu.texture_paths or []
    layers, slot_of_tex = [], {}
    for m in range(n_mats):
        if cutoffs[m] <= 0:
            continue
        ti = int(mats.base_color_tex[m])
        if ti < 0 or ti >= len(paths) or not paths[ti]:
            continue
        if ti not in slot_of_tex:
            mips = load_texture(paths[ti], srgb=True)
            if mips is None:
                continue
            a = np.asarray(mips[0][..., 3], np.float32)
            ys = (np.arange(ALPHA_RES) * a.shape[0] // ALPHA_RES).clip(0, a.shape[0] - 1)
            xs = (np.arange(ALPHA_RES) * a.shape[1] // ALPHA_RES).clip(0, a.shape[1] - 1)
            slot_of_tex[ti] = len(layers)
            layers.append(a[np.ix_(ys, xs)])
        slot_of_mat[m] = slot_of_tex[ti]
    if not layers:
        return None, slot_of_mat
    return np.stack(layers).astype(np.float32), slot_of_mat


def upload_scene_arrays(cpu: CpuScene, cluster_size: int | None = None) -> dict:
    """CpuScene -> dict of padded numpy tables (the SceneBuffers fields but
    the traversal tree, which ``buffers_from_arrays`` builds).
    ``cluster_size``: None clusters above ``CLUSTER_THRESHOLD`` triangles,
    0 never clusters, C > 0 (a multiple of 128, so that the clusters fill
    the padded tables) always clusters C slots to a cluster."""
    if cluster_size is None:
        cluster_size = CLUSTER_SIZE if cpu.num_tris > CLUSTER_THRESHOLD else 0
    if cluster_size % LANE or cluster_size < 0:
        raise ValueError(f"cluster_size={cluster_size} is not a multiple of {LANE}")
    cluster_aabb = None
    if cluster_size:
        cpu, cluster_aabb = _clusterize(cpu, cluster_size)
    lane = LANE
    t = cpu.num_tris
    tp = max(lane, ((t + lane - 1) // lane) * lane)
    v0 = _pad_to(cpu.v0, tp)
    v1 = _pad_to(cpu.v1, tp)
    v2 = _pad_to(cpu.v2, tp)
    woop = _woop_matrices(v0, v1, v2)
    ng = np.zeros((tp, 3), np.float32)
    ng[:t] = cpu.geometric_normals()

    em = cpu.emissive_tris
    e = em.shape[0]
    ep = max(lane, ((e + lane - 1) // lane) * lane)
    if e > 0:
        powers = emissive_powers(cpu)
        prob, alias, pdf = build_alias_table(powers)
        total_power = float(powers.sum())
        em_area = cpu.areas()[em].astype(np.float32)
    else:
        prob = np.ones(0, np.float32)
        alias = np.zeros(0, np.int32)
        pdf = np.zeros(0, np.float32)
        em_area = np.zeros(0, np.float32)
        total_power = 0.0
    em_of_tri = np.full(tp, -1, np.int32)
    em_of_tri[em] = np.arange(e, dtype=np.int32)

    mats = cpu.materials
    mid = cpu.mat_id
    attrs = np.zeros((tp, A.WIDTH), np.float32)
    attrs[:t, A.NG : A.NG + 3] = ng[:t]
    attrs[:t, A.N0 : A.N0 + 3] = cpu.n0
    attrs[:t, A.N1 : A.N1 + 3] = cpu.n1
    attrs[:t, A.N2 : A.N2 + 3] = cpu.n2
    attrs[:t, A.UV0 : A.UV0 + 2] = cpu.uv0
    attrs[:t, A.UV1 : A.UV1 + 2] = cpu.uv1
    attrs[:t, A.UV2 : A.UV2 + 2] = cpu.uv2
    attrs[:t, A.BASE : A.BASE + 3] = mats.base_color[mid]
    attrs[:t, A.METAL] = mats.metallic[mid]
    attrs[:t, A.ROUGH] = mats.roughness[mid]
    attrs[:t, A.EMISS : A.EMISS + 3] = mats.emissive[mid]
    attrs[:t, A.IOR] = mats.ior[mid]
    attrs[:t, A.TRANS] = mats.transmission[mid]
    attrs[:t, A.DOUBLE] = mats.double_sided[mid].astype(np.float32)
    attrs[:t, A.MATID] = mid.astype(np.float32)
    attrs[:t, A.TEXID] = mats.base_color_tex[mid].astype(np.float32)
    attrs[:t, A.COATW] = mats.coat_weight[mid]
    attrs[:t, A.COATR] = mats.coat_roughness[mid]
    tang, uvdens = _tangents_and_uv_density(cpu)
    attrs[:t, A.TANG : A.TANG + 3] = tang
    attrs[:t, A.UVDENS] = uvdens
    alpha_atlas, alpha_slot = _build_alpha_atlas(cpu)
    if mats.alpha_cutoff is not None:
        attrs[:t, A.ACUT] = np.where(alpha_slot[mid] >= 0, mats.alpha_cutoff[mid], 0.0)
    attrs[:t, A.ATEX] = alpha_slot[mid].astype(np.float32)
    attrs[:, A.INSTID] = -1.0
    attrs[:t, A.INSTID] = cpu.inst_id[:t].astype(np.float32)
    em_attrs = np.zeros((ep, EA.WIDTH), np.float32)
    if e > 0:
        attrs[em, A.EM_PDF_AREA] = pdf / np.maximum(em_area, 1e-12)
        em_attrs[:e, EA.V0 : EA.V0 + 3] = v0[em]
        em_attrs[:e, EA.E1 : EA.E1 + 3] = (v1 - v0)[em]
        em_attrs[:e, EA.E2 : EA.E2 + 3] = (v2 - v0)[em]
        em_attrs[:e, EA.NG : EA.NG + 3] = ng[em]
        em_attrs[:e, EA.LE : EA.LE + 3] = mats.emissive[mid[em]]
        em_attrs[:e, EA.PDF_AREA] = pdf / np.maximum(em_area, 1e-12)
        em_attrs[:e, EA.TWO_SIDED] = mats.double_sided[mid[em]].astype(np.float32)

    lo, hi = cpu.aabb()
    return dict(
        woop=woop, tri_attrs=attrs, em_attrs=em_attrs,
        v0=v0, e1=v1 - v0, e2=v2 - v0, ng=ng,
        n0=_pad_to(cpu.n0, tp), n1=_pad_to(cpu.n1, tp), n2=_pad_to(cpu.n2, tp),
        uv0=_pad_to(cpu.uv0, tp), uv1=_pad_to(cpu.uv1, tp), uv2=_pad_to(cpu.uv2, tp),
        mat_id=_pad_to(cpu.mat_id, tp), inst_id=_pad_to(cpu.inst_id, tp, value=-1),
        num_tris=t,
        mat_base_color=mats.base_color, mat_metallic=mats.metallic,
        mat_roughness=mats.roughness, mat_emissive=mats.emissive,
        mat_ior=mats.ior, mat_transmission=mats.transmission,
        mat_coat_weight=mats.coat_weight, mat_coat_roughness=mats.coat_roughness,
        mat_double_sided=mats.double_sided,
        em_tri=_pad_to(em, ep, value=-1), em_prob=_pad_to(prob, ep),
        em_alias=_pad_to(alias, ep), em_pdf=_pad_to(pdf, ep),
        em_area=_pad_to(em_area, ep, value=1.0), em_of_tri=em_of_tri,
        em_power=np.asarray(total_power, np.float32), num_emissives=e,
        has_transmission=bool((mats.transmission > 0).any()),
        has_coat=bool((mats.coat_weight > 0).any()), has_cutout=alpha_atlas is not None,
        alpha_tex=alpha_atlas,
        world_lo=np.asarray(lo, np.float32), world_hi=np.asarray(hi, np.float32),
        cluster_aabb=cluster_aabb,
    )


def buffers_from_arrays(d: dict, device=None) -> SceneBuffers:
    """Dict of SceneBuffers fields (numpy or scalars) -> SceneBuffers on
    ``device`` (default: the card; ``native.default_device``). Where
    ``cluster_aabb`` is given, the cluster size and the walks' tree are
    derived from it, the Woop table and ``v0``/``e1``/``e2``."""
    from ..accel.bvh import cluster_tree, walk_tree

    device = native.default_device(device)
    d = dict(d)
    if d.get("has_cutout") and d.get("alpha_tex") is None:
        raise ValueError("has_cutout without an alpha atlas (alpha_tex): the cutout re-trace "
                         "has nothing to test the hits' alpha against")
    if d.get("cluster_aabb") is not None:
        m = np.asarray(d["cluster_aabb"]).shape[0]
        tp = np.asarray(d["woop"]).shape[1] // 3
        if tp % m:
            raise ValueError(f"{tp} triangle slots do not split into {m} clusters")
        d.update(walk_tree(cluster_tree(d["cluster_aabb"]), tp // m,
                           *(np.asarray(d[k]) for k in ("woop", "v0", "e1", "e2"))),
                 cluster_size=tp // m)
    kw = {}
    for f in fields(SceneBuffers):
        if not f.init:
            continue
        v = d.get(f.name) if f.default is None else d[f.name]
        if v is None:
            kw[f.name] = None
        elif f.name in ("num_tris", "num_emissives", "cluster_size", "walk_stack", "walk_top"):
            kw[f.name] = int(v)
        elif f.name.startswith("has_"):
            kw[f.name] = bool(v)
        else:
            kw[f.name] = torch.from_numpy(np.array(v)).to(device)
    return SceneBuffers(**kw)


def with_cluster_tree(scene: SceneBuffers, tree: dict) -> SceneBuffers:
    """``scene`` (clustered) with the walks' tree rebuilt over ``tree`` as its
    clusters' tree, in the form of ``accel.bvh.cluster_tree``
    (``accel.bvh.chain_tree`` is the deepest)."""
    from ..accel.bvh import walk_tree

    host = lambda k: getattr(scene, k).cpu().numpy()
    walk = walk_tree(tree, scene.cluster_size, *(host(k) for k in ("woop", "v0", "e1", "e2")))
    ints = {k: walk.pop(k) for k in ("walk_stack", "walk_top")}
    tables = {k: torch.from_numpy(np.asarray(v)).to(scene.device) for k, v in walk.items()}
    return replace(scene, **ints, **tables)


@spanned("setup:upload_scene")
def upload_scene(cpu: CpuScene, device=None, cluster_size: int | None = None) -> SceneBuffers:
    """CpuScene -> SceneBuffers on ``device``. The default is the card;
    without CUDA it raises unless ``device="cpu"`` is named.
    ``cluster_size`` as in the JAX package: None clusters automatically
    above ``CLUSTER_THRESHOLD`` triangles, 0 never clusters, C > 0 (a
    multiple of 128) forces clusters of C slots."""
    return buffers_from_arrays(upload_scene_arrays(cpu, cluster_size), device)
