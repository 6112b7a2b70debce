"""Occlusion (B3) and G-buffer (B1) of the PyTorch port against the JAX kernels.

On the CPU the port runs each kernel's plain PyTorch version; it is held
against the Pallas kernel in interpret mode and the jnp intersector
(tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions on the card).
"""

import dataclasses
import inspect
import math
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.intersect import intersect_any
from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.accel.megakernel import G as JG, LSET_ROWS as JLSET_ROWS, gbuffer as jax_gbuffer
from zetaray_tpu.ops import shading_soa as JS
from zetaray_tpu.accel.pallas_kernels import occlusion_pallas
from zetaray_tpu.ops.restir_di import R_ROWS as JR_ROWS
from zetaray_tpu.ops import sky as JSK
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu.scene.scene import A as JA, EA as JEA
from zetaray_tpu_torch import native
from zetaray_tpu_torch.accel import bvh as TB
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.accel import intersect as XI
from zetaray_tpu_torch.accel import stream as ST
from zetaray_tpu_torch.accel.intersect import closest_hit_plain_shaded, occlusion, occlusion_plain
from zetaray_tpu_torch.accel.megakernel import G, gbuffer, gbuffer_plain
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import pick_rt
from zetaray_tpu_torch.scene.procedural import (
    CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, SYMMETRIC_ROOM, cornell_box,
)
from zetaray_tpu_torch.scene.scene import upload_scene
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_scene import SCENES, scene_pair

torch.set_num_threads(1)

EXACT_ROWS = [G.VALID, G.MATID, G.INST]


def _random_rays(seed, n=512, spread=4.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _camera_rays(res=32):
    cam = JaxCamera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    o, d = cam.generate_rays(res, res)
    return np.array(o), np.array(d)


def _segment_rays(seed, n=512):
    """Shadow segments from inside the Cornell box toward its light."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-0.95, 0.95, n), r.uniform(0.02, 1.9, n),
                  r.uniform(-0.95, 0.95, n)], -1)
    tgt = np.stack([r.uniform(-0.19, 0.19, n), np.full(n, 1.98),
                    r.uniform(-0.24, 0.24, n)], -1)
    return o.astype(np.float32), (tgt - o).astype(np.float32)


@pytest.mark.parametrize("name,rays,t_min,t_max", [
    ("random300", "random", 1e-3, 3.0),
    ("random300", "random", 1e-4, 3.0e38),
    ("cornell", "segment", 1e-3, 1.0 - 1e-3),
])
def test_occlusion_plain_matches_jax(name, rays, t_min, t_max):
    jdev, tdev = scene_pair(SCENES[name]())
    o, d = _random_rays(8) if rays == "random" else _segment_rays(9)
    got = occlusion_plain(tdev.woop, torch.from_numpy(o), torch.from_numpy(d), t_min, t_max)
    woop3 = jdev.woop.reshape(4, 3, -1)
    want_k = occlusion_pallas(woop3, jnp.asarray(o), jnp.asarray(d), t_min=t_min,
                              t_max=t_max, interpret=True)
    want_j = intersect_any(jdev, jnp.asarray(o), jnp.asarray(d), t_min=t_min, t_max=t_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_j))
    assert 0 < got.sum() < got.numel()
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        occlusion(tdev, torch.from_numpy(o), torch.from_numpy(d), t_min, t_max).numpy(),
        got.numpy())


@pytest.mark.parametrize("name,rays", [("cornell", "camera"), ("random300", "random")])
def test_gbuffer_plain_matches_jax(name, rays):
    jdev, tdev = scene_pair(SCENES[name]())
    o, d = _camera_rays() if rays == "camera" else _random_rays(11, n=1024)
    want = np.asarray(jax_gbuffer(jdev, jnp.asarray(o), jnp.asarray(d), interpret=True))
    got = gbuffer_plain(tdev, torch.from_numpy(o), torch.from_numpy(d)).numpy()
    assert got.shape == want.shape == (G.ROWS, o.shape[0])
    assert G.ROWS == JG.ROWS and G.INST == JG.INST
    for r in EXACT_ROWS:
        np.testing.assert_array_equal(got[r], want[r], err_msg=f"row {r}")
    assert 0.2 < got[G.VALID].mean() <= 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        gbuffer(tdev, torch.from_numpy(o), torch.from_numpy(d)).numpy(), got)


def test_gbuffer_tie_rule_across_chunks():
    """Duplicate triangles in one chunk and in a later chunk: the highest
    index of the first chunk that reaches the minimum wins (the JAX rule)."""
    cpu = cornell_box()
    jdev, tdev = scene_pair(_duplicated(cpu))
    o, d = _camera_rays(16)
    want = np.asarray(jax_gbuffer(jdev, jnp.asarray(o), jnp.asarray(d), interpret=True))
    got = gbuffer_plain(tdev, torch.from_numpy(o), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got[G.INST], want[G.INST])
    # copy 1 (same chunk, higher index) beats copy 0; copy 2 (next chunk) never wins
    hit = got[G.VALID] > 0.5
    assert set(np.unique(got[G.INST][hit])) == {1.0}


def _duplicated(cpu):
    """Three copies of the 36-triangle box: copies 0 and 1 share the first
    128-triangle chunk, copy 2 starts at 128; instance id = copy index."""
    import dataclasses

    t = cpu.num_tris
    pad = 128 - 2 * t

    def rep(a, fill=None):
        gap = np.repeat(a[:1], pad, 0) if fill is None else np.full((pad,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, a, gap, a])

    tiny = lambda a: np.concatenate([a, a, np.repeat(a[:1] * 0 + 50.0, pad, 0), a])
    out = dataclasses.replace(
        cpu, v0=tiny(cpu.v0), v1=tiny(cpu.v1), v2=tiny(cpu.v2),
        n0=rep(cpu.n0), n1=rep(cpu.n1), n2=rep(cpu.n2),
        uv0=rep(cpu.uv0), uv1=rep(cpu.uv1), uv2=rep(cpu.uv2),
        mat_id=rep(cpu.mat_id), inst_id=np.concatenate([
            np.zeros(t, np.int32), np.ones(t, np.int32), np.full(pad, 3, np.int32),
            np.full(t, 2, np.int32)]),
        emissive_tris=cpu.emissive_tris,
    )
    return out


def _edge_margin(cpu, o, d):
    """Float64 Moller-Trumbore: the smallest distance, in barycentrics, from
    the ray's crossing of any triangle plane ahead of it to that triangle's
    edge (0 means the ray passes exactly through an edge)."""
    v0, v1, v2 = (a.astype(np.float64) for a in (cpu.v0, cpu.v1, cpu.v2))
    e1, e2 = v1 - v0, v2 - v0
    o, d = o.astype(np.float64), d.astype(np.float64)
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    s = o - v0
    q = np.cross(s, e1)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (s * p).sum(-1) / det
        v = (d * q).sum(-1) / det
        t = (e2 * q).sum(-1) / det
    m = np.abs(np.minimum(np.minimum(u, v), 1.0 - u - v))
    return m[t > 0].min()


def test_gbuffer_symmetric_box_flips_only_on_edges():
    """On the box that is symmetric about the camera axis, a few camera rays
    pass exactly through an outer edge, where hit or miss is decided by how
    the edge test rounds: XLA fuses its multiply-adds, the port rounds each
    operation; where two walls meet, the same decides which wall is hit.
    Pixels whose VALID, MATID or INST differ stay few, and each lies on an
    edge."""
    cpu = cornell_box(room=SYMMETRIC_ROOM)
    jdev, tdev = scene_pair(cpu)
    o, d = _camera_rays()
    want = np.asarray(jax_gbuffer(jdev, jnp.asarray(o), jnp.asarray(d), interpret=True))
    got = gbuffer_plain(tdev, torch.from_numpy(o), torch.from_numpy(d)).numpy()
    flip = np.nonzero((got[EXACT_ROWS] != want[EXACT_ROWS]).any(0))[0]
    assert len(flip) <= 0.01 * o.shape[0]
    for i in flip:
        assert _edge_margin(cpu, o[i], d[i]) < 1e-9, f"pixel {i} differs away from any edge"


_LAYOUT_NAMES = (r"[AG]_[A-Z0-9_]+|LSET_ROWS|LSET_STAGED|R_ROWS|STATE_ROWS|SURF_ROWS"
                 r"|BOUNCE_BLOCK|BOUNCE_SALT|GGX_[A-Z_]+|WALK_STACK_MAX|TREE_PAD_REL"
                 r"|PATH_OPTS|SKY_[A-Z0-9_]+")


def _header_constants(text):
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (-?\d+);", text)}


def test_kernel_layout_header_matches_the_reference():
    """The kernels' ``layout.h`` is generated from the port's Python layouts,
    and those equal the JAX package's: ``A``, ``EA``, ``G``, ``LSET_ROWS``,
    ``R_ROWS``, ``STATE_ROWS``, ``SURF_ROWS``, the bounce uniforms' salt,
    the WoPS uniforms' salt (0x905A, written into the JAX
    ``bounce_uniforms``; its rows are held bit for bit in
    tests/test_torch_wops.py) and the GGX
    albedo fit, whose coefficients read back as exactly the JAX package's
    Python floats, and the closed-form sky's fixed parameters (``SKY_*``),
    the float32 values of the JAX ``ops/sky.py`` expressions.
    ``LSET_STAGED`` is the 11 filled rows of a light set (pos, ng, Le, pdf,
    two-sided); ``BOUNCE_BLOCK`` has no JAX counterpart and must divide
    every tile width the frame picks; nor have the tree walks' stack limit
    and box padding (``accel.bvh``), ``PATH_OPTS``, the length of the
    bounce kernels' path options block, and ``WOPS_ROW``, the width of a
    row of the port's WoPS table (``EA.WIDTH`` columns and the alias entry,
    in 16-byte words)."""
    text = native.layout_header()
    consts = _header_constants(text)
    want = {f"{p}_{k}": v for p, cls in (("A", JA), ("EA", JEA), ("G", JG))
            for k, v in vars(cls).items() if k.isupper()}
    salt = inspect.signature(JMK.bounce_uniforms).parameters["salt"].default
    want.update(LSET_ROWS=JLSET_ROWS, LSET_STAGED=11, R_ROWS=JR_ROWS,
                STATE_ROWS=JMK.STATE_ROWS, SURF_ROWS=JMK.SURF_ROWS,
                BOUNCE_BLOCK=MK.BOUNCE_BLOCK, BOUNCE_SALT=salt, WOPS_SALT=0x905A,
                GGX_E_DEG=JS._GGX_E_DEG,
                WALK_STACK_MAX=TB.WALK_STACK_MAX, PATH_OPTS=MK.PATH_OPTS, WOPS_ROW=MK.WOPS_ROW)
    assert len(MK.path_options(PTConfig())) == MK.PATH_OPTS
    assert MK.WOPS_ROW % 4 == 0 and MK.WOPS_ROW >= JEA.WIDTH + 2
    assert all(pick_rt(n) % MK.BOUNCE_BLOCK == 0 for n in (100, 64 * 64, 512 * 512, 1920 * 1080))
    assert consts == want
    arrays = {k: [float(x) for x in v.split(",")]
              for k, v in re.findall(r"float (\w+)\[\d+\] = \{([^}]*)\};", text)}
    assert arrays == {"GGX_E_COEF": list(JS._GGX_E_COEF),
                      "GGX_EAVG_COEF": list(JS._GGX_EAVG_COEF)}
    pad = re.findall(r"constexpr float TREE_PAD_REL = ([^;]+)f;", text)
    assert [float(x) for x in pad] == [TB.TREE_PAD_REL]
    g = JSK._MIE_G
    sky = {"SKY_RAYLEIGH": 3.0 / (16.0 * math.pi), "SKY_MIE_A": 1.0 + g * g,
           "SKY_MIE_B": 2.0 * g, "SKY_MIE_NUM": 1.0 - g * g, "SKY_FOUR_PI": 4.0 * math.pi,
           "SKY_MIE_K": JSK._BETA_M[0] * JSK._MIE_H * 2.2,
           "SKY_SUN_SCALE": JSK.SUN_RADIANCE_SCALE,
           **{f"SKY_BETA_R{i}": b for i, b in enumerate(JSK._BETA_R * JSK._RAYLEIGH_H)}}
    got = {k: float(v) for k, v in re.findall(r"constexpr float (SKY_\w+) = ([^;]+)f;", text)}
    assert got == {k: float(np.float32(v)) for k, v in sky.items()}


def test_kernel_sources_take_layouts_only_from_the_header():
    """Every layout name a kernel source uses is one the generated header
    defines, and no source defines a layout of its own."""
    header = native.layout_header()
    consts = _header_constants(header)
    used = set()
    for src in native.sources():
        text = src.read_text()
        assert not re.search(rf"\b(?:{_LAYOUT_NAMES})\s*(?:\[\s*\d*\s*\]\s*)?=(?!=)", text), src.name
        assert "enum" not in text, src.name
        used |= set(re.findall(rf"\b(?:{_LAYOUT_NAMES})\b", text))
    floats = {"GGX_E_COEF", "GGX_EAVG_COEF", "TREE_PAD_REL",
              *re.findall(r"constexpr float (SKY_\w+)", header)}
    assert used and used <= set(consts) | floats, sorted(used - set(consts))


def _inside_rays(seed, n=1000):
    """Rays from seeded points inside the Cornell box in seeded directions."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-0.95, 0.95, n), r.uniform(0.05, 1.9, n),
                  r.uniform(-0.95, 0.95, n)], -1)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@pytest.mark.parametrize("rays", ["camera", "inside"])
@pytest.mark.parametrize("subdivide", [None, 1000])
def test_pad_slots_never_hit(subdivide, rays):
    """B6 and B7 sweep only the first ``num_tris`` slots (36 of 128 on the
    box, 1000 of 1024 when it is split to 1000 triangles). Every slot past
    them is an all-zero Woop row that misses every ray under the plain Woop
    test, and with NaN attribute rows there the plain B7 and the plain B6
    (a shaded bounce and a last, trace-only one) give the same outputs bit
    for bit: no pad slot ever wins."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device="cpu")
    nt, tp = scene.num_tris, scene.woop.shape[1] // 3
    assert 0 < nt < tp and nt % 128
    o, d = map(torch.from_numpy, _camera_rays() if rays == "camera" else _inside_rays(5))
    w3 = scene.woop.reshape(4, 3, tp)
    assert not w3[:, :, nt:].any()
    t_pad, _, _ = MK.tri_hits(w3[:, :, nt:], o, d, 0.0, MK.INF)
    assert (t_pad == MK.INF).all()

    attrs = scene.tri_attrs.clone()
    attrs[nt:] = float("nan")
    nan_scene = dataclasses.replace(scene, tri_attrs=attrs)
    want = closest_hit_plain_shaded(scene.woop, scene.tri_attrs, o, d)
    got = closest_hit_plain_shaded(nan_scene.woop, nan_scene.tri_attrs, o, d)
    assert (want.tri >= 0).float().mean() > 0.5 and (want.tri < nt).all()
    assert all(_bits_equal(a, b) for a, b in zip(got, want))

    lsets = MK.build_light_sets(scene, 7)
    cfg = PTConfig(max_bounces=2, min_emissive_bounce=1)
    st = MK.initial_state(o, d)
    for b, last in ((1, False), (2, True)):
        want6 = MK.bounce_plain(scene, st, lsets, b, 7, cfg, last, True, 128)
        got6 = MK.bounce_plain(nan_scene, st, lsets, b, 7, cfg, last, True, 128)
        assert torch.isfinite(want6).all()
        assert _bits_equal(got6, want6)


@pytest.mark.parametrize("subdivide", [None, 300])
def test_woop_rows_follow_the_woop_table(subdivide):
    """The triangle-major table that B6 and B7 stage: row k holds triangle
    k's w, u and v rows of ``woop`` (x, y, z, translation each). It is made
    once and reused, and made again after ``woop`` is changed in place, so
    the sweep never reads geometry that ``woop`` no longer holds; a copy of
    the scene makes its own."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device="cpu")
    tp = scene.woop.shape[1] // 3

    def holds_woop(rows):
        w3 = scene.woop.reshape(4, 3, tp)
        return rows.shape == (tp, 12) and rows.is_contiguous() and all(
            torch.equal(rows[:, 4 * k:4 * k + 4], w3[:, plane, :].T)
            for k, plane in enumerate((2, 0, 1)))  # w, u, v

    rows = scene.woop_rows()
    assert holds_woop(rows)
    assert scene.woop_rows() is rows
    scene.woop[:, :3] *= 2.0  # the u rows of triangles 0-2
    moved = scene.woop_rows()
    assert moved is not rows and holds_woop(moved) and not holds_woop(rows)
    assert dataclasses.replace(scene, num_tris=tp).woop_rows() is not moved


def test_dense_queries_refuse_clustered_scenes():
    """B3's and B7's wrappers sweep the dense table from slot 0, where a
    clustered scene has pad slots inside each cluster and real triangles
    past num_tris: they raise on such a scene before any launch, on the CPU
    as on the card. ``intersect_occluded`` and ``intersect_closest_shaded``
    take it to B9 and B8."""
    scene = upload_scene(subdivide_scene(cornell_box(), 500), device="cpu", cluster_size=128)
    assert scene.cluster_aabb is not None
    o, d = (torch.from_numpy(x) for x in _camera_rays(16))
    with pytest.raises(ValueError, match="dense scenes only.*intersect_occluded"):
        occlusion(scene, o, d)
    with pytest.raises(ValueError, match="dense scenes only.*intersect_closest_shaded"):
        XI.closest_hit(scene, o, d)
    assert torch.equal(XI.intersect_occluded(scene, o, d, 1e-3, 0.5),
                       ST.occlusion_stream_plain(scene, o, d, 1e-3, 0.5))
    _, tri = ST.stream_closest_plain(scene, o, d)
    assert torch.equal(XI.intersect_closest_shaded(scene, o, d).tri, tri)
    assert (tri >= 0).any()
