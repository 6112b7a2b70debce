"""Alpha cutout of the PyTorch port against the JAX package: the alpha
atlas of the upload, the re-trace around the closest-hit queries
(``accel.intersect``) and the G-buffer of a cutout scene, dense and
clustered.

tests/test_cutout.py's scene (a masked panel, transparent on its left
half, in front of a solid wall) and ``procedural.cutout_box`` are uploaded
by both packages. The atlas and the attribute rows are held exactly; hits
to the slot, t within 1e-5; occlusion flags exactly. Random rays do not
land on the panel's seam (u = 0.5), where one ulp of u may pick the other
texel (``ROADMAP.md`` section C); camera rays may, so the G-buffer holds
the rays that agree on their hit, and bounds the others.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import intersect as JI
from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.scene import scene as JS
from zetaray_tpu.scene.gltf import GltfMaterial
from zetaray_tpu.scene.scene import _materials_soa
from zetaray_tpu.utils.png import write_png
from zetaray_tpu_torch.accel import intersect as XI
from zetaray_tpu_torch.accel.megakernel import G, gbuffer
from zetaray_tpu_torch.interop import scene_from_arrays
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import PANEL, cutout_box
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_intersect import EXACT_ROWS, _camera_rays
from tests.test_torch_scene import jax_scene_arrays, to_jax_cpu_scene, to_port_cpu_scene

torch.set_num_threads(1)


def _panel_scene(tmp, n_panels=1):
    """tests/test_cutout.py's scene: panels (alpha 0 for x < 0, cutoff 0.5)
    at z = 1, 1.1, ... in front of a wall at z = 0, all facing +z."""
    img = np.full((8, 8, 4), 255, np.uint8)
    img[:, :4, 3] = 0
    path = tmp / "mask.png"
    write_png(str(path), img)
    panel = (np.array([[-1, -1], [1, 1]], np.float32), np.array([[1, -1], [-1, 1]], np.float32),
             np.array([[1, 1], [-1, -1]], np.float32))
    v0, v1, v2 = [], [], []
    for k in range(n_panels):
        for corner, out in zip(panel, (v0, v1, v2)):
            out.append(np.concatenate([corner, np.full((2, 1), 1.0 + 0.1 * k, np.float32)], 1))
    wall = (np.array([[-2, -2, 0], [2, 2, 0]], np.float32),
            np.array([[2, -2, 0], [-2, 2, 0]], np.float32),
            np.array([[2, 2, 0], [-2, -2, 0]], np.float32))
    v0, v1, v2 = (np.concatenate(p + [w]) for p, w in zip((v0, v1, v2), wall))
    t = v0.shape[0]
    n = np.tile(np.array([[0, 0, 1.0]], np.float32), (t, 1))
    uv = lambda v: ((v[:, :2] + 1.0) * 0.5).astype(np.float32)
    mats = _materials_soa([
        GltfMaterial(name="panel", metallic=0.0, roughness=1.0, base_color_tex=0,
                     alpha_mode="MASK", alpha_cutoff=0.5),
        GltfMaterial(name="wall", metallic=0.0, roughness=1.0),
    ])
    cpu = JS.CpuScene(v0=v0, v1=v1, v2=v2, n0=n, n1=n, n2=n, uv0=uv(v0), uv1=uv(v1), uv2=uv(v2),
                      mat_id=np.array([0] * (2 * n_panels) + [1, 1], np.int32), materials=mats,
                      emissive_tris=np.zeros(0, np.int32), texture_paths=[str(path)])
    return JS.upload_scene(cpu), TS.upload_scene(to_port_cpu_scene(cpu), device="cpu")


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    return _panel_scene(tmp_path_factory.mktemp("panel"))


def _rays_toward_panel(seed, n=2048):
    """Rays from z = 2 toward the panel and the wall, tilted at random."""
    r = np.random.default_rng(seed)
    o = np.concatenate([r.uniform(-1.5, 1.5, (n, 2)), np.full((n, 1), 2.0)], 1)
    d = np.concatenate([r.normal(scale=0.2, size=(n, 2)), -np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _closest_both(jdev, tdev, o, d):
    want = JI.intersect_closest_shaded(jdev, jnp.asarray(o), jnp.asarray(d))
    got = XI.intersect_closest_shaded(tdev, torch.from_numpy(o), torch.from_numpy(d))
    return want, got


def _assert_hits_match(want, got):
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    hit = got.tri.numpy() >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5)
    for a, b in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.attrs.numpy(), np.asarray(want.attrs).T)


def test_upload_atlas_and_rows_match_jax(panel):
    jdev, tdev = panel
    assert tdev.has_cutout and jdev.has_cutout
    np.testing.assert_array_equal(tdev.alpha_tex.numpy(), np.asarray(jdev.alpha_tex))
    np.testing.assert_array_equal(tdev.tri_attrs.numpy(), np.asarray(jdev.tri_attrs))
    at = tdev.tri_attrs.numpy()
    assert list(at[:4, TS.A.ACUT]) == [0.5, 0.5, 0.0, 0.0]
    assert list(at[:4, TS.A.ATEX]) == [0.0, 0.0, -1.0, -1.0]
    carried = scene_from_arrays(jax_scene_arrays(jdev), device="cpu")
    assert carried.has_cutout
    np.testing.assert_array_equal(carried.alpha_tex.numpy(), np.asarray(jdev.alpha_tex))


def test_closest_hit_matches_jax(panel):
    """Through the transparent half to the wall, stopped by the opaque half;
    tri exact, t, u, v within 1e-5, the attribute rows exact."""
    jdev, tdev = panel
    o, d = _rays_toward_panel(1)
    want, got = _closest_both(jdev, tdev, o, d)
    _assert_hits_match(want, got)
    tri = got.tri.numpy()
    pierced = (o[:, 0] + (1.0 - 2.0) / d[:, 2] * d[:, 0] < -0.05) & (tri >= 2)
    assert pierced.sum() > 100 and (np.isin(tri, [0, 1])).sum() > 100
    got2 = XI.intersect_closest_shaded(tdev, torch.tensor([[-0.5, 0.0, 2.0], [0.5, 0.0, 2.0]]),
                                       torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]]))
    np.testing.assert_allclose(got2.t.numpy(), [2.0, 1.0], atol=1e-5)


def test_occlusion_matches_jax(panel):
    """Segments from z = 2 to points between the panel and the wall (they
    cross the panel only) and to the wall's far side: every flag equal."""
    jdev, tdev = panel
    r = np.random.default_rng(2)
    o, _ = _rays_toward_panel(3)
    end = np.concatenate([r.uniform(-1.5, 1.5, (o.shape[0], 2)),
                          r.uniform(-0.5, 0.7, (o.shape[0], 1))], 1).astype(np.float32)
    seg = end - o
    want = np.asarray(JI.intersect_occluded(jdev, jnp.asarray(o), jnp.asarray(seg), 1e-3, 1.0))
    got = XI.intersect_occluded(tdev, torch.from_numpy(o), torch.from_numpy(seg), 1e-3, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.8


def test_layer_budget_overflow_matches_jax(tmp_path):
    """Five stacked masked panels: a ray through their transparent halves
    pierces four, the budget, and then reports no hit (closest: tri -1 at
    the distance it reached) or counts as occluded; one through the opaque
    halves stops at the first panel."""
    jdev, tdev = _panel_scene(tmp_path, n_panels=5)
    o = np.array([[-0.5, 0.0, 2.0], [0.5, 0.0, 2.0], [-0.5, 0.3, 2.0]], np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (3, 1))
    want, got = _closest_both(jdev, tdev, o, d)
    _assert_hits_match(want, got)
    np.testing.assert_array_equal(got.tri.numpy(), [-1, 8, -1])
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    # the panels nearest the origin come first: it stopped past the fourth (z = 1.1)
    assert 0.9 < got.t[0].item() < 0.91
    seg = np.tile(np.array([[0.0, 0.0, -3.0]], np.float32), (3, 1))
    want = np.asarray(JI.intersect_occluded(jdev, jnp.asarray(o), jnp.asarray(seg), 1e-3, 1.0))
    got = XI.intersect_occluded(tdev, torch.from_numpy(o), torch.from_numpy(seg), 1e-3, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.all()


def _gbuffer_both(jdev, tdev, res=32):
    o, d = _camera_rays(res)
    want = np.asarray(jax_gbuffer(jdev, jnp.asarray(o), jnp.asarray(d)))
    got = gbuffer(tdev, torch.from_numpy(o), torch.from_numpy(d)).numpy()
    return got, want


def _assert_gbuffers_match(got, want, panel_pixels=50):
    """The hit rows agree on all but a few seam pixels; the rest to 1e-5.
    The panel's opaque half and the wall behind its transparent half show."""
    same = (got[EXACT_ROWS] == want[EXACT_ROWS]).all(0)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=1e-5, atol=1e-5)
    assert (got[G.MATID] == PANEL).sum() >= panel_pixels


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    cpu = cutout_box(tmp_path_factory.mktemp("cutout_box"))
    return cpu, JS.upload_scene(to_jax_cpu_scene(cpu)), TS.upload_scene(cpu, device="cpu")


def test_gbuffer_matches_jax(box):
    cpu, jdev, tdev = box
    assert tdev.has_cutout and tdev.cluster_aabb is None
    got, want = _gbuffer_both(jdev, tdev)
    _assert_gbuffers_match(got, want)
    # through the panel's transparent half the back wall (z = -1.04) shows
    pos_z = got[G.POS + 2]
    hit_panel_plane = np.isclose(pos_z, -0.85, atol=1e-4)
    x = got[G.POS]
    assert (hit_panel_plane & (x < -0.01)).sum() == 0
    assert (hit_panel_plane & (x > 0.01)).sum() >= 50


def test_clustered_upload_and_queries_match_jax(box):
    """The box split to 546 triangles and clustered by 128: the ACUT and
    ATEX rows follow the clusters' reorder, and the re-trace runs the
    streaming closest hit (B8 on the card)."""
    cpu, _, _ = box
    big = subdivide_scene(cpu, 500)
    jdev = JS.upload_scene(to_jax_cpu_scene(big), cluster_size=128)
    tdev = TS.upload_scene(big, device="cpu", cluster_size=128)
    assert tdev.cluster_aabb is not None and tdev.has_cutout
    np.testing.assert_array_equal(tdev.tri_attrs.numpy(), np.asarray(jdev.tri_attrs))
    np.testing.assert_array_equal(tdev.alpha_tex.numpy(), np.asarray(jdev.alpha_tex))
    masked = tdev.tri_attrs.numpy()[:, TS.A.ACUT] > 0
    assert masked.sum() == (big.mat_id == PANEL).sum()
    got, want = _gbuffer_both(jdev, tdev)
    _assert_gbuffers_match(got, want)
    o, d = _camera_rays(32)
    seg = np.concatenate([np.zeros((o.shape[0], 2)), np.full((o.shape[0], 1), -4.0)],
                         1).astype(np.float32)
    o2 = (o + d).astype(np.float32)
    want = np.asarray(JI.intersect_occluded(jdev, jnp.asarray(o2), jnp.asarray(seg), 1e-3, 1.0))
    got = XI.intersect_occluded(tdev, torch.from_numpy(o2), torch.from_numpy(seg), 1e-3, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_raw_dense_queries_refuse_cutout_scenes(panel):
    """B3's and B7's wrappers test no alpha: on a cutout scene they raise,
    and the bounce kernels too; the dispatching queries run the re-trace."""
    from zetaray_tpu_torch.accel import megakernel as MK
    from zetaray_tpu_torch.ops.pathtracer import PTConfig

    _, tdev = panel
    o, d = (torch.from_numpy(x) for x in _rays_toward_panel(5, n=16))
    with pytest.raises(ValueError, match="cutout.*intersect_occluded"):
        XI.occlusion(tdev, o, d)
    with pytest.raises(ValueError, match="cutout.*intersect_closest_shaded"):
        XI.closest_hit(tdev, o, d)
    with pytest.raises(ValueError, match="cutout scene traces with"):
        MK.trace_megakernel(tdev, o, d, 1, PTConfig(max_bounces=1), rt=16)
    uncut = dataclasses.replace(tdev, has_cutout=False, alpha_tex=None)
    assert (XI.intersect_closest_shaded(tdev, o, d).t >= XI.closest_hit(uncut, o, d).t).all()
