"""The light voxel grid (``ops/prelighting.py``) and its two consumers, the
DI grid candidates (``restir_di.lvg_merge``) and the ReSTIR_GI_LVG NEE at
x2 (``restir_gi.initial_samples(lvg=...)``), PyTorch port against the JAX
package.

The grid is the default 32 x 8 x 40 voxels of 8 slots (81,920 reservoirs
of 6 candidates each) on the procedural box. Its candidates come from the
same pcg4d streams and alias table in both packages, and each operation
rounds alike, so the rows are held bit for bit. ``voxel_of_position``
floors camera-space coordinates in float32: XLA on the CPU may fuse the
dot products into multiply-adds where the port does not, so a point on a
voxel face may land in the neighbouring voxel; the face test bounds the
share of such points. The GI samples run the JAX side through its bounce
kernels in interpret mode (``patch_megakernel``) on the dense box, and
through both packages' wavefront trace on the box split to 546 triangles
and clustered by 128.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.megakernel import build_light_sets as jax_light_sets
from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import prelighting as JPL
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.ops import restir_gi as JRG
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import prelighting as TPL
from zetaray_tpu_torch.ops import restir_di as TRD
from zetaray_tpu_torch.ops import restir_gi as TRG
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import pick_rt
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import cornell_box
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_frame import _camera, _seed
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_restir_gi import patch_megakernel
from tests.test_torch_scene import scene_pair, to_jax_cpu_scene

torch.set_num_threads(1)

RES = 32
CFG_J, CFG_T = JPL.LVGConfig(), TPL.LVGConfig()
PT = dict(max_bounces=3, min_emissive_bounce=2, min_nee_bounce=1)  # the frame's GI trace


@pytest.fixture(scope="module")
def run():
    """The box, frame 1's camera and seed, the JAX grid and G-buffer."""
    jdev, tdev = scene_pair(cornell_box())
    cam, seed = _camera(1), _seed(1)
    o, d = cam.generate_rays(RES, RES)
    return dict(jdev=jdev, tdev=tdev, cam=cam, tcam=camera_from_arrays(cam_dict(cam)),
                seed=seed, gb=jax_gbuffer(jdev, o, d, interpret=True),
                lvg=np.asarray(JPL.build_light_voxel_grid(jdev, cam, jnp.uint32(seed), CFG_J)))


def test_config_and_rows_match_the_reference():
    assert TPL.LVGConfig() == TPL.LVGConfig(**vars(JPL.LVGConfig()))
    assert TPL.LVG_ROWS == JPL.LVG_ROWS == 16


def test_light_voxel_grid_matches_jax(run):
    """Every row of the default grid, bit for bit."""
    got = TPL.build_light_voxel_grid(run["tdev"], run["tcam"], run["seed"], CFG_T).numpy()
    want = run["lvg"]
    assert got.shape == want.shape == (32 * 8 * 40 * 8, 16)
    assert 0.3 < (want[:, 9] > 0).mean() < 1.0  # full and empty reservoirs
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _world(cam, c):
    """Camera-space points c [N, 3] (float64) -> float32 world points."""
    f64 = lambda k: np.asarray(getattr(cam, k), np.float64)
    w = f64("eye") + c[:, :1] * f64("right") + c[:, 1:2] * f64("up") + c[:, 2:3] * f64("forward")
    return w.astype(np.float32)


def _points(kind, run):
    """World points [N, 3]: the G-buffer's hits, uniform points of the
    grid's volume and beyond it, or points on the voxels' x faces."""
    if kind == "gbuffer":
        return np.asarray(run["gb"][0:3]).T.copy()
    dx, dy, dz = CFG_T.dim
    ex, ey, ez = CFG_T.extents
    r = np.random.default_rng(12)
    n = 20_000
    c = np.stack([r.uniform(-1.1 * dx * ex, 1.1 * dx * ex, n),
                  r.uniform(-1.1 * dy * ey, 1.1 * dy * ey, n) + CFG_T.offset_y,
                  r.uniform(-0.1, 2.2 * dz * ez, n)], -1)
    if kind == "faces":
        c[:, 0] = r.integers(1, dx, n) * 2 * ex - dx * ex
    return _world(run["cam"], c)


@pytest.mark.parametrize("kind", ["gbuffer", "volume", "faces"])
def test_voxel_of_position_matches_jax(run, kind):
    """The same voxel and in-grid flag for every G-buffer hit and every
    point of the volume; on the voxels' faces at most 1% of the points land
    one voxel over in x (the float32 floor after differently fused dot
    products), and no point further."""
    p = _points(kind, run)
    vj, ij = (np.asarray(a) for a in JPL.voxel_of_position(jnp.asarray(p), run["cam"], CFG_J))
    vt, it = (a.numpy() for a in TPL.voxel_of_position(T(p), run["tcam"], CFG_T))
    assert 0.3 < ij.mean() <= 1.0
    if kind != "faces":
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(it, ij)
        return
    moved = vt != vj
    assert moved.mean() <= 0.01
    assert (np.abs(vt[moved & ij & it] - vj[moved & ij & it]) == 1).all()


def test_sample_lvg_matches_jax(run):
    """The grid rows and the valid mask of each pixel's candidate."""
    rj, mj = JPL.sample_lvg(jnp.asarray(run["lvg"]), run["gb"], run["cam"], jnp.uint32(run["seed"]),
                            CFG_J)
    rt, mt = TPL.sample_lvg(T(run["lvg"]), T(run["gb"]), run["tcam"], run["seed"], CFG_T)
    mj = np.asarray(mj)
    assert rt.shape == (16, RES * RES) and 0.5 < mj.mean() < 1.0
    np.testing.assert_array_equal(mt.numpy(), mj)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


@pytest.mark.parametrize("samples", [1, 2])
def test_lvg_merge_matches_jax(run, samples):
    """DI's initial reservoirs with ``lvg_samples`` grid candidates merged:
    every row on 99.5% of the pixels (a merge compares a uniform with a sum,
    so a pick at the boundary may flip), to 1e-5."""
    seed, gb = run["seed"], run["gb"]
    rt = pick_rt(RES * RES)
    res0 = JRD.initial_candidates(gb, jax_light_sets(run["jdev"], jnp.uint32(seed)),
                                  jnp.uint32(seed), JRD.ReSTIRConfig(), rt=rt, interpret=True)
    want = np.asarray(JRD.lvg_merge(res0, gb, run["cam"], jnp.asarray(run["lvg"]),
                                    jnp.uint32(seed), JRD.ReSTIRConfig(lvg_samples=samples),
                                    CFG_J))
    got = TRD.lvg_merge(T(res0), T(gb), run["tcam"], T(run["lvg"]), seed,
                        TRD.ReSTIRConfig(lvg_samples=samples), CFG_T).numpy()
    assert (want[10] > np.asarray(res0)[10]).mean() > 0.5  # grid candidates merged
    assert np.isclose(got, want, rtol=1e-5, atol=1e-6).all(0).mean() >= 0.995


def test_gi_lvg_initial_samples_match_jax(run):
    """The ReSTIR_GI_LVG samples on the dense box: the JAX side through its
    bounce kernels (bounce 0 without NEE, min_nee_bounce=1) in interpret
    mode, the port through B4-B6's plain versions; x2 and n2 on 99% of the
    pixels to 1e-4, every row on 98% to 1e-3 (as the GI tests hold)."""
    cam, seed, gb = run["cam"], run["seed"], run["gb"]
    rt = pick_rt(RES * RES)
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        kw = dict(rt=rt, spread_angle=cam.pixel_spread_angle(RES))
        want = np.asarray(JRG.initial_samples(
            run["jdev"], gb, jax.random.PRNGKey(1), JPT.PTConfig(**PT), jnp.uint32(seed),
            lvg=jnp.asarray(run["lvg"]), lvg_cam=cam, lvg_cfg=CFG_J, **kw))
        no_lvg = np.asarray(JRG.initial_samples(
            run["jdev"], gb, jax.random.PRNGKey(1), JPT.PTConfig(**PT), jnp.uint32(seed), **kw))
    got = TRG.initial_samples(run["tdev"], T(gb), PTConfig(**PT), seed, rt,
                              spread_angle=cam.pixel_spread_angle(RES), lvg=T(run["lvg"]),
                              lvg_cam=run["tcam"], lvg_cfg=CFG_T).numpy()
    assert not np.array_equal(want[6:9], no_lvg[6:9])  # the grid NEE changed L2
    agree = lambda rows, rtol: np.isclose(got[rows], want[rows], rtol=rtol, atol=1e-5).all(0)
    assert agree(slice(0, 6), 1e-4).mean() >= 0.99
    assert agree(slice(None), 1e-3).mean() >= 0.98
    assert abs(got[9].mean() - want[9].mean()) <= 0.02 * want[9].mean()


def test_gi_lvg_initial_samples_match_jax_clustered(run):
    """The same on the clustered box: both packages trace x2 and the path
    past it with their wavefront tracer (B8/B9 on the card), x2's material
    from the first hit's attribute row; the shares of
    tests/test_torch_frame_clustered.py's GI samples (99%, 98%)."""
    box = subdivide_scene(cornell_box(), 500)
    jdev = JS.upload_scene(to_jax_cpu_scene(box), cluster_size=128)
    tdev = TS.upload_scene(box, device="cpu", cluster_size=128)
    cam, seed = run["cam"], run["seed"]
    o, d = cam.generate_rays(RES, RES)
    gb = jax_gbuffer(jdev, o, d)
    lvg = JPL.build_light_voxel_grid(jdev, cam, jnp.uint32(seed), CFG_J)
    pt = dict(max_bounces=2, min_emissive_bounce=2, min_nee_bounce=1)
    want = np.asarray(JRG.initial_samples(jdev, gb, jax.random.PRNGKey(1), JPT.PTConfig(**pt),
                                          jnp.uint32(seed), rt=pick_rt(RES * RES), lvg=lvg,
                                          lvg_cam=cam, lvg_cfg=CFG_J))
    got = TRG.initial_samples(tdev, T(gb), PTConfig(**pt), seed, pick_rt(RES * RES),
                              lvg=T(lvg), lvg_cam=run["tcam"], lvg_cfg=CFG_T).numpy()
    assert (want[10] > 0).mean() > 0.5 and want[6:9].max() > 0
    agree = lambda rows, rtol: np.isclose(got[rows], want[rows], rtol=rtol, atol=1e-5).all(0)
    assert agree(slice(0, 6), 1e-4).mean() >= 0.99
    assert agree(slice(None), 1e-3).mean() >= 0.98
    np.testing.assert_allclose(got[9].mean(), want[9].mean(), rtol=1e-3)
