"""ReSTIR DI of the PyTorch port against the JAX package, stage by stage.

Every stage gets the inputs the JAX run produced (converted to tensors),
so each comparison isolates one function. Selections compare a uniform
with a sum taken in another order (the RIS prefix sum, the merge's
``u * w_sum < w_b``), so a pick right at a boundary may flip: those
tests require agreement on a stated share of pixels, and closeness where
the picks agree. Pairwise MIS is also held to its purpose: its mean over
frames equals the frame without spatial reuse.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.megakernel import build_light_sets as jax_light_sets
from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.ops import gbuffer_pack as JGP
from zetaray_tpu.ops import reservoir_pack as JRP
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import gbuffer_pack as TGP
from zetaray_tpu_torch.ops import reservoir_pack as TRP
from zetaray_tpu_torch.ops import restir_di as TRD
from zetaray_tpu_torch.render.frame import pick_rt
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from tests.test_torch_scene import frame_seed, scene_pair

torch.set_num_threads(1)

RES = 32
CFG_J = JRD.ReSTIRConfig()


def cam_dict(cam) -> dict:
    return {k: np.asarray(getattr(cam, k)) for k in
            ("eye", "right", "up", "forward", "tan_half_fov", "aspect", "lens_radius",
             "focus_dist", "jitter")}


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def run():
    """The JAX DI chain over a previous and a current frame (camera moved)."""
    jdev, tdev = scene_pair(cornell_box(subdivide_to=600))
    n = RES * RES
    rt = pick_rt(n)
    out = {"jdev": jdev, "tdev": tdev, "rt": rt}
    for tag, k, dx in (("prev", 3, 0.0), ("curr", 4, 0.04)):
        cam = JaxCamera.look_at(
            (CAMERA_EYE[0] + dx, CAMERA_EYE[1], CAMERA_EYE[2]), CAMERA_TARGET,
            vfov_deg=CAMERA_VFOV, aspect=1.0,
        ).with_jitter(k)
        seed = frame_seed(k)
        o, d = cam.generate_rays(RES, RES)
        gb = jax_gbuffer(jdev, o, d, interpret=True)
        lsets = jax_light_sets(jdev, jnp.uint32(seed))
        res0 = JRD.initial_candidates(gb, lsets, jnp.uint32(seed), CFG_J, rt=rt, interpret=True)
        out[tag] = dict(cam=cam, seed=seed, gb=gb, lsets=lsets, res0=res0)
    p, c = out["prev"], out["curr"]
    p["res_vis"] = JRD.visibility_reuse(jdev, p["res0"], p["gb"])
    p["tg"] = JGP.pack_temporal(p["gb"])
    c["res_t"] = JRD.temporal_reuse(
        c["res0"], p["res_vis"], p["tg"], c["gb"], p["cam"], RES, RES, jnp.uint32(c["seed"]),
        CFG_J,
    )
    c["res_vis"] = JRD.visibility_reuse(jdev, c["res_t"], c["gb"])
    c["res_sp"] = JRD.spatial_reuse(c["res_vis"], c["gb"], RES, RES, jnp.uint32(c["seed"]), CFG_J)
    c["direct"] = JRD.shade(jdev, c["res_sp"], c["gb"], rows_out=True)
    return out


def _pixel_agreement(got, want, rtol=1e-4, atol=1e-5):
    """Share of pixels whose every row agrees."""
    return np.isclose(got, want, rtol=rtol, atol=atol).all(0).mean()


def test_initial_candidates_match_jax(run):
    c = run["curr"]
    got = TRD.initial_candidates(T(c["gb"]), T(c["lsets"]), c["seed"], rt=run["rt"]).numpy()
    want = np.asarray(c["res0"])
    assert got.shape == want.shape == (16, RES * RES)
    same_pick = (got[0:3] == want[0:3]).all(0)
    assert same_pick.mean() >= 0.995
    np.testing.assert_allclose(got[:, same_pick], want[:, same_pick], rtol=1e-5, atol=1e-6)
    assert (want[11] > 0).mean() > 0.5  # most pixels hold a live sample


def test_temporal_reuse_matches_jax(run):
    p, c = run["prev"], run["curr"]
    got = TRD.temporal_reuse(
        T(c["res0"]), T(p["res_vis"]), T(p["tg"]), T(c["gb"]),
        camera_from_arrays(cam_dict(p["cam"])), RES, RES, c["seed"], TRD.ReSTIRConfig(),
    ).numpy()
    want = np.asarray(JRD.temporal_reuse(
        c["res0"], p["res_vis"], p["tg"], c["gb"], p["cam"], RES, RES, jnp.uint32(c["seed"]),
        CFG_J,
    ))
    assert (want[10] > 128).mean() > 0.5  # temporal reuse happened
    assert _pixel_agreement(got, want) >= 0.99


def test_visibility_reuse_matches_jax(run):
    c = run["curr"]
    got = TRD.visibility_reuse(run["tdev"], T(c["res_t"]), T(c["gb"])).numpy()
    want = np.asarray(c["res_vis"])
    np.testing.assert_array_equal(got[11] > 0, want[11] > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_spatial_reuse_matches_jax(run):
    c = run["curr"]
    got = TRD.spatial_reuse(
        T(c["res_vis"]), T(c["gb"]), RES, RES, c["seed"], TRD.ReSTIRConfig()
    ).numpy()
    want = np.asarray(JRD.spatial_reuse(
        c["res_vis"], c["gb"], RES, RES, jnp.uint32(c["seed"]), CFG_J
    ))
    assert _pixel_agreement(got, want) >= 0.99


@pytest.mark.parametrize("kw", [{"full_target": True}, {"packed_reuse": False}])
def test_restir_options_pairwise_match_jax(run, kw):
    """Pairwise MIS (3 neighbours, one pass) on the visibility-tested
    reservoirs with the whole-BSDF target, and with raw float32 gathers,
    against the JAX pass under the same option: every row on 99% of the
    pixels."""
    c = run["curr"]
    opts = dict(spatial_mis="pairwise", spatial_neighbors=3, **kw)
    got = TRD.spatial_reuse(T(c["res_vis"]), T(c["gb"]), RES, RES, c["seed"],
                            TRD.ReSTIRConfig(**opts)).numpy()
    want = np.asarray(JRD.spatial_reuse(c["res_vis"], c["gb"], RES, RES, jnp.uint32(c["seed"]),
                                        JRD.ReSTIRConfig(**opts)))
    base = np.asarray(JRD.spatial_reuse(c["res_vis"], c["gb"], RES, RES, jnp.uint32(c["seed"]),
                                        JRD.ReSTIRConfig(spatial_mis="pairwise",
                                                         spatial_neighbors=3)))
    assert (want != base).any(0).mean() > 0.05  # the option acts
    assert _pixel_agreement(got, want) >= 0.99


@pytest.mark.parametrize("neighbors", [1, 3])
def test_pairwise_spatial_reuse_matches_jax(run, neighbors):
    """Pairwise MIS over 1 and 3 neighbours, one and two passes, on the
    visibility-tested reservoirs: every row on 99% of the pixels (a pick
    compares a uniform with a running sum)."""
    c = run["curr"]
    kw = dict(spatial_mis="pairwise", spatial_neighbors=neighbors,
              spatial_iterations=neighbors - 1 or 2)
    got = TRD.spatial_reuse(T(c["res_vis"]), T(c["gb"]), RES, RES, c["seed"],
                            TRD.ReSTIRConfig(**kw)).numpy()
    want = np.asarray(JRD.spatial_reuse(c["res_vis"], c["gb"], RES, RES, jnp.uint32(c["seed"]),
                                        JRD.ReSTIRConfig(**kw)))
    res_in = np.asarray(c["res_vis"])
    assert (want[10] > res_in[10]).mean() > 0.15  # neighbours passed the geometry test
    assert _pixel_agreement(got, want) >= 0.99


def _mean_frame(scene, cam, restir, frames=8):
    """Mean HDR of independent DI-only frames (no temporal reuse, no TAA)."""
    from zetaray_tpu_torch.ops.pathtracer import PTConfig
    from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir

    cfg = RenderConfig(width=64, height=64, mode="restir_di", pt=PTConfig(max_bounces=1),
                       restir=TRD.ReSTIRConfig(temporal=False, **restir), taa=False,
                       auto_exposure=False, indirect=False)
    acc = sum(render_frame_restir(scene, cam, 100 + i, cfg, None)[0]["hdr"].numpy()
              for i in range(frames))
    return acc / frames


def test_pairwise_matches_unreused_mean():
    """Pairwise MIS is unbiased: the 8-frame mean of the port's DI frame with
    one pairwise pass stays within 5% (mean absolute difference over lit
    pixels; 0.3% on the CPU) of the frame without spatial reuse, on the
    procedural box, as tests/test_pairwise_mis.py holds the JAX frame (to
    12%) on the Cornell glTF."""
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.scene import upload_scene

    scene = upload_scene(cornell_box(), device="cpu")
    cam = Camera.look_at((0, 1, 3.5), (0, 1, 0), vfov_deg=45, aspect=1.0)
    ref = _mean_frame(scene, cam, dict(spatial_iterations=0))
    pw = _mean_frame(scene, cam, dict(spatial_iterations=1, spatial_mis="pairwise",
                                      spatial_neighbors=3))
    assert np.isfinite(pw).all()
    lit = ref.mean(-1) > 0.02
    assert lit.mean() > 0.3
    rel = np.abs(ref[lit] - pw[lit]).mean() / ref[lit].mean()
    assert rel < 0.05, rel


def test_shade_matches_jax(run):
    c = run["curr"]
    got = TRD.shade(run["tdev"], T(c["res_sp"]), T(c["gb"])).numpy()
    want = np.asarray(c["direct"])
    assert got.shape == want.shape == (3, RES * RES)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stage", ["res0", "res_t", "res_sp"])
def test_pack_di_bit_exact(run, stage):
    res = np.asarray(run["curr"][stage])
    want = np.asarray(JRP.pack_di(jnp.asarray(res)))
    got = TRP.pack_di(T(res))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))
    got_u = TRP.unpack_di(got).numpy()
    want_u = np.asarray(JRP.unpack_di(jnp.asarray(want)))
    np.testing.assert_array_equal(got_u.view(np.uint32), want_u.view(np.uint32))


def test_pack_temporal_bit_exact(run):
    gb = np.asarray(run["curr"]["gb"])
    want = np.asarray(JGP.pack_temporal(jnp.asarray(gb)))
    got = TGP.pack_temporal(T(gb)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for g, w in zip(TGP.unpack_normal(T(want)), JGP.unpack_normal(jnp.asarray(want))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_di_extremes_bit_exact():
    """Values past the f16 range, negative M, huge M and subnormals."""
    r = np.random.default_rng(5)
    res = r.normal(0, 1, (16, 256)).astype(np.float32)
    res[6:9] *= np.float32(1e6)
    res[10] = r.uniform(-10, 1e6, 256).astype(np.float32)
    res[13, :8] = [7e4, -7e4, 1e-8, 6.1e-5, 0.0, -0.0, 65504.0, 65520.0]
    n = res[3:6] / np.linalg.norm(res[3:6], axis=0)
    res[3:6] = n
    want = np.asarray(JRP.pack_di(jnp.asarray(res))).astype(np.int64)
    np.testing.assert_array_equal(TRP.pack_di(T(res)).to(torch.int64).numpy(), want)
