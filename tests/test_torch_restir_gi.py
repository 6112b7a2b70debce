"""ReSTIR GI of the PyTorch port against the JAX package, stage by stage.

On the CPU the JAX package traces GI samples with its wavefront path tracer
(``megakernel_eligible`` is False there), whose random streams differ from
the bounce kernels'. These tests therefore run the JAX side through the
bounce kernels B4-B6 in interpret mode: the module fixture patches
``pathtracer.megakernel_eligible`` to True and ``trace_with_first_hit`` to
``interpret=True`` for this test process only.

Every stage gets the inputs the JAX run produced, so each comparison
isolates one function. The share of pixels that must agree is stated per
test: a sample whose path grazes a triangle edge may hit on one side and
miss on the other (see tests/test_torch_bounce.py), and the merges compare
a uniform with a sum, so a pick at a boundary may flip.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.core.rng import seed_from_key
from zetaray_tpu.ops import gbuffer_pack as JGP
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import restir_gi as JRG
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import restir_gi as TRG
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import pick_rt
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

RES = 32
PT = dict(max_bounces=3, min_emissive_bounce=2, min_nee_bounce=1)  # the frame's GI trace
CFG_J = JRG.ReSTIRGIConfig()
CFG_T = TRG.ReSTIRGIConfig()


def patch_megakernel(mp):
    """Send the JAX package's GI sampling through the bounce kernels in
    interpret mode (the path it takes on the TPU)."""
    mp.setattr(JPT, "megakernel_eligible", lambda scene: True)
    mp.setattr(JMK, "trace_with_first_hit",
               functools.partial(JMK.trace_with_first_hit, interpret=True))


@pytest.fixture(scope="module")
def run():
    """The JAX GI chain over a previous and a current frame (camera moved)."""
    jdev, tdev = scene_pair(cornell_box())
    rt = pick_rt(RES * RES)
    out = {"jdev": jdev, "tdev": tdev, "rt": rt}
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        for tag, k, dx in (("prev", 3, 0.0), ("curr", 4, 0.04)):
            cam = JaxCamera.look_at(
                (CAMERA_EYE[0] + dx, CAMERA_EYE[1], CAMERA_EYE[2]), CAMERA_TARGET,
                vfov_deg=CAMERA_VFOV, aspect=1.0,
            ).with_jitter(k)
            key = jax.random.PRNGKey(k)
            seed = int(seed_from_key(key))
            o, d = cam.generate_rays(RES, RES)
            gb = jax_gbuffer(jdev, o, d, interpret=True)
            res0 = JRG.initial_samples(
                jdev, gb, key, JPT.PTConfig(**PT), jnp.uint32(seed), rt=rt,
                spread_angle=cam.pixel_spread_angle(RES),
            )
            out[tag] = dict(cam=cam, seed=seed, gb=gb, res0=res0)
    p, c = out["prev"], out["curr"]
    p["tg"] = JGP.pack_temporal(p["gb"])
    c["res_t"] = JRG.temporal_reuse(c["res0"], p["res0"], p["tg"], c["gb"], p["cam"], RES, RES,
                                    jnp.uint32(c["seed"]), CFG_J)
    c["res_sp"] = JRG.spatial_reuse(c["res_t"], c["gb"], RES, RES, jnp.uint32(c["seed"]), CFG_J)
    c["indirect"] = JRG.shade(jdev, c["res_sp"], c["gb"], rows_out=True)
    return out


def _agree(got, want, rtol=1e-4, atol=1e-5):
    """Per-pixel: every row agrees."""
    return np.isclose(got, np.asarray(want), rtol=rtol, atol=atol).all(0)


def test_initial_samples_match_jax(run):
    c = run["curr"]
    got = TRG.initial_samples(run["tdev"], T(c["gb"]), PTConfig(**PT), c["seed"], run["rt"],
                              spread_angle=c["cam"].pixel_spread_angle(RES)).numpy()
    want = np.asarray(c["res0"])
    assert got.shape == want.shape == (16, RES * RES)
    assert (want[10] > 0).mean() > 0.5  # most pixels hold a sample
    assert want[6:9].max() > 0  # and some carry indirect light
    # x2 and n2 come from the bounce-0 hit; L2 and the weights from the
    # whole path (NEE shadow segments and later bounces can flip on edges)
    assert _agree(got[0:6], want[0:6]).mean() >= 0.99
    assert _agree(got, want, rtol=1e-3, atol=1e-5).mean() >= 0.98
    assert abs(got[9].mean() - want[9].mean()) <= 0.02 * want[9].mean()


def test_temporal_reuse_matches_jax(run):
    p, c = run["prev"], run["curr"]
    got = TRG.temporal_reuse(
        T(c["res0"]), T(p["res0"]), T(p["tg"]), T(c["gb"]), camera_from_arrays(cam_dict(p["cam"])),
        RES, RES, c["seed"], CFG_T,
    ).numpy()
    want = np.asarray(c["res_t"])
    assert (want[10] > 1).mean() > 0.3  # temporal reuse happened
    assert (want[10] == 1).mean() > 0  # and boiling suppression reset some M
    assert _agree(got, want).mean() >= 0.99


@pytest.mark.parametrize("suppression", [True, False])
def test_boiling_suppression_matches_jax(run, suppression):
    """Outlier reservoirs lose their M; with suppression off, M passes."""
    res = np.asarray(run["curr"]["res_t"]).copy()
    r = np.random.default_rng(4)
    res[9] = r.exponential(1.0, res.shape[1]).astype(np.float32)
    res[9, ::97] *= 400.0  # a few outliers
    res[10] = r.uniform(1.0, 10.0, res.shape[1]).astype(np.float32)
    want = np.asarray(JRG.suppress_outlier_reservoirs(jnp.asarray(res)))
    got = TRG.suppress_outlier_reservoirs(T(res)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[10] == 1.0).sum() >= 10
    cfg = TRG.ReSTIRGIConfig(boiling_suppression=suppression)
    p, c = run["prev"], run["curr"]
    out = TRG.temporal_reuse(
        T(c["res0"]), T(p["res0"]), T(p["tg"]), T(c["gb"]), camera_from_arrays(cam_dict(p["cam"])),
        RES, RES, c["seed"], cfg,
    ).numpy()
    want = np.asarray(JRG.temporal_reuse(
        c["res0"], p["res0"], p["tg"], c["gb"], p["cam"], RES, RES, jnp.uint32(c["seed"]),
        JRG.ReSTIRGIConfig(boiling_suppression=suppression),
    ))
    assert _agree(out, want).mean() >= 0.99


def test_spatial_reuse_matches_jax(run):
    c = run["curr"]
    got = TRG.spatial_reuse(T(c["res_t"]), T(c["gb"]), RES, RES, c["seed"], CFG_T).numpy()
    want = np.asarray(c["res_sp"])
    assert _agree(got, want).mean() >= 0.99


def test_shade_matches_jax(run):
    c = run["curr"]
    got = TRG.shade(run["tdev"], T(c["res_sp"]), T(c["gb"])).numpy()
    want = np.asarray(c["indirect"])
    assert got.shape == want.shape == (3, RES * RES)
    assert want.max() > 0
    assert _agree(got, want).mean() >= 0.99
    np.testing.assert_allclose(got.mean(1), want.mean(1), rtol=1e-3)
