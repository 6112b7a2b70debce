"""The sun and sky and the path options of the PyTorch port's path traces
against the JAX package: ``trace_reference`` (the wavefront of clustered
scenes, the CPU oracle of the frames' clustered branch),
``trace_with_first_hit`` and ``trace_megakernel`` with a stochastic
multi-bounce mask, and the GI and PT initial samples with a sky.

``trace_reference`` runs in both packages from the same rays with the same
random streams (``uniform4`` with salts 1-3 and the alias table), so the
images agree pixel for pixel but where a ray meets an edge shared by two
triangles or XLA's fused multiply-adds move a value across a test: pixels
agree to 1e-3 * (1 + |x|) on at least 99%, as in
tests/test_torch_frame_clustered.py, and the mean to rtol 1e-3. None of
these rays meets the sun disk's rim (tests/test_torch_sky.py). The traces
through the bounce kernels and the initial samples are held as in
tests/test_torch_bounce.py, tests/test_torch_restir_gi.py and
tests/test_torch_restir_pt.py, with the JAX side in interpret mode on its
megakernel path.

The scenes: the JAX package's open scene (a ground quad under a floating
roof, tests/test_sky_integration.py) uploaded by both packages, and the
procedural box, open at +z, with a sun that shines in through the opening.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.core.rng import seed_from_key
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import restir_gi as JRG
from zetaray_tpu.ops import restir_pt as JRP
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.scene import scene as JS
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.ops import pathtracer as TPT
from zetaray_tpu_torch.ops import restir_gi as TRG
from zetaray_tpu_torch.ops import restir_pt as TRP
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render.frame import pick_rt
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import (
    CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box,
)
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_sky_integration import _open_scene
from tests.test_torch_bounce import _bounce0_rays
from tests.test_torch_restir_di import T
from tests.test_torch_restir_gi import patch_megakernel as patch_gi
from tests.test_torch_restir_pt import patch_megakernel as patch_pt
from tests.test_torch_scene import scene_pair, to_jax_cpu_scene, to_port_cpu_scene

torch.set_num_threads(1)

RES = 32
SUN = (0.2, 0.45, 0.87)  # in through the box's opening at +z
GI_PT = dict(max_bounces=3, min_emissive_bounce=2, min_nee_bounce=1)  # the frame's


def _share(got, want, tol=1e-3):
    want = np.asarray(want)
    return (np.abs(got - want) <= tol * (1.0 + np.abs(want))).all(-1).mean()


def _cfgs(**kw):
    """(JAX PTConfig, port PTConfig); ``sky`` given as a sun direction."""
    sun = kw.pop("sky", None)
    return (JPT.PTConfig(**kw, sky=None if sun is None else JSkyParams(sun_dir=sun)),
            TPT.PTConfig(**kw, sky=None if sun is None else SkyParams(sun_dir=sun)))


def _box_rays(k=1):
    cam = JaxCamera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    o, d = cam.with_jitter(k).generate_rays(RES, RES)
    return o, d, T(o), T(d)


@pytest.fixture(scope="module")
def scenes():
    open_cpu = to_port_cpu_scene(_open_scene())
    box = cornell_box()
    mats = box.materials
    glossy = dataclasses.replace(box, materials=dataclasses.replace(
        mats, roughness=np.full_like(mats.roughness, 0.05)))
    clustered = subdivide_scene(box, 500)
    return {
        "open": scene_pair(open_cpu),
        "box": scene_pair(box),
        "glossy": scene_pair(glossy),
        "clustered": (JS.upload_scene(to_jax_cpu_scene(clustered), cluster_size=128),
                      TS.upload_scene(clustered, device="cpu", cluster_size=128)),
    }


def _trace_pair(scenes, name, o, d, o_t, d_t, k, kw, smb=None):
    jdev, tdev = scenes[name]
    jcfg, tcfg = _cfgs(**kw)
    key = jax.random.PRNGKey(k)
    want = np.asarray(JPT.trace_reference(
        jdev, o, d, key, jcfg, smb_kill=None if smb is None else jnp.asarray(smb)))
    got = TPT.trace_reference(tdev, o_t, d_t, int(seed_from_key(key)), tcfg,
                              smb_kill=None if smb is None else torch.from_numpy(smb)).numpy()
    return got, want


TRACES = {
    "open_sky": ("open", dict(max_bounces=2, sky=(0.2, 0.9, 0.3))),
    "open_sky_no_sun_nee": ("open", dict(max_bounces=2, sky=(0.2, 0.9, 0.3), sun_nee=False)),
    "box_sky": ("box", dict(max_bounces=2, sky=SUN)),
    "glossy_regularized": ("glossy", dict(max_bounces=3, path_regularization=True)),
    "box_firefly": ("box", dict(max_bounces=2, firefly_clamp=0.05)),
    "clustered_sky_all": ("clustered", dict(max_bounces=2, sky=SUN, path_regularization=True,
                                            firefly_clamp=0.05)),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_reference_options_match_jax(scenes, name):
    """Each option through ``trace_reference``, against the JAX wavefront;
    each changes the image (the open scene's sky lights its top rows, which
    are black without it)."""
    scene, kw = TRACES[name]
    if scene == "open":
        cam = JaxCamera.look_at((0, 2.5, 6), (0, 0.5, 0), vfov_deg=50, aspect=1.0)
        o, d = cam.generate_rays(RES, RES)
        o_t, d_t = T(o), T(d)
    else:
        o, d, o_t, d_t = _box_rays()
    got, want = _trace_pair(scenes, scene, o, d, o_t, d_t, 3, kw)
    assert got.shape == (RES * RES, 3) and np.isfinite(got).all() and want.mean() > 0
    assert _share(got, want) >= 0.99
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)
    base = {k: v for k, v in kw.items() if k == "max_bounces"}
    plain = TPT.trace_reference(scenes[scene][1], o_t, d_t, int(seed_from_key(
        jax.random.PRNGKey(3))), TPT.PTConfig(**base)).numpy()
    assert (np.abs(got - plain).max(-1) > 1e-6).mean() > 0.02
    if scene == "open":
        assert got.reshape(RES, RES, 3)[:4].mean() > 0.01 and plain.reshape(RES, RES, 3)[:4].max() == 0


def test_trace_reference_smb_kill_matches_jax(scenes):
    """A stochastic multi-bounce mask (a seeded half of the rays): the same
    image as JAX; no ray killed is the unmasked trace bit for bit; every ray
    killed gives less light."""
    o, d, o_t, d_t = _box_rays()
    smb = np.random.default_rng(7).uniform(size=RES * RES) < 0.5
    kw = dict(max_bounces=3)
    got, want = _trace_pair(scenes, "box", o, d, o_t, d_t, 5, kw, smb)
    assert _share(got, want) >= 0.99
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)
    none, _ = _trace_pair(scenes, "box", o, d, o_t, d_t, 5, kw, np.zeros(RES * RES, bool))
    unmasked, _ = _trace_pair(scenes, "box", o, d, o_t, d_t, 5, kw)
    np.testing.assert_array_equal(none, unmasked)
    every, _ = _trace_pair(scenes, "box", o, d, o_t, d_t, 5, kw, np.ones(RES * RES, bool))
    assert every.mean() < 0.9 * unmasked.mean()


@pytest.mark.parametrize("fn", ["trace_with_first_hit", "trace_megakernel"])
def test_kernel_traces_with_smb_kill_match_jax(scenes, fn):
    """``trace_with_first_hit`` (B4, B5, then B6) and ``trace_megakernel``
    (B6 each bounce) with a mask and with the sky, against the Pallas
    kernels in interpret mode: the mask lowers the radiance where it kills."""
    jdev, tdev = scenes["box"]
    o, d = _bounce0_rays(tdev)
    n = o.shape[0]
    smb = np.random.default_rng(8).uniform(size=n) < 0.5
    seed = int(seed_from_key(jax.random.PRNGKey(9)))
    jcfg, tcfg = _cfgs(max_bounces=2, min_emissive_bounce=1, sky=SUN)
    if fn == "trace_with_first_hit":
        want = JMK.trace_with_first_hit(jdev, jnp.asarray(o), jnp.asarray(d), jnp.uint32(seed),
                                        jcfg, rt=256, interpret=True, smb_kill=jnp.asarray(smb))[0]
        run = lambda mask: MK.trace_with_first_hit(tdev, T(o), T(d), seed, tcfg, 256,
                                                   smb_kill=mask)[0]
    else:
        want = JMK.trace_megakernel(jdev, jnp.asarray(o), jnp.asarray(d), jnp.uint32(seed), jcfg,
                                    rt=256, interpret=True, rows_out=True,
                                    smb_kill=jnp.asarray(smb))
        run = lambda mask: MK.trace_megakernel(tdev, T(o), T(d), seed, tcfg, rt=256,
                                               rows_out=True, smb_kill=mask)
    got = run(torch.from_numpy(smb)).numpy()
    want = np.asarray(want)
    ok = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(0)
    assert ok.mean() >= 0.95
    assert abs(got.mean() - want.mean()) <= 0.03 * want.mean()
    free = run(None).numpy()
    assert (got[:, ~smb] == free[:, ~smb]).all()
    assert got[:, smb].sum() < free[:, smb].sum()


def _far(x):
    """Vertices [3, N] on the far sphere: SKY_DIST from the box."""
    return np.abs(np.linalg.norm(x.astype(np.float64), axis=0) - TRG.SKY_DIST) < 10.0


def _frame_gbuffer(jdev, k):
    """(camera, key, u32 seed, JAX G-buffer) of frame k of the box camera."""
    cam = JaxCamera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV,
                            aspect=1.0).with_jitter(k)
    key = jax.random.PRNGKey(k)
    o, d = cam.generate_rays(RES, RES)
    return cam, key, int(seed_from_key(key)), jax_gbuffer(jdev, o, d, interpret=True)


@pytest.mark.parametrize("name", ["box", "clustered"])
def test_gi_initial_samples_with_sky_match_jax(scenes, name):
    """GI samples with the sky and stochastic multi-bounce: escaped rays
    reconnect on the far sphere (1e4 away) with the sky's radiance. The
    dense box runs JAX through its bounce kernels, the clustered box
    through the wavefront on both sides."""
    jdev, tdev = scenes[name]
    jcfg, tcfg = _cfgs(**GI_PT, sky=SUN, stochastic_multi_bounce=True)
    cam, key, seed, gb = _frame_gbuffer(jdev, 4)
    rt = pick_rt(RES * RES)
    with pytest.MonkeyPatch.context() as mp:
        if name == "box":
            patch_gi(mp)
        want = np.asarray(JRG.initial_samples(jdev, gb, key, jcfg, jnp.uint32(seed), rt=rt,
                                              spread_angle=cam.pixel_spread_angle(RES)))
    got = TRG.initial_samples(tdev, T(gb), tcfg, seed, rt,
                              spread_angle=cam.pixel_spread_angle(RES)).numpy()
    assert got.shape == want.shape == (16, RES * RES)
    far = _far(want[0:3])
    assert far.sum() > 20 and (want[6:9, far].sum(0) > 0).mean() > 0.5  # the sky above the horizon
    np.testing.assert_array_equal(_far(got[0:3]), far)
    agree = lambda rows, rtol: np.isclose(got[rows], want[rows], rtol=rtol, atol=1e-5).all(0)
    assert agree(slice(0, 6), 1e-4).mean() >= 0.99  # x2, n2
    assert agree(slice(None), 1e-3).mean() >= 0.98
    assert abs(got[9].mean() - want[9].mean()) <= 0.02 * want[9].mean()


def test_pt_initial_samples_with_sky_match_jax(scenes):
    """PT samples with the sky: escaped prefixes become far-sphere vertices
    that emit the sky (LE rows), with no suffix and roughness 1; escaped
    suffixes bring back the sky."""
    jdev, tdev = scenes["box"]
    jcfg, tcfg = _cfgs(**GI_PT, sky=SUN)
    _, key, seed, gb = _frame_gbuffer(jdev, 4)
    rt = pick_rt(RES * RES)
    PR = TRP.PR
    with pytest.MonkeyPatch.context() as mp:
        patch_pt(mp)
        want = np.asarray(JRP.initial_samples(jdev, gb, key, jcfg, jnp.uint32(seed),
                                              JRP.ReSTIRPTConfig(), rt=rt))
    got = TRP.initial_samples(tdev, T(gb), tcfg, seed, TRP.ReSTIRPTConfig(), rt).numpy()
    assert got.shape == want.shape == (PR.ROWS, RES * RES)
    far = _far(want[PR.X : PR.X + 3])
    assert far.sum() > 20 and (want[PR.LE : PR.LE + 3, far].sum(0) > 0).mean() > 0.5
    assert (want[PR.ROUGH, far] == 1.0).all()
    agree = lambda rows, rtol: np.isclose(got[rows], want[rows], rtol=rtol, atol=1e-5).all(0)
    assert agree(slice(PR.X, PR.N + 3), 1e-4).mean() >= 0.99
    assert agree(slice(None), 1e-3).mean() >= 0.97
    assert abs(got[PR.WSUM].mean() - want[PR.WSUM].mean()) <= 0.03 * want[PR.WSUM].mean()
