"""Shading, light sampling and camera of the PyTorch port against the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.core.vec3 import V3 as JV3
from zetaray_tpu.ops import lights as JL
from zetaray_tpu.ops import shading_soa as JS
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.core.vec3 import V3 as TV3
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import lights as TL
from zetaray_tpu_torch.ops import shading_soa as TS
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)


def _unit(r, n, upper=False):
    v = r.normal(size=(3, n))
    if upper:
        v[2] = np.abs(v[2])
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


def test_ggx_albedo_fit_matches_jax():
    assert TS._GGX_E_COEF == pytest.approx(JS._GGX_E_COEF, rel=1e-12, abs=1e-12)
    assert TS._GGX_EAVG_COEF == pytest.approx(JS._GGX_EAVG_COEF, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("metallic", [0.0, 0.5, 1.0])
def test_bsdf_eval_matches_jax(metallic):
    r = np.random.default_rng(int(metallic * 10) + 1)
    n = 4096
    base = r.uniform(0, 1, (3, n)).astype(np.float32)
    rough = r.uniform(0.1, 1.0, n).astype(np.float32)
    ior = r.uniform(1.01, 2.0, n).astype(np.float32)
    metal = np.full(n, metallic, np.float32)
    wo = _unit(r, n, upper=True)
    wi = _unit(r, n)
    jm = JS.MatSoA(JV3(*map(jnp.asarray, base)), jnp.asarray(metal), jnp.asarray(rough),
                   jnp.asarray(ior))
    tm = TS.MatSoA(TV3(*map(torch.from_numpy, base)), torch.from_numpy(metal),
                   torch.from_numpy(rough), torch.from_numpy(ior))
    fj, pj = JS.bsdf_eval(jm, JV3(*map(jnp.asarray, wo)), JV3(*map(jnp.asarray, wi)))
    ft, pt = TS.bsdf_eval(tm, TV3(*map(torch.from_numpy, wo)), TV3(*map(torch.from_numpy, wi)))
    # At the GGX peak the denominator c2 * (a2 - 1) + 1 cancels down to
    # about roughness^4, so one ulp of cos_h (rsqrt is not correctly
    # rounded on either side) becomes ~2e-7 / roughness^4 relative: 1e-4
    # at roughness 0.2. Elsewhere the two agree to 2e-5.
    for a, b in [*zip(ft, fj), (pt, pj)]:
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7)
        assert np.isclose(a, b, rtol=2e-5, atol=1e-7).mean() >= 0.999
    assert (np.asarray(pj) > 0).mean() > 0.3


def test_make_frame_matches_jax():
    nrm = _unit(np.random.default_rng(4), 2048)
    fj = JS.make_frame(JV3(*map(jnp.asarray, nrm)))
    ft = TS.make_frame(TV3(*map(torch.from_numpy, nrm)))
    for vj, vt in zip(fj, ft):
        for a, b in zip(vt, vj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_sample_emissive_matches_jax():
    jdev, tdev = scene_pair(cornell_box(subdivide_to=400))
    r = np.random.default_rng(9)
    u = [r.uniform(0, 1, 1024).astype(np.float32) for _ in range(4)]
    want = JL.sample_emissive(jdev, tuple(jnp.asarray(x) for x in u))
    got = TL.sample_emissive(tdev, tuple(torch.from_numpy(x) for x in u))
    for k in ("pos", "ng", "le", "pdf_area", "tri", "two_sided"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("jitter_frame", [None, 5])
def test_camera_rays_and_projection_match_jax(jitter_frame):
    cam = JaxCamera.look_at((0.3, 1.1, 3.4), (0.0, 1.0, 0.0), vfov_deg=45.0, aspect=40 / 24)
    if jitter_frame is not None:
        cam = cam.with_jitter(jitter_frame)
    tcam = camera_from_arrays(cam_dict(cam))
    oj, dj = cam.generate_rays(40, 24)
    ot, dt = tcam.generate_rays(40, 24, device="cpu")
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-7)
    pts = np.asarray(oj) + 2.5 * np.asarray(dj)
    for a, b in zip(tcam.project(torch.from_numpy(pts), 40, 24), cam.project(jnp.asarray(pts), 40, 24)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
