"""Spherical harmonics (``core.sh``) and ``ops.pathtracer.render_spp`` of the
port against the JAX package: the basis, projection, reconstruction and
irradiance convolution on the same numpy-seeded directions to 1e-6; the
sky probe against JAX's projection of the same directions (exact in
formula) and against JAX's own probe (its directions from ``jax.random``:
a Monte-Carlo estimate, to 3%); ``render_spp`` against its definition and
against the JAX function's image mean."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_restir_di import cam_dict
from tests.test_torch_scene import to_jax_cpu_scene
from zetaray_tpu.core import sh as JSH
from zetaray_tpu.core.vec3 import V3 as JV3
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import sky as JSK
from zetaray_tpu.scene import scene as JS
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.core import sh as TSH
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import pathtracer as TPT
from zetaray_tpu_torch.ops import sky as TSK
from zetaray_tpu_torch.scene.procedural import cornell_box
from zetaray_tpu_torch.scene.scene import upload_scene

torch.set_num_threads(1)


def _dirs(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_basis_projection_and_eval_match_jax():
    d = _dirs(2000, 1)
    vals = np.random.default_rng(2).uniform(0, 3, (2000, 3)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(TSH.sh_basis9(t(d)).numpy(), np.asarray(JSH.sh_basis9(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TSH.project_to_sh1(t(d), t(vals[:, 0])).numpy(),
                               np.asarray(JSH.project_to_sh1(jnp.asarray(d), jnp.asarray(vals[:, 0]))),
                               rtol=1e-6, atol=1e-6)
    for v in (vals, vals[:, 1]):
        c_t = TSH.project_function(t(d), t(np.ascontiguousarray(v)))
        c_j = JSH.project_function(jnp.asarray(d), jnp.asarray(v))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-6)
        n = _dirs(64, 3)
        np.testing.assert_allclose(TSH.eval_sh9(TSH.irradiance_sh9(c_t), t(n)).numpy(),
                                   np.asarray(JSH.eval_sh9(JSH.irradiance_sh9(c_j), jnp.asarray(n))),
                                   rtol=1e-5, atol=1e-5)
    w = np.random.default_rng(4).uniform(0, 1, 2000).astype(np.float32)
    np.testing.assert_allclose(TSH.project_function(t(d), t(vals), t(w)).numpy(),
                               np.asarray(JSH.project_function(jnp.asarray(d), jnp.asarray(vals),
                                                               jnp.asarray(w))),
                               rtol=1e-5, atol=1e-6)


def test_furnace_identity():
    d = TSH.probe_directions(100_000, 5, device="cpu")
    coeffs = TSH.irradiance_sh9(TSH.project_function(d, torch.ones(d.shape[0])))
    e = TSH.eval_sh9(coeffs, torch.from_numpy(_dirs(64, 11)))
    np.testing.assert_allclose(e.numpy(), np.pi, rtol=0.02)
    np.testing.assert_allclose(torch.linalg.norm(d, dim=1).numpy(), 1.0, rtol=1e-6)


def test_sky_probe_matches_jax():
    sun = (0.3, 0.8, 0.2)
    got = TSH.sky_irradiance_probe(TSK.SkyParams(sun_dir=sun), device="cpu")
    assert got.shape == (9, 3)
    # the same directions through JAX's sky and projection
    d = TSH.probe_directions(4096, 7, device="cpu").numpy()
    rad = JSK.sky_radiance(JV3(*(jnp.asarray(d[:, k]) for k in range(3))),
                           JSK.SkyParams(sun_dir=sun), with_disk=False)
    same = JSH.irradiance_sh9(JSH.project_function(jnp.asarray(d),
                                                   jnp.stack([rad.x, rad.y, rad.z], -1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(same), rtol=1e-4, atol=1e-4)
    # JAX's probe (its own directions): the up-facing irradiance to 3%
    want = JSH.sky_irradiance_probe(JSK.SkyParams(sun_dir=sun))
    up = np.array([[0.0, 1.0, 0.0]], np.float32)
    np.testing.assert_allclose(TSH.eval_sh9(got, torch.from_numpy(up)).numpy(),
                               np.asarray(JSH.eval_sh9(want, jnp.asarray(up))), rtol=0.03)


def test_render_spp():
    cpu = cornell_box()
    scene = upload_scene(cpu, device="cpu")
    jcam = JaxCamera.look_at((0.0, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0, aspect=1.0)
    cam = camera_from_arrays(cam_dict(jcam))
    cfg = TPT.PTConfig(max_bounces=1)
    o, d = cam.generate_rays(24, 24, device="cpu")
    one = TPT.render_spp(scene, cam, 24, 24, 99, cfg)
    assert torch.equal(one, TPT.trace(scene, o, d, 99, cfg))
    three = TPT.render_spp(scene, cam, 24, 24, 99, cfg, spp=3)
    seeds = [TPT._sample_seed(99, i) for i in range(3)]
    assert len(set(seeds)) == 3 and all(0 <= s < 2**32 for s in seeds)
    want = sum(TPT.trace(scene, o, d, s, cfg) for s in seeds) / 3
    torch.testing.assert_close(three, want, rtol=1e-6, atol=1e-7)
    # against the JAX function (its samples from fold_in): the image mean
    js = JS.upload_scene(to_jax_cpu_scene(cpu))
    got = TPT.render_spp(scene, cam, 24, 24, 5, cfg, spp=8).mean().item()
    ref = float(JPT.render_spp(js, jcam, 24, 24, jax.random.PRNGKey(5),
                               JPT.PTConfig(max_bounces=1), spp=8).mean())
    assert got == pytest.approx(ref, rel=0.03)


def test_probe_defaults_to_the_card():
    """Without a named device the probe goes to the card; where there is
    none it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        assert TSH.probe_directions(8, 1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TSH.probe_directions(8, 1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TSH.sky_irradiance_probe(TSK.SkyParams())
