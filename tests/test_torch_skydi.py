"""SkyDI (``ops/skydi.py``) of the PyTorch port against the JAX package,
pass by pass, and its estimator on a floor under the open sky.

The passes run at 32^2 on the procedural box with the sun shining in
through its opening; each gets the inputs the JAX run produced, and the
temporal pass merges the JAX reservoirs of the previous frame (camera
moved). A candidate's pick compares a uniform with a running sum, and the
sun disk's radiance on its rim moves by percents with one ulp of a cosine
that XLA fuses and PyTorch does not, so the reservoirs agree on a stated
share of pixels. The pairwise pass's
unbiasedness is held as tests/test_skydi.py holds the JAX pass: the mean
over seeds of the shaded floor against a quadrature of f * Le * cos.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.ops import gbuffer_pack as JGP
from zetaray_tpu.ops import skydi as JSD
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.scene.scene import CpuScene, MaterialsSoA
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import skydi as TSD
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import cornell_box
from tests.test_skydi import _quadrature
from tests.test_torch_frame import _camera, _seed
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_scene import scene_pair, to_port_cpu_scene

torch.set_num_threads(1)

RES = 32
SUN = (0.2, 0.45, 0.87)  # in through the box's opening at +z
SKY_J, SKY_T = JSkyParams(sun_dir=SUN), SkyParams(sun_dir=SUN)


@pytest.fixture(scope="module")
def run():
    """The JAX SkyDI chain over a previous and a current frame."""
    jdev, tdev = scene_pair(cornell_box())
    out = {"jdev": jdev, "tdev": tdev}
    cfg = JSD.SkyDIConfig()
    for tag, k in (("prev", 0), ("curr", 1)):
        cam = _camera(k)
        o, d = cam.generate_rays(RES, RES)
        gb = jax_gbuffer(jdev, o, d, interpret=True)
        seed = _seed(k)
        out[tag] = dict(cam=cam, seed=seed, gb=gb,
                        res0=JSD.initial_candidates(gb, SKY_J, jnp.uint32(seed), cfg))
    p, c = out["prev"], out["curr"]
    c["res_t"] = JSD.temporal_reuse(c["res0"], p["res0"], JGP.pack_temporal(p["gb"]), c["gb"],
                                    p["cam"], RES, RES, jnp.uint32(c["seed"]), cfg, SKY_J)
    return out


def _agree(got, want, rtol=1e-4, atol=1e-5):
    return np.isclose(got, np.asarray(want), rtol=rtol, atol=atol).all(0).mean()


def test_config_matches_the_reference():
    assert TSD.SkyDIConfig() == TSD.SkyDIConfig(**vars(JSD.SkyDIConfig()))
    for a, b in zip(TSD._sun_basis(SKY_T), JSD._sun_basis(SKY_J)):
        np.testing.assert_array_equal(np.float32(a), b)


def test_initial_candidates_match_jax(run):
    """Every row on each pixel whose sun-cone candidate lies off the disk's
    rim. A candidate at cos z = 1 - u (1 - cos r) is on the rim's ramp for
    u > 0.75, where one float32 ulp of its cosine with the sun (XLA's fused
    dot against PyTorch's) moves the disk's radiance by percents
    (tests/test_torch_sky.py leaves the rim out): those pixels' Le and
    weights may differ, and on 80% of them they still agree."""
    from zetaray_tpu_torch.core.rng import uniform4

    c = run["curr"]
    got = TSD.initial_candidates(T(c["gb"]), SKY_T, c["seed"], TSD.SkyDIConfig()).numpy()
    want = np.asarray(c["res0"])
    assert got.shape == want.shape == (16, RES * RES)
    assert (want[11] > 0).mean() > 0.3  # pixels that see the sky through the opening
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(0)
    u_sun = uniform4(torch.arange(RES * RES), 0, c["seed"], salt=0x50D1)[0].numpy()
    rim = u_sun > 0.74
    assert 0.2 < rim.mean() < 0.35
    assert ok[~rim].all()
    assert ok[rim].mean() >= 0.8


def test_temporal_reuse_matches_jax(run):
    """Frame 1's candidates merged with the JAX reservoirs of frame 0."""
    p, c = run["prev"], run["curr"]
    got = TSD.temporal_reuse(T(c["res0"]), T(p["res0"]), T(JGP.pack_temporal(p["gb"])),
                             T(c["gb"]), camera_from_arrays(cam_dict(p["cam"])), RES, RES,
                             c["seed"], TSD.SkyDIConfig(), SKY_T).numpy()
    want = np.asarray(c["res_t"])
    assert (want[10] > 3).mean() > 0.5  # reuse happened
    assert _agree(got, want) >= 0.99


@pytest.mark.parametrize("mis", ["biased", "pairwise"])
def test_spatial_reuse_matches_jax(run, mis):
    c = run["curr"]
    kw = dict(spatial_mis=mis, spatial_iterations=2)
    want = np.asarray(JSD.spatial_reuse(c["res_t"], c["gb"], RES, RES, jnp.uint32(c["seed"]),
                                        JSD.SkyDIConfig(**kw)))
    got = TSD.spatial_reuse(T(c["res_t"]), T(c["gb"]), RES, RES, c["seed"],
                            TSD.SkyDIConfig(**kw)).numpy()
    assert (want[10] > np.asarray(c["res_t"])[10]).mean() > 0.2  # neighbours merged
    assert _agree(got, want) >= 0.99


def test_shade_matches_jax(run):
    """The shade's segments toward the winning directions (B3's plain
    version here): radiance to 1e-4 on 99.5% of the pixels, and the mean."""
    c = run["curr"]
    res = JSD.spatial_reuse(c["res_t"], c["gb"], RES, RES, jnp.uint32(c["seed"]),
                            JSD.SkyDIConfig())
    want = np.asarray(JSD.shade(run["jdev"], res, c["gb"]))
    got = TSD.shade(run["tdev"], T(res), T(c["gb"])).numpy()
    assert got.shape == want.shape == (3, RES * RES) and want.max() > 0
    assert _agree(got, want) >= 0.995
    np.testing.assert_allclose(got.mean(1), want.mean(1), rtol=1e-4)


@pytest.fixture(scope="module")
def floor():
    """The port's 100 x 100 Lambertian floor under the open sky, and a
    G-buffer of 16^2 pixels on it (camera above, looking down)."""
    v = np.array([[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]], np.float64)
    tris = ([0, 2, 1], [0, 3, 2])  # facing +y
    v0, v1, v2 = (np.stack([v[t[i]] for t in tris]) for i in range(3))
    g = np.cross(v1 - v0, v2 - v0)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    one = lambda x, dt=np.float32: np.asarray([x], dt)
    mats = MaterialsSoA(
        base_color=np.array([[0.6, 0.5, 0.4]], np.float32), metallic=one(0.0),
        roughness=one(1.0), emissive=np.zeros((1, 3), np.float32), ior=one(1.5),
        transmission=one(0.0), coat_weight=one(0.0), coat_roughness=one(0.0),
        double_sided=one(False, bool), base_color_tex=one(-1, np.int32),
        normal_tex=one(-1, np.int32), metallic_roughness_tex=one(-1, np.int32),
        emissive_tex=one(-1, np.int32), alpha_cutoff=one(0.0),
    )
    z2 = np.zeros((2, 2), np.float32)
    cpu = CpuScene(v0=v0, v1=v1, v2=v2, n0=g.copy(), n1=g.copy(), n2=g.copy(), uv0=z2,
                   uv1=z2, uv2=z2, mat_id=np.zeros(2, np.int32), materials=mats,
                   emissive_tris=np.zeros(0, np.int32))
    scene = TS.upload_scene(to_port_cpu_scene(cpu), device="cpu")
    cam = Camera.look_at((0, 3.0, 0.01), (0, 0, 0), vfov_deg=40, aspect=1.0)
    from zetaray_tpu_torch.accel.megakernel import gbuffer

    return scene, gbuffer(scene, *cam.generate_rays(16, 16, device="cpu"))


@pytest.mark.parametrize("mis", ["biased", "pairwise"])
def test_spatial_reuse_unbiased_on_the_floor(floor, mis):
    """E[shade] over 20 seeds with one spatial pass of 3 neighbours stays on
    the quadrature of f * Le * cos over the sky and the sun (to 12%, the
    bound tests/test_skydi.py holds the JAX pass to): wrong pairwise MIS
    denominators shift the mean even on a uniform floor."""
    scene, gb = floor
    sky = SkyParams(sun_dir=(0.3, 0.8, 0.2))
    cfg = TSD.SkyDIConfig(temporal=False, spatial_iterations=1, spatial_mis=mis,
                          spatial_neighbors=3)
    acc = 0.0
    for i in range(20):
        res = TSD.initial_candidates(gb, sky, 2000 + i, cfg)
        res = TSD.spatial_reuse(res, gb, 16, 16, 3000 + i, cfg)
        acc = acc + TSD.shade(scene, res, gb).numpy()
    got = (acc / 20).mean(1)
    want = _quadrature(JSkyParams(sun_dir=(0.3, 0.8, 0.2)), np.array([0.6, 0.5, 0.4]))
    np.testing.assert_allclose(got, want, rtol=0.12)
