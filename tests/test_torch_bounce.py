"""Path bounce of the PyTorch port (kernels B4-B6) against the JAX package.

On the CPU the port runs each kernel's plain version; it is held against
the Pallas kernels ``_bounce_trace_kernel``, ``_bounce_shade_kernel`` and
``_bounce_kernel`` in interpret mode (``bounce_step_split``,
``bounce_step``, ``trace_with_first_hit``), on the same states and light
sets. tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions on the card.

What must agree, and how closely:

- the pcg4d uniforms of a bounce: bit for bit;
- a bounce ray's hit: XLA contracts the Woop test's multiply-adds into
  FMAs on the CPU and the port rounds each operation, and the bounce
  directions go through sin, cos and rsqrt, which round differently by an
  ulp; so a ray that grazes a triangle edge may hit on one side and miss
  on the other. Each test states the share of rays that must agree;
- on rays that agree on the hit: alive (row 13) and the hit material
  exactly, radiance and the specular flag to rtol 1e-4, and every row to
  rtol 1e-4 where the ray found its hit. A ray that did not find one
  (dead at the input, or missed) still moves on, sampled from whatever
  surface it got -- for a miss a zero-attribute one (roughness 0), where
  the sampled pdf swings by percents with an ulp of the direction.

The path options (``test_bounce_options_match_jax``) are held the same
way: the sky and the sun disk on rays that miss (B4, B6), sun NEE with its
shadow segment (B5, B6), path regularization and the firefly clamp (B5,
B6). No ray of these sets meets the sun disk's rim, where one ulp of the
direction moves the radiance by about 1e3 (tests/test_torch_sky.py).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.core.vec3 import V3 as JV3
from zetaray_tpu.ops import shading_soa as JS
from zetaray_tpu.ops.pathtracer import PTConfig as JPTConfig
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.core.rng import bounce_uniforms
from zetaray_tpu_torch.core.vec3 import V3 as TV3
from zetaray_tpu_torch.ops import shading_soa as TS
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV
from tests.test_torch_intersect import _random_rays
from tests.test_torch_restir_di import T
from tests.test_torch_scene import SCENES, frame_seed, scene_pair
from tests.test_torch_shading import _unit

torch.set_num_threads(1)

N = 256  # rays per test, one tile
RT = 256
SEED = frame_seed(11)
CFG = dict(max_bounces=3, min_emissive_bounce=1, rr_start=3)
RTOL, ATOL = 1e-4, 1e-5


def _bounce0_rays(tdev):
    """Rays leaving the primary hits of a 16^2 camera as ReSTIR GI's
    initial samples leave them."""
    from zetaray_tpu_torch.ops.restir_gi import secondary_rays

    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    o, d = cam.generate_rays(16, 16, device="cpu")
    o2, d2, _, _ = secondary_rays(MK.gbuffer_plain(tdev, o, d), SEED)
    return o2.numpy(), d2.numpy()


def _state(o, d, seed=5):
    """A path state over rays o, d with varied throughput, radiance, pdf,
    alive (about 85%), specular flag and cone width."""
    r = np.random.default_rng(seed)
    st = np.zeros((16, o.shape[0]), np.float32)
    st[0:3], st[3:6] = o.T, d.T
    st[6:9] = r.uniform(0.05, 1.0, (3, o.shape[0]))
    st[9:12] = r.uniform(0.0, 0.5, (3, o.shape[0]))
    st[12] = r.uniform(0.05, 4.0, o.shape[0])
    st[13] = r.uniform(0, 1, o.shape[0]) < 0.85
    st[14] = r.uniform(0, 1, o.shape[0]) < 0.3
    st[15] = r.uniform(0, 0.01, o.shape[0])
    return st


@pytest.fixture(scope="module", params=["cornell", "random300"])
def case(request):
    name = request.param
    jdev, tdev = scene_pair(SCENES[name]())
    o, d = _bounce0_rays(tdev) if name == "cornell" else _random_rays(21, n=N, spread=3.0)
    has_lights = tdev.num_emissives > 0
    if has_lights:
        lsets = JMK.build_light_sets(jdev, jnp.uint32(SEED))
    else:  # what the JAX trace hands its kernels when the scene has no lights
        lsets = jnp.zeros((JMK.NS, JMK.LSET_ROWS, JMK.PS))
    out = dict(name=name, jdev=jdev, tdev=tdev, st=_state(o, d), has_lights=has_lights,
               lsets=lsets, woop3=jdev.woop.reshape(4, 3, -1), attrs_t=jdev.tri_attrs.T)
    out["agree"], out["found"], out["surf"], out["surf_want"] = _hit_agreement(out)
    return out


def _hit_agreement(case):
    """(rays whose B4 hit surface agrees between the two packages, rays that
    are alive and hit, the port's and the JAX surface rows)."""
    st = case["st"]
    jcfg = JPTConfig(**CFG)
    _, want, _ = JMK.trace_with_first_hit(
        case["jdev"], jnp.asarray(st[0:3].T), jnp.asarray(st[3:6].T), jnp.uint32(SEED),
        dataclasses.replace(jcfg, max_bounces=0), rt=RT, interpret=True,
    )
    st2, got = MK.bounce_trace_plain(case["tdev"], T(st), 0, PTConfig(**CFG),
                                     case["has_lights"])
    want = np.asarray(want)
    same = np.isclose(got.numpy(), want, rtol=RTOL, atol=ATOL).all(0)
    return same, st2[13].numpy() > 0.5, got.numpy(), want


def _check_state(got, want, agree, found):
    """Every row on rays that agree on the hit and found it; radiance,
    alive and the specular flag on every ray that agrees on the hit."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape == (16, N)
    assert agree.mean() >= 0.97
    np.testing.assert_array_equal(got[13, agree], want[13, agree])
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert close[[9, 10, 11, 13, 14]][:, agree].all(0).mean() >= 0.99
    assert close[:, agree & found].all(0).mean() >= 0.99


def test_bounce_uniforms_bit_exact():
    for bounce in (0, 1, 2, 15):
        for seed in (0, SEED, 2**32 - 1):
            want = np.asarray(JMK.bounce_uniforms(4096, bounce, jnp.uint32(seed)))
            got = bounce_uniforms(4096, bounce, seed)
            assert got.dtype == torch.float32 and got.shape == (5, 4096)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metallic", [0.0, 0.5, 1.0])
def test_bsdf_sample_matches_jax(metallic):
    r = np.random.default_rng(int(metallic * 10) + 3)
    n = 4096
    base = r.uniform(0, 1, (3, n)).astype(np.float32)
    rough = r.uniform(0.1, 1.0, n).astype(np.float32)
    ior = r.uniform(1.01, 2.0, n).astype(np.float32)
    metal = np.full(n, metallic, np.float32)
    wo = _unit(r, n, upper=True)
    u = r.uniform(0, 1, (3, n)).astype(np.float32)
    jm = JS.MatSoA(JV3(*map(jnp.asarray, base)), jnp.asarray(metal), jnp.asarray(rough),
                   jnp.asarray(ior))
    tm = TS.MatSoA(TV3(*map(torch.from_numpy, base)), torch.from_numpy(metal),
                   torch.from_numpy(rough), torch.from_numpy(ior))
    wj, gj, pj = JS.bsdf_sample(jm, JV3(*map(jnp.asarray, wo)), *map(jnp.asarray, u))
    wt, gt, pt = TS.bsdf_sample(tm, TV3(*map(torch.from_numpy, wo)), *map(torch.from_numpy, u))
    # sin/cos/rsqrt differ by an ulp between XLA and PyTorch. Directions and
    # weights stay within 1e-4; the pdf at the GGX peak scales as about
    # 1/roughness^4 (see test_bsdf_eval_matches_jax), so at roughness 0.05
    # an ulp of the half vector moves it by a few percent.
    for a, b in [*zip(wt, wj), *zip(gt, gj)]:
        a, b = a.numpy(), np.asarray(b)
        assert np.isclose(a, b, rtol=1e-4, atol=1e-6).mean() >= 0.999
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)
    a, b = pt.numpy(), np.asarray(pj)
    assert np.isclose(a, b, rtol=1e-3, atol=1e-6).mean() >= 0.95
    np.testing.assert_allclose(a, b, rtol=5e-2, atol=1e-6)
    assert (np.asarray(pj) > 0).mean() > 0.5
    pa, pb = (r.uniform(0, 10, n).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        TS.power_heuristic(torch.from_numpy(pa), torch.from_numpy(pb)).numpy(),
        np.asarray(JS.power_heuristic(jnp.asarray(pa), jnp.asarray(pb))), rtol=1e-6)


def test_bounce_trace_plain_matches_jax(case):
    """B4 state (all rows) and surface rows against the split trace kernel."""
    st = case["st"]
    agree, found = case["agree"], case["found"]
    jcfg = JPTConfig(**CFG)
    for bounce in (0, 1):
        want = JMK.bounce_step_split(
            jnp.asarray(st), case["woop3"], case["attrs_t"], case["lsets"], bounce,
            jnp.uint32(SEED), jcfg, last=True, has_lights=case["has_lights"], rt=RT,
            interpret=True, spread_angle=0.004,
        )
        got, _ = MK.bounce_trace_plain(case["tdev"], T(st), bounce, PTConfig(**CFG),
                                       case["has_lights"], spread_angle=0.004)
        _check_state(got, want, agree, found)
    # the winner's material rows match exactly where the hit agrees
    for r in (9, 10, 11, 12, 13, 14, 21):
        np.testing.assert_array_equal(case["surf"][r, agree], case["surf_want"][r, agree])


def test_bounce_shade_plain_matches_jax(case):
    """B4 then B5 (one split bounce) against ``bounce_step_split``."""
    st = case["st"]
    agree, found = case["agree"], case["found"]
    jcfg = JPTConfig(**CFG)
    want = JMK.bounce_step_split(
        jnp.asarray(st), case["woop3"], case["attrs_t"], case["lsets"], 0, jnp.uint32(SEED),
        jcfg, last=False, has_lights=case["has_lights"], rt=RT, interpret=True,
    )
    cfg = PTConfig(**CFG)
    st2, surf = MK.bounce_trace_plain(case["tdev"], T(st), 0, cfg, case["has_lights"])
    got = MK.bounce_shade_plain(case["tdev"], st2, surf, T(case["lsets"]), 0, SEED, cfg,
                                case["has_lights"], RT)
    _check_state(got, want, agree, found)


@pytest.mark.parametrize("bounce,last", [(1, False), (3, False), (2, True)])
def test_bounce_plain_matches_jax(case, bounce, last):
    """B6 against ``bounce_step``; bounce 3 runs Russian roulette."""
    st = case["st"]
    agree, found = case["agree"], case["found"]
    want = JMK.bounce_step(
        jnp.asarray(st), case["woop3"], case["attrs_t"], case["lsets"], bounce,
        jnp.uint32(SEED), JPTConfig(**CFG), last=last, has_lights=case["has_lights"], rt=RT,
        interpret=True,
    )
    got = MK.bounce_plain(case["tdev"], T(st), T(case["lsets"]), bounce, SEED, PTConfig(**CFG),
                          last, case["has_lights"], RT)
    _check_state(got, want, agree, found)


def test_trace_with_first_hit_matches_jax():
    """The whole GI trace (B4, B5, then B6 twice) from bounce-0 rays."""
    jdev, tdev = scene_pair(SCENES["cornell"]())
    o, d = _bounce0_rays(tdev)
    cfg = dict(max_bounces=2, min_emissive_bounce=1, min_nee_bounce=0)
    jr, js, ja = JMK.trace_with_first_hit(jdev, jnp.asarray(o), jnp.asarray(d),
                                          jnp.uint32(SEED), JPTConfig(**cfg), rt=RT,
                                          interpret=True, spread_angle=0.004)
    lsets = MK.build_light_sets(tdev, SEED)
    tr, ts, ta = MK.trace_with_first_hit(tdev, T(o), T(d), SEED, PTConfig(**cfg), RT,
                                         light_sets=lsets, spread_angle=0.004)
    jr, js, ja = map(np.asarray, (jr, js, ja))
    surf_ok = np.isclose(ts.numpy(), js, rtol=RTOL, atol=ATOL).all(0)
    assert surf_ok.mean() >= 0.97
    np.testing.assert_array_equal(ta.numpy()[surf_ok], ja[surf_ok])
    rad_ok = np.isclose(tr.numpy(), jr, rtol=1e-3, atol=1e-4).all(0)
    assert rad_ok.mean() >= 0.95
    assert jr.mean() > 0.01
    # the radiance estimate agrees on the whole: its mean within 3%
    assert abs(tr.numpy().mean() - jr.mean()) <= 0.03 * jr.mean()


SUN = (0.2, 0.45, 0.87)  # in through the box's opening at +z
OPTS = {
    "sky": dict(sky=SUN),
    "sky_no_sun_nee": dict(sky=SUN, sun_nee=False),
    "regularized": dict(path_regularization=True),
    "firefly": dict(firefly_clamp=0.05),
}


def _opt_cfgs(opt):
    """(JAX PTConfig, port PTConfig) of CFG with the path option ``opt``."""
    kw = dict(OPTS[opt])
    sky = kw.pop("sky", None)
    return (JPTConfig(**CFG, **kw, sky=None if sky is None else JSkyParams(sun_dir=sky)),
            PTConfig(**CFG, **kw, sky=None if sky is None else SkyParams(sun_dir=sky)))


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_bounce_options_match_jax(case, opt):
    """Each path option through B4 (trace), B4 then B5 (one split bounce)
    and B6 (a whole bounce, and for the sky its trace-only last bounce)
    against ``bounce_step_split`` and ``bounce_step``, at bounce 1 (path
    regularization starts there); each option changes the rows it acts on
    (direction, throughput or radiance)."""
    st = case["st"]
    agree, found = case["agree"], case["found"]
    jcfg, cfg = _opt_cfgs(opt)
    b = 1
    args = (case["woop3"], case["attrs_t"], case["lsets"], b, jnp.uint32(SEED))
    want4 = JMK.bounce_step_split(jnp.asarray(st), *args, jcfg, last=True,
                                  has_lights=case["has_lights"], rt=RT, interpret=True)
    st4, surf = MK.bounce_trace_plain(case["tdev"], T(st), b, cfg, case["has_lights"])
    _check_state(st4, want4, agree, found)
    want5 = JMK.bounce_step_split(jnp.asarray(st), *args, jcfg, last=False,
                                  has_lights=case["has_lights"], rt=RT, interpret=True)
    got5 = MK.bounce_shade_plain(case["tdev"], st4, surf, T(case["lsets"]), b, SEED, cfg,
                                 case["has_lights"], RT)
    _check_state(got5, want5, agree, found)
    lasts = (False, True) if cfg.sky is not None else (False,)
    for last in lasts:
        want6 = JMK.bounce_step(jnp.asarray(st), *args, jcfg, last=last,
                                has_lights=case["has_lights"], rt=RT, interpret=True)
        got6 = MK.bounce_plain(case["tdev"], T(st), T(case["lsets"]), b, SEED, cfg, last,
                               case["has_lights"], RT)
        _check_state(got6, want6, agree, found)
    # the option changes the rows it acts on (the firefly clamp, the NEE
    # radiance, only where the scene has lights)
    base = MK.bounce_plain(case["tdev"], T(st), T(case["lsets"]), b, SEED, PTConfig(**CFG),
                           False, case["has_lights"], RT)
    got = MK.bounce_plain(case["tdev"], T(st), T(case["lsets"]), b, SEED, cfg, False,
                          case["has_lights"], RT)
    changed = (got != base)[3:12].any(0).float().mean().item()
    if opt == "firefly" and not case["has_lights"]:
        assert changed == 0.0
    else:
        assert changed > 0.02, opt
