"""Glass and coated materials in the PyTorch port against the JAX package:
the transmission and coat lobes of ``ops.shading_soa``, the scene flags,
the rows kernels B1, B4 and B7 hand on (transmission, eta, coat), B2 under
the JAX kernel's ``full``/``trans``/``coat`` and the plain B4-B6 on the
materials box against the Pallas bounce kernels in interpret mode.

What must agree, and how closely:

- the lobes: on directions that enter and leave glass (eta = 1/ior and
  ior), at total internal reflection, at grazing angles (a quarter of the
  outgoing directions within 3 degrees of the surface) and under coats of
  weight 0, 0.5 and 1, the BSDF and its pdf agree to 1e-3 relative
  everywhere but at the sharpest GGX peaks (roughness 0.02: an ulp of the
  half vector, which rsqrt rounds its own way on each side, moves the
  value there by up to 1e-3), and to 2e-5 on 99.8% of them. A sampled
  direction flips lobe where its pick sits on a threshold (the
  reflect-or-refract choice, total internal reflection), so samples agree
  on shares, each stated below;
- the bounce kernels: as tests/test_torch_bounce.py states, with the
  shares stated per test.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.core.vec3 import V3 as JV3
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.ops import shading_soa as JS
from zetaray_tpu.ops.pathtracer import PTConfig as JPTConfig
from zetaray_tpu_torch import interop
from zetaray_tpu_torch.accel import intersect as XI
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.core.vec3 import V3 as TV3
from zetaray_tpu_torch.ops import restir_di as TRD
from zetaray_tpu_torch.ops import shading_soa as TS
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import pick_rt
from zetaray_tpu_torch.scene import procedural as P
from zetaray_tpu_torch.scene import scene as TSC
from zetaray_tpu_torch.scene.camera import Camera
from tests.test_torch_bounce import _bounce0_rays, _state
from tests.test_torch_restir_di import T
from tests.test_torch_scene import frame_seed, jax_scene_arrays, scene_pair
from tests.test_torch_shading import _unit

torch.set_num_threads(1)

N = 256
RT = 256
SEED = frame_seed(12)
CFG = dict(max_bounces=3, min_emissive_bounce=1, rr_start=3)
RTOL, ATOL = 1e-4, 1e-5


def _materials(trans, coat, n=8192, seed=3):
    """Random materials and directions: (JAX MatSoA, port MatSoA, wo, wi, u).
    Half the materials face the ray from inside (eta = ior), transmission
    is 0, 0.5 or 1, a quarter of the outgoing directions graze the surface."""
    r = np.random.default_rng(seed)
    base = r.uniform(0, 1, (3, n)).astype(np.float32)
    rough = r.uniform(0.02, 1.0, n).astype(np.float32)
    ior = r.uniform(1.01, 2.0, n).astype(np.float32)
    metal = r.choice([0.0, 0.0, 0.5, 1.0], n).astype(np.float32)
    t = r.choice([0.0, 0.5, 1.0, 1.0], n).astype(np.float32)
    eta = np.where(r.uniform(0, 1, n) < 0.5, 1.0 / ior, ior).astype(np.float32)
    cw = np.full(n, 0.0 if coat is None else coat, np.float32)
    cr = r.uniform(0.02, 0.5, n).astype(np.float32)
    wo = _unit(r, n, upper=True)
    wo[2] = np.where(r.uniform(0, 1, n) < 0.25, r.uniform(1e-4, 0.05, n), wo[2])
    wo = (wo / np.linalg.norm(wo, axis=0)).astype(np.float32)
    wi = _unit(r, n)
    u = r.uniform(0, 1, (3, n)).astype(np.float32)

    def mat(pkg, vec, f):
        return pkg.MatSoA(vec(*map(f, base)), f(metal), f(rough), f(ior),
                          transmission=f(t) if trans else None, eta=f(eta) if trans else None,
                          coat=None if coat is None else f(cw),
                          coat_roughness=None if coat is None else f(cr))

    return (mat(JS, JV3, jnp.asarray), mat(TS, TV3, torch.from_numpy), wo, wi, u, eta)


LOBES = [(trans, coat) for trans in (False, True) for coat in (None, 0.0, 0.5, 1.0)]
LOBE_IDS = [f"{'glass' if t else 'opaque'}-coat{c}" for t, c in LOBES]


@pytest.mark.parametrize("trans,coat", LOBES, ids=LOBE_IDS)
def test_bsdf_eval_lobes_match_jax(trans, coat):
    jm, tm, wo, wi, _, eta = _materials(trans, coat)
    fj, pj = JS.bsdf_eval(jm, JV3(*map(jnp.asarray, wo)), JV3(*map(jnp.asarray, wi)))
    ft, pt = TS.bsdf_eval(tm, TV3(*map(torch.from_numpy, wo)), TV3(*map(torch.from_numpy, wi)))
    for a, b in [*zip(ft, fj), (pt, pj)]:
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all()
        assert np.isclose(a, b, rtol=1e-3, atol=1e-7).mean() >= 0.9998
        assert np.isclose(a, b, rtol=2e-5, atol=1e-7).mean() >= 0.998
    below = wi[2] < -1e-6
    if trans:  # the transmission lobe answers below the surface, both faces
        pj = np.asarray(pj)
        for face in (eta < 1.0, eta > 1.0):
            assert (pj[below & face] > 0).mean() > 0.05
    else:
        assert (pt.numpy()[below] == 0).all()


@pytest.mark.parametrize("trans,coat", LOBES, ids=LOBE_IDS)
def test_bsdf_sample_lobes_match_jax(trans, coat):
    """Directions agree to 1e-4 on 99.9% of samples; the weights (f |cos| /
    pdf) to 1e-4 on 98.5% (the coat at roughness 0.02 has the sharpest
    peak) and to 1e-3 on 99.5%; the pdf to 1e-3 on 92%. Transmitted
    samples occur through both faces, and total internal reflection kills
    samples that leave the glass at grazing angles."""
    jm, tm, wo, _, u, eta = _materials(trans, coat)
    wj, gj, pj = JS.bsdf_sample(jm, JV3(*map(jnp.asarray, wo)), *map(jnp.asarray, u))
    wt, gt, pt = TS.bsdf_sample(tm, TV3(*map(torch.from_numpy, wo)), *map(torch.from_numpy, u))
    for a, b in zip(wt, wj):
        assert np.isclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6).mean() >= 0.999
    for a, b in zip(gt, gj):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all()
        assert np.isclose(a, b, rtol=1e-4, atol=1e-6).mean() >= 0.985
        assert np.isclose(a, b, rtol=1e-3, atol=1e-6).mean() >= 0.995
    assert np.isclose(pt.numpy(), np.asarray(pj), rtol=1e-3, atol=1e-6).mean() >= 0.92
    down = (wt.z.numpy() < 0) & (pt.numpy() > 0)
    if trans:
        assert down[eta < 1.0].mean() > 0.1 and down[eta > 1.0].mean() > 0.05
        # leaving the glass (eta = ior) past the critical angle: no sample
        dead = pt.numpy() == 0
        assert dead[(eta > 1.0) & (wo[2] < 0.05)].mean() > dead[eta < 1.0].mean()
    else:
        assert not down.any()


def test_fresnel_dielectric_matches_jax():
    """The exact dielectric Fresnel at total internal reflection and around
    it (the critical cosine of each eta)."""
    r = np.random.default_rng(5)
    eta = r.uniform(0.4, 2.5, 4096).astype(np.float32)
    crit = np.sqrt(np.clip(1.0 - 1.0 / eta**2, 0.0, 1.0))
    cos = np.concatenate([r.uniform(0, 1, 2048), crit[2048:] + r.uniform(-1e-3, 1e-3, 2048)])
    cos = cos.astype(np.float32)
    want = np.asarray(JS._fresnel_scalar_dielectric(jnp.asarray(cos), jnp.asarray(eta)))
    got = TS._fresnel_scalar_dielectric(torch.from_numpy(cos), torch.from_numpy(eta)).numpy()
    assert (want == 1.0).mean() > 0.2  # total internal reflection
    # the TIR test sin2_t >= 1 sits on a threshold (XLA fuses its
    # multiply-adds): all but a few cosines at the critical angle agree
    assert np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() >= 0.998
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-2)


def test_materials_box_scene():
    """The upload computes has_transmission and has_coat from the materials
    (as the JAX upload does), the tables match JAX's, and the converters
    accept glass and coat and still refuse alpha cutout."""
    cpu = P.materials_box()
    jdev, tdev = scene_pair(cpu)
    assert tdev.has_transmission and tdev.has_coat
    assert (jdev.has_transmission, jdev.has_coat) == (True, True)
    for k in ("tri_attrs", "woop", "mat_transmission", "mat_coat_weight", "mat_coat_roughness"):
        np.testing.assert_allclose(getattr(tdev, k).numpy(), np.asarray(getattr(jdev, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    conv = interop.scene_from_arrays(jax_scene_arrays(jdev), device="cpu")
    assert conv.has_transmission and conv.has_coat
    np.testing.assert_array_equal(conv.tri_attrs.numpy(), tdev.tri_attrs.numpy())
    assert not TSC.upload_scene(P.cornell_box(), device="cpu").has_transmission
    for only, flags in (("transmission", (True, False)), ("coat_weight", (False, True))):
        m = cpu.materials
        other = "coat_weight" if only == "transmission" else "transmission"
        one = dataclasses.replace(cpu, materials=dataclasses.replace(
            m, **{other: np.zeros_like(getattr(m, other))}))
        s = TSC.upload_scene(one, device="cpu")
        assert (s.has_transmission, s.has_coat) == flags


def test_cutout_still_refused():
    """Alpha cutout is ported (tests/test_torch_cutout.py); what stays
    refused is a cutout without an alpha atlas. MASK-mode materials without
    a base-colour map give no atlas, so the upload, as the JAX one, gives a
    scene without cutout; a scene that claims cutout without an atlas is
    refused."""
    cpu = P.materials_box()
    cut = dataclasses.replace(cpu, materials=dataclasses.replace(
        cpu.materials, alpha_cutoff=np.full(6, 0.5, np.float32)))
    jdev, tdev = scene_pair(cut)
    assert not tdev.has_cutout and not jdev.has_cutout and tdev.alpha_tex is None
    np.testing.assert_array_equal(tdev.tri_attrs.numpy(), np.asarray(jdev.tri_attrs))
    arrays = jax_scene_arrays(scene_pair(cpu)[0])
    with pytest.raises(ValueError, match="alpha atlas"):
        interop.scene_from_arrays({**arrays, "has_cutout": True}, device="cpu")


@pytest.fixture(scope="module")
def box():
    jdev, tdev = scene_pair(P.materials_box())
    cam = Camera.look_at(P.CAMERA_EYE, P.CAMERA_TARGET, vfov_deg=P.CAMERA_VFOV, aspect=1.0)
    o, d = cam.generate_rays(32, 32, device="cpu")
    return dict(jdev=jdev, tdev=tdev, o=o, d=d)


def test_gbuffer_material_rows_match_jax(box):
    """B1's plain version hands on G.TRANS, G.ETA (1/ior from the front,
    ior from inside), G.COATW and G.COATR on the glass and the coated block
    as the JAX kernel does (the rows the ReSTIR passes read)."""
    gt = MK.gbuffer_plain(box["tdev"], box["o"], box["d"]).numpy()
    gj = np.asarray(JMK.gbuffer(box["jdev"], jnp.asarray(box["o"].numpy()),
                                jnp.asarray(box["d"].numpy()), interpret=True))
    valid = gt[MK.G.VALID] > 0.5
    same = (gt[MK.G.MATID] == gj[MK.G.MATID]) & valid
    assert same.sum() >= 0.99 * valid.sum()
    glass, coated = gt[MK.G.TRANS] > 0.5, gt[MK.G.COATW] > 0.5
    assert glass.sum() > 50 and coated.sum() > 50
    for r in (MK.G.TRANS, MK.G.ETA, MK.G.COATW, MK.G.COATR):
        np.testing.assert_array_equal(gt[r, same], gj[r, same])
    np.testing.assert_allclose(gt[MK.G.ETA, glass], 1.0 / 1.5, rtol=1e-6)


def test_closest_attributes_carry_materials(box):
    """B7's plain version returns the whole attribute row, the rc material
    of ReSTIR PT included, on prefix rays into the glass and the coat."""
    from zetaray_tpu_torch.ops.restir_pt import prefix_rays

    gb = MK.gbuffer_plain(box["tdev"], box["o"], box["d"])
    o7, d7 = prefix_rays(gb, SEED, trans=True, coat=True)
    sh = XI.closest_hit_plain_shaded(box["tdev"].woop, box["tdev"].tri_attrs, o7, d7)
    hit = sh.tri >= 0
    want = box["tdev"].tri_attrs[sh.tri[hit]].T
    torch.testing.assert_close(sh.attrs[:, hit], want, rtol=0, atol=0)
    from zetaray_tpu_torch.scene.scene import A

    assert (sh.attrs[A.TRANS, hit] > 0.5).sum() > 5 and (sh.attrs[A.COATW, hit] > 0.5).sum() > 5


def test_ris_full_trans_coat_matches_jax(box):
    """The Pallas ``_ris_kernel`` with ``full=True, trans=True, coat=True``
    rates every entry with the albedo/pi target, as it does without them:
    the port's ``initial_candidates_plain`` (which reads no flag) picks the
    same entry on at least 99.5% of the pixels and agrees to 1e-5 there."""
    gb_t = MK.gbuffer_plain(box["tdev"], box["o"], box["d"])
    gb_j = jnp.asarray(gb_t.numpy())
    lsets = MK.build_light_sets(box["tdev"], SEED)
    rt = pick_rt(gb_t.shape[1])
    want = np.asarray(JRD.initial_candidates(
        gb_j, jnp.asarray(lsets.numpy()), jnp.uint32(SEED), JRD.ReSTIRConfig(full_target=True),
        rt=rt, interpret=True, trans=True, coat=True))
    plain = np.asarray(JRD.initial_candidates(
        gb_j, jnp.asarray(lsets.numpy()), jnp.uint32(SEED), JRD.ReSTIRConfig(), rt=rt,
        interpret=True))
    np.testing.assert_array_equal(want, plain)  # the flags change nothing in the kernel
    got = TRD.initial_candidates(gb_t, lsets, SEED, rt=rt, trans=True, coat=True).numpy()
    same = (got[0:3] == want[0:3]).all(0)
    assert same.mean() >= 0.995
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    """The bounce kernels' inputs on the materials box: the GI bounce-0 rays
    of a 16^2 camera (rays onto the glass from outside) and the JAX and
    port states."""
    jdev, tdev = scene_pair(P.materials_box())
    o, d = _bounce0_rays(tdev)
    lsets = JMK.build_light_sets(jdev, jnp.uint32(SEED))
    out = dict(jdev=jdev, tdev=tdev, st=_state(o, d), lsets=lsets,
               woop3=jdev.woop.reshape(4, 3, -1), attrs_t=jdev.tri_attrs.T)
    st = out["st"]
    _, want, _ = JMK.trace_with_first_hit(
        jdev, jnp.asarray(st[0:3].T), jnp.asarray(st[3:6].T), jnp.uint32(SEED),
        JPTConfig(**{**CFG, "max_bounces": 0}), rt=RT, interpret=True)
    st2, got = MK.bounce_trace_plain(tdev, T(st), 0, PTConfig(**CFG), True)
    out["agree"] = np.isclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL).all(0)
    out["found"] = st2[13].numpy() > 0.5
    out["surf"], out["surf_want"] = got.numpy(), np.asarray(want)
    return out


def _jax_step(case, split, bounce, last, st=None):
    fn = JMK.bounce_step_split if split else JMK.bounce_step
    return np.asarray(fn(
        jnp.asarray(case["st"] if st is None else st), case["woop3"], case["attrs_t"],
        case["lsets"], bounce, jnp.uint32(SEED), JPTConfig(**CFG), last=last, has_lights=True,
        has_transmission=True, has_coat=True, rt=RT, interpret=True))


def _check(got, want, agree, found):
    """Every row but the BSDF pdf on 99% of the rays that agree on the hit
    and found it; radiance, alive and the specular flag on 98% of the rays
    that agree on the hit. The pdf (row 12) of a sample off the glass, at
    roughness 0.05 (GGX alpha^2 = 6.25e-6), moves by percents with an ulp of
    the half vector, which XLA (fused multiply-adds) and PyTorch round
    apart: it agrees to 1e-4 on 85% of those rays and to 10% on all; the
    throughput rows (f |cos| / pdf, whose f moves alike) agree to 1e-4."""
    got = got.numpy()
    assert got.shape == want.shape == (16, N)
    assert agree.mean() >= 0.97
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert close[[9, 10, 11, 13, 14]][:, agree].all(0).mean() >= 0.98
    m = agree & found
    rows = [r for r in range(16) if r != 12]
    assert close[rows][:, m].all(0).mean() >= 0.99
    assert close[12, m].mean() >= 0.85
    np.testing.assert_allclose(got[12, m], want[12, m], rtol=0.1, atol=ATOL)


def test_materials_box_rays_meet_glass_and_coat(case):
    """The bounce-0 rays hit the glass (eta 1/1.5) and the coated block, and
    B4's surface rows carry transmission, eta, coat weight and roughness as
    the JAX trace kernel writes them."""
    surf, want, agree = case["surf"], case["surf_want"], case["agree"]
    assert ((surf[15] > 0.5) & case["found"]).sum() > 5
    assert ((surf[17] > 0.5) & case["found"]).sum() > 5
    for r in (15, 16, 17, 18):
        np.testing.assert_array_equal(surf[r, agree], want[r, agree])


def test_bounce_shade_plain_materials_match_jax(case):
    """B4 then B5 (one split bounce, bounce 0) against ``bounce_step_split``
    with has_transmission and has_coat; some samples are transmitted."""
    cfg = PTConfig(**CFG)
    st2, surf = MK.bounce_trace_plain(case["tdev"], T(case["st"]), 0, cfg, True)
    got = MK.bounce_shade_plain(case["tdev"], st2, surf, T(case["lsets"]), 0, SEED, cfg, True, RT)
    _check(got, _jax_step(case, True, 0, False), case["agree"], case["found"])
    below = (got[3:6] * surf[6:9]).sum(0) < 0.0
    assert (below & (got[13] > 0.5)).sum() > 3


@pytest.mark.parametrize("bounce,last", [(1, False), (3, False), (2, True)])
def test_bounce_plain_materials_match_jax(case, bounce, last):
    """B6 against ``bounce_step`` with has_transmission and has_coat, on the
    state after one split bounce (rays inside the glass among them: B6 meets
    its back faces, eta = ior); bounce 3 runs Russian roulette."""
    cfg = PTConfig(**CFG)
    st2, surf = MK.bounce_trace_plain(case["tdev"], T(case["st"]), 0, cfg, True)
    st1 = MK.bounce_shade_plain(case["tdev"], st2, surf, T(case["lsets"]), 0, SEED, cfg, True,
                                RT).numpy()
    st_t, sf_t = MK.bounce_trace_plain(case["tdev"], T(st1), bounce, cfg, True)
    _, want_sf, _ = JMK.trace_with_first_hit(
        case["jdev"], jnp.asarray(st1[0:3].T), jnp.asarray(st1[3:6].T), jnp.uint32(SEED),
        JPTConfig(**{**CFG, "max_bounces": 0}), rt=RT, interpret=True)
    agree = np.isclose(sf_t.numpy(), np.asarray(want_sf), rtol=RTOL, atol=ATOL).all(0)
    found = st_t[13].numpy() > 0.5
    assert ((sf_t[16] > 1.0).numpy() & found).sum() > 3  # hits on the glass from inside
    got = MK.bounce_plain(case["tdev"], T(st1), T(case["lsets"]), bounce, SEED, cfg, last, True,
                          RT)
    want = _jax_step(case, False, bounce, last, st=st1)
    _check(got, want, agree, found)
