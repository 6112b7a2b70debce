"""The ReSTIR passes of the PyTorch port on glass and coated materials, and
under the reuse options ``full_target=True`` and ``packed_reuse=False``,
against the JAX package, pass by pass, on the materials box
(``procedural.materials_box``: a glass block and a clear-coated block).

Both packages run each pass with ``trans=True, coat=True`` (the box has
both) from the inputs the JAX chain produced, as
tests/test_torch_restir_di.py, tests/test_torch_restir_gi.py and
tests/test_torch_restir_pt.py do on the opaque box (the GI and PT traces
through the JAX bounce kernels in interpret mode). ``run_option`` runs one
config's passes under one option; tests/test_torch_config.py holds each
of the six (config, option) pairs through it. Raw-float32 gathers change
nothing but the packing's rounding, so each option is held to JAX under
the same option, not to the packed run. The shares of pixels that must
agree are stated per pass: a sample whose ray grazes an edge, or whose
pick sits on a boundary, may flip.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel.megakernel import build_light_sets as jax_light_sets
from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.core.rng import seed_from_key
from zetaray_tpu.ops import gbuffer_pack as JGP
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.ops import restir_gi as JRG
from zetaray_tpu.ops import restir_pt as JRP
from zetaray_tpu.ops import skydi as JSD
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import restir_di as TRD
from zetaray_tpu_torch.ops import restir_gi as TRG
from zetaray_tpu_torch.ops import restir_pt as TRP
from zetaray_tpu_torch.ops import skydi as TSD
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render.frame import pick_rt
from zetaray_tpu_torch.scene.procedural import (
    CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, materials_box,
)
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

RES = 32
PT = dict(max_bounces=3, min_emissive_bounce=2, min_nee_bounce=1)  # the frames' indirect traces
# ReSTIR PT's samples with one NEE bounce beyond x3: at max_bounces=3 its
# suffix brings light only where x3 or x4 is the light, which none of this
# run's 1024 pixels reaches on the materials box
PT4 = {**PT, "max_bounces": 4}
MAT = dict(trans=True, coat=True)
PR = TRP.PR
OPTIONS = {"full_target": dict(full_target=True), "packed_reuse": dict(packed_reuse=False)}


def _patch(mp):
    """The JAX GI and PT traces through the bounce kernels in interpret
    mode (tests/test_torch_restir_gi.py, tests/test_torch_restir_pt.py)."""
    from zetaray_tpu.accel import megakernel as JMK

    mp.setattr(JPT, "megakernel_eligible", lambda scene: True)
    mp.setattr(JMK, "trace_with_first_hit",
               functools.partial(JMK.trace_with_first_hit, interpret=True))
    mp.setattr(JMK, "trace_megakernel", functools.partial(JMK.trace_megakernel, interpret=True))


@functools.lru_cache(maxsize=None)
def materials_run():
    """The JAX chain inputs on the materials box over a previous and a
    current frame (camera moved): G-buffers, DI candidates and the
    previous frame's DI, GI and PT reservoirs."""
    jdev, tdev = scene_pair(materials_box())
    assert jdev.has_transmission and jdev.has_coat
    rt = pick_rt(RES * RES)
    out = {"jdev": jdev, "tdev": tdev, "rt": rt}
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        for tag, k, dx in (("prev", 3, 0.0), ("curr", 4, 0.04)):
            cam = JaxCamera.look_at(
                (CAMERA_EYE[0] + dx, CAMERA_EYE[1], CAMERA_EYE[2]), CAMERA_TARGET,
                vfov_deg=CAMERA_VFOV, aspect=1.0,
            ).with_jitter(k)
            key = jax.random.PRNGKey(k)
            seed = int(seed_from_key(key))
            o, d = cam.generate_rays(RES, RES)
            gb = jax_gbuffer(jdev, o, d, interpret=True)
            s = jnp.uint32(seed)
            lsets = jax_light_sets(jdev, s)
            di0 = JRD.initial_candidates(gb, lsets, s, JRD.ReSTIRConfig(), rt=rt,
                                         interpret=True, **MAT)
            gi0 = JRG.initial_samples(jdev, gb, key, JPT.PTConfig(**PT), s, rt=rt,
                                      spread_angle=cam.pixel_spread_angle(RES), **MAT)
            pt0 = JRP.initial_samples(jdev, gb, key, JPT.PTConfig(**PT4), s,
                                      JRP.ReSTIRPTConfig(), rt=rt, **MAT)
            out[tag] = dict(cam=cam, key=key, seed=seed, gb=gb, di0=di0, gi0=gi0, pt0=pt0)
    assert np.asarray(out["curr"]["pt0"])[PR.PHAT].max() > 0  # PT's suffixes carry light
    p = out["prev"]
    p["di_vis"] = JRD.visibility_reuse(jdev, p["di0"], p["gb"])
    p["tg"] = JGP.pack_temporal(p["gb"])
    return out


def _agree(got, want, rtol=1e-4, atol=1e-5, pt=False):
    """Per pixel: every row agrees (PT's SRCSEED bit for bit, NaN with NaN;
    its PDFA and PDFS3 rows to 10%: they hold the pdf of a sample off the
    glass, at roughness 0.05, where an ulp of the half vector, which XLA
    and PyTorch round apart, moves the GGX peak by percents)."""
    got, want = np.asarray(got), np.asarray(want)
    close = np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=pt)
    if pt:
        close[PR.SRCSEED] = got[PR.SRCSEED].view(np.uint32) == want[PR.SRCSEED].view(np.uint32)
        for row in (PR.PDFA, PR.PDFS3):
            close[row] = np.isclose(got[row], want[row], rtol=0.1, atol=atol, equal_nan=True)
    return close.all(0)


def run_option(kind: str, option: str):
    """The passes of config ``kind`` ("di", "gi" or "pt") under ``option``
    ("full_target" or "packed_reuse"), in both packages on the same inputs,
    each pass held to JAX at its share: {pass: share of pixels agreeing}.
    DI: temporal and biased spatial reuse; GI and PT also the initial
    samples where the option rates them (full_target), and PT's merges
    with the replay shift."""
    r = materials_run()
    p, c = r["prev"], r["curr"]
    jdev, tdev = r["jdev"], r["tdev"]
    kw = OPTIONS[option]
    s = jnp.uint32(c["seed"])
    prev_cam = camera_from_arrays(cam_dict(p["cam"]))
    shares = {}
    if kind == "di":
        cj, ct = JRD.ReSTIRConfig(**kw), TRD.ReSTIRConfig(**kw)
        want_t = JRD.temporal_reuse(c["di0"], p["di_vis"], p["tg"], c["gb"], p["cam"], RES, RES,
                                    s, cj, **MAT)
        got_t = TRD.temporal_reuse(T(c["di0"]), T(p["di_vis"]), T(p["tg"]), T(c["gb"]), prev_cam,
                                   RES, RES, c["seed"], ct, **MAT)
        assert (np.asarray(want_t)[10] > 128).mean() > 0.5  # temporal reuse happened
        shares["temporal"] = (_agree(got_t.numpy(), want_t).mean(), 0.99)
        want_s = JRD.spatial_reuse(want_t, c["gb"], RES, RES, s, cj, **MAT)
        got_s = TRD.spatial_reuse(T(want_t), T(c["gb"]), RES, RES, c["seed"], ct, **MAT)
        shares["spatial"] = (_agree(got_s.numpy(), want_s).mean(), 0.99)
        return shares
    if kind == "gi":
        cj, ct = JRG.ReSTIRGIConfig(**kw), TRG.ReSTIRGIConfig(**kw)
        res0_j = c["gi0"]
        if cj.full_target:
            with pytest.MonkeyPatch.context() as mp:
                _patch(mp)
                res0_j = JRG.initial_samples(jdev, c["gb"], c["key"], JPT.PTConfig(**PT), s,
                                             rt=r["rt"], full_target=True,
                                             spread_angle=c["cam"].pixel_spread_angle(RES), **MAT)
            got0 = TRG.initial_samples(tdev, T(c["gb"]), PTConfig(**PT), c["seed"], r["rt"],
                                       spread_angle=c["cam"].pixel_spread_angle(RES),
                                       full_target=True, **MAT)
            shares["initial"] = (_agree(got0.numpy(), res0_j, rtol=1e-3).mean(), 0.97)
        want_t = JRG.temporal_reuse(res0_j, p["gi0"], p["tg"], c["gb"], p["cam"], RES, RES, s,
                                    cj, **MAT)
        got_t = TRG.temporal_reuse(T(res0_j), T(p["gi0"]), T(p["tg"]), T(c["gb"]), prev_cam,
                                   RES, RES, c["seed"], ct, **MAT)
        assert (np.asarray(want_t)[10] > 1).mean() > 0.3
        shares["temporal"] = (_agree(got_t.numpy(), want_t).mean(), 0.99)
        want_s = JRG.spatial_reuse(want_t, c["gb"], RES, RES, s, cj, **MAT)
        got_s = TRG.spatial_reuse(T(want_t), T(c["gb"]), RES, RES, c["seed"], ct, **MAT)
        shares["spatial"] = (_agree(got_s.numpy(), want_s).mean(), 0.99)
        return shares
    cj, ct = JRP.ReSTIRPTConfig(**kw), TRP.ReSTIRPTConfig(**kw)
    res0_j = c["pt0"]
    if cj.full_target:
        with pytest.MonkeyPatch.context() as mp:
            _patch(mp)
            res0_j = JRP.initial_samples(jdev, c["gb"], c["key"], JPT.PTConfig(**PT4), s, cj,
                                         rt=r["rt"], **MAT)
        got0 = TRP.initial_samples(tdev, T(c["gb"]), PTConfig(**PT4), c["seed"], ct, r["rt"],
                                   **MAT)
        shares["initial"] = (_agree(got0.numpy(), res0_j, rtol=1e-3, pt=True).mean(), 0.97)
    want_t = JRP.temporal_reuse(res0_j, p["pt0"], p["tg"], c["gb"], p["cam"], RES, RES, s, cj,
                                scene=jdev, **MAT)
    got_t = TRP.temporal_reuse(T(res0_j), T(p["pt0"]), T(p["tg"]), T(c["gb"]), prev_cam, RES,
                               RES, c["seed"], ct, scene=tdev, **MAT)
    assert (np.asarray(want_t)[PR.M] > 1).mean() > 0.3
    shares["temporal"] = (_agree(got_t.numpy(), want_t, pt=True).mean(), 0.98)
    want_s = JRP.spatial_reuse(want_t, c["gb"], RES, RES, s, cj, scene=jdev, **MAT)
    got_s = TRP.spatial_reuse(T(want_t), T(c["gb"]), RES, RES, c["seed"], ct, scene=tdev, **MAT)
    shares["spatial"] = (_agree(got_s.numpy(), want_s, pt=True).mean(), 0.98)
    return shares


def check_option(kind: str, option: str) -> None:
    for name, (share, need) in run_option(kind, option).items():
        assert share >= need, f"{kind} {option} {name}: {share:.4f} of pixels agree"


def test_options_change_the_reservoirs():
    """Each option acts (GI temporal reuse): full_target changes which
    samples the merge keeps and their weights, packed_reuse=False the
    reused rows' rounding (L2 travels as f16 when packed; the DI rows of
    this box pack without loss: axis-aligned normals, an f16-exact Le)."""
    r = materials_run()
    p, c = r["prev"], r["curr"]
    prev_cam = camera_from_arrays(cam_dict(p["cam"]))
    outs = {}
    for name, kw in (("default", {}), *OPTIONS.items()):
        outs[name] = TRG.temporal_reuse(T(c["gi0"]), T(p["gi0"]), T(p["tg"]), T(c["gb"]),
                                        prev_cam, RES, RES, c["seed"], TRG.ReSTIRGIConfig(**kw),
                                        **MAT).numpy()
    for name in OPTIONS:
        assert (outs[name] != outs["default"]).any(0).mean() > 0.05, name


@pytest.mark.parametrize("kind", ["di", "gi", "pt"])
def test_initial_and_shade_with_materials_match_jax(kind):
    """The DI candidates (B2's plain version), the GI and PT initial samples
    and each shade on the glass and the coated block, against JAX's with
    trans and coat: the shades agree to 1e-4 on 99% of pixels and in the
    mean to 1e-3."""
    r = materials_run()
    c = r["curr"]
    tdev, jdev = r["tdev"], r["jdev"]
    gb = T(c["gb"])
    glass = (c["gb"][27] > 0.5).sum()
    assert glass > 30 and (c["gb"][29] > 0.5).sum() > 30  # both blocks in view
    if kind == "di":
        lsets = jax_light_sets(jdev, jnp.uint32(c["seed"]))
        got0 = TRD.initial_candidates(gb, T(lsets), c["seed"], rt=r["rt"], **MAT).numpy()
        same = (got0[0:3] == np.asarray(c["di0"])[0:3]).all(0)
        assert same.mean() >= 0.995
        want = JRD.shade(jdev, c["di0"], c["gb"], rows_out=True, **MAT)
        got = TRD.shade(tdev, T(c["di0"]), gb, **MAT)
    elif kind == "gi":
        got0 = TRG.initial_samples(tdev, gb, PTConfig(**PT), c["seed"], r["rt"],
                                   spread_angle=c["cam"].pixel_spread_angle(RES), **MAT)
        assert _agree(got0.numpy()[0:6], np.asarray(c["gi0"])[0:6]).mean() >= 0.99
        assert _agree(got0.numpy(), c["gi0"], rtol=1e-3).mean() >= 0.97
        want = JRG.shade(jdev, c["gi0"], c["gb"], rows_out=True, **MAT)
        got = TRG.shade(tdev, T(c["gi0"]), gb, **MAT)
    else:
        got0 = TRP.initial_samples(tdev, gb, PTConfig(**PT4), c["seed"], TRP.ReSTIRPTConfig(),
                                   r["rt"], **MAT)
        want0 = np.asarray(c["pt0"])
        assert _agree(got0.numpy()[PR.X : PR.N + 3], want0[PR.X : PR.N + 3]).mean() >= 0.99
        assert _agree(got0.numpy(), want0, rtol=1e-3, pt=True).mean() >= 0.97
        assert (want0[PR.TRANS] > 0.5).sum() > 5  # some reconnection vertices are glass
        want = JRP.shade(jdev, c["pt0"], c["gb"], JRP.ReSTIRPTConfig(), rows_out=True, **MAT)
        got = TRP.shade(tdev, T(c["pt0"]), gb, **MAT)
    got, want = got.numpy(), np.asarray(want)
    assert want.max() > 0
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5).all(0).mean() >= 0.99
    np.testing.assert_allclose(got.mean(1), want.mean(1), rtol=1e-3)


def test_skydi_with_materials_matches_jax():
    """SkyDI's candidates, spatial pass and shade with trans and coat. The
    candidates as tests/test_torch_skydi.py holds them: every row on the
    pixels whose sun-cone candidate lies off the disk's rim (99%: a BSDF
    candidate through the glass may flip lobe), 80% on the rim."""
    from zetaray_tpu_torch.core.rng import uniform4

    r = materials_run()
    c = r["curr"]
    sky_j, sky_t = JSkyParams(sun_dir=(0.2, 0.45, 0.87)), SkyParams(sun_dir=(0.2, 0.45, 0.87))
    cj, ct = JSD.SkyDIConfig(), TSD.SkyDIConfig()
    s = jnp.uint32(c["seed"])
    want0 = JSD.initial_candidates(c["gb"], sky_j, s, cj, **MAT)
    got0 = TSD.initial_candidates(T(c["gb"]), sky_t, c["seed"], ct, **MAT).numpy()
    ok = _agree(got0, want0)
    rim = uniform4(torch.arange(RES * RES), 0, c["seed"], salt=0x50D1)[0].numpy() > 0.74
    assert ok[~rim].mean() >= 0.99 and ok[rim].mean() >= 0.8
    want_s = JSD.spatial_reuse(want0, c["gb"], RES, RES, s, cj, **MAT)
    got_s = TSD.spatial_reuse(T(want0), T(c["gb"]), RES, RES, c["seed"], ct, **MAT).numpy()
    assert _agree(got_s, want_s).mean() >= 0.99
    want = np.asarray(JSD.shade(r["jdev"], want_s, c["gb"], **MAT))
    got = TSD.shade(r["tdev"], T(want_s), T(c["gb"]), **MAT).numpy()
    want = want.T if want.shape[0] != 3 else want
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5).all(0).mean() >= 0.99
