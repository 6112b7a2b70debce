"""The host-side utils of the port against the JAX package: the params
tree the app registers, frame stats and the log ring, frame validation
(``check_frame``'s verdicts and messages on planes with injected NaN, Inf
and negatives), the frame graph's DOT text over every mode and option,
checkpoints cross-loaded between the packages (the packed G-buffer and
ReSTIR PT's seed rows compared as bits), and a resumed 32^2 chain equal
to the unbroken one."""

import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zetaray_tpu import app as japp
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.ops import restir_gi as JRG
from zetaray_tpu.ops import restir_pt as JRP
from zetaray_tpu.ops import sky as JSK
from zetaray_tpu.ops import skydi as JSD
from zetaray_tpu.ops import upscale as JUP
from zetaray_tpu.ops import volumetrics as JVL
from zetaray_tpu.render import frame as JF
from zetaray_tpu.render.graph import frame_dag as jax_frame_dag
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu.utils import checkpoint as JC
from zetaray_tpu.utils import log as JL
from zetaray_tpu.utils import params as JPM
from zetaray_tpu.utils import validate as JV
from zetaray_tpu_torch import app as tapp
from zetaray_tpu_torch.ops import pathtracer as TPT
from zetaray_tpu_torch.ops import restir_di as TRD
from zetaray_tpu_torch.ops import restir_gi as TRG
from zetaray_tpu_torch.ops import restir_pt as TRP
from zetaray_tpu_torch.ops import sky as TSK
from zetaray_tpu_torch.ops import skydi as TSD
from zetaray_tpu_torch.ops import upscale as TUP
from zetaray_tpu_torch.ops import volumetrics as TVL
from zetaray_tpu_torch.ops.gbuffer_pack import TG
from zetaray_tpu_torch.render import frame as TF
from zetaray_tpu_torch.render.graph import dump_launches, frame_dag
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import (
    CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box,
)
from zetaray_tpu_torch.scene.scene import upload_scene
from zetaray_tpu_torch.utils import checkpoint as TC
from zetaray_tpu_torch.utils import log as TL
from zetaray_tpu_torch.utils import params as TPM
from zetaray_tpu_torch.utils import stats as TST
from zetaray_tpu_torch.utils import validate as TV

torch.set_num_threads(1)

JAX_PKG = types.SimpleNamespace(
    RenderConfig=JF.RenderConfig, PTConfig=JPT.PTConfig, SkyParams=JSK.SkyParams,
    ReSTIRConfig=JRD.ReSTIRConfig, ReSTIRGIConfig=JRG.ReSTIRGIConfig,
    ReSTIRPTConfig=JRP.ReSTIRPTConfig, SkyDIConfig=JSD.SkyDIConfig,
    VolumetricsConfig=JVL.VolumetricsConfig, UpscaleConfig=JUP.UpscaleConfig)
PORT_PKG = types.SimpleNamespace(
    RenderConfig=TF.RenderConfig, PTConfig=TPT.PTConfig, SkyParams=TSK.SkyParams,
    ReSTIRConfig=TRD.ReSTIRConfig, ReSTIRGIConfig=TRG.ReSTIRGIConfig,
    ReSTIRPTConfig=TRP.ReSTIRPTConfig, SkyDIConfig=TSD.SkyDIConfig,
    VolumetricsConfig=TVL.VolumetricsConfig, UpscaleConfig=TUP.UpscaleConfig)


def _params_tree(registry):
    return [(p.path, p.kind, p.value, p.min, p.max, p.step, tuple(p.choices))
            for p in registry.all()]


@pytest.mark.parametrize("mode", ["restir_di", "restir_gi"])
def test_params_tree_matches_jax(mode):
    JPM.registry._params.clear()
    TPM.registry._params.clear()
    jholder = [JF.RenderConfig(width=32, height=32, mode=mode)]
    tholder = [TF.RenderConfig(width=32, height=32, mode=mode)]
    japp._register_params(jholder)
    tapp._register_params(tholder)
    tree = _params_tree(TPM.registry)
    assert tree == _params_tree(JPM.registry)
    assert len(tree) == 11
    # a queued set applies at the frame boundary; a bad one is dropped
    TPM.registry.queue_set("Renderer/General/Tonemapper", "neutral")
    TPM.registry.queue_set("Renderer/General/Tonemapper", "no_such_tonemapper")
    TPM.registry.queue_set("PathTracer/Path/MaxBounces", 99)
    TL.set_mirror(False)
    try:
        assert TPM.registry.apply_pending() == 2
    finally:
        TL.set_mirror(True)
    assert tholder[0].tonemapper == "neutral" and tholder[0].pt.max_bounces == 16
    snap = TPM.registry.snapshot()
    assert snap["Renderer/General/Tonemapper"] == "neutral"
    TPM.registry._params.clear()
    JPM.registry._params.clear()


def test_unitdir_and_color_params():
    reg = TPM.ParamRegistry()
    seen = []
    reg.add(TPM.Param("Sky", "Sun", "Dir", "unitdir", (0, 1, 0), on_change=seen.append))
    reg.set("Sky/Sun/Dir", (3, 0, 4))
    assert reg.get("Sky/Sun/Dir").value == pytest.approx((0.6, 0.0, 0.8))
    with pytest.raises(ValueError):
        reg.set("Sky/Sun/Dir", (1, 2))
    assert seen == [reg.get("Sky/Sun/Dir").value]


def test_frame_stats_and_kernel_timer():
    fs = TST.FrameStats()
    assert fs.fps == 0.0 and fs.frame_time_ms() == 0.0
    for k in range(TST.FrameStats.HISTORY + 5):
        fs.begin_frame()
        fs.add("frame", "k", k)
        fs.end_frame()
    assert fs.frame_index == TST.FrameStats.HISTORY + 5
    assert len(fs._frame_times) == TST.FrameStats.HISTORY and fs.fps > 0.0
    rep = fs.report().splitlines()
    assert rep[0].startswith(f"frame {TST.FrameStats.HISTORY + 5} |")
    assert rep[1] == f"  frame/k: {TST.FrameStats.HISTORY + 4}"
    with fs.frame():
        with fs.span("post:cpu"):
            torch.ones(64).sum()
    assert fs.last.ms["post:cpu"] >= 0.0 and list(fs.frames) == [fs.last]
    assert "  host/post:cpu: " in fs.report()


def test_log_ring_levels_and_mirror(capsys):
    TL.info("utils-test info")
    TL.set_mirror(False)
    try:
        TL.warning("utils-test warning")
        TL.error("utils-test error")
        for k in range(600):
            TL.log("DEBUG", f"utils-test flood {k}")
    finally:
        TL.set_mirror(True)
    err = capsys.readouterr().err
    assert "[zetaray:INFO] utils-test info" in err and "utils-test warning" not in err
    ring = TL.ring()
    assert len(ring) == 512  # bounded
    assert ring[-1][1:] == ("DEBUG", "utils-test flood 599")
    with pytest.raises(AssertionError):
        TL.log("LOUD", "no such level")


def _planes(seed, inject):
    r = np.random.default_rng(seed)
    hdr = r.uniform(0.0, 2.0, (8, 12, 3)).astype(np.float32)
    res = r.normal(size=(16, 96)).astype(np.float32)
    gi = r.normal(size=(16, 96)).astype(np.float32)
    hist = r.uniform(0.0, 2.0, (8, 12, 3)).astype(np.float32)
    sky = r.normal(size=(16, 96)).astype(np.float32)
    planes = dict(hdr=hdr, reservoirs=res, gi_reservoirs=gi, history=hist, sky=sky)
    for name, idx, value in inject:
        planes[name].reshape(-1)[idx] = value
    return planes


INJECT = {
    "clean": [],
    "hdr_nan": [("hdr", 5, np.nan)],
    "hdr_inf": [("hdr", 7, np.inf), ("hdr", 8, np.inf)],
    "hdr_negative": [("hdr", 3, -0.25)],
    "hdr_neg_inf": [("hdr", 3, -np.inf)],
    "reservoir_nan": [("reservoirs", 40, np.nan)],
    "gi_inf": [("gi_reservoirs", 1, -np.inf)],
    "history_nan": [("history", 11, np.nan), ("hdr", 2, -1.0)],
    "sky_inf": [("sky", 0, np.inf)],
}


@pytest.mark.parametrize("case", INJECT)
def test_check_frame_verdicts_match_jax(case):
    p = _planes(11, INJECT[case])
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.5)
    t = torch.from_numpy
    tstate = TF.FrameState(reservoirs=t(p["reservoirs"]), gi_reservoirs=t(p["gi_reservoirs"]),
                           gbuf=torch.zeros(3, 96), camera_prev=cam,
                           history=t(p["history"]).permute(2, 0, 1), sky_reservoirs=t(p["sky"]))
    jstate = JF.FrameState(reservoirs=jnp.asarray(p["reservoirs"]),
                           gi_reservoirs=jnp.asarray(p["gi_reservoirs"]),
                           gbuf=jnp.zeros((3, 96)), camera_prev=None,
                           history=jnp.asarray(p["history"]),
                           sky_reservoirs=jnp.asarray(p["sky"]))
    out_t, out_j = {"hdr": t(p["hdr"])}, {"hdr": jnp.asarray(p["hdr"])}
    TL.set_mirror(False)
    JL.set_mirror(False)
    try:
        TL._ring.clear()
        JL._ring.clear()
        got = TV.check_frame(out_t, tstate, raise_on_error=False)
        want = JV.check_frame(out_j, jstate, raise_on_error=False)
        msgs_t = [m for _, lv, m in TL.ring() if lv == "ERROR"]
        msgs_j = [m for _, lv, m in JL.ring() if lv == "ERROR"]
        assert got == want == (case == "clean")
        assert msgs_t == msgs_j
        assert TV.check_frame(out_t, None, raise_on_error=False) == JV.check_frame(
            out_j, None, raise_on_error=False)
        if not got:
            with pytest.raises(TV.ValidationError, match=msgs_t[0].split(" has ")[0]):
                TV.check_frame(out_t, tstate)
    finally:
        TL.set_mirror(True)
        JL.set_mirror(True)
    # integer planes are skipped, as in JAX
    assert TV.check_finite("ints", torch.tensor([-1, 2]), allow_negative=False)


def _dag_configs(pkg):
    """(label, RenderConfig) over every mode and option frame_dag reads."""
    sky = pkg.SkyParams(sun_dir=(0.3, 0.8, 0.2))
    out = []
    for mode, lvg, skydi, vol, scale, denoise, taa in itertools.product(
            ("pt", "restir_di", "restir_gi", "restir_pt"), (0, 2), (False, True),
            (False, True), (1.0, 0.5), (False, True), (False, True)):
        out.append((f"{mode} lvg{lvg} skydi{skydi} vol{vol} scale{scale} dn{denoise} taa{taa}",
                    pkg.RenderConfig(
                        width=32, height=32, mode=mode,
                        pt=pkg.PTConfig(max_bounces=2, sky=sky if (skydi or vol) else None),
                        restir=pkg.ReSTIRConfig(lvg_samples=lvg), skydi=skydi,
                        volumetrics=pkg.VolumetricsConfig() if vol else None,
                        render_scale=scale, denoise=denoise, taa=taa,
                        firefly_factor=4.0 if denoise else 0.0)))
    for mode in ("restir_di", "restir_gi", "restir_pt"):
        out += [
            (f"{mode} no temporal", pkg.RenderConfig(
                mode=mode, restir=pkg.ReSTIRConfig(temporal=False),
                restir_gi=pkg.ReSTIRGIConfig(temporal=False),
                restir_pt=pkg.ReSTIRPTConfig(temporal=False), skydi=True,
                skydi_cfg=pkg.SkyDIConfig(temporal=False), pt=pkg.PTConfig(sky=sky))),
            (f"{mode} no replay", pkg.RenderConfig(
                mode=mode, restir_pt=pkg.ReSTIRPTConfig(replay=False))),
            (f"{mode} direct only", pkg.RenderConfig(mode=mode, indirect=False)),
            (f"{mode} upscale no rcas", pkg.RenderConfig(
                mode=mode, render_scale=0.5, upscale_cfg=pkg.UpscaleConfig(rcas_sharpness=0.0))),
            (f"{mode} upscale rcas", pkg.RenderConfig(
                mode=mode, render_scale=0.5, upscale_cfg=pkg.UpscaleConfig(rcas_sharpness=0.8))),
        ]
    return out


def test_frame_dag_matches_jax():
    ported, reference = _dag_configs(PORT_PKG), _dag_configs(JAX_PKG)
    assert len(ported) == 271
    seen = set()
    for (label, tcfg), (_, jcfg) in zip(ported, reference):
        got = frame_dag(tcfg)
        assert got == jax_frame_dag(jcfg), label
        seen.add(got)
    assert len(seen) > 100  # the options do change the graph


def test_dump_launches_lists_operators():
    x = torch.ones(16)
    text = dump_launches(lambda: (x + 1.0).sum() * 2.0).splitlines()
    assert text[0] == "aten::add x 1"
    assert text[-1] == "3 operators"


def _cam(k):
    return Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV,
                          aspect=1.0).with_jitter(k)


@pytest.fixture(scope="module")
def pt_state():
    """A port state with every plane: ReSTIR PT reservoirs (seed rows hold
    u32 bits), SkyDI's reservoirs and the upscaler's locks."""
    scene = upload_scene(cornell_box(), device="cpu")
    cfg = TF.RenderConfig(width=32, height=32, mode="restir_pt", pt=TPT.PTConfig(
        max_bounces=2, sky=TSK.SkyParams(sun_dir=(0.2, 0.45, 0.87))), skydi=True,
        render_scale=0.5)
    state = None
    for k in range(2):
        _, state = TF.render_frame_restir(scene, _cam(k), 0x2468ACE1 + k, cfg, state)
    assert state.sky_reservoirs is not None and state.upscale_lock is not None
    return state


def _assert_bits(a, b):
    a, b = (np.ascontiguousarray(np.asarray(x, np.float32)) for x in (a, b))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_checkpoint_port_to_jax_and_back(tmp_path, pt_state):
    s = pt_state
    p = str(tmp_path / "port.npz")
    TC.save_frame_state(p, s, params_snapshot={"a/b/c": 1.5, "x/y/z": "agx"})
    js, jparams = JC.load_frame_state(p)
    assert jparams == {"a/b/c": 1.5, "x/y/z": "agx"}
    for k in ("reservoirs", "gi_reservoirs", "gbuf", "sky_reservoirs", "upscale_lock"):
        _assert_bits(getattr(js, k), getattr(s, k).numpy())
    _assert_bits(js.history, s.history.permute(1, 2, 0).numpy())  # JAX keeps [H, W, 3]
    assert np.asarray(js.history).shape == (32, 32, 3)
    for k in ("eye", "right", "up", "forward"):
        np.testing.assert_array_equal(np.asarray(getattr(js.camera_prev, k)),
                                      getattr(s.camera_prev, k))
    # and back: the JAX package's file loads into the port bit for bit
    q = str(tmp_path / "jax.npz")
    JC.save_frame_state(q, js, params_snapshot=jparams)
    s2, params2 = TC.load_frame_state(q, device="cpu")
    assert params2 == jparams
    for k in ("reservoirs", "gi_reservoirs", "gbuf", "history", "sky_reservoirs",
              "upscale_lock"):
        _assert_bits(getattr(s2, k).numpy(), getattr(s, k).numpy())
    for k in ("eye", "right", "up", "forward"):
        np.testing.assert_array_equal(getattr(s2.camera_prev, k), getattr(s.camera_prev, k))
    for k in ("tan_half_fov", "aspect", "lens_radius", "focus_dist", "jitter"):
        assert getattr(s2.camera_prev, k) == getattr(s.camera_prev, k), k


def test_checkpoint_keeps_nan_bit_patterns(tmp_path):
    """The packed G-buffer's normal row holds u32 bits, some of them NaN
    patterns with payloads: both packages keep them."""
    r = np.random.default_rng(5)
    bits = r.integers(-2**31, 2**31 - 1, (3, 64), dtype=np.int64).astype(np.int32)
    bits[0, :8] = np.array([0x7FC00001, 0x7F800001, -1, 0x7FFFFFFF, -0x400000, 0, 1, 0x7F800000],
                           dtype=np.int64).astype(np.int32)
    gbuf = torch.from_numpy(bits.view(np.float32).copy())
    hist = torch.rand(3, 8, 8)
    state = TF.FrameState(reservoirs=torch.rand(16, 64), gi_reservoirs=torch.rand(16, 64),
                          gbuf=gbuf, camera_prev=_cam(3), history=hist)
    p = str(tmp_path / "bits.npz")
    TC.save_frame_state(p, state)
    back, params = TC.load_frame_state(p, device="cpu")
    assert params is None and back.sky_reservoirs is None and back.upscale_lock is None
    assert torch.equal(back.gbuf.view(torch.int32), gbuf.view(torch.int32))
    js, _ = JC.load_frame_state(p)
    np.testing.assert_array_equal(np.asarray(js.gbuf).view(np.int32), bits)


def test_resumed_chain_equals_unbroken(tmp_path):
    scene = upload_scene(cornell_box(), device="cpu")
    cfg = TF.RenderConfig(width=32, height=32, mode="restir_gi", pt=TPT.PTConfig(max_bounces=2),
                          denoise=True, taa=True)
    outs, state, p = [], None, str(tmp_path / "chain.npz")
    for k in range(4):
        out, state = TF.render_frame_restir(scene, _cam(k), tapp.frame_seed(k), cfg, state)
        outs.append(out)
        if k == 1:
            TC.save_frame_state(p, state)
    state, _ = TC.load_frame_state(p, device="cpu")
    for k in (2, 3):
        out, state = TF.render_frame_restir(scene, _cam(k), tapp.frame_seed(k), cfg, state)
        assert torch.equal(out["hdr"], outs[k]["hdr"]) and torch.equal(out["ldr"], outs[k]["ldr"])
