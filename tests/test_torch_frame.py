"""The DI slice of the frame, PyTorch port against ``render_frame_restir``.

The slice is the flagship ReSTIR GI frame with its indirect pass off. The
JAX side runs with ``band_rows=0``: banded gathers are a TPU workaround
that the port does not have, and they drop reuse the port would keep.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import pytest
import torch

from zetaray_tpu.render.frame import RenderConfig as JaxRenderConfig
from zetaray_tpu.render.frame import render_frame_restir_jit
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.restir_gi import ReSTIRGIConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame, render_frame_restir
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from zetaray_tpu_torch.scene.scene import upload_scene
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

RES = 32
SLICE = dict(width=RES, height=RES, mode="restir_gi", indirect=False, denoise=True, taa=True)
CFG_J = JaxRenderConfig(band_rows=0, **SLICE)
CFG_T = RenderConfig(**SLICE)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _camera(k):
    """Frame k: the reference framing, eye drifting right, Halton jitter."""
    eye = (CAMERA_EYE[0] + 0.03 * k, CAMERA_EYE[1], CAMERA_EYE[2])
    return JaxCamera.look_at(eye, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0).with_jitter(k)


def _state_dict(state) -> dict:
    return {
        "reservoirs": np.asarray(state.reservoirs),
        "gi_reservoirs": np.asarray(state.gi_reservoirs),
        "gbuf": np.asarray(state.gbuf),
        "camera_prev": cam_dict(state.camera_prev),
        "history": np.asarray(state.history),
        "sky_reservoirs": state.sky_reservoirs,
        "upscale_lock": state.upscale_lock,
    }


@pytest.fixture(scope="module")
def jax_run():
    """Four JAX frames: (outputs, state after each frame)."""
    jdev, tdev = scene_pair(cornell_box())
    outs, states, state = [], [], None
    for k in range(4):
        out, state = render_frame_restir_jit(jdev, _camera(k), jax.random.PRNGKey(k), CFG_J, state)
        outs.append({key: np.asarray(v) for key, v in out.items()})
        states.append(_state_dict(state))
    return tdev, outs, states


def _seed(k):
    from zetaray_tpu.core.rng import seed_from_key

    return int(seed_from_key(jax.random.PRNGKey(k)))


def _port_frame(tdev, k, state, cfg=CFG_T):
    return render_frame_restir(
        tdev, camera_from_arrays(cam_dict(_camera(k))), _seed(k), cfg, state
    )


@pytest.mark.parametrize("k", [0, 1, 3])
def test_frame_from_jax_state(jax_run, k):
    """Start the port from the JAX state after frame k-1, render frame k."""
    tdev, outs, states = jax_run
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k > 0 else None
    out, new_state = _port_frame(tdev, k, state)
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert hdr.shape == want.shape == (RES, RES, 3)
    close = np.abs(hdr - want) <= 1e-3 * (1.0 + np.abs(want))
    assert close.all(-1).mean() >= 0.99
    ldr = out["ldr"].numpy()
    assert ldr.dtype == np.uint8 and ldr.shape == (RES, RES, 3)
    assert (np.abs(ldr.astype(int) - outs[k]["ldr"]) <= 1).all(-1).mean() >= 0.99
    tg, tg_want = new_state.gbuf.numpy(), states[k]["gbuf"]
    assert (tg[0].view(np.uint32) == tg_want[0].view(np.uint32)).mean() >= 0.99  # oct16 normal
    np.testing.assert_allclose(tg[1], tg_want[1], rtol=1e-5)  # depth
    np.testing.assert_array_equal(tg[2], tg_want[2])  # instance id


def test_chained_frames_mean(jax_run):
    """Each package chains its own four frames from nothing. Temporal reuse
    and TAA feed any flipped pick forward, so pixels drift apart; the mean
    HDR, which the estimator's expectation fixes, stays within 1%."""
    tdev, outs, _ = jax_run
    state = None
    for k in range(4):
        out, state = _port_frame(tdev, k, state)
        got, want = out["hdr"].numpy(), outs[k]["hdr"]
        assert np.isfinite(got).all()
        assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()
    assert (state.reservoirs[10] > 128).float().mean() > 0.5  # temporal reuse ran


def test_unported_settings_raise():
    gi = {**SLICE, "indirect": True}
    RenderConfig(**gi).check_ported()  # the whole flagship frame is ported
    RenderConfig(**{**gi, "mode": "restir_pt"}).check_ported()  # and ReSTIR PT
    RenderConfig(**{**gi, "mode": "restir_di"}).check_ported()  # and the JAX app's default
    RenderConfig(**{**gi, "mode": "pt"}).check_ported()  # and plain PT
    # render_frame reads neither the reuse passes nor the post chain's filters
    RenderConfig(**{**gi, "mode": "pt", "firefly_factor": 2.0}).check_ported()
    # the sun and sky and the path options, in every mode
    opts = PTConfig(sky=SkyParams(), stochastic_multi_bounce=True, path_regularization=True,
                    firefly_clamp=10.0)
    for mode in ("restir_di", "restir_gi", "restir_pt"):
        RenderConfig(**{**gi, "mode": mode, "pt": opts}).check_ported()
    RenderConfig(**{**gi, "mode": "pt", "pt": opts}).check_ported()
    # the light voxel grid, pairwise MIS, SkyDI and volumetrics, in every mode
    from zetaray_tpu_torch.ops.restir_di import ReSTIRConfig
    from zetaray_tpu_torch.ops.skydi import SkyDIConfig
    from zetaray_tpu_torch.ops.volumetrics import VolumetricsConfig

    features = dict(restir=ReSTIRConfig(lvg_samples=2, spatial_mis="pairwise"),
                    restir_gi=ReSTIRGIConfig(lvg=True), skydi=True,
                    skydi_cfg=SkyDIConfig(spatial_mis="pairwise"),
                    volumetrics=VolumetricsConfig(), pt=PTConfig(sky=SkyParams()))
    for mode in ("restir_di", "restir_gi", "restir_pt"):
        RenderConfig(**{**gi, **features, "mode": mode}).check_ported()
    RenderConfig(**{**gi, **features, "mode": "pt"}).check_ported()
    # the upscaler and the display options, in every mode; WoPS NEE
    from zetaray_tpu_torch.ops.upscale import UpscaleConfig

    for kw in ({"pt": PTConfig(nee_mode="wops")}, {"render_scale": 0.5},
               {"render_scale": 0.5, "upscale_cfg": UpscaleConfig(rcas_sharpness=0.8)},
               {"firefly_factor": 2.0}, {"tonemapper": "neutral"},
               {"exposure_mode": "weighted_avg"}):
        for mode in ("restir_di", "restir_gi", "restir_pt"):
            RenderConfig(**{**gi, **kw, "mode": mode}).check_ported()
    for kw in ({"pt": PTConfig(nee_mode="wops")}, {"tonemapper": "agx_punchy"},
               {"exposure_mode": "weighted_avg"}):
        RenderConfig(**{**gi, **kw, "mode": "pt"}).check_ported()
    # each frame takes the other's modes, as the JAX frames do: "pt" in
    # render_frame_restir (the branches of restir_di), every restir_* mode in
    # render_frame (it traces cfg.pt whatever the mode); an unknown mode raises
    for mode in ("pt", "restir_gi", "restir_pt", "restir_di"):
        RenderConfig(**{**gi, "mode": mode}).check_ported()
    with pytest.raises(ValueError, match="mode"):
        RenderConfig(**{**gi, "mode": "restir"}).check_ported()
    box = upload_scene(cornell_box(), device="cpu")
    cam = camera_from_arrays(cam_dict(_camera(0)))
    small = {**gi, "width": 16, "height": 16}
    out, _ = render_frame_restir(box, cam, 1, RenderConfig(**{**small, "mode": "pt"}), None)
    twin, _ = render_frame_restir(box, cam, 1, RenderConfig(**{**small, "mode": "restir_di"}),
                                  None)
    assert torch.equal(out["hdr"], twin["hdr"]) and out["hdr"].mean() > 0
    frames = [render_frame(box, cam, 1, RenderConfig(**{**small, "mode": m}))["hdr"]
              for m in ("pt", "restir_gi")]
    assert torch.equal(*frames) and frames[0].mean() > 0
    # shard renders a row band (tests/test_torch_parallel.py): one band of
    # the whole image is the whole frame; a shard that is no ShardCtx, or
    # bands that do not make the image, raise
    from zetaray_tpu_torch.parallel.halo import ShardCtx

    one, _ = render_frame_restir(box, cam, 1, RenderConfig(**small), None,
                                 shard=ShardCtx(None, 0, 1, 16))
    plain, _ = render_frame_restir(box, cam, 1, RenderConfig(**small), None)
    assert torch.equal(one["hdr"], plain["hdr"]) and torch.equal(one["ldr"], plain["ldr"])
    with pytest.raises(TypeError, match="ShardCtx"):
        render_frame_restir(box, cam, 1, RenderConfig(**small), None, shard=object())
    with pytest.raises(ValueError, match="bands"):
        render_frame_restir(box, cam, 1, RenderConfig(**small), None,
                            shard=ShardCtx(None, 0, 1, 8))
    # ReSTIR PT on a clustered scene renders (B8 and B9 on the card)
    clustered = upload_scene(subdivide_scene(cornell_box(), 500), device="cpu", cluster_size=128)
    cfg = RenderConfig(**{**gi, "mode": "restir_pt", "width": 16, "height": 16})
    out, state = render_frame_restir(clustered, cam, 1, cfg, None)
    assert torch.isfinite(out["hdr"]).all() and out["hdr"].mean() > 0


def test_frame_state_from_arrays_roundtrip():
    """A JAX-side state with SkyDI reservoirs and the upscaler's lock plane
    comes over bit for bit; without them those fields stay None."""
    r = np.random.default_rng(1)
    state = {k: r.uniform(-1, 1, (16, 64)).astype(np.float32)
             for k in ("reservoirs", "gi_reservoirs", "sky_reservoirs")}
    state.update(gbuf=r.uniform(0, 4, (3, 64)).astype(np.float32),
                 history=r.uniform(0, 2, (3, 16, 16)).astype(np.float32),
                 upscale_lock=r.uniform(0, 1, (16, 16)).astype(np.float32),
                 camera_prev=cam_dict(_camera(2)))
    got = frame_state_from_arrays(state, device="cpu")
    for k in ("reservoirs", "gi_reservoirs", "sky_reservoirs", "gbuf", "history",
              "upscale_lock"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), state[k], err_msg=k)
    assert got.camera_prev.jitter == tuple(float(x) for x in _camera(2).jitter)
    bare = frame_state_from_arrays({**state, "sky_reservoirs": None, "upscale_lock": None},
                                   device="cpu")
    assert bare.sky_reservoirs is None and bare.upscale_lock is None


def test_loaders_default_to_the_card(monkeypatch):
    """Without a device named, the scene, the camera's rays and the interop
    loaders go to the card; where CUDA is absent that raises instead of
    falling back to the CPU."""
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.scene import upload_scene
    from zetaray_tpu_torch.interop import scene_from_arrays
    from tests.test_torch_scene import jax_scene_arrays

    jdev, _ = scene_pair(cornell_box())
    arrays = jax_scene_arrays(jdev)
    state = {k: np.zeros((16, 4), np.float32) for k in ("reservoirs", "gi_reservoirs", "gbuf")}
    state.update(history=np.zeros((3, 2, 2), np.float32), camera_prev=cam_dict(_camera(0)))
    cam = Camera.look_at((0, 1, 3.5), (0, 1, 0), vfov_deg=45.0, aspect=1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (lambda: upload_scene(cornell_box()), lambda: cam.generate_rays(4, 4),
                 lambda: scene_from_arrays(arrays), lambda: frame_state_from_arrays(state)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load()
    assert upload_scene(cornell_box(), device="cpu").device.type == "cpu"
    assert cam.generate_rays(4, 4, device="cpu")[0].device.type == "cpu"


def test_port_runs_without_jax():
    """Port frames on the CPU (DI only, with ReSTIR GI, with ReSTIR PT, plain
    PT, the JAX app's default restir_di frame with the sun and sky, ReSTIR
    GI and ReSTIR PT on a clustered scene, bench.py's features frame on
    both, and the upscale frame with WoPS NEE, the display options and a
    thin lens) in a process where importing jax fails."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["zetaray_tpu"] = None
        import torch
        from zetaray_tpu_torch.ops.pathtracer import PTConfig
        from zetaray_tpu_torch.render.frame import RenderConfig, render_frame, render_frame_restir
        from zetaray_tpu_torch.scene.camera import Camera
        from zetaray_tpu_torch.scene.procedural import cornell_box
        from zetaray_tpu_torch.scene.scene import upload_scene
        torch.set_num_threads(1)
        cam = Camera.look_at((0, 1, 3.5), (0, 1, 0), vfov_deg=45.0, aspect=1.0)
        scene = upload_scene(cornell_box(), device="cpu")
        for mode, indirect, m_row in (("restir_gi", False, 10), ("restir_gi", True, 10),
                                      ("restir_pt", True, 21)):
            cfg = RenderConfig(width=16, height=16, mode=mode, indirect=indirect,
                               pt=PTConfig(max_bounces=3), denoise=True, taa=True)
            out, state = render_frame_restir(scene, cam, 7, cfg, None)
            out, state = render_frame_restir(scene, cam, 8, cfg, state)
            assert torch.isfinite(out["hdr"]).all() and out["hdr"].mean() > 0
            assert (state.gi_reservoirs[m_row] > 1).any() == indirect
        out = render_frame(scene, cam, 9, RenderConfig(width=16, height=16, mode="pt"))
        assert torch.isfinite(out["hdr"]).all() and out["hdr"].mean() > 0
        # the JAX app's default frame, with its sun and sky
        from zetaray_tpu_torch.ops.sky import SkyParams
        cfg = RenderConfig(width=16, height=16, mode="restir_di", taa=True,
                           pt=PTConfig(max_bounces=4, sky=SkyParams(sun_dir=(0.2, 0.45, 0.87))))
        out, state = render_frame_restir(scene, cam, 7, cfg, None)
        out, state = render_frame_restir(scene, cam, 8, cfg, state)
        assert torch.isfinite(out["hdr"]).all() and out["hdr"].mean() > 0
        assert not state.gi_reservoirs.any()
        # the GI frame on a clustered scene (kernels B8/B9)
        from zetaray_tpu_torch.scene.subdivide import subdivide_scene
        clustered = upload_scene(subdivide_scene(cornell_box(), 500), device="cpu",
                                 cluster_size=128)
        cfg = RenderConfig(width=16, height=16, mode="restir_gi", pt=PTConfig(max_bounces=2),
                           denoise=True, taa=True)
        out, state = render_frame_restir(clustered, cam, 7, cfg, None)
        out, state = render_frame_restir(clustered, cam, 8, cfg, state)
        assert torch.isfinite(out["hdr"]).all() and out["hdr"].mean() > 0
        assert (state.gi_reservoirs[10] > 1).any()
        # ReSTIR PT there, and bench.py's features frame (grid candidates,
        # pairwise MIS, SkyDI, volumetrics) with the GI grid NEE, on both scenes
        from zetaray_tpu_torch.ops.restir_di import ReSTIRConfig
        from zetaray_tpu_torch.ops.restir_gi import ReSTIRGIConfig
        from zetaray_tpu_torch.ops.skydi import SkyDIConfig
        from zetaray_tpu_torch.ops.volumetrics import VolumetricsConfig
        cfg = RenderConfig(width=16, height=16, mode="restir_pt", pt=PTConfig(max_bounces=3))
        out, state = render_frame_restir(clustered, cam, 7, cfg, None)
        assert torch.isfinite(out["hdr"]).all() and out["hdr"].mean() > 0
        cfg = RenderConfig(
            width=16, height=16, mode="restir_gi",
            pt=PTConfig(max_bounces=2, sky=SkyParams(sun_dir=(0.3, 0.8, 0.2)),
                        stochastic_multi_bounce=True, path_regularization=True),
            restir=ReSTIRConfig(lvg_samples=2, spatial_mis="pairwise"),
            restir_gi=ReSTIRGIConfig(lvg=True), skydi=True,
            skydi_cfg=SkyDIConfig(spatial_mis="pairwise"), volumetrics=VolumetricsConfig(),
            denoise=True, taa=True)
        for sc in (scene, clustered):
            out, state = render_frame_restir(sc, cam, 7, cfg, None)
            out, state = render_frame_restir(sc, cam, 8, cfg, state)
            assert torch.isfinite(out["hdr"]).all() and out["hdr"].mean() > 0
            assert state.sky_reservoirs is not None
        # the upscaler with RCAS, WoPS NEE, a display option and a thin lens
        from zetaray_tpu_torch.ops.upscale import UpscaleConfig
        lens = Camera.look_at((0, 1, 3.5), (0, 1, 0), vfov_deg=45.0, aspect=1.0, f_stop=2.8,
                              focal_length_mm=50.0, focus_dist=3.5)
        cfg = RenderConfig(width=16, height=16, mode="restir_gi",
                           pt=PTConfig(max_bounces=2, nee_mode="wops"), render_scale=0.5,
                           upscale_cfg=UpscaleConfig(rcas_sharpness=0.8), firefly_factor=3.0,
                           tonemapper="agx_punchy", exposure_mode="weighted_avg", taa=True)
        out, state = render_frame_restir(scene, lens, 7, cfg, None)
        out, state = render_frame_restir(scene, lens, 8, cfg, state)
        assert out["hdr"].shape == (16, 16, 3) and state.gbuf.shape[1] == 8 * 8
        assert torch.isfinite(out["hdr"]).all() and out["hdr"].mean() > 0
        assert state.upscale_lock.shape == (16, 16)
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
