"""Animated frames of the PyTorch port against the JAX package's
``render_frame_restir(..., motion=...)``, and the modes each frame
function takes as the JAX one does: ``"pt"`` in ``render_frame_restir`` and
every mode in ``render_frame``.

The scene is ``procedural.animated_box`` (its tall block slides and turns),
each package refitting its own upload to the frame's time with its own
``refit_scene`` and passing ``motion = transform_deltas(W_curr, W_prev)[0]``.
The JAX frames run through the bounce kernels in interpret mode
(tests/test_torch_restir_gi.py's and test_torch_restir_pt.py's patches)
under a jit made inside the patch, with ``band_rows=0`` and the a-trous
filter off; TAA stays on, so the motion reaches it. The port renders frame
k from the JAX state after frame k-1: pixels agree to 1e-3 * (1 + |x|) on
97% of the pixels and the mean to 2%, as in
tests/test_torch_frame_restir_di.py (the two refits differ by ulps, which
may flip an edge pixel). ``_prev_positions`` is held to 1e-6, the
reprojection of its points to the same previous pixel on 99% of the pixels
(a point on a pixel's edge may round either way) and their depths to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.render import frame as JF
from zetaray_tpu.scene import animation as JA
from zetaray_tpu.scene import refit as JR
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays
from zetaray_tpu_torch.ops import restir_di as RD
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render import frame as TF
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.animation import AnimationRig, transform_deltas
from zetaray_tpu_torch.scene.gltf import load_gltf
from zetaray_tpu_torch.scene.procedural import animated_box
from zetaray_tpu_torch.scene.refit import refit_scene
from tests.test_torch_frame import _camera, _seed, _state_dict
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_gi import patch_megakernel as patch_gi
from tests.test_torch_restir_pt import patch_megakernel as patch_pt

torch.set_num_threads(1)

RES = 32
TIMES = (0.0, 0.4, 0.8)  # the block's time in frames 0, 1, 2
BASE = dict(width=RES, height=RES, denoise=False, taa=True)
# name: (mode, max_bounces)
CHAINS = {"restir_di": ("restir_di", 4), "restir_gi": ("restir_gi", 3), "pt": ("pt", 4)}


def _cfgs(mode, bounces, base=BASE):
    return (JF.RenderConfig(band_rows=0, mode=mode, pt=JPT.PTConfig(max_bounces=bounces), **base),
            TF.RenderConfig(mode=mode, pt=PTConfig(max_bounces=bounces), **base))


def _share(got, want, tol=1e-3):
    want = np.asarray(want)
    return (np.abs(got - want) <= tol * (1.0 + np.abs(want))).all(-1).mean()


@pytest.fixture(scope="module")
def anim(tmp_path_factory):
    """Both packages' rigs, uploads, refit scenes and motion tables of the
    frames: {"jax": [...], "port": [...]} of (scene, motion or None)."""
    path = animated_box(tmp_path_factory.mktemp("motion") / "box.gltf")
    from zetaray_tpu.scene import gltf as JG

    rig_t, rig_j = AnimationRig(load_gltf(path)), JA.AnimationRig(JG.load_gltf(path))
    tdev = TS.upload_scene(TS.load_scene(path), device="cpu")
    jdev = JS.upload_scene(JS.load_scene(str(path)))
    frames = {"jax": [], "port": []}
    for k, t in enumerate(TIMES):
        w = rig_t.instance_worlds(t)
        motion = transform_deltas(w, rig_t.instance_worlds(TIMES[k - 1]))[0] if k else None
        frames["port"].append((refit_scene(tdev, *rig_t.deltas(t)), motion))
        frames["jax"].append((JR.refit_scene(jdev, *rig_j.deltas(t)), motion))
    return frames


@pytest.fixture(scope="module")
def jax_runs(anim):
    """Three JAX frames of each chain: {name: (outputs, states)}."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_gi(mp)
        patch_pt(mp)
        render = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))
        for name, (mode, bounces) in CHAINS.items():
            cfg_j, _ = _cfgs(mode, bounces)
            outs, states, state = [], [], None
            for k, (sc, motion) in enumerate(anim["jax"]):
                if name == "pt" and k == 2:
                    break
                out, state = render(sc, _camera(k), jax.random.PRNGKey(k), cfg_j, state,
                                    motion=None if motion is None else jnp.asarray(motion))
                outs.append({key: np.asarray(v) for key, v in out.items()})
                states.append(_state_dict(state))
            runs[name] = (outs, states)
    return runs


def _port(anim, k, state, cfg, motion="frame"):
    sc, m = anim["port"][k]
    return TF.render_frame_restir(sc, camera_from_arrays(cam_dict(_camera(k))), _seed(k), cfg,
                                  state, motion=m if motion == "frame" else motion)


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("name", ["restir_di", "restir_gi"])
def test_animated_frame_from_jax_state(anim, jax_runs, name, k):
    outs, states = jax_runs[name]
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k else None
    out, new_state = _port(anim, k, state, _cfgs(*CHAINS[name])[1])
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert hdr.shape == want.shape == (RES, RES, 3) and np.isfinite(hdr).all()
    assert _share(hdr, want) >= 0.97
    assert abs(hdr.mean() - want.mean()) <= 0.02 * want.mean()
    assert np.isclose(new_state.reservoirs.numpy(), states[k]["reservoirs"], rtol=1e-3,
                      atol=1e-5).all(0).mean() >= 0.97


@pytest.mark.parametrize("k", [0, 1])
def test_pt_mode_frame_matches_jax(anim, jax_runs, k):
    """``mode="pt"`` renders through ``render_frame_restir`` as the JAX
    frame renders it, the branches of ``"restir_di"`` (no indirect
    reservoirs; the same image as a ``restir_di`` frame from that state)."""
    outs, states = jax_runs["pt"]
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k else None
    cfg = _cfgs(*CHAINS["pt"])[1]
    out, new_state = _port(anim, k, state, cfg)
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert _share(hdr, want) >= 0.97
    assert abs(hdr.mean() - want.mean()) <= 0.02 * want.mean()
    assert not new_state.gi_reservoirs.any()
    twin, _ = _port(anim, k, state, TF.RenderConfig(**{**vars(cfg), "mode": "restir_di"}))
    assert torch.equal(twin["hdr"], out["hdr"])


@pytest.mark.parametrize("mode", ["restir_gi", "restir_pt"])
def test_render_frame_takes_any_mode(anim, mode):
    """``render_frame`` path-traces ``cfg.pt`` whatever the mode, as the
    JAX function does: 99% of the pixels against JAX, and the same image as
    ``mode="pt"``."""
    jsc, tsc = anim["jax"][1][0], anim["port"][1][0]
    base = dict(width=RES, height=RES)
    cfg_j, cfg_t = _cfgs(mode, 4, base)
    with pytest.MonkeyPatch.context() as mp:
        patch_pt(mp)
        render = jax.jit(JF.render_frame, static_argnames=("cfg",))
        want = np.asarray(render(jsc, _camera(1), jax.random.PRNGKey(1), cfg_j)["hdr"])
    cam = camera_from_arrays(cam_dict(_camera(1)))
    got = TF.render_frame(tsc, cam, _seed(1), cfg_t)["hdr"]
    assert _share(got.numpy(), want) >= 0.99 and want.mean() > 0
    plain = TF.render_frame(tsc, cam, _seed(1), _cfgs("pt", 4, base)[1])
    assert torch.equal(plain["hdr"], got)


def test_prev_positions_and_reprojection_match_jax(anim):
    """_prev_positions (a miss takes the identity row) and the
    reprojection of those points into the previous camera, against JAX's."""
    jsc, motion = anim["jax"][2]
    o, d = _camera(2).generate_rays(RES, RES)
    gb_j = JMK.gbuffer(jsc, o, d, interpret=True)
    gb_t = torch.from_numpy(np.array(gb_j))
    want = np.asarray(JF._prev_positions(gb_j, motion))
    got = TF._prev_positions(gb_t, motion)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    miss = gb_t[MK.G.INST] < 0
    hit_block = gb_t[MK.G.INST] == 1
    assert miss.any() and hit_block.sum() > 20
    pos = gb_t[MK.G.POS : MK.G.POS + 3].T
    assert torch.equal(got[miss], pos[miss]) and torch.equal(got[gb_t[MK.G.INST] == 0],
                                                             pos[gb_t[MK.G.INST] == 0])
    assert (got[hit_block] - pos[hit_block]).norm(dim=1).min() > 1e-3
    prev = _camera(1)
    cam_t = camera_from_arrays(cam_dict(prev))
    for pp in (None, got):
        idx, inside, dep = RD.reproject_prev(gb_t, cam_t, RES, RES, pp)
        j_idx, j_in, j_dep = JRD.reproject_prev(gb_j, prev, RES, RES,
                                                pos_prev=None if pp is None else jnp.asarray(want))
        assert (idx.numpy() == np.asarray(j_idx)).mean() >= 0.99
        assert (inside.numpy() == np.asarray(j_in)).mean() >= 0.99
        np.testing.assert_allclose(dep.numpy(), np.asarray(j_dep), rtol=1e-5)


def test_motion_keeps_the_moving_block_reused(anim, jax_runs):
    """With ``motion`` the block's pixels reproject to where the block was
    and keep their DI history (M at its cap): fewer than a quarter as many
    of them lose some of it as when the frame is told nothing moved."""
    _, states = jax_runs["restir_di"]
    state = frame_state_from_arrays(states[1], device="cpu")
    cfg = _cfgs(*CHAINS["restir_di"])[1]
    _, with_m = _port(anim, 2, state, cfg)
    _, without = _port(anim, 2, state, cfg, motion=None)
    sc = anim["port"][2][0]
    o, d = camera_from_arrays(cam_dict(_camera(2))).generate_rays(RES, RES, device="cpu")
    block = MK.gbuffer(sc, o, d)[MK.G.INST] == 1
    m_with, m_without = with_m.reservoirs[10][block], without.reservoirs[10][block]
    full = m_with.max()  # the M cap: the history kept whole
    assert block.sum() > 50 and 4 * (m_with < full).sum() < (m_without < full).sum()
    assert torch.equal(with_m.gbuf.view(torch.int32), without.gbuf.view(torch.int32))
