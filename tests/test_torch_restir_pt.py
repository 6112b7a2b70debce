"""ReSTIR PT of the PyTorch port against the JAX package, stage by stage.

The JAX side runs as on the TPU: its suffix trace goes through the bounce
kernel in interpret mode (``pathtracer.megakernel_eligible`` patched to
True and ``megakernel.trace_megakernel`` to ``interpret=True``; on the CPU
it would take the wavefront tracer, whose random streams differ). Its
closest-hit queries take the pure-XLA dense path, which breaks ties toward
the lowest index and rounds the Woop coordinates its own way; the port
sends them through B7. So a ray that grazes an edge may hit another
triangle, and the merges compare a uniform with a sum: each test states the
share of pixels that must agree and the tolerance.

Every stage gets the inputs the JAX run produced, so each comparison
isolates one function. Reservoir rows compare by value, but the SRCSEED
row (a u32 seed's bits) compares bit for bit.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer
from zetaray_tpu.core.rng import seed_from_key
from zetaray_tpu.ops import gbuffer_pack as JGP
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import reservoir_pack as JPACK
from zetaray_tpu.ops import restir_pt as JRP
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops import reservoir_pack as TPACK
from zetaray_tpu_torch.ops import restir_pt as TRP
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.render.frame import pick_rt
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_scene import scene_pair

torch.set_num_threads(1)

RES = 32
PR = TRP.PR
PT = dict(max_bounces=3, min_emissive_bounce=2, min_nee_bounce=1)  # the frame's settings
CFG_J = JRP.ReSTIRPTConfig()
CFG_T = TRP.ReSTIRPTConfig()


def patch_megakernel(mp):
    """Send the JAX package's path traces through the bounce kernel in
    interpret mode (the path it takes on the TPU)."""
    mp.setattr(JPT, "megakernel_eligible", lambda scene: True)
    mp.setattr(JMK, "trace_megakernel", functools.partial(JMK.trace_megakernel, interpret=True))


def test_reservoir_rows_match_the_reference():
    names = [k for k in vars(JRP.PR) if k.isupper()]
    assert names == [k for k in vars(PR) if k.isupper()]
    assert all(getattr(PR, k) == getattr(JRP.PR, k) for k in names)
    assert TPACK.PT_PACKED_ROWS == JPACK.PT_PACKED_ROWS == 30


def _random_reservoirs(n=4096, seed=3):
    """Rows of every kind: unit vectors, radiance beyond f16, materials,
    counts, pixel ids, and SRCSEED bits including NaN patterns."""
    r = np.random.default_rng(seed)
    res = r.normal(0.0, 2.0, (PR.ROWS, n)).astype(np.float32)
    for row in (PR.N, PR.WS, PR.N3, PR.WS3):
        v = r.normal(size=(3, n))
        res[row : row + 3] = v / np.linalg.norm(v, axis=0)
    res[PR.LE : PR.LE + 3] *= 1e4  # beyond f16: clamped
    for row in (PR.BASE, PR.B3):
        res[row : row + 3] = r.uniform(-0.1, 1.1, (3, n))
    res[PR.M] = r.integers(0, 70000, n)
    res[PR.SRCPIX] = r.integers(0, 1 << 24, n)
    res[PR.HAS3] = r.integers(0, 2, n)
    bits = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    bits[:4] = [0x7FC00001, 0x7F800001, 0xFFFFFFFF, 0x80000000]
    res[PR.SRCSEED] = bits.view(np.float32)
    return res


OCT_ROWS = [r + k for r in (PR.N, PR.WS, PR.N3, PR.WS3) for k in range(3)]


def test_pack_pt_bit_exact():
    """pack_pt matches bit for bit, and so does unpack_pt but for the four
    octahedral unit vectors: XLA on the CPU sums their norm with fused
    multiply-adds, so those decode to within 2 ulps."""
    res = _random_reservoirs()
    assert np.isnan(res[PR.SRCSEED][:3]).all()
    want = np.asarray(JPACK.pack_pt(jnp.asarray(res)))
    got = TPACK.pack_pt(T(res))
    assert got.dtype == torch.uint32 and got.shape == (30, res.shape[1])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[13], res[PR.SRCSEED].view(np.uint32))
    back_want = np.asarray(JPACK.unpack_pt(jnp.asarray(want)))
    back = TPACK.unpack_pt(got).numpy()
    exact = [r for r in range(PR.ROWS) if r not in OCT_ROWS]
    np.testing.assert_array_equal(back[exact].view(np.uint32), back_want[exact].view(np.uint32))
    np.testing.assert_allclose(back[OCT_ROWS], back_want[OCT_ROWS], rtol=3e-7, atol=1e-7)
    np.testing.assert_array_equal(back[PR.SRCSEED].view(np.uint32),
                                  res[PR.SRCSEED].view(np.uint32))


@pytest.fixture(scope="module")
def run():
    """The JAX PT chain over a previous and a current frame (camera moved),
    and the current frame's initial samples at max_bounces=4."""
    jdev, tdev = scene_pair(cornell_box())
    rt = pick_rt(RES * RES)
    out = {"jdev": jdev, "tdev": tdev, "rt": rt}
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        for tag, k, dx in (("prev", 3, 0.0), ("curr", 4, 0.04)):
            cam = JaxCamera.look_at(
                (CAMERA_EYE[0] + dx, CAMERA_EYE[1], CAMERA_EYE[2]), CAMERA_TARGET,
                vfov_deg=CAMERA_VFOV, aspect=1.0,
            ).with_jitter(k)
            key = jax.random.PRNGKey(k)
            seed = int(seed_from_key(key))
            o, d = cam.generate_rays(RES, RES)
            gb = jax_gbuffer(jdev, o, d, interpret=True)
            res0 = JRP.initial_samples(jdev, gb, key, JPT.PTConfig(**PT), jnp.uint32(seed), CFG_J,
                                       rt=rt)
            out[tag] = dict(cam=cam, key=key, seed=seed, gb=gb, res0=res0)
        c = out["curr"]
        c["res0_b4"] = JRP.initial_samples(
            jdev, c["gb"], c["key"], JPT.PTConfig(**{**PT, "max_bounces": 4}),
            jnp.uint32(c["seed"]), CFG_J, rt=rt)
    p = out["prev"]
    p["tg"] = JGP.pack_temporal(p["gb"])
    s = jnp.uint32(c["seed"])
    c["res_t"] = JRP.temporal_reuse(c["res0"], p["res0"], p["tg"], c["gb"], p["cam"], RES, RES,
                                    s, CFG_J, scene=jdev)
    c["res_sp"] = JRP.spatial_reuse(c["res_t"], c["gb"], RES, RES, s, CFG_J, scene=jdev)
    c["indirect"] = JRP.shade(jdev, c["res_sp"], c["gb"], CFG_J, rows_out=True)
    return out


def _agree(got, want, rows=slice(None), rtol=1e-4, atol=1e-5):
    """Per pixel: every row of ``rows`` agrees (SRCSEED bit for bit; a NaN
    agrees with a NaN, as in the rows an invalid replay leaves)."""
    want = np.asarray(want)
    close = np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    close[PR.SRCSEED] = got[PR.SRCSEED].view(np.uint32) == want[PR.SRCSEED].view(np.uint32)
    return close[rows].all(0)


def _prev_cam(run):
    return camera_from_arrays(cam_dict(run["prev"]["cam"]))


@pytest.mark.parametrize("bounces", [3, 4])
def test_initial_samples_match_jax(run, bounces):
    """max_bounces=3 (the frame's: the suffix trace beyond x3 is one
    trace-only bounce) and 4 (a bounce with NEE and a trace-only one).
    x_rc comes from one closest hit; the suffix rows from two more and the
    path trace, so they may flip on more edges."""
    c = run["curr"]
    want = np.asarray(c["res0"] if bounces == 3 else c["res0_b4"])
    got = TRP.initial_samples(run["tdev"], T(c["gb"]), PTConfig(**{**PT, "max_bounces": bounces}),
                              c["seed"], CFG_T, run["rt"]).numpy()
    assert got.shape == want.shape == (PR.ROWS, RES * RES)
    assert (want[PR.M] > 0).mean() > 0.5 and (want[PR.HAS3] > 0).mean() > 0.3
    assert want[PR.LS : PR.LS + 3].max() > 0  # some paths carry light
    assert _agree(got, want, slice(PR.X, PR.N + 3)).mean() >= 0.99
    assert _agree(got, want, rtol=1e-3).mean() >= 0.97
    np.testing.assert_array_equal(got[PR.SRCSEED].view(np.uint32),
                                  want[PR.SRCSEED].view(np.uint32))
    assert abs(got[PR.WSUM].mean() - want[PR.WSUM].mean()) <= 0.03 * want[PR.WSUM].mean()


def test_temporal_reuse_with_replay_matches_jax(run):
    p, c = run["prev"], run["curr"]
    got = TRP.temporal_reuse(T(c["res0"]), T(p["res0"]), T(p["tg"]), T(c["gb"]), _prev_cam(run),
                             RES, RES, c["seed"], CFG_T, scene=run["tdev"]).numpy()
    want = np.asarray(c["res_t"])
    assert (want[PR.M] > 1).mean() > 0.3  # temporal reuse happened
    assert _agree(got, want).mean() >= 0.98


def test_replay_shift_matches_jax(run):
    """The replay shift alone, of the previous frame's fresh paths at the
    current frame's pixels: the source pixel's reseeded uniforms, the replay
    trace (B7) and the reconnection at x3. Values and validity agree on at
    least 98% of pixels (a replayed ray that grazes an edge may flip). Where
    a shift is invalid, its rows hold NaNs on both sides (a missed replay
    ray reconnects from 3e38 away); no merge takes them."""
    p, c = run["prev"], run["curr"]
    want = JRP._replay_shift(run["jdev"], JRP._surf(c["gb"]), p["res0"], CFG_J)
    got = TRP._replay_shift(run["tdev"], TRP._surf(T(c["gb"])), T(p["res0"]), CFG_T)
    ok_w = np.asarray(want[3])
    assert ok_w.mean() > 0.2  # most live paths replay validly
    same = np.asarray(got[3]) == ok_w
    for g, w in zip(got[:2], want[:2]):
        same &= np.isclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    same &= _agree(got[2].numpy(), want[2])
    assert same.mean() >= 0.98


@pytest.mark.parametrize("stage", ["temporal", "spatial"])
def test_force_replay_matches_jax(run, stage):
    """Every merge through the replay shift (``force_replay``)."""
    p, c = run["prev"], run["curr"]
    cfg_j = JRP.ReSTIRPTConfig(force_replay=True)
    cfg_t = TRP.ReSTIRPTConfig(force_replay=True)
    s = jnp.uint32(c["seed"])
    if stage == "temporal":
        want = JRP.temporal_reuse(c["res0"], p["res0"], p["tg"], c["gb"], p["cam"], RES, RES, s,
                                  cfg_j, scene=run["jdev"])
        got = TRP.temporal_reuse(T(c["res0"]), T(p["res0"]), T(p["tg"]), T(c["gb"]),
                                 _prev_cam(run), RES, RES, c["seed"], cfg_t, scene=run["tdev"])
    else:
        want = JRP.spatial_reuse(c["res_t"], c["gb"], RES, RES, s, cfg_j, scene=run["jdev"])
        got = TRP.spatial_reuse(T(c["res_t"]), T(c["gb"]), RES, RES, c["seed"], cfg_t,
                                scene=run["tdev"])
    want = np.asarray(want)
    assert (want[PR.PDFS3] == 1.0).any()  # a replayed path was taken
    assert _agree(got.numpy(), want).mean() >= 0.98


@pytest.mark.parametrize("search", [1, 3])
def test_spatial_reuse_matches_jax(run, search):
    c = run["curr"]
    cfg_j = JRP.ReSTIRPTConfig(spatial_search=search)
    want = (c["res_sp"] if search == 1 else
            JRP.spatial_reuse(c["res_t"], c["gb"], RES, RES, jnp.uint32(c["seed"]), cfg_j,
                              scene=run["jdev"]))
    got = TRP.spatial_reuse(T(c["res_t"]), T(c["gb"]), RES, RES, c["seed"],
                            TRP.ReSTIRPTConfig(spatial_search=search), scene=run["tdev"]).numpy()
    assert _agree(got, want).mean() >= 0.98


def test_shade_matches_jax(run):
    c = run["curr"]
    got = TRP.shade(run["tdev"], T(c["res_sp"]), T(c["gb"])).numpy()
    want = np.asarray(c["indirect"])
    assert got.shape == want.shape == (3, RES * RES)
    assert want.max() > 0
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5).all(0).mean() >= 0.99
    np.testing.assert_allclose(got.mean(1), want.mean(1), rtol=1e-3)
