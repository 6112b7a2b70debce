"""Row-band sharding of the port (``parallel/mesh.py``, the frame's
``shard`` path) on gloo ranks on the CPU.

- The tile offset: ``bounce_uniforms(pix0)`` equals the JAX package's bit
  for bit; the plain versions of B2, B5 and B6 with an offset (tile0 > 0)
  equal the Pallas kernels in interpret mode with the same ``pix0``, to the
  criteria of tests/test_torch_restir_di.py and tests/test_torch_bounce.py.
- The sharded frames: worlds of 2 and 4 ranks (``parallel.mesh.run_ranks``:
  fresh processes, a file store, JAX unimportable there;
  ``tests/torch_ranks.py``) chain each configuration's frames, and the
  gathered bands are held to the port's whole-image frames from the same
  seeds. The image is 128 x 32 (the upscaler's display 256 x 64), so a band
  is 2048 or 1024 pixels and ``pick_rt`` gives the whole image's tile
  width: every random stream and light-set pick is the whole image's. The
  tolerances are the JAX tests' (tests/test_parallel.py): rtol 1e-5, atol
  1e-6 for plain PT, rtol 3e-3, atol 1e-5 for the ReSTIR frames; the HDR
  of these frames is in fact bit-equal, and each test asserts so too,
  except where the weighted-average exposure sums in another order (the
  LDR of the lens frame, within one step).
- The port sharded (world 4) against the JAX package's
  ``render_frame_restir_sharded(make_mesh(4), ...)``: the GI frame of
  tests/test_torch_frame_gi.py, each frame from the JAX state of the frame
  before, to that test's tolerance and share of pixels.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.ops.pathtracer import PTConfig as JPTConfig
from zetaray_tpu.parallel.mesh import make_mesh, render_frame_restir_sharded as jax_sharded
from zetaray_tpu.render import frame as JF
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.core.rng import bounce_uniforms
from zetaray_tpu_torch.ops import restir_di as TRD
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.ops.upscale import UpscaleConfig
from zetaray_tpu_torch.ops.volumetrics import VolumetricsConfig
from zetaray_tpu_torch.parallel.mesh import run_ranks
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame, render_frame_restir
from zetaray_tpu_torch.scene.procedural import cornell_box
from zetaray_tpu_torch.scene.scene import upload_scene
from tests.test_torch_bounce import CFG, RT, SEED, _bounce0_rays, _check_state, _hit_agreement
from tests.test_torch_bounce import _state
from tests.test_torch_frame import _camera, _seed, _state_dict
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_restir_gi import patch_megakernel
from tests.test_torch_scene import scene_pair
from tests.torch_ranks import BLOCKED, camera

torch.set_num_threads(1)

W, H = 128, 32
SUN = SkyParams(sun_dir=(0.2, 0.45, 0.87))  # the JAX app's --sun
SPECS = {
    "plain_pt": (RenderConfig(width=W, height=H, mode="pt", pt=PTConfig(max_bounces=2)), 2),
    "restir_gi": (RenderConfig(width=W, height=H, mode="restir_gi",
                               pt=PTConfig(max_bounces=2), denoise=True, taa=True), 2),
    "restir_pt": (RenderConfig(width=W, height=H, mode="restir_pt",
                               pt=PTConfig(max_bounces=2), denoise=True, taa=True), 2),
    "skydi_volumetrics": (RenderConfig(width=W, height=H, mode="restir_gi",
                                       pt=PTConfig(max_bounces=2,
                                                   sky=SkyParams(sun_dir=(0.3, 0.8, 0.2))),
                                       skydi=True, volumetrics=VolumetricsConfig(), taa=True), 2),
    "upscale_rcas": (RenderConfig(width=2 * W, height=2 * H, mode="restir_gi",
                                  pt=PTConfig(max_bounces=2), render_scale=0.5, taa=True,
                                  upscale_cfg=UpscaleConfig(rcas_sharpness=0.8)), 2),
    "default_restir_di_sun": (RenderConfig(width=W, height=H, mode="restir_di",
                                           pt=PTConfig(max_bounces=4, sky=SUN), taa=True), 2),
    # one frame through a thin lens, with the firefly filter and the
    # weighted-average exposure
    "lens": (RenderConfig(width=W, height=H, mode="restir_di", pt=PTConfig(max_bounces=2),
                          firefly_factor=2.0, exposure_mode="weighted_avg"), 1),
}
SEEDS = (0x9E3779B9, 12345)


def _specs():
    return [(name, cfg, SEEDS[:n], name == "lens") for name, (cfg, n) in SPECS.items()]


# -- the tile offset -------------------------------------------------------


@pytest.mark.parametrize("pix0", [1024, 7 * 256 + 96, 2**31 - 4096])
def test_bounce_uniforms_offset_bit_exact(pix0):
    for bounce, wops in ((0, False), (3, True)):
        want = np.asarray(JMK.bounce_uniforms(2048, bounce, jnp.uint32(SEED), pix0=pix0,
                                              wops=wops))
        got = bounce_uniforms(2048, bounce, SEED, pix0=pix0, wops=wops)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not np.array_equal(want, np.asarray(JMK.bounce_uniforms(
            2048, bounce, jnp.uint32(SEED), wops=wops)))


@pytest.fixture(scope="module")
def box():
    jdev, tdev = scene_pair(cornell_box())
    o, d = _bounce0_rays(tdev)
    lsets = JMK.build_light_sets(jdev, jnp.uint32(SEED))
    out = dict(jdev=jdev, tdev=tdev, st=_state(o, d), has_lights=True, lsets=lsets,
               woop3=jdev.woop.reshape(4, 3, -1), attrs_t=jdev.tri_attrs.T)
    out["agree"], out["found"], _, _ = _hit_agreement(out)
    return out


OFFSETS = [3 * RT, 5 * RT + 96]  # tile0 = 3; tile0 = 5 with the streams 96 further on


@pytest.mark.parametrize("pix0", OFFSETS)
def test_ris_offset_matches_jax(box, pix0):
    """B2's plain version with a band's offset against the Pallas kernel
    (interpret mode) with the same ``pix0``, on the box's 16^2 camera
    G-buffer at rt = 128: the picks agree on 99.5% of the pixels and every
    row there to 1e-5 (tests/test_torch_restir_di.py). The offset moves the
    picks."""
    from zetaray_tpu.accel.megakernel import gbuffer as jax_gbuffer

    cam = _camera(1)
    o, d = cam.generate_rays(16, 16)
    gb = jax_gbuffer(box["jdev"], o, d, interpret=True)
    want = np.asarray(JRD.initial_candidates(gb, box["lsets"], jnp.uint32(SEED),
                                             JRD.ReSTIRConfig(), rt=128, interpret=True,
                                             pix0=pix0))
    got = TRD.initial_candidates(T(gb), T(box["lsets"]), SEED, rt=128, pix0=pix0).numpy()
    same_pick = (got[0:3] == want[0:3]).all(0)
    assert same_pick.mean() >= 0.995
    np.testing.assert_allclose(got[:, same_pick], want[:, same_pick], rtol=1e-5, atol=1e-6)
    at0 = TRD.initial_candidates(T(gb), T(box["lsets"]), SEED, rt=128).numpy()
    assert (at0[0:3] != got[0:3]).any(0).mean() > 0.3


@pytest.mark.parametrize("pix0", OFFSETS)
def test_bounce_shade_offset_matches_jax(box, pix0):
    """B4 then B5 with a band's offset against ``bounce_step_split`` with
    the same ``pix0``, to the criteria of tests/test_torch_bounce.py."""
    st = box["st"]
    jcfg = JPTConfig(**CFG)
    want = JMK.bounce_step_split(
        jnp.asarray(st), box["woop3"], box["attrs_t"], box["lsets"], 0, jnp.uint32(SEED), jcfg,
        last=False, has_lights=True, rt=RT, interpret=True, pix0=pix0,
    )
    cfg = PTConfig(**CFG)
    st2, surf = MK.bounce_trace_plain(box["tdev"], T(st), 0, cfg, True)
    got = MK.bounce_shade_plain(box["tdev"], st2, surf, T(box["lsets"]), 0, SEED, cfg, True, RT,
                                pix0)
    _check_state(got, want, box["agree"], box["found"])
    at0 = MK.bounce_shade_plain(box["tdev"], st2, surf, T(box["lsets"]), 0, SEED, cfg, True, RT)
    assert not torch.equal(got[3:6], at0[3:6])


@pytest.mark.parametrize("pix0", OFFSETS)
def test_bounce_offset_matches_jax(box, pix0):
    """B6 with a band's offset against ``bounce_step`` with the same
    ``pix0`` at bounce 3 (Russian roulette draws too), to the criteria of
    tests/test_torch_bounce.py."""
    st = box["st"]
    want = JMK.bounce_step(
        jnp.asarray(st), box["woop3"], box["attrs_t"], box["lsets"], 3, jnp.uint32(SEED),
        JPTConfig(**CFG), last=False, has_lights=True, rt=RT, interpret=True, pix0=pix0,
    )
    got = MK.bounce_plain(box["tdev"], T(st), T(box["lsets"]), 3, SEED, PTConfig(**CFG), False,
                          True, RT, pix0)
    _check_state(got, want, box["agree"], box["found"])


# -- the sharded frames against the whole image ----------------------------


@pytest.fixture(scope="module")
def whole():
    """Each configuration's frames rendered whole, from the seeds the ranks use."""
    scene = upload_scene(cornell_box(), device="cpu")
    out = {}
    for name, cfg, seeds, lens in _specs():
        state = None
        for k, seed in enumerate(seeds):
            cam = camera(k, cfg.width, cfg.height, lens)
            if name == "plain_pt":
                res = render_frame(scene, cam, seed, cfg)
            else:
                res, state = render_frame_restir(scene, cam, seed, cfg, state)
            out[name, k] = {key: v.numpy() for key, v in res.items()}
        if state is not None:
            out[name, "state"] = {k: getattr(state, k).numpy() for k in
                                  ("reservoirs", "gi_reservoirs", "gbuf", "history",
                                   "sky_reservoirs", "upscale_lock")
                                  if getattr(state, k) is not None}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def sharded(request):
    world = request.param
    return world, run_ranks("tests.torch_ranks:frames", world, (_specs(),), timeout=600,
                            blocked=BLOCKED)


@pytest.mark.parametrize("name", list(SPECS))
def test_sharded_frames_match_whole(whole, sharded, name):
    """The gathered bands of each chained frame against the whole image:
    HDR to the JAX tests' tolerance of the configuration (and bit-equal),
    LDR within one step, the last FrameState's tables bit-equal; every rank
    gathered the same image, and the exchanges moved bytes."""
    world, ranks = sharded
    cfg, n = SPECS[name]
    rtol, atol = (1e-5, 1e-6) if name == "plain_pt" else (3e-3, 1e-5)
    for k in range(n):
        want = whole[name, k]
        for rank in range(world):
            got = ranks[rank][name, k]
            assert got["hdr"].shape == want["hdr"].shape == (cfg.height, cfg.width, 3)
            assert np.isfinite(got["hdr"]).all()
            np.testing.assert_allclose(got["hdr"], want["hdr"], rtol=rtol, atol=atol)
            np.testing.assert_array_equal(got["hdr"], want["hdr"])
            diff = np.abs(got["ldr"].astype(int) - want["ldr"].astype(int))
            assert diff.max() <= (1 if cfg.exposure_mode == "weighted_avg" else 0)
    assert want["hdr"].mean() > 0
    if (name, "state") in whole:
        for key, table in whole[name, "state"].items():
            np.testing.assert_array_equal(ranks[0][name, "state"][key], table)
    assert ranks[0][name, "bytes"] > 0


# -- the port sharded against the JAX package sharded ----------------------


GI = dict(width=32, height=32, mode="restir_gi", denoise=False, taa=False)


@pytest.fixture(scope="module")
def jax_sharded_gi():
    """Two JAX GI frames sharded over 4 devices (the bounce kernels in
    interpret mode, as tests/test_torch_frame_gi.py runs them): (outputs,
    states, cameras, seeds)."""
    jdev, _ = scene_pair(cornell_box())
    cfg = JF.RenderConfig(band_rows=0, pt=JPTConfig(max_bounces=2), **GI)
    outs, states, state = [], [None], None
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        for k in range(2):
            out, state = jax_sharded(make_mesh(4), jdev, _camera(k), jax.random.PRNGKey(k), cfg,
                                     state)
            outs.append(np.asarray(out["hdr"]))
            states.append(_state_dict(state))
    return outs, states, [cam_dict(_camera(k)) for k in range(2)], [_seed(k) for k in range(2)]


def test_sharded_gi_matches_jax_sharded(jax_sharded_gi):
    """Each port frame from the JAX sharded state of the frame before: HDR
    to 1e-3 relative on 97% of the pixels and the GI reservoirs to rtol
    1e-3 on 97%, the criteria tests/test_torch_frame_gi.py holds the whole
    frame to."""
    outs, states, cams, seeds = jax_sharded_gi
    cfg = RenderConfig(pt=PTConfig(max_bounces=2), **GI)
    ranks = run_ranks("tests.torch_ranks:jax_state_frames", 4,
                      (cfg, seeds, cams, states[:2]), timeout=600, blocked=BLOCKED)
    for k in range(2):
        got, want = ranks[0][k]["hdr"], outs[k]
        assert ranks[0][k]["rows"] == 8 and got.shape == want.shape == (32, 32, 3)
        close = np.abs(got - want) <= 1e-3 * (1.0 + np.abs(want))
        assert close.all(-1).mean() >= 0.97
        gi, gi_want = ranks[0][k]["gi_reservoirs"], states[k + 1]["gi_reservoirs"]
        assert (gi_want[10] > 0).mean() > 0.5
        assert np.isclose(gi, gi_want, rtol=1e-3, atol=1e-5).all(0).mean() >= 0.97
    assert (states[2]["gi_reservoirs"][10] > 1).mean() > 0.3  # temporal GI reuse ran
