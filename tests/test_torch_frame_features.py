"""The JAX bench's features frame (``bench.py``'s
``features_256_skydi_lvg_pairwise_vol_ms``), PyTorch port against
``render_frame_restir``: ReSTIR DI with 2 light-voxel-grid candidates and
pairwise MIS, ReSTIR GI (max_bounces 2, stochastic multi-bounce, path
regularization), SkyDI with pairwise MIS under the sky and sun, and froxel
volumetrics; with ``restir_gi.lvg`` also the ReSTIR_GI_LVG variant.

Dense frames run the JAX side through its bounce kernels in interpret mode
(``patch_megakernel`` of tests/test_torch_restir_gi.py), with the a-trous
filter and TAA off; the port starts each
frame from the JAX state after the previous one (SkyDI's reservoirs
included) and pixels agree to 1e-3 * (1 + |x|) on 97% of them, the share
tests/test_torch_frame_gi.py holds. On the box split to 546 triangles and
clustered by 128 both packages trace with their wavefront tracer, each
chains its own frames and 98% of the pixels agree, as in
tests/test_torch_frame_clustered.py. The JAX frames run eagerly (no jit:
its compile of these frames takes longer than the frames), with
``band_rows=0``: the port has no banded gathers.

Those shares hold with the sun's angular radius widened to 0.05 rad
(``wide_sun``). At the default 0.00465 rad (bench.py's frame as it stands)
a quarter of SkyDI's sun-cone candidates land on the disk's rim, where one
float32 ulp of the candidate's cosine with the sun (XLA fuses the dot
product and rounds its sines an ulp apart from PyTorch's) moves the disk's
radiance by percents (tests/test_torch_skydi.py): those frames are held to
94% of the pixels and their mean to 2%.
"""

import numpy as np
import jax
import pytest
import torch

from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import restir_di as JRD
from zetaray_tpu.ops import restir_gi as JRG
from zetaray_tpu.ops import skydi as JSD
from zetaray_tpu.ops import volumetrics as JVL
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.render import frame as JF
from zetaray_tpu.scene import scene as JS
from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays
from zetaray_tpu_torch.ops import restir_di as TRD
from zetaray_tpu_torch.ops import restir_gi as TRG
from zetaray_tpu_torch.ops import skydi as TSD
from zetaray_tpu_torch.ops import volumetrics as TVL
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import cornell_box
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_frame import _camera, _port_frame, _seed, _state_dict
from tests.test_torch_restir_di import cam_dict
from tests.test_torch_restir_gi import patch_megakernel
from tests.test_torch_scene import scene_pair, to_jax_cpu_scene

torch.set_num_threads(1)

RES = 32
SUN = (0.3, 0.8, 0.2)  # bench.py's features frame
WIDE_SUN = 0.05  # rad: the disk's rim is conditioned within the tolerance
# name: (restir_gi.lvg, the sun's angular radius or None for the default,
#        share of pixels dense, clustered)
CASES = {
    "features": (False, None, 0.94, 0.94),
    "features_wide_sun": (False, WIDE_SUN, 0.97, 0.98),
    "features_gi_lvg_wide_sun": (True, WIDE_SUN, 0.97, 0.98),
}
DENSE = ("features", "features_wide_sun")


def _cfgs(name, denoise=False, taa=False):
    """(JAX RenderConfig, port RenderConfig) of bench.py's features frame at
    RES^2, as CASES[name] sets it."""
    lvg, radius, _, _ = CASES[name]
    sky = dict(sun_dir=SUN, **({} if radius is None else {"sun_angular_radius": radius}))
    common = dict(width=RES, height=RES, mode="restir_gi", skydi=True, denoise=denoise,
                  taa=taa)
    pt = dict(max_bounces=2, stochastic_multi_bounce=True, path_regularization=True)
    restir = dict(lvg_samples=2, spatial_mis="pairwise")
    return (
        JF.RenderConfig(band_rows=0, **common,
                        pt=JPT.PTConfig(**pt, sky=JSkyParams(**sky)),
                        restir=JRD.ReSTIRConfig(**restir),
                        restir_gi=JRG.ReSTIRGIConfig(boiling_suppression=True, lvg=lvg),
                        skydi_cfg=JSD.SkyDIConfig(spatial_mis="pairwise"),
                        volumetrics=JVL.VolumetricsConfig()),
        RenderConfig(**common, pt=PTConfig(**pt, sky=SkyParams(**sky)),
                     restir=TRD.ReSTIRConfig(**restir),
                     restir_gi=TRG.ReSTIRGIConfig(boiling_suppression=True, lvg=lvg),
                     skydi_cfg=TSD.SkyDIConfig(spatial_mis="pairwise"),
                     volumetrics=TVL.VolumetricsConfig()),
    )


def _share(got, want, tol=1e-3):
    want = np.asarray(want)
    return (np.abs(got - want) <= tol * (1.0 + np.abs(want))).all(-1).mean()


@pytest.fixture(scope="module")
def scenes():
    box = subdivide_scene(cornell_box(), 500)
    return {
        "dense": scene_pair(cornell_box()),
        "clustered": (JS.upload_scene(to_jax_cpu_scene(box), cluster_size=128),
                      TS.upload_scene(box, device="cpu", cluster_size=128)),
    }


@pytest.fixture(scope="module")
def jax_runs(scenes):
    """Two JAX frames of each DENSE case through the bounce kernels:
    {name: (outputs, states)}."""
    jdev, _ = scenes["dense"]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_megakernel(mp)
        for name in DENSE:
            outs, states, state = [], [], None
            for k in range(2):
                out, state = JF.render_frame_restir(jdev, _camera(k), jax.random.PRNGKey(k), _cfgs(name)[0],
                                    state)
                outs.append({key: np.asarray(v) for key, v in out.items()})
                states.append(_state_dict(state))
            runs[name] = (outs, states)
    return runs


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", DENSE)
def test_frame_from_jax_state(scenes, jax_runs, name, k):
    """Frame k from the JAX state after frame k-1: the image, and the DI,
    GI and SkyDI reservoirs the next frame reuses (to 1e-3 on 95% of the
    pixels; SkyDI's at the default sun on 90%)."""
    _, tdev = scenes["dense"]
    outs, states = jax_runs[name]
    state = frame_state_from_arrays(states[k - 1], device="cpu") if k > 0 else None
    if k > 0:
        assert state.sky_reservoirs is not None
    out, new_state = _port_frame(tdev, k, state, _cfgs(name)[1])
    hdr, want = out["hdr"].numpy(), outs[k]["hdr"]
    assert hdr.shape == want.shape == (RES, RES, 3) and np.isfinite(hdr).all()
    assert _share(hdr, want) >= CASES[name][2]
    assert abs(hdr.mean() - want.mean()) <= 0.02 * want.mean()
    for key in ("reservoirs", "gi_reservoirs", "sky_reservoirs"):
        got_r, want_r = getattr(new_state, key).numpy(), states[k][key]
        share = 0.9 if key == "sky_reservoirs" and CASES[name][1] is None else 0.95
        assert np.isclose(got_r, want_r, rtol=1e-3, atol=1e-5).all(0).mean() >= share, key


def test_features_change_the_frame(scenes):
    """Each feature shows in the port's frame: the grid candidates raise DI's
    M, SkyDI keeps reservoirs, and the medium changes the image."""
    _, tdev = scenes["dense"]
    cfg = _cfgs("features")[1]
    out, state = _port_frame(tdev, 0, None, cfg)
    assert (state.reservoirs[10] > 128).float().mean() > 0.3  # grid candidates merged
    assert state.sky_reservoirs.shape == (16, RES * RES)
    from dataclasses import replace

    out_novol, _ = _port_frame(tdev, 0, None, replace(cfg, volumetrics=None))
    assert not torch.equal(out["hdr"], out_novol["hdr"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_clustered_chained_frames_match_jax(scenes, name):
    """Two chained frames on the clustered box, each package chaining its
    own, with a-trous and TAA on."""
    jdev, tdev = scenes["clustered"]
    cfg_j, cfg_t = _cfgs(name, denoise=True, taa=True)
    state_j = state_t = None
    for k in range(2):
        out_j, state_j = JF.render_frame_restir(jdev, _camera(k), jax.random.PRNGKey(k), cfg_j,
                                                state_j)
        out_t, state_t = render_frame_restir(tdev, camera_from_arrays(cam_dict(_camera(k))),
                                             _seed(k), cfg_t, state_t)
        got = out_t["hdr"].numpy()
        assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
        assert _share(got, out_j["hdr"]) >= CASES[name][3]
        assert abs(got.mean() - np.asarray(out_j["hdr"]).mean()) <= 0.02 * got.mean()
