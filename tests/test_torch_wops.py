"""WoPS NEE (``PTConfig.nee_mode="wops"``: each ray draws its light from the
emissive alias table, ``wops_table``) in the PyTorch port's bounce kernels
B5 and B6, held through their plain versions against the Pallas kernels
``_bounce_shade_kernel`` and ``_bounce_kernel`` in interpret mode, and in
the flagship and the JAX app's default frame.

The scene is the box with three wall triangles made two-sided lights of
unequal power (``multi_light_box``): the box's own light is two triangles
of equal power, whose alias table never redirects a pick. The tests check
that the alias is taken on a share of the rays.

JAX's ``bounce_step_split`` hands its shade kernel neither the emissive
count nor the WoPS uniforms (only ``trace_with_first_hit`` does), so B5 is
held against ``_bounce_shade_kernel`` launched here as
``trace_with_first_hit`` launches it, on the same state and surface rows
(B4's plain version) as the port's plain B5. B6 is held against
``bounce_step``. The criteria are tests/test_torch_bounce.py's (rows to
rtol 1e-4 where the ray found its hit). The frames run the JAX side
through its bounce kernels in interpret mode and hold tests/
test_torch_frame_restir_di.py's share of pixels (97%).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from zetaray_tpu.accel import megakernel as JMK
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.render import frame as JF
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.core.rng import bounce_uniforms
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
from zetaray_tpu_torch.scene.procedural import multi_light_box
from zetaray_tpu_torch.scene.scene import EA
from tests.test_torch_bounce import _bounce0_rays, _check_state, _state
from tests.test_torch_frame import _camera, _seed
from tests.test_torch_restir_di import T, cam_dict
from tests.test_torch_restir_gi import patch_megakernel as patch_gi
from tests.test_torch_restir_pt import patch_megakernel as patch_pt
from tests.test_torch_scene import frame_seed, scene_pair

torch.set_num_threads(1)

N = RT = 256
SEED = frame_seed(11)
SUN = (0.2, 0.45, 0.87)
CFG = dict(max_bounces=3, min_emissive_bounce=1, rr_start=3, nee_mode="wops")


@pytest.fixture(scope="module")
def case():
    jdev, tdev = scene_pair(multi_light_box())
    o, d = _bounce0_rays(tdev)
    return dict(jdev=jdev, tdev=tdev, st=_state(o, d), woop3=jdev.woop.reshape(4, 3, -1),
                attrs_t=jdev.tri_attrs.T, table=JMK.wops_table(jdev))


def _cfgs(sun: bool):
    return (JPT.PTConfig(**CFG, sky=JSkyParams(sun_dir=SUN) if sun else None),
            PTConfig(**CFG, sky=SkyParams(sun_dir=SUN) if sun else None))


def _jax_shade(case, st, surf, bounce, jcfg):
    """``_bounce_shade_kernel`` with the emissive count and the WoPS
    uniforms, launched as ``trace_with_first_hit`` launches it."""
    tp = case["woop3"].shape[2]
    scal = jnp.array([[bounce], [np.uint32(SEED).view(np.int32)], [0], [0]], jnp.int32)
    kernel = functools.partial(
        JMK._bounce_shade_kernel, rt=RT, tp=tp, tc=min(128, tp), cfg=jcfg, has_lights=True,
        has_transmission=False, has_coat=False, n_em=case["jdev"].num_emissives)
    u = JMK.bounce_uniforms(N, bounce, jnp.uint32(SEED), wops=True)
    row = lambda rows: pl.BlockSpec((rows, RT), lambda i: (0, i), memory_space=pltpu.VMEM)
    whole = pl.BlockSpec(memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kernel, grid=(N // RT,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), row(16), row(MK.SURF_ROWS), whole,
                  whole, row(u.shape[0])],
        out_specs=row(16), out_shape=jax.ShapeDtypeStruct((16, N), jnp.float32),
        input_output_aliases={1: 0}, interpret=True,
    )(scal, jnp.asarray(st), jnp.asarray(surf), case["woop3"], case["table"], u)


def _alias_share(tdev, alive, bounce):
    """The share of the live rays whose pick the alias table redirects."""
    u = bounce_uniforms(N, bounce, SEED, wops=True)
    redirected = MK.wops_pick(MK.wops_table(tdev), tdev.num_emissives, u[0], u[5])[1]
    return (redirected & alive).float().sum().item() / alive.sum().item()


def test_wops_uniforms_and_table_match_jax(case):
    for bounce in (0, 1, 7):
        want = np.asarray(JMK.bounce_uniforms(4096, bounce, jnp.uint32(SEED), wops=True))
        got = bounce_uniforms(4096, bounce, SEED, wops=True)
        assert got.shape == (8, 4096)
        np.testing.assert_array_equal(got.numpy(), want)
    # the port's table is the JAX table's transpose, padded to WOPS_ROW columns
    table = MK.wops_table(case["tdev"])
    assert table.shape == (case["tdev"].em_attrs.shape[0], MK.WOPS_ROW)
    np.testing.assert_array_equal(table[:, : EA.WIDTH + 2].numpy().T,
                                  np.asarray(case["table"])[0])
    assert not table[:, EA.WIDTH + 2 :].any()
    e = case["tdev"].num_emissives
    assert e == 5 and (table[:e, EA.WIDTH] < 1.0).sum() >= 2  # unequal powers


@pytest.mark.parametrize("sun", [False, True], ids=["no_sky", "sun_nee"])
@pytest.mark.parametrize("bounce", [0, 1])
def test_wops_shade_and_bounce_match_jax(case, bounce, sun):
    """B5 (on B4's surface rows) and B6 with WoPS NEE; the alias redirects
    a share of the picks, and WoPS lights other rays than the light sets."""
    st = case["st"]
    jcfg, cfg = _cfgs(sun)
    st4, surf = MK.bounce_trace_plain(case["tdev"], T(st), bounce, cfg, True)
    found = st4[13].numpy() > 0.5
    assert 0.3 < found.mean() < 1.0
    everyone = np.ones(N, bool)
    table = MK.wops_table(case["tdev"])
    got5 = MK.bounce_shade_plain(case["tdev"], st4, surf, table, bounce, SEED, cfg, True, RT)
    want5 = _jax_shade(case, st4.numpy(), surf.numpy(), bounce, jcfg)
    _check_state(got5, want5, everyone, found)
    assert _alias_share(case["tdev"], st4[13] > 0.5, bounce) > 0.05
    lit = (got5[9:12] != st4[9:12]).any(0)
    assert lit.float().mean() > 0.1

    want6 = JMK.bounce_step(jnp.asarray(st), case["woop3"], case["attrs_t"], case["table"],
                            bounce, jnp.uint32(SEED), jcfg, last=False, has_lights=True,
                            rt=RT, interpret=True, n_em=case["jdev"].num_emissives)
    got6 = MK.bounce_plain(case["tdev"], T(st), table, bounce, SEED, cfg, False, True, RT)
    _check_state(got6, want6, everyone, found)
    wps = dataclasses.replace(cfg, nee_mode="wps")
    lsets = MK.build_light_sets(case["tdev"], SEED)
    got_wps = MK.bounce_plain(case["tdev"], T(st), lsets, bounce, SEED, wps, False, True, RT)
    assert (got_wps[9:12] != got6[9:12]).any(0).float().mean() > 0.05


RES = 32
FRAMES = {
    # the flagship (bench.py:75-82) with WoPS, a-trous and TAA off for pixels
    "flagship": ("restir_gi", dict(max_bounces=3)),
    # the JAX app's default frame with WoPS: B6 alone
    "restir_di": ("restir_di", dict(max_bounces=4)),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_wops_frame_matches_jax(name):
    mode, pt = FRAMES[name]
    base = dict(width=RES, height=RES, mode=mode, denoise=False, taa=False)
    jdev, tdev = scene_pair(multi_light_box())
    jcfg = JF.RenderConfig(band_rows=0, pt=JPT.PTConfig(**pt, nee_mode="wops"), **base)
    cfg = RenderConfig(pt=PTConfig(**pt, nee_mode="wops"), **base)
    k = 1
    with pytest.MonkeyPatch.context() as mp:
        patch_gi(mp)
        patch_pt(mp)
        out_j, _ = jax.jit(JF.render_frame_restir, static_argnames=("cfg",))(
            jdev, _camera(k), jax.random.PRNGKey(k), jcfg, None)
    cam = camera_from_arrays(cam_dict(_camera(k)))
    out, _ = render_frame_restir(tdev, cam, _seed(k), cfg, None)
    hdr, want = out["hdr"].numpy(), np.asarray(out_j["hdr"])
    assert hdr.shape == want.shape == (RES, RES, 3) and np.isfinite(hdr).all()
    assert (np.abs(hdr - want) <= 1e-3 * (1.0 + np.abs(want))).all(-1).mean() >= 0.97
    assert abs(hdr.mean() - want.mean()) <= 0.02 * want.mean()
    wps, _ = render_frame_restir(tdev, cam, _seed(k), dataclasses.replace(
        cfg, pt=PTConfig(**pt)), None)
    assert (wps["hdr"].numpy() != hdr).any(-1).mean() > 0.1  # WoPS draws other lights
