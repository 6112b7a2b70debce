"""The port's configs against the JAX package's: every field of the JAX
``ReSTIRConfig``, ``ReSTIRGIConfig``, ``ReSTIRPTConfig`` and
``RenderConfig`` is accepted with the JAX default, and the reuse options
``full_target`` and ``packed_reuse=False`` of the three ReSTIR configs
act as in JAX.

The JAX defaults are the fields' declared defaults. JAX's
``RenderConfig.__post_init__`` fills ``lvg_cfg``, ``skydi_cfg`` and
``upscale_cfg`` with their configs' defaults; the port fills them alike
(``LVGConfig``, ``SkyDIConfig``, ``UpscaleConfig``).
"""

import dataclasses

import pytest
import torch

from zetaray_tpu.ops import restir_di as JD
from zetaray_tpu.ops import restir_gi as JG
from zetaray_tpu.ops import pathtracer as JPT
from zetaray_tpu.ops import prelighting as JPL
from zetaray_tpu.ops import restir_pt as JP
from zetaray_tpu.ops import sky as JSK
from zetaray_tpu.ops import skydi as JSD
from zetaray_tpu.ops import upscale as JUP
from zetaray_tpu.ops import volumetrics as JVL
from zetaray_tpu.render import frame as JF
from zetaray_tpu_torch.ops import restir_di as RD
from zetaray_tpu_torch.ops import restir_gi as RG
from zetaray_tpu_torch.ops import prelighting as PL
from zetaray_tpu_torch.ops import restir_pt as RP
from zetaray_tpu_torch.ops import skydi as SD
from zetaray_tpu_torch.ops import upscale as UP
from zetaray_tpu_torch.ops import volumetrics as VL
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render import frame as TF
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from zetaray_tpu_torch.scene.scene import upload_scene

torch.set_num_threads(1)

PAIRS = {
    "ReSTIRConfig": (JD.ReSTIRConfig, RD.ReSTIRConfig),
    "ReSTIRGIConfig": (JG.ReSTIRGIConfig, RG.ReSTIRGIConfig),
    "ReSTIRPTConfig": (JP.ReSTIRPTConfig, RP.ReSTIRPTConfig),
    "RenderConfig": (JF.RenderConfig, TF.RenderConfig),
    "PTConfig": (JPT.PTConfig, PTConfig),
    "SkyParams": (JSK.SkyParams, SkyParams),
    "LVGConfig": (JPL.LVGConfig, PL.LVGConfig),
    "SkyDIConfig": (JSD.SkyDIConfig, SD.SkyDIConfig),
    "VolumetricsConfig": (JVL.VolumetricsConfig, VL.VolumetricsConfig),
    "UpscaleConfig": (JUP.UpscaleConfig, UP.UpscaleConfig),
}
PORT_CLASSES = {port.__name__: port for _, port in PAIRS.values()}


def _declared_defaults(cls) -> dict:
    return {f.name: (f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)}


def _to_port(value):
    """A JAX config (nested ones too) as the port's config of the same name."""
    if dataclasses.is_dataclass(value) and type(value).__name__ in PORT_CLASSES:
        kw = {f.name: _to_port(getattr(value, f.name)) for f in dataclasses.fields(value)}
        return PORT_CLASSES[type(value).__name__](**kw)
    return value


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_jax_defaults_give_the_port_default(name):
    jax_cls, port_cls = PAIRS[name]
    assert [f.name for f in dataclasses.fields(port_cls)] == \
        [f.name for f in dataclasses.fields(jax_cls)]
    kw = {k: _to_port(v) for k, v in _declared_defaults(jax_cls).items()}
    assert port_cls(**kw) == port_cls()


def test_jax_sky_config_converts():
    """A JAX PTConfig with a sky (the app's --sun) becomes the port's, sky
    included, and the frame admits it in every mode."""
    jax_pt = JPT.PTConfig(max_bounces=4, sky=JSK.SkyParams(sun_dir=(0.2, 0.45, 0.87)),
                          sun_nee=False, path_regularization=True, firefly_clamp=3.0,
                          stochastic_multi_bounce=True)
    pt = _to_port(jax_pt)
    assert pt == PTConfig(max_bounces=4, sky=SkyParams(sun_dir=(0.2, 0.45, 0.87)), sun_nee=False,
                          path_regularization=True, firefly_clamp=3.0,
                          stochastic_multi_bounce=True)
    assert isinstance(pt.sky, SkyParams)
    for mode in ("restir_di", "restir_gi", "restir_pt"):
        TF.RenderConfig(mode=mode, pt=pt).check_ported()
    TF.RenderConfig(mode="pt", pt=pt).check_ported()


REUSE_OPTIONS = [
    (RD.ReSTIRConfig, {"full_target": True}),
    (RD.ReSTIRConfig, {"packed_reuse": False}),
    (RG.ReSTIRGIConfig, {"full_target": True}),
    (RG.ReSTIRGIConfig, {"packed_reuse": False}),
    (RP.ReSTIRPTConfig, {"full_target": True}),
    (RP.ReSTIRPTConfig, {"packed_reuse": False}),
]
KIND = {RD.ReSTIRConfig: "di", RG.ReSTIRGIConfig: "gi", RP.ReSTIRPTConfig: "pt"}


@pytest.mark.parametrize("cls,kw", REUSE_OPTIONS,
                         ids=[f"{c.__name__}-{'-'.join(k)}" for c, k in REUSE_OPTIONS])
def test_reuse_options_match_jax(cls, kw):
    """Each config takes ``full_target=True`` and ``packed_reuse=False``
    (the frame admits them in every mode), and its passes under the option
    agree with the JAX passes under it on the materials box
    (tests/test_torch_reuse_options.py ``check_option``: the shares of
    pixels stated there)."""
    from tests.test_torch_reuse_options import check_option

    cfg = cls(**kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items())
    field_name = {"di": "restir", "gi": "restir_gi", "pt": "restir_pt"}[KIND[cls]]
    for mode in ("restir_di", "restir_gi", "restir_pt"):
        TF.RenderConfig(mode=mode, **{field_name: cfg}).check_ported()
    check_option(KIND[cls], next(iter(kw)))


def test_jax_features_config_converts():
    """bench.py's features frame config, written with the JAX classes,
    becomes the port's (nested configs included) and the frame admits it:
    pairwise MIS, grid candidates, SkyDI, volumetrics and the GI grid NEE."""
    jax_cfg = JF.RenderConfig(
        width=256, height=256, mode="restir_gi",
        pt=JPT.PTConfig(max_bounces=2, sky=JSK.SkyParams(sun_dir=(0.3, 0.8, 0.2)),
                        stochastic_multi_bounce=True, path_regularization=True),
        restir=JD.ReSTIRConfig(lvg_samples=2, spatial_mis="pairwise", spatial_neighbors=5),
        restir_gi=JG.ReSTIRGIConfig(boiling_suppression=True, lvg=True),
        skydi=True, skydi_cfg=JSD.SkyDIConfig(spatial_mis="pairwise"),
        lvg_cfg=JPL.LVGConfig(dim=(16, 8, 20), slots=4),
        volumetrics=JVL.VolumetricsConfig(), denoise=True, taa=True,
    )
    kw = {f.name: _to_port(getattr(jax_cfg, f.name)) for f in dataclasses.fields(jax_cfg)}
    cfg = TF.RenderConfig(**kw)
    assert cfg.upscale_cfg == UP.UpscaleConfig()
    assert isinstance(cfg.lvg_cfg, PL.LVGConfig) and cfg.lvg_cfg.slots == 4
    assert isinstance(cfg.skydi_cfg, SD.SkyDIConfig) and cfg.skydi_cfg.spatial_mis == "pairwise"
    assert isinstance(cfg.volumetrics, VL.VolumetricsConfig)
    assert cfg.restir.spatial_neighbors == 5
    cfg.check_ported()


def test_jax_upscale_config_converts():
    """bench.py's upscale_256_to_512 config (bench.py:178-183), written with
    the JAX classes, becomes the port's and the frame admits it, with the
    render size the JAX frame computes."""
    jax_cfg = JF.RenderConfig(width=512, height=512, mode="restir_gi",
                              pt=JPT.PTConfig(max_bounces=2), render_scale=0.5, taa=True,
                              upscale_cfg=JUP.UpscaleConfig(rcas_sharpness=0.8))
    kw = {f.name: _to_port(getattr(jax_cfg, f.name)) for f in dataclasses.fields(jax_cfg)}
    cfg = TF.RenderConfig(**kw)
    assert isinstance(cfg.upscale_cfg, UP.UpscaleConfig)
    assert cfg.upscale_cfg.rcas_sharpness == 0.8
    cfg.check_ported()
    assert cfg.render_size() == (256, 256)
    for scale, size in ((0.67, (343, 343)), (0.001, (8, 8)), (1.0, (512, 512))):
        assert dataclasses.replace(cfg, render_scale=scale).render_size() == size


def test_accepted_fields_leave_the_frame_unchanged():
    """``num_candidates`` (never read, as in JAX), ``spatial_neighbors``
    (read by pairwise MIS only) and ``band_rows``/``band_halo`` (the port
    has no banded gathers) change nothing in a GI frame."""
    scene = upload_scene(cornell_box(), device="cpu")
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    base = dict(width=16, height=16, mode="restir_gi", pt=PTConfig(max_bounces=2),
                denoise=True, taa=True)
    outs = []
    for cfg in (TF.RenderConfig(**base),
                TF.RenderConfig(**base, restir=RD.ReSTIRConfig(num_candidates=4,
                                                               spatial_neighbors=7),
                                band_rows=0, band_halo=8, restir_gi=None, restir_pt=None)):
        state = None
        for k in range(2):
            out, state = TF.render_frame_restir(scene, cam.with_jitter(k), 0x1234 + k, cfg, state)
        outs.append(out)
    assert torch.isfinite(outs[0]["hdr"]).all() and outs[0]["hdr"].mean() > 0
    assert torch.equal(outs[0]["hdr"], outs[1]["hdr"])
    assert torch.equal(outs[0]["ldr"], outs[1]["ldr"])
