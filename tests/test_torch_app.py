"""The port's app (``python -m zetaray_tpu_torch.app``) on the CPU.

``app.main([..., "--device", "cpu"])`` on the animated box's glTF writes
PNGs bit-equal to a direct chain of ``render_frame_restir`` (or
``render_frame`` for ``--mode pt``) with the same frame seeds
(``app.frame_seed``), the same refit and motion (``--animate``) and the
same outline (``--outline``); ``--validate`` passes on those frames;
``--dump-graph`` prints the JAX app's DOT text; without CUDA and without
``--device cpu`` the app raises.
"""

import numpy as np
import pytest
import torch

from zetaray_tpu.ops.pathtracer import PTConfig as JPTConfig
from zetaray_tpu.ops.sky import SkyParams as JSkyParams
from zetaray_tpu.render.frame import RenderConfig as JRenderConfig
from zetaray_tpu.render.graph import frame_dag as jax_frame_dag
from zetaray_tpu_torch import app
from zetaray_tpu_torch.ops import post
from zetaray_tpu_torch.ops.gbuffer_pack import TG
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.render.frame import RenderConfig, render_frame, render_frame_restir
from zetaray_tpu_torch.scene.animation import AnimationRig, transform_deltas
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.gltf import load_gltf
from zetaray_tpu_torch.scene.procedural import animated_box
from zetaray_tpu_torch.scene.refit import refit_scene
from zetaray_tpu_torch.scene.scene import load_scene, upload_scene
from zetaray_tpu_torch.utils import log
from zetaray_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

SIZE = 16
SUN = (0.2, 0.45, 0.87)


@pytest.fixture(scope="module")
def gltf(tmp_path_factory):
    return animated_box(tmp_path_factory.mktemp("app") / "box.gltf")


def _direct(path, cfg, frames, animate=0.0, outline=None):
    """The frames the app should write, from the frame functions."""
    doc = load_gltf(path)
    cpu = load_scene(doc)
    scene = upload_scene(cpu, "cpu")
    rig = AnimationRig(doc) if animate else None
    cam0 = Camera.look_at((0.0, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0, aspect=1.0)
    state, ldrs = None, []
    for i in range(frames):
        frame_scene, motion = scene, None
        if rig is not None:
            t = i / animate
            frame_scene = refit_scene(scene, *rig.deltas(t))
            motion, _ = transform_deltas(rig.instance_worlds(t),
                                         rig.instance_worlds(max(t - 1.0 / animate, 0.0)))
        if cfg.mode == "pt":
            out = render_frame(frame_scene, cam0.with_jitter(i), app.frame_seed(i), cfg)
        else:
            out, state = render_frame_restir(frame_scene, cam0.with_jitter(i), app.frame_seed(i),
                                             cfg, state, None, motion=motion)
        ldr = out["ldr"]
        if outline is not None:
            pid = [n for n in cpu.inst_names].index(outline)
            inst = state.gbuf[TG.INST].reshape(SIZE, SIZE)
            ldr = (post.picked_outline_p(ldr.float().permute(2, 0, 1) / 255.0, inst, pid)
                   * 255.0).permute(1, 2, 0).to(torch.uint8)
            assert not torch.equal(ldr, out["ldr"])  # the outline shows
        ldrs.append(ldr.numpy())
    return ldrs


def _written(out_dir, frames):
    return [read_png(str(out_dir / f"frame_{i:04d}.png")) for i in range(frames)]


def test_restir_di_animated_validated_outlined(gltf, tmp_path, capsys):
    out_dir = tmp_path / "di"
    log.set_mirror(False)
    try:
        app.main([str(gltf), "--frames", "3", "--size", f"{SIZE}x{SIZE}", "--animate", "4",
                  "--validate", "--outline", "tall", "--sun", ",".join(map(str, SUN)),
                  "--dump-graph", "--out", str(out_dir), "--device", "cpu"])
    finally:
        log.set_mirror(True)
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="restir_di",
                       pt=PTConfig(max_bounces=4, sky=SkyParams(sun_dir=SUN)))
    want = _direct(gltf, cfg, 3, animate=4.0, outline="tall_block")
    got = _written(out_dir, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[2])  # the block moved
    printed = capsys.readouterr().out
    jcfg = JRenderConfig(width=SIZE, height=SIZE, mode="restir_di",
                         pt=JPTConfig(max_bounces=4, sky=JSkyParams(sun_dir=SUN)))
    assert jax_frame_dag(jcfg) in printed
    assert "frame/mean_radiance" in printed  # the stats report


@pytest.mark.parametrize("mode, extra", [("pt", []), ("restir_gi", ["--denoise", "--bounces", "2"])])
def test_other_modes(gltf, tmp_path, mode, extra):
    out_dir = tmp_path / mode
    log.set_mirror(False)
    try:
        app.main([str(gltf), "--frames", "2", "--size", f"{SIZE}x{SIZE}", "--mode", mode,
                  "--out", str(out_dir), "--device", "cpu", *extra])
    finally:
        log.set_mirror(True)
    cfg = RenderConfig(width=SIZE, height=SIZE, mode=mode,
                       pt=PTConfig(max_bounces=2 if extra else 4), denoise=bool(extra))
    for g, w in zip(_written(out_dir, 2), _direct(gltf, cfg, 2)):
        np.testing.assert_array_equal(g, w)


def test_frame_seeds_are_u32():
    assert app.frame_seed(0) == app.FRAME_SEED0
    assert app.frame_seed(3) == app.FRAME_SEED0 + 3
    assert 0 <= app.frame_seed(2**32) < 2**32


def test_app_needs_cuda_or_cpu(gltf, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main([str(gltf), "--frames", "1", "--size", "8x8", "--out", str(tmp_path)])


def test_warmup_renders_each_variant_on_cpu(capsys):
    """``python -m zetaray_tpu_torch.warmup --device cpu``: the BCn library
    and one frame pair of every variant (no CUDA library on the CPU)."""
    from zetaray_tpu_torch import warmup

    seconds = warmup.main(["--size", "8", "--device", "cpu"])
    assert "CUDA library" not in seconds and "BCn library" in seconds
    assert len(seconds) == 1 + len(warmup.variants(8)) == 10
    assert "warmup complete" in capsys.readouterr().out
