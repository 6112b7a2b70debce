"""The animated cell's path through the harness's frame (``Port.frame``):
the clip moves the tall block and nothing else, the frame gets its motion,
and a static cell takes the calls it took before the animated path."""

import numpy as np
import pytest
import torch
from conftest import CELLS, tiny
from rtb import loop, spec
from rtb.port import Animated, Port
from rtb.traffic import Traffic

ANIMATED = "gi139k.1080p.animated"


def _load(tmp_path, name, package, cpu):
    cell = tiny(spec.cell(name))
    scene_cfg = cell["config"]["scene"]
    gltf = spec.scene_generator(scene_cfg["generator"]).write(tmp_path, scene_cfg)
    port = Port(package)
    scene, cfg = loop.load_port_scene(cell, gltf, port, cpu)
    return cell, port, scene, cfg


@pytest.mark.parametrize("package", [loop.PORT, loop.REFERENCE])
def test_the_clip_moves_the_tall_block_only(tmp_path, package, cpu):
    cell, port, scene, _ = _load(tmp_path, ANIMATED, package, cpu)
    assert isinstance(scene, Animated) and scene.loop and scene.dt == pytest.approx(1 / 60)
    k = 60  # t = 1 s: the middle key
    posed, motion = port.pose(scene, k)
    inst = scene.rest.inst_id
    block = inst == 1
    assert int(block.sum()) == 12 * 4**4
    moved = (posed.v0 != scene.rest.v0).any(1)
    assert torch.equal(moved, block)
    assert torch.equal(posed.v0[inst == 0], scene.rest.v0[inst == 0])
    eye = np.eye(3, 4, dtype=np.float32)
    assert np.array_equal(motion[0], eye) and np.array_equal(motion[2], eye)
    assert np.abs(motion[1] - eye).max() > 1e-3
    # looped: a clip's length on, the same pose
    again, _ = port.pose(scene, k + 120)
    assert torch.allclose(again.v0, posed.v0, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_refit_and_motion_only_in_the_animated_cell(tmp_path, name, cpu, monkeypatch):
    """A static cell's frame never refits and passes no motion; the animated
    cell's refits once a frame and passes each frame's motion."""
    cell, port, scene, cfg = _load(tmp_path, name, loop.PORT, cpu)
    refit, frames = port.module("scene.refit"), []

    def refit_scene(*a, _fn=refit.refit_scene):
        frames.append("refit")
        return _fn(*a)

    def render(*a, _fn=port.F.render_frame_restir, **kw):
        frames.append(sorted(kw))
        return _fn(*a, **kw)

    monkeypatch.setattr(refit, "refit_scene", refit_scene)
    monkeypatch.setattr(port.F, "render_frame_restir", render)
    traffic = Traffic(cell["traffic"], cell["config"]["camera"], 5)
    port.frame(scene, traffic, 0, cfg, None)
    expect = [[]] if cell["config"].get("animation") is None else ["refit", ["motion"]]
    assert frames == expect
