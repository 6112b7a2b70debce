"""Picking (``render.picking.pick``) of the port against the JAX package.

On a dense scene (the animated box's glTF, two instances, loaded by both
packages) the port's pick equals JAX's ``pick``: triangle, instance, its
name and material exactly, t to 1e-5 (relative), the position to 1e-5.

On a clustered scene and on a scene with alpha cutout the JAX ``pick`` is
not the reference: it runs the raw dense ``intersect_closest``, which
ignores the alpha test, and reads instance and material from the host
scene's triangle order, which a clustered upload has reordered (a slot past
the host's triangle count raises there). The port's pick runs
``intersect_closest_shaded`` (B8 and the re-trace on the card) and reads
the upload's tables, so it is held to JAX's ``intersect_closest_shaded``
and the JAX upload's tables at the hit's slot; the JAX pick's faults are
shown beside it.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_restir_di import cam_dict
from tests.test_torch_scene import to_jax_cpu_scene
from zetaray_tpu.accel.intersect import intersect_closest_shaded as jax_closest_shaded
from zetaray_tpu.render.picking import pick as jax_pick
from zetaray_tpu.scene import scene as JS
from zetaray_tpu.scene.camera import Camera as JaxCamera
from zetaray_tpu_torch.interop import camera_from_arrays
from zetaray_tpu_torch.render.picking import PickResult, pick
from zetaray_tpu_torch.scene import scene as TS
from zetaray_tpu_torch.scene.procedural import (
    PANEL, PANEL_Z, animated_box, cornell_box, cutout_box,
)
from zetaray_tpu_torch.scene.subdivide import subdivide_scene

torch.set_num_threads(1)


def _same_pick(got: PickResult, want):
    assert (got.hit, got.tri, got.instance, got.instance_name, got.material) == (
        want.hit, want.tri, want.instance, want.instance_name, want.material)
    if got.hit:
        np.testing.assert_allclose(got.t, want.t, rtol=1e-5)
        np.testing.assert_allclose(got.position, want.position, atol=1e-5)
    else:
        assert got.t == want.t == float("inf") and got.position == want.position == ()


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    path = animated_box(tmp_path_factory.mktemp("pick") / "box.gltf")
    jcpu = JS.load_scene(str(path))
    tcpu = TS.load_scene(path)
    return JS.upload_scene(jcpu), jcpu, TS.upload_scene(tcpu, device="cpu"), tcpu


CAMERAS = {
    # the box from the front: centre pixel and a corner of the image
    "front": (((0.0, 1.0, 3.5), (0.0, 1.0, 0.0)), {}, 64, [(32, 32), (5, 40), (60, 3)]),
    # straight up under the light
    "light": (((-0.004, 1.2, -0.04), (-0.004, 3.0, -0.04)), dict(up=(0, 0, 1), vfov_deg=30),
              9, [(4, 4)]),
    # away from the scene: a miss
    "away": (((0.0, 1.0, 60.0), (0.0, 1.0, 120.0)), {}, 8, [(0, 0), (4, 4)]),
}


@pytest.mark.parametrize("view", CAMERAS)
def test_dense_pick_matches_jax(dense, view):
    js, jcpu, ts, tcpu = dense
    (eye, target), kw, size, pixels = CAMERAS[view]
    cam = JaxCamera.look_at(eye, target, **{"vfov_deg": 45, **kw}, aspect=1.0)
    for px, py in pixels:
        want = jax_pick(js, jcpu, cam, px, py, size, size)
        got = pick(ts, tcpu, camera_from_arrays(cam_dict(cam)), px, py, size, size)
        _same_pick(got, want)
    if view == "light":
        assert got.hit and got.tri in tcpu.emissive_tris.tolist()
        assert got.instance_name == "room"
    if view == "away":
        assert not got.hit and got.tri == -1


def _against_shaded(js, ts, tcpu, cam, pixels, size):
    """The port's picks against JAX's intersect_closest_shaded on the same
    camera rays; returns the port's picks."""
    o, d = (np.asarray(x) for x in cam.generate_rays(size, size))
    idx = np.asarray([py * size + px for px, py in pixels])
    sh = jax_closest_shaded(js, o[idx], d[idx])
    tri, t = np.asarray(sh.tri), np.asarray(sh.t)
    picks = [pick(ts, tcpu, camera_from_arrays(cam_dict(cam)), px, py, size, size)
             for px, py in pixels]
    for k, got in enumerate(picks):
        assert got.tri == int(tri[k])
        assert got.hit and got.tri >= 0
        assert got.instance == int(np.asarray(js.inst_id)[got.tri])
        assert got.material == int(np.asarray(js.mat_id)[got.tri])
        np.testing.assert_allclose(got.t, t[k], rtol=1e-5)
    return picks


def test_clustered_pick(tmp_path):
    cpu = subdivide_scene(cornell_box(), 500)
    assert cpu.num_tris == 546
    jcpu = to_jax_cpu_scene(cpu)
    js = JS.upload_scene(jcpu, cluster_size=128)
    ts = TS.upload_scene(cpu, device="cpu", cluster_size=128)
    assert ts.cluster_aabb is not None
    cam = JaxCamera.look_at((0.0, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45, aspect=1.0)
    pixels = [(8, 8), (16, 16), (3, 10), (28, 20), (16, 30), (16, 2)]
    picks = _against_shaded(js, ts, cpu, cam, pixels, 32)
    # the left wall is red (material 1), the right wall green (2)
    assert picks[2].material == 1 and picks[3].material == 2
    # the JAX pick reads the host scene's triangle order: a wrong material
    # where the upload reordered the slot, an IndexError past its count
    assert jax_pick(js, jcpu, cam, 3, 10, 32, 32).material != picks[2].material
    assert picks[4].tri >= cpu.num_tris
    with pytest.raises(IndexError):
        jax_pick(js, jcpu, cam, 16, 30, 32, 32)


def test_cutout_pick(tmp_path):
    cpu = cutout_box(tmp_path)
    jcpu = to_jax_cpu_scene(cpu)
    js = JS.upload_scene(jcpu)
    ts = TS.upload_scene(cpu, device="cpu")
    assert ts.has_cutout
    cam = JaxCamera.look_at((0.0, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45, aspect=1.0)
    # along a row above the tall block: the panel's transparent half (x <
    # 0), its opaque half, and the walls past it
    pixels = [(px, 11) for px in (2, 9, 12, 15, 17, 20, 23, 29)]
    picks = _against_shaded(js, ts, cpu, cam, pixels, 32)
    on_panel = [p.material == PANEL for p in picks]
    assert any(on_panel) and not all(on_panel)
    pierced = 0
    for (px, py), got in zip(pixels, picks):
        want = jax_pick(js, jcpu, cam, px, py, 32, 32)
        if got.material == PANEL or want.material != PANEL:
            _same_pick(got, want)  # no transparent texel on the way
        else:
            # the JAX pick stops at the panel's transparent half; the port
            # sees on past it to the back wall
            assert want.position[2] == pytest.approx(PANEL_Z, abs=1e-4)
            assert got.t > want.t and got.position[0] < 0.0
            pierced += 1
    assert pierced == 3
