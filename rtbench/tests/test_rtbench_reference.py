"""The frozen plain reference: its fast B8/B9 answers equal the dense plain
versions bit for bit (ties, far and parked origins, rays that are not
finite), and its frames equal the port's CPU frames at a tiny size."""

import pytest
import torch
from conftest import CELLS, tiny
from reference.portref.accel import stream as ST
from reference.portref.accel import stream_fast as SF
from reference.portref.scene.camera import Camera
from reference.portref.scene.scene import upload_scene
from rtb import loop, spec
from rtb.port import Port
from rtb.traffic import Traffic

from zetaray_tpu_torch.scene.procedural import cornell_box, repeated_box
from zetaray_tpu_torch.scene.subdivide import subdivide_scene


def _rays(scene_cpu, n_side=48, seed=3):
    """Camera rays, GI-like rays from their hits (some with zero direction
    components), the same from far and parked origins, and rays whose
    origin or direction is not finite."""
    cam = Camera.look_at((0, 1, 3.5), (0, 1, 0), vfov_deg=45, aspect=1.0)
    o, d = cam.generate_rays(n_side, n_side, device="cpu")
    g = torch.Generator().manual_seed(seed)
    t, _ = ST.stream_closest_plain(scene_cpu, o, d)
    og = o + (t.clamp_max(1e3) - 1e-3)[:, None] * d
    dg = torch.randn(o.shape, generator=g)
    dg = dg / dg.norm(dim=1, keepdim=True)
    dg[::7, 0] = 0.0
    dg[::11, 1] = 0.0
    far = og.clone()
    far[::5] = 3e7
    far[1::5] = -2e38
    bad_o, bad_d = og.clone(), dg.clone()
    bad_o[::3, 0] = float("inf")
    bad_o[1::3, 1] = float("nan")
    bad_d[2::3, 2] = float("-inf")
    return {"camera": (o, d), "gi": (og, dg), "far": (far, dg), "not_finite": (bad_o, bad_d),
            "missed": (o + t[:, None] * d, dg)}


@pytest.mark.parametrize("make", [lambda: subdivide_scene(cornell_box(), 2000),
                                  lambda: repeated_box(4, 600)], ids=["split", "ties"])
def test_fast_ray_queries_equal_the_dense_plain_versions(make):
    scene = upload_scene(make(), device="cpu", cluster_size=128)
    assert scene.cluster_aabb is not None and scene.cluster_aabb.shape[0] > SF.RANKS
    for name, (o, d) in _rays(scene).items():
        t0, tri0 = ST.stream_closest_plain(scene, o, d)
        t1, tri1 = SF.closest(scene, o, d)
        assert torch.equal(tri0, tri1) and torch.equal(t0, t1), name
        for t_min, t_max in ((1e-4, 3e38), (1e-3, 0.999)):
            seg = d * 2.0
            assert torch.equal(ST.occlusion_stream_plain(scene, o, seg, t_min, t_max),
                               SF.any_hit(scene, o, seg, t_min, t_max)), name


@pytest.mark.parametrize("name", CELLS)
def test_reference_frames_equal_the_ports_cpu_frames(tmp_path, name, cpu):
    cell = tiny(spec.cell(name))
    scene_cfg = cell["config"]["scene"]
    gltf = spec.scene_generator(scene_cfg["generator"]).write(tmp_path, scene_cfg)
    traffic = Traffic(cell["traffic"], cell["config"]["camera"], 2**33 + 7)
    port, ref = Port(loop.PORT), Port(loop.REFERENCE)
    (ps, pcfg), (rs, rcfg) = (loop.load_port_scene(cell, gltf, p, cpu) for p in (port, ref))
    assert ps.cluster_aabb is not None and rs.cluster_aabb is not None
    p_state = r_state = None
    for k in range(3):
        p_out, p_state = port.frame(ps, traffic, k, pcfg, p_state)
        r_out, r_state = ref.frame(rs, traffic, k, rcfg, r_state)
        for key in ("hdr", "ldr"):
            assert torch.equal(p_out[key], r_out[key]), (k, key)
        assert torch.equal(p_state.reservoirs, r_state.reservoirs)
        assert torch.equal(p_state.gi_reservoirs, r_state.gi_reservoirs)
    # the reference continues from the port's state as from its own
    p_out, _ = port.frame(ps, traffic, 3, pcfg, p_state)
    r_out, _ = ref.frame(rs, traffic, 3, rcfg, ref.state_from(p_state))
    assert torch.equal(p_out["hdr"], r_out["hdr"])
