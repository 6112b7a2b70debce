"""The many-light hall of ``rtbench/scenes/lamp_hall.py`` and the
configuration ``restir_di.lamps262k`` on the CPU: the generator, the light
voxel grid's view of the hall, the port against the benchmark's frozen
plain copy (``reference.portref``) on the configuration's frame, and the
loader's threads.

The port's plain B8/B9 (the dense sweep over every slot) cost about 25 ms
a ray on the CPU at 18,304 triangles, so the frames here are 16 x 9.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "rtbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))  # the harness (``rtb``) and its reference

from rtb import check, loop, spec  # noqa: E402
from rtb.port import Port  # noqa: E402
from rtb.traffic import Traffic  # noqa: E402

from zetaray_tpu_torch.ops import prelighting as PL  # noqa: E402
from zetaray_tpu_torch.scene.camera import Camera  # noqa: E402
from zetaray_tpu_torch.scene.light_build import emissive_powers  # noqa: E402
from zetaray_tpu_torch.scene.scene import load_scene, upload_scene  # noqa: E402

torch.set_num_threads(1)

CELL = "di262k.1080p.sway"
CPU = torch.device("cpu")
FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_id", "inst_id",
          "emissive_tris")


def _gen():
    return spec.scene_generator("lamp_hall")


def _triangles(rounds: int) -> int:
    gen = _gen()
    return gen.BASE_TRIANGLES * 4**rounds + 8 * gen.LAMPS


@pytest.mark.parametrize("rounds", [5, 3])
def test_hall_counts_and_lamps(rounds):
    """254 x 4^rounds split triangles, then 256 whole lamps of 8 outward
    triangles each, a material a lamp; the configuration states the count."""
    gen = _gen()
    tris = gen.triangles(rounds)
    mat = tris["mat"]
    n_lamp = 8 * gen.LAMPS
    assert mat.shape[0] == _triangles(rounds)
    assert n_lamp == 2048 and (mat[-n_lamp:] >= len(gen.BASE)).all()
    assert (mat[:-n_lamp] < len(gen.BASE)).all()
    assert np.array_equal(mat[-n_lamp:], np.repeat(np.arange(gen.LAMPS) + len(gen.BASE), 8))
    centres, _, _ = gen.lamp_layout()
    p = np.stack([tris["p0"], tris["p1"], tris["p2"]], 1)[-n_lamp:].astype(np.float64)
    c = np.repeat(centres, 8, axis=0)
    # whole: every corner of a lamp lies on its octahedron's axes at the radius
    np.testing.assert_allclose(np.abs(p - c[:, None]).sum(-1), gen.LAMP_RADIUS, rtol=1e-5)
    ng = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    assert (np.einsum("ij,ij->i", ng, p.mean(1) - c) > 0).all()  # wound outward
    if rounds == 5:
        conf = spec.cell(CELL)["config"]["scene"]
        assert conf["triangles"] == 262_144 == mat.shape[0] and conf["split_rounds"] == 5


def test_lamp_powers_span_thirty_times():
    gen = _gen()
    centres, tint, strength = gen.lamp_layout()
    assert centres.shape == (256, 3) and set(tint) == {0, 1, 2}
    assert strength.min() == pytest.approx(5.0) and strength.max() == pytest.approx(150.0)
    assert len(np.unique(np.round(np.log(strength), 9))) == 256  # log-uniform, stratified
    x0, x1, y1, z0, z1 = gen.HALL
    r = gen.LAMP_RADIUS
    assert ((centres[:, 0] - r > x0) & (centres[:, 0] + r < x1) & (centres[:, 1] - r > 0)
            & (centres[:, 1] + r < y1) & (centres[:, 2] - r > z0) & (centres[:, 2] + r < z1)).all()


@pytest.mark.parametrize("rounds", [3, 1])
def test_file_is_the_same_on_two_writes_and_loads(tmp_path, rounds):
    gen = _gen()
    a = gen.write(tmp_path / "a", {"split_rounds": rounds})
    b = gen.write(tmp_path / "b", {"split_rounds": rounds})
    assert a.read_bytes() == b.read_bytes()
    assert (a.parent / "scene.bin").read_bytes() == (b.parent / "scene.bin").read_bytes()
    cpu = load_scene(str(a))
    n = _triangles(rounds)
    assert cpu.num_tris == n
    assert np.array_equal(cpu.emissive_tris, np.arange(n - 2048, n))
    tris = gen.triangles(rounds)
    # the file holds a primitive a material, in material order
    order = np.argsort(tris["mat"], kind="stable")
    for ours, theirs in (("p0", "v0"), ("p1", "v1"), ("p2", "v2"), ("mat", "mat_id")):
        assert np.array_equal(tris[ours][order], getattr(cpu, theirs)), ours
    power = emissive_powers(cpu)
    assert power.max() / power.min() > 20.0  # strengths 30x, tints within 1.3x


@pytest.mark.parametrize("seed,frame", [(0x5EED, 0), (2**32 + 777, 12)])
def test_grid_covers_the_hall(tmp_path, seed, frame):
    """At the configuration's camera (swayed to ``frame``), with the whole
    lamp layout, more than half of the default grid's voxels whose centre
    lies inside the hall hold a nonzero reservoir."""
    gen = _gen()
    cell = spec.cell(CELL)
    traffic = Traffic(cell["traffic"], cell["config"]["camera"], seed)
    cam = Camera.look_at(traffic.eye(frame), tuple(traffic.target), vfov_deg=traffic.vfov,
                         aspect=traffic.aspect)
    scene = upload_scene(load_scene(str(gen.write(tmp_path, {"split_rounds": 0}))), device="cpu")
    cfg = PL.LVGConfig()
    grid = PL.build_light_voxel_grid(scene, cam, seed, cfg)
    centres, _ = PL._voxel_centers(cam, cfg, CPU)
    x0, x1, y1, z0, z1 = gen.HALL
    inside = ((centres[:, 0] > x0) & (centres[:, 0] < x1) & (centres[:, 1] > 0)
              & (centres[:, 1] < y1) & (centres[:, 2] > z0) & (centres[:, 2] < z1))
    lit = (grid[:, 9] > 0).reshape(-1, cfg.slots).any(1)
    assert inside.sum() > 1000
    assert lit[inside].float().mean() > 0.5


@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    """The cell on the hall split 3 rounds (18,304 triangles: clustered, so
    every ray query takes B8/B9's plain path and the path trace the
    wavefront) at 16 x 9, with the configuration's render settings; the
    glTF file and the port's and the reference's loads of it."""
    cell = copy.deepcopy(spec.cell(CELL))
    cell["config"]["scene"].update(split_rounds=3, triangles=_triangles(3))
    cell["traffic"].update(width=16, height=9)
    gltf = _gen().write(tmp_path_factory.mktemp("hall"), cell["config"]["scene"])
    port, ref = Port(loop.PORT), loop.reference_port()
    return dict(cell=cell, port=port, ref=ref,
                port_scene=loop.load_port_scene(cell, gltf, port, CPU),
                ref_scene=loop.load_port_scene(cell, gltf, ref, CPU),
                traffic=Traffic(cell["traffic"], cell["config"]["camera"], 2**32 + 4321))


def test_config_renders_restir_di_with_the_grid(small_cell):
    scene, cfg = small_cell["port_scene"]
    assert scene.cluster_aabb is not None and scene.num_emissives == 2048
    assert cfg.mode == "restir_di" and cfg.pt.max_bounces == 4 and cfg.denoise and cfg.taa
    assert cfg.restir.lvg_samples == 2 and cfg.restir.spatial_mis == "pairwise"
    assert cfg.lvg_cfg == PL.LVGConfig() and cfg.pt.sky is None


@pytest.fixture(scope="module")
def chains(small_cell):
    """The port's frames 0..3 (3 chained from nothing, the 4th from the
    carried state) and the reference's: frames 0..2 chained from nothing,
    frame 3 from the port's state after frame 2."""
    port, ref, traffic = small_cell["port"], small_cell["ref"], small_cell["traffic"]
    (ps, cfg), (rs, rcfg) = small_cell["port_scene"], small_cell["ref_scene"]
    port_frames, ref_frames, p_state, r_state = [], [], None, None
    for k in range(4):
        out, p_new = port.frame(ps, traffic, k, cfg, p_state)
        r_in = r_state if k < 3 else ref.state_from(p_state)
        r_out, r_state = ref.frame(rs, traffic, k, rcfg, r_in)
        port_frames.append((p_state, out, p_new))
        ref_frames.append((r_out, r_state))
        p_state = p_new
    return port_frames, ref_frames


@pytest.mark.parametrize("k", range(4))
def test_port_matches_reference_exactly(chains, k):
    """Every number of the benchmark's check is 0.0 at every frame."""
    port_frames, ref_frames = chains
    _, out, state = port_frames[k]
    nums = check.numbers(out, state, *ref_frames[k])
    assert nums == {name: 0.0 for name in nums}, nums
    assert float(out["hdr"].abs().sum()) > 0.0  # the lamps light the hall


def test_bfloat16_inputs_fail_the_check(small_cell, chains):
    """The 4th frame rendered from the carried state rounded to bfloat16
    reads above at least one of the cell's limits."""
    port, traffic = small_cell["port"], small_cell["traffic"]
    ps, cfg = small_cell["port_scene"]
    port_frames, ref_frames = chains
    out, state = port.frame(ps, traffic, 3, cfg, check.round_bf16(port_frames[3][0]))
    vals = {f"last.{n}": v for n, v in check.numbers(out, state, *ref_frames[3]).items()}
    limits = {n: v for n, v in small_cell["cell"]["check"]["limits"].items()
              if n.startswith("last.")}
    correct, rows = check.verdict(vals, limits)
    assert not correct, rows


@pytest.mark.parametrize("scene", ["hall", "box"])
def test_threaded_loads_equal_one_thread(tmp_path, scene):
    """``load_scene`` on 4 threads gives, 20 times, the arrays of a load on
    one (numpy's OpenBLAS returned other products now and then when the
    workers' matrix products overlapped)."""
    if scene == "hall":
        path = _gen().write(tmp_path, {"split_rounds": 3})
    else:
        path = spec.scene_generator("cornell_split").write(
            tmp_path, {"variant": "box", "split_rounds": 6})
    one = load_scene(str(path), workers=1)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # the workers trade the interpreter more often
    try:
        for _ in range(20):
            four = load_scene(str(path), workers=4)
            for f in FIELDS:
                assert np.array_equal(getattr(four, f), getattr(one, f)), f
    finally:
        sys.setswitchinterval(switch)
