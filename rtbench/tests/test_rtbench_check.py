"""The comparison fails where it must: a run with the look for a card
skipped (the CPU) and the timed path broken underneath comes out not
correct under each cell's own limits, and so does the control (the
reference with every pass rounded to bfloat16); a sound run comes out
correct."""

import time

import pytest
from conftest import CELLS, tiny
from rtb import check, faults, loop, report, spec
from rtb.port import Port
from rtb.traffic import Traffic

SEED = 2**32 + 12345


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, cpu):
    res = report.run_cell(tiny(spec.cell(name)), SEED, 0.5, False, time.perf_counter(), cpu)
    line = res["line"]
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) >= {"frame_ms", "setup_s"}
    assert list(line)[-1] == "compared"
    assert set(line["compared"]) == set(spec.cell(name)["check"]["limits"])


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_fails_the_check(fault, cpu):
    cell = tiny(spec.cell(CELLS[0]))
    res = report.run_cell(cell, SEED, 0.5, False, time.perf_counter(), cpu,
                          frame_hook=faults.FAULTS[fault])
    assert not res["line"]["correct"]
    assert res["line"]["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(tmp_path, name, cpu):
    cell = tiny(spec.cell(name))
    port = Port(loop.PORT)
    traffic = Traffic(cell["traffic"], cell["config"]["camera"], SEED)
    scene_cfg = cell["config"]["scene"]
    gltf = spec.scene_generator(scene_cfg["generator"]).write(tmp_path, scene_cfg)
    scene, cfg = loop.load_port_scene(cell, gltf, port, cpu)
    state, start = loop.warm_up(port, scene, cfg, traffic, port.frame, 3, cpu)
    win = loop.window(port, scene, cfg, traffic, port.frame, state, 0.0, cpu, max_frames=2,
                      keep=traffic.warm_frames)
    vals = loop.reference_checks(cell, gltf, traffic, cpu, start,
                                 {"sampled": win.kept, "last": win.last}, control=True)
    correct, rows = check.verdict(vals, cell["check"]["limits"])
    assert not correct
    # the control fails every number compared, each by more than ten times its limit
    assert all(v > 10 * lim for _, v, lim in rows), rows
