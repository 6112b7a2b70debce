"""The harness is driven by its files: in a temporary copy of the
benchmark, a configuration, a traffic mix, a cell and a metric added as new
files (and named in ``BENCHMARK.json``) run without an edit to any file
that was there. ``run.py`` refuses to run without a card."""

import json
import shutil
import subprocess
import sys

from conftest import BENCH

ROOT = BENCH.parent

NEW_METRIC = '''"""frames_done: the frames the window completed."""


def read(run):
    return float(run.frames)
'''

DRIVE = """
import sys, time, json
sys.path[:0] = ["rtbench", {root!r}]
import torch
from rtb import report, spec
res = report.run_cell(spec.cell("tiny.cell"), 99, 0.5, False, time.perf_counter(),
                      torch.device("cpu"))
print(json.dumps(res["line"]))
"""


def test_new_files_make_a_new_cell(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "rtbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (copy / "rtbench").rglob("*") if p.is_file()}
    b = copy / "rtbench"
    conf = json.loads((b / "configs" / "restir_gi.box139k.json").read_text())
    conf.update(name="tiny.config", scene=dict(conf["scene"], split_rounds=4, triangles=8706))
    (b / "configs" / "tiny.config.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic" / "1080p.sway.json").read_text())
    (b / "traffic" / "tiny.traffic.json").write_text(json.dumps(dict(traffic, width=24, height=16)))
    work = json.loads((b / "workloads" / "gi139k.1080p.sway.json").read_text())
    work.update(name="tiny.cell", config="tiny.config", traffic="tiny.traffic")
    (b / "workloads" / "tiny.cell.json").write_text(json.dumps(work))
    (b / "metrics" / "frames_done.py").write_text(NEW_METRIC)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny.config",
                               "traffic": "tiny.traffic", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["tiny.cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == v for p, v in before.items())  # no file was edited

    out = subprocess.run([sys.executable, "-c", DRIVE.format(root=str(ROOT))], cwd=copy,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["metrics"]["frames_done"]["value"] == line["attempted"]
    assert "frame_p95_ms" not in line["metrics"]  # named for another cell only


def test_run_refuses_without_a_card():
    code = ("import torch, runpy, sys; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['run.py', '--workload', 'gi139k.1080p.sway', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']; runpy.run_path('rtbench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr
