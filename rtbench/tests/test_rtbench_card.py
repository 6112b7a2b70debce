"""On the card: one short run of each cell through ``run.py`` prints a
correct result with every end-to-end metric the cell names. Run with
``python -m pytest rtbench/tests -m cuda`` on a machine with a card."""

import json
import subprocess
import sys

import pytest
from conftest import BENCH, CELLS
from rtb import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "rtbench/run.py", "--workload", name, "--seed",
                          str(2**31 + 11), "--seconds", "5", "--trace", "0"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    names = {m["name"] for m in spec.cell(name)["end_to_end"]}
    assert set(line["metrics"]) == names - ({"frame_p95_ms"} if line["attempted"] < 20 else set())
