"""Shared set-up of the benchmark's own tests: ``rtbench/`` and the
checkout's root on the import path, and the cells cut to a size the CPU
runs in seconds (the box split 4 rounds: 8,706 triangles, still above the
port's dense limit, so every ray query takes the clustered path)."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

CELLS = ("gi139k.1080p.sway", "pt139k.4k_taau.sway", "gi139k.1080p.animated")


def tiny(cell: dict) -> dict:
    """``cell`` at 1/60 of its display size on the 8,706-triangle box."""
    cell = copy.deepcopy(cell)
    cell["config"]["scene"].update(split_rounds=4, triangles=8706)
    tr = cell["traffic"]
    tr.update(width=int(tr["width"]) // 60, height=int(tr["height"]) // 60)
    return cell


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
