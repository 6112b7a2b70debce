"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root names the cells and the metrics.
Everything that belongs to one cell, configuration, traffic mix, metric,
kernel bound, layer or scene generator sits in a file of its own under
``rtbench/``, named after it:

  workloads/<cell>.json      configuration, traffic, profiled frames, check limits
  configs/<config>.json      scene, renderer settings, camera
  traffic/<traffic>.json     resolution, camera sway, frames in flight, warm frames
  metrics/<metric>.py        ``read(run)``: the metric's value, or None
  bounds/<kernel>.py         ``counts(args, kwargs, result)``, ``work(counts)``
  layers/<layer>.json        the port functions and kernels of a layer
  scenes/<generator>.py      ``write(directory, params)``: a glTF file
"""

from __future__ import annotations

import importlib.util
import json
from functools import lru_cache
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """``BENCHMARK.json`` of the checkout."""
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return _json(path)


def _module(kind: str, name: str):
    """The module ``rtbench/<kind>/<name>.py``, loaded from its file (names
    may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(f"rtbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(None)
def metric(name: str):
    """The reader ``metrics/<name>.py``: ``read(run)`` -> value or None."""
    return _module("metrics", name)


@lru_cache(None)
def bound(kernel: str):
    """``bounds/<kernel>.py``: ``counts(args, kwargs, result)``, ``work(counts)``."""
    return _module("bounds", kernel)


@lru_cache(None)
def scene_generator(name: str):
    """``scenes/<name>.py``: ``write(directory, params)`` -> a glTF path."""
    return _module("scenes", name)


def layers() -> dict:
    """{layer file stem: its dict} of every ``layers/*.json``."""
    return {p.stem: _json(p) for p in sorted((BENCH_DIR / "layers").glob("*.json"))}


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name``: its workload file, with ``config`` and ``traffic``
    replaced by their files' contents and ``metrics`` the names of its
    end-to-end and per-layer metrics in ``BENCHMARK.json``."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json names no workload {name!r}")
    work = _json(BENCH_DIR / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if work[key] != entry[key]:
            raise ValueError(f"{name}: {key} {work[key]!r} in its workload file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    conf = _json(BENCH_DIR / "configs" / f"{work['config']}.json")
    traffic = _json(BENCH_DIR / "traffic" / f"{work['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(work, config=conf, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))
