"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the port: by the sources
(every import statement) and by ``sys.modules`` after a dry run on the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "zetaray_tpu", "bench", "chip_smoke"}


def _imports(path: Path):
    """(top-level name, full name) of every absolute import in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    for top, full in _imports(path):
        assert top not in FORBIDDEN, (path, full)
        assert full != "zetaray_tpu_torch.profile", (path, full)
        if "reference" in path.relative_to(BENCH).parts:
            assert top != "zetaray_tpu_torch", (path, full)


DRY_RUN = """
import sys, json, copy, tempfile
sys.path[:0] = [{bench!r}, {root!r}]
import torch
from rtb import loop, spec
from rtb.port import Port
from rtb.traffic import Traffic
cell = copy.deepcopy(spec.cell("gi139k.1080p.sway"))
cell["config"]["scene"].update(split_rounds=4, triangles=8706)
cell["traffic"].update(width=16, height=8)
with tempfile.TemporaryDirectory() as tmp:
    sc = cell["config"]["scene"]
    gltf = spec.scene_generator(sc["generator"]).write(tmp, sc)
    tr = Traffic(cell["traffic"], cell["config"]["camera"], 1)
    for pkg in {packages!r}:
        p = Port(pkg)
        scene, cfg = loop.load_port_scene(cell, gltf, p, torch.device("cpu"))
        p.frame(scene, tr, 0, cfg, None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("packages", [["zetaray_tpu_torch", "reference.portref"],
                                      ["reference.portref"]], ids=["port", "reference"])
def test_dry_run_loads_no_jax(packages):
    code = DRY_RUN.format(bench=str(BENCH), root=str(BENCH.parent), packages=packages)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    if packages == ["reference.portref"]:
        assert "zetaray_tpu_torch" not in loaded
