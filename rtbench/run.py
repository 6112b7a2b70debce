"""The benchmark of ``zetaray_tpu_torch``: one run of one cell.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root, on a machine with the cell's CUDA cards. It
writes the cell's scene as a glTF file under ``TMPDIR``, loads and uploads
it through the port as a user's file is, renders the set-up's warm frames,
then renders frames for ``--seconds`` in a user's frame loop (two frames in
flight, nothing read back) and compares the port's frames with the frozen
plain reference (``rtb/check.py``). With ``--trace 1`` a few frames in the
middle of the window run under ``torch.profiler`` and the per-layer metrics
are read from that trace (its gzipped Chrome trace goes to
``rtbench/out/``). The last line of standard output is the result as one
JSON object; the last lines of standard error are the numbers compared,
each beside its limit. Without CUDA, or with fewer cards than the cell
asks for, it prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, and the checkout's root: the port
# build caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(HERE / "out" / "cache" / sub)

FORBIDDEN = {"jax", "jaxlib", "flax", "zetaray_tpu"}


def _card_lines() -> list:
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return [f"card: {line}" for line in out.strip().splitlines()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from rtb import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"rtbench: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from rtb import report

    res = report.run_cell(cell, args.seed, args.seconds, bool(args.trace), T0,
                          torch.device("cuda"))
    for line in _card_lines():
        print(line)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"rtbench: the process imported {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in res["info"]:
        print(line)
    for name, value, limit in res["rows"]:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(res["line"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
