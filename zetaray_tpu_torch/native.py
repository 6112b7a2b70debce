"""Build and load the hand-written CUDA kernels in ``csrc/``.

The kernels are compiled with ``nvcc`` for Hopper (``sm_90a``), one process
per source started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use,
keyed by a hash of the sources and the flags, into ``_build/`` inside the
package (listed in ``.gitignore``), so a fresh checkout builds everything
the first time a CUDA tensor reaches a kernel.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code
into an exception.

The row and column layouts the kernels index (``A``, ``G``, ``LSET_ROWS``,
``R_ROWS``, ``STATE_ROWS``, ``SURF_ROWS``), the bounce kernels' block size
and pcg4d salt, the tree walks' stack limit and box padding, and the GGX
albedo fit of ``ops.shading_soa`` are defined once, in Python:
:func:`layout_header`
writes them as C constants into the ``layout.h`` that the sources include.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No fast math: the Woop edge tests sit on triangle edges. No FMA
# contraction: each operation rounds on its own, as in the plain versions.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-Xcompiler", "-fPIC",
]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # o, d, woop_rows, attrs, out, n, tp, nt, t_min, stream
    "zr_gbuffer": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP],
    # o, d, woop_rows, out, n, tp, nt, t_min, t_max, stream
    "zr_occlusion": [_VP, _VP, _VP, _VP, _I, _I, _I, _F, _F, _VP],
    # gb, sets, out, n, n_sets, ps, rt, block, seed, stream
    "zr_ris": [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_uint32, _VP],
    # state, woop_rows, attrs, state_out, surf_out, n, tp, nt, bounce, t_min, spread,
    # min_emissive_bounce, nee, has_lights, stream
    "zr_bounce_trace": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _I, _I, _I, _VP],
    # state, surf, woop_rows, sets, state_out, n, tp, nt, n_sets, ps, rt, bounce, seed,
    # min_nee_bounce, rr_start, nee, has_lights, stream
    "zr_bounce_shade": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, ctypes.c_uint32,
                        _I, _I, _I, _I, _VP],
    # state, woop_rows, attrs, sets, state_out, n, tp, nt, n_sets, ps, rt, bounce, seed,
    # t_min, min_emissive_bounce, min_nee_bounce, rr_start, nee, has_lights, last, stream
    "zr_bounce": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, ctypes.c_uint32, _F,
                  _I, _I, _I, _I, _I, _I, _VP],
    # o, d, woop_rows, attrs, t, tri, u, v, attrs_out, n, tp, nt, tie, t_min, t_max, stream
    "zr_closest": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _VP],
    # o, d, walk_nodes, leaf_rows, leaf_slot, t, tri, n, c, stack, t_min, t_max, stream
    "zr_stream_closest": [_VP] * 7 + [_I, _I, _I, _F, _F, _VP],
    # o, d, walk_nodes, leaf_rows, out, n, stack, t_min, t_max, stream
    "zr_stream_occlusion": [_VP] * 5 + [_I, _I, _F, _F, _VP],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def layout_header() -> str:
    """``layout.h``: the Python layouts and launch constants as ``constexpr
    int`` constants (``A_<column>``, ``G_<row>``, ``LSET_ROWS``,
    ``LSET_STAGED``, ``R_ROWS``, ``STATE_ROWS``, ``SURF_ROWS``,
    ``BOUNCE_BLOCK``, ``BOUNCE_SALT``, ``WALK_STACK_MAX``), ``TREE_PAD_REL``
    as a ``constexpr float`` and the GGX albedo fit (``GGX_E_DEG``,
    ``GGX_E_COEF``, ``GGX_EAVG_COEF``) as float arrays in constant memory,
    each coefficient the ``repr`` of its Python float, so it rounds to
    float32 as in PyTorch."""
    from .accel.bvh import TREE_PAD_REL, WALK_STACK_MAX
    from .accel.megakernel import (
        BOUNCE_BLOCK, G, LSET_ROWS, LSET_STAGED, STATE_ROWS, SURF_ROWS,
    )
    from .core.rng import BOUNCE_SALT
    from .ops import shading_soa as S
    from .ops.restir_di import R_ROWS
    from .scene.scene import A

    lines = ["// Generated by zetaray_tpu_torch.native.layout_header(); do not edit.",
             "#pragma once"]
    for prefix, cls in (("A", A), ("G", G)):
        lines += [f"constexpr int {prefix}_{k} = {v};"
                  for k, v in vars(cls).items() if k.isupper()]
    lines += [f"constexpr int {k} = {v};" for k, v in (
        ("LSET_ROWS", LSET_ROWS), ("LSET_STAGED", LSET_STAGED), ("R_ROWS", R_ROWS),
        ("STATE_ROWS", STATE_ROWS), ("SURF_ROWS", SURF_ROWS), ("BOUNCE_BLOCK", BOUNCE_BLOCK),
        ("BOUNCE_SALT", BOUNCE_SALT), ("GGX_E_DEG", S._GGX_E_DEG),
        ("WALK_STACK_MAX", WALK_STACK_MAX))]
    lines.append(f"constexpr float TREE_PAD_REL = {TREE_PAD_REL!r}f;")
    for name, coef in (("GGX_E_COEF", S._GGX_E_COEF), ("GGX_EAVG_COEF", S._GGX_EAVG_COEF)):
        vals = ", ".join(repr(float(c)) for c in coef)
        lines.append(f"static __constant__ float {name}[{len(coef)}] = {{{vals}}};")
    return "\n".join(lines) + "\n"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(layout_header().encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libzetaray_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the output of the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{text}")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    (tmp_dir / "layout.h").write_text(layout_header())
    objs = [tmp_dir / f"{p.stem}.o" for p in sorted(CSRC.glob("*.cu"))]
    try:
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-I", str(tmp_dir), "-o", str(obj),
                   str(CSRC / f"{obj.stem}.cu")] for obj in objs])
        lib_tmp = tmp_dir / out.name
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib_tmp), *map(str, objs)]])
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = loaded
        return _lib


def default_device(device=None) -> torch.device:
    """The device a loader puts its tensors on: ``device`` where one is
    named, else the card. Without CUDA and without a named device it raises:
    the CPU runs only where the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: name device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    return torch.device("cuda")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Validate a tensor handed to a kernel: device, dtype, contiguity, shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
