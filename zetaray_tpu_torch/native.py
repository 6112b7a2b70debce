"""Build and load the hand-written CUDA kernels in ``csrc/``.

The kernels are compiled with ``nvcc`` for Hopper (``sm_90a``), one process
per source started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use,
keyed by a hash of the sources and the flags, into ``_build/`` inside the
package (listed in ``.gitignore``), so a fresh checkout builds everything
the first time a CUDA tensor reaches a kernel.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``. Each kernel's launch function checks
its tensors with :func:`require` and calls :func:`launch`, the one seam to
the library: it appends the stream, turns a non-zero code into an
exception and counts the launch in ``launches``. The host rehearsal puts a
host build of the same sources in the place of :func:`lib`.

The host's BCn texture decoder (``csrc/host/bcdec.cpp``, :func:`decode_bcn`)
is a second, plain C++ library built with ``g++`` at its first use into the
same ``_build/`` under a name hashed from its sources. It stays out of
:func:`sources`, so that it never changes the CUDA library's hash.

The row and column layouts the kernels index (``A``, ``EA``, ``G``,
``LSET_ROWS``, ``R_ROWS``, ``STATE_ROWS``, ``SURF_ROWS``), the bounce
kernels' block size, pcg4d salts and path options block, the tree walks' stack limit and box
padding, the closed-form sky's fixed parameters of ``ops.sky`` and the GGX
albedo fit of ``ops.shading_soa`` are defined once, in Python:
:func:`layout_header`
writes them as C constants into the ``layout.h`` that the sources include.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
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
_LL = ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)  # a host array (accel.megakernel.path_options)
_SIGNATURES = {
    # o, d, woop_rows, attrs, out, n, tp, nt, t_min, stream
    "zr_gbuffer": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP],
    # o, d, woop_rows, out, n, tp, nt, t_min, t_max, stream
    "zr_occlusion": [_VP, _VP, _VP, _VP, _I, _I, _I, _F, _F, _VP],
    # gb, sets, out, n, n_sets, ps, rt, block, seed, pix0, stream
    "zr_ris": [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_uint32, ctypes.c_int, _VP],
    # state, woop_rows, attrs, state_out, surf_out, n, tp, nt, bounce, t_min, spread,
    # min_emissive_bounce, nee, has_lights, path options, stream
    "zr_bounce_trace": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _I, _I, _I, _FP, _VP],
    # state, surf, woop_rows, sets, state_out, n, tp, nt, n_sets, ps, rt, pix0, bounce,
    # seed, min_nee_bounce, rr_start, nee, has_lights, wops_em, material flags, path
    # options, stream
    "zr_bounce_shade": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
                        ctypes.c_uint32, _I, _I, _I, _I, _I, _I, _FP, _VP],
    # state, woop_rows, attrs, sets, state_out, n, tp, nt, n_sets, ps, rt, pix0, bounce,
    # seed, t_min, min_emissive_bounce, min_nee_bounce, rr_start, nee, has_lights, last,
    # wops_em, material flags, path options, stream
    "zr_bounce": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_uint32,
                  _F, _I, _I, _I, _I, _I, _I, _I, _I, _FP, _VP],
    # o, d, woop_rows, attrs, t, tri, u, v, attrs_out, n, tp, nt, tie, t_min, t_max, stream
    "zr_closest": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _VP],
    # o, d, walk_nodes, leaf_rows, leaf_slot, t, tri, n, c, stack, t_min, t_max, stream
    "zr_stream_closest": [_VP] * 7 + [_I, _I, _I, _F, _F, _VP],
    # o, d, walk_nodes, leaf_rows, out, n, stack, t_min, t_max, stream
    "zr_stream_occlusion": [_VP] * 5 + [_I, _I, _F, _F, _VP],
    # src, src plane/row strides, nrm, its strides, dep, its row stride, valid, its row
    # stride, dst, h, w, step, sigma_color, sigma_normal, sigma_depth, stream
    "zr_atrous": [_VP, _LL, _LL, _VP, _LL, _LL, _VP, _LL, _VP, _LL, _VP, _I, _I, _I,
                  _F, _F, _F, _VP],
    # o, d, tri, occluded, smb_kill, v0, e1, e2, attrs, em_prob, em_alias, em_attrs, state,
    # rad, o_next, d_next, seg_o, seg_d, hit t, u, v, attrs, n, bounce, pix0, seed, n_em,
    # min_emissive_bounce, min_nee_bounce, rr_start, nee, has_lights, last, path_reg,
    # material flags, firefly, stream
    "zr_wavefront_vertex": [_VP] * 22 + [_I, _I, _I, ctypes.c_uint32] + [_I] * 9 + [_F, _VP],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
launches: collections.Counter = collections.Counter()  # {entry point: launches so far}
_bcn_lib: ctypes.CDLL | None = None
HOST_SRC = CSRC / "host"


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
    int`` constants (``A_<column>``, ``EA_<column>``, ``G_<row>``,
    ``LSET_ROWS``, ``LSET_STAGED``, ``R_ROWS``, ``STATE_ROWS``, ``SURF_ROWS``,
    ``BOUNCE_BLOCK``, ``BOUNCE_SALT``, ``WOPS_SALT``, ``WALK_STACK_MAX``,
    ``PATH_OPTS``, ``WOPS_ROW``),
    ``TREE_PAD_REL`` and the sky's ``SKY_*`` (``ops.sky.layout_constants``)
    as ``constexpr float`` and the GGX albedo fit (``GGX_E_DEG``,
    ``GGX_E_COEF``, ``GGX_EAVG_COEF``) as float arrays in constant memory,
    each coefficient the ``repr`` of its Python float, so it rounds to
    float32 as in PyTorch."""
    from .accel.bvh import TREE_PAD_REL, WALK_STACK_MAX
    from .accel.megakernel import (
        BOUNCE_BLOCK, G, LSET_ROWS, LSET_STAGED, PATH_OPTS, STATE_ROWS, SURF_ROWS, WOPS_ROW,
    )
    from .core.rng import BOUNCE_SALT, WOPS_SALT
    from .ops import shading_soa as S
    from .ops import sky as SK
    from .ops.restir_di import R_ROWS
    from .scene.scene import A, EA

    lines = ["// Generated by zetaray_tpu_torch.native.layout_header(); do not edit.",
             "#pragma once"]
    for prefix, cls in (("A", A), ("EA", EA), ("G", G)):
        lines += [f"constexpr int {prefix}_{k} = {v};"
                  for k, v in vars(cls).items() if k.isupper()]
    lines += [f"constexpr int {k} = {v};" for k, v in (
        ("LSET_ROWS", LSET_ROWS), ("LSET_STAGED", LSET_STAGED), ("R_ROWS", R_ROWS),
        ("STATE_ROWS", STATE_ROWS), ("SURF_ROWS", SURF_ROWS), ("BOUNCE_BLOCK", BOUNCE_BLOCK),
        ("BOUNCE_SALT", BOUNCE_SALT), ("WOPS_SALT", WOPS_SALT), ("GGX_E_DEG", S._GGX_E_DEG),
        ("WALK_STACK_MAX", WALK_STACK_MAX), ("PATH_OPTS", PATH_OPTS), ("WOPS_ROW", WOPS_ROW))]
    lines.append(f"constexpr float TREE_PAD_REL = {TREE_PAD_REL!r}f;")
    lines += [f"constexpr float {k} = {v!r}f;" for k, v in SK.layout_constants().items()]
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


def bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    """Give each entry point of ``_SIGNATURES`` that ``cdll`` holds (a host
    build holds some) its argument and return types; returns ``cdll``."""
    for name, argtypes in _SIGNATURES.items():
        if hasattr(cdll, name):
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


def reload_lib() -> bool:
    """Where the kernels' library is loaded and its sources changed since
    (``library_path`` names another file), build the library of the new
    sources and load it in place of the old one. Returns whether it did;
    where no library is loaded (no kernel has run) there is nothing to
    swap."""
    global _lib
    with _lock:
        if _lib is None or Path(_lib._name) == library_path():
            return False
        _lib = None
    lib()
    return True


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


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the entry point ``entry`` of :func:`lib` with ``args`` (a tensor
    as its data pointer, None as a null pointer) and the current stream of
    ``device`` (None for a CPU device, which only a host build takes); raise
    where it refuses the launch, else count the launch in ``launches``."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None
    err = getattr(lib(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: cudaError {err}")
    launches[entry] += 1


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device: torch.device,
            contiguous: bool = True) -> None:
    """Validate a tensor handed to a kernel: on ``device`` (the rays' or the
    outputs'), its dtype, contiguity (unless the kernel takes strides),
    shape."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


# -- the host's BCn decoder --------------------------------------------------

BCN_BLOCK_BYTES = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16,
                   "BC7": 16, "BC6H": 16, "BC6H_SF": 16}
_GXX_FLAGS = ["-O2", "-shared", "-fPIC"]


def bcn_library_path() -> Path:
    """The decoder library's path in ``_build/``, named by a hash of its
    sources and flags."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    for p in sorted(HOST_SRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libbcdec_{h.hexdigest()[:16]}.so"


def build_bcn() -> Path:
    """Compile ``csrc/host/bcdec.cpp`` with g++ unless a library for these
    sources exists. A failed build raises."""
    out = bcn_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        lib_tmp = tmp_dir / out.name
        cmd = ["g++", *_GXX_FLAGS, "-o", str(lib_tmp), str(HOST_SRC / "bcdec.cpp")]
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed ({p.returncode}):\n{' '.join(cmd)}\n{p.stdout}")
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


def bcn_lib() -> ctypes.CDLL:
    """The loaded decoder library (built on first call)."""
    global _bcn_lib
    with _lock:
        if _bcn_lib is None:
            loaded = ctypes.CDLL(str(build_bcn()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            for fmt in ("bc1", "bc2", "bc3", "bc4", "bc5", "bc7"):
                fn = getattr(loaded, f"{fmt}_decode")
                fn.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
                fn.restype = None
            loaded.bc6h_decode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_float)]
            loaded.bc6h_decode.restype = None
            _bcn_lib = loaded
        return _bcn_lib


def decode_bcn(fmt: str, data: bytes, width: int, height: int) -> np.ndarray:
    """Decode one BCn mip level of ``width`` x ``height`` texels: BC1-BC5
    and BC7 -> uint8 RGBA [H, W, 4]; BC6H and BC6H_SF (HDR) -> float32
    RGBA [H, W, 4]. As the JAX package's ``native.decode_bcn``."""
    fmt = fmt.upper()
    if fmt not in BCN_BLOCK_BYTES:
        raise NotImplementedError(f"BC format {fmt} not supported")
    bw, bh = (width + 3) // 4, (height + 3) // 4
    need = bw * bh * BCN_BLOCK_BYTES[fmt]
    if len(data) < need:
        raise ValueError(f"{fmt}: need {need} bytes, got {len(data)}")
    src = np.frombuffer(data, np.uint8, count=need)
    lib_ = bcn_lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fmt.startswith("BC6H"):
        out = np.empty(height * width * 4, np.float32)
        lib_.bc6h_decode(src.ctypes.data_as(u8p), width, height, int(fmt == "BC6H_SF"),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    else:
        out = np.empty(height * width * 4, np.uint8)
        getattr(lib_, f"{fmt.lower()}_decode")(src.ctypes.data_as(u8p), width, height,
                                               out.ctypes.data_as(u8p))
    return out.reshape(height, width, 4)
