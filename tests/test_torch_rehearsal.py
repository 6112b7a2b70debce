"""The kernels B1, B2, B3, B4, B5, B6, B8 and B9, the a-trous pass and the
wavefront's vertex kernel built for the host and held to their plain
versions, so that their logic (the sign test, the pruning, the tie rules,
node culling, the shadow sweep's early exit, RIS's checkpoints, the
transmission and coat lobes of B5 and B6, a-trous's wrapped taps and
strides, and the wavefront's order of a bounce, random streams and path
state) is checked on every run of the tests, with no card.

``csrc/gbuffer.cu``, ``csrc/ris.cu``, ``csrc/occlusion.cu``,
``csrc/bounce.cu``, ``csrc/stream.cu``, ``csrc/atrous.cu`` and
``csrc/wavefront.cu`` are compiled
with g++ against a small stand-in for
``cuda_runtime.h``: the CUDA qualifiers are empty, ``__shared__`` is
``static``, each block runs as ``blockDim.x`` threads with barriers behind
``__syncthreads``, ``__syncthreads_and`` and ``__all_sync``, the
``<<<...>>>`` launches become calls of that launcher, and an ``extern
__shared__`` array points at a buffer of the launch's size. Without
``__CUDA_ARCH__`` the sweep's ``cp.async`` copies are plain copies, and
``rsqrtf`` is ``1 / sqrtf``. With ``-ffp-contract=off`` each float operation
rounds on its own, as in the plain versions and in the card's build
(``--fmad=false``), so the ray queries' outputs and B2's reservoirs must be
equal bit for bit; the shading rows of B1, B4 and B5, whose operations PyTorch orders its own
way, agree to 1e-5, and so does a-trous, whose expf and powf are the host's
and whose division by sigma_color PyTorch on the CPU does not turn into a
multiply.
The wavefront's radiance agrees to the limits ``test_wavefront_on_host``
states (the host's cosf, sinf and rsqrtf in its BSDF samples).

The ``host_kernels`` fixture puts the host build in the place of
``native.lib``, so the kernels are launched through the port's own launch
functions (``MK.launch_gbuffer``, ``RD.launch_ris``, ...,
``PT.wavefront_vertex``) and ``native.launch``: the argument lists under
test are the ones the card gets. Each ``host_*`` helper fills the outputs
with -7 first, so an output the kernel leaves unwritten fails.

Skips only where g++ is absent.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zetaray_tpu_torch import native
from zetaray_tpu_torch.accel import intersect as XI
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.accel import stream as ST
from zetaray_tpu_torch.accel import bvh as TB
from zetaray_tpu_torch.accel.bvh import LEAF_SIZE, WALK_STACK_MAX
from zetaray_tpu_torch.accel.megakernel import INF
from zetaray_tpu_torch.core.rng import uniform4
from zetaray_tpu_torch.ops import denoise as DN
from zetaray_tpu_torch.ops import pathtracer as PT
from zetaray_tpu_torch.ops import restir_di as RD
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.restir_gi import secondary_rays
from zetaray_tpu_torch.ops.sky import SkyParams, sun_direction
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import (
    CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box, materials_box, multi_light_box,
    repeated_box,
)
from zetaray_tpu_torch.scene.scene import upload_scene, with_cluster_tree
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from tests.test_torch_cuda import (
    MATERIAL_CASES, RIS_CASES, RIS_RT, RIS_SEED, RIS_U0_PIXEL, _close_rays,
    atrous_case, lobes_box, ris_case, ris_pick,
)

torch.set_num_threads(1)

SEED = 0x1234567

MOCK_CUDA = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
#include <atomic>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline dim3 blockIdx, blockDim;
inline thread_local dim3 threadIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float rsqrtf(float x) { return 1.f / sqrtf(x); }

namespace mock {
using Barrier = std::barrier<>;
inline Barrier* block;
inline std::vector<std::unique_ptr<Barrier>> warps;
inline std::atomic<int> block_false;
inline std::atomic<int> warp_false[32];
inline std::vector<float4> dynamic_shared;  // a launch's extern __shared__ bytes

// all threads of a group: arrive, count the false predicates, read, reset
inline bool all_of(Barrier& bar, std::atomic<int>& n_false, bool p, bool leader) {
  bar.arrive_and_wait();
  if (!p) n_false.fetch_add(1);
  bar.arrive_and_wait();
  const bool all = n_false.load() == 0;
  bar.arrive_and_wait();
  if (leader) n_false.store(0);
  return all;
}
}  // namespace mock

inline void __syncthreads() { mock::block->arrive_and_wait(); }
inline int __syncthreads_and(int p) {
  return mock::all_of(*mock::block, mock::block_false, p != 0, threadIdx.x == 0);
}
inline bool __all_sync(unsigned, int p) {
  const unsigned w = threadIdx.x / 32;
  return mock::all_of(*mock::warps[w], mock::warp_false[w], p != 0, threadIdx.x % 32 == 0);
}

// kernel<<<grid, block, shared, ...>>>(args): the blocks one after another,
// each as `block` threads
template <class K, class... A>
void zr_launch(int grid, int block, size_t shared, K kernel, A... args) {
  blockDim.x = block;
  mock::dynamic_shared.assign(shared / sizeof(float4) + 1, float4{});
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    mock::Barrier bar(block);
    mock::block = &bar;
    mock::warps.clear();
    for (int w = 0; w * 32 < block; ++w) {
      mock::warps.push_back(std::make_unique<mock::Barrier>(std::min(32, block - 32 * w)));
    }
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([=] {
        threadIdx.x = t;
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
}
"""

LAUNCH = re.compile(r"(\w+)<<<\s*([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>\(")
DYNAMIC_SHARED = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


@pytest.fixture(scope="session")
def host_build(tmp_path_factory):
    """csrc/gbuffer.cu, csrc/ris.cu, csrc/occlusion.cu, csrc/bounce.cu,
    csrc/stream.cu, csrc/atrous.cu and csrc/wavefront.cu built for the host,
    loaded and bound (``native.bind``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    tmp = tmp_path_factory.mktemp("rehearsal")
    (tmp / "cuda_runtime.h").write_text(MOCK_CUDA)
    (tmp / "layout.h").write_text(native.layout_header())
    for p in native.CSRC.glob("*.cuh"):
        shutil.copy(p, tmp / p.name)
    srcs = []
    for name in ("gbuffer.cu", "ris.cu", "occlusion.cu", "bounce.cu", "stream.cu", "atrous.cu",
                 "wavefront.cu"):
        text = LAUNCH.sub(r"zr_launch(\2, \3, \4, \1, ", (native.CSRC / name).read_text())
        text = DYNAMIC_SHARED.sub(
            r"\1* const \2 = reinterpret_cast<\1*>(mock::dynamic_shared.data());", text)
        (tmp / f"{name}.cc").write_text(text)
        srcs.append(str(tmp / f"{name}.cc"))
    lib_path = tmp / "libhost_kernels.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-I", str(tmp), *srcs, "-o", str(lib_path)],
                   check=True, capture_output=True)
    return native.bind(ctypes.CDLL(str(lib_path)))


@pytest.fixture
def host_kernels(host_build, monkeypatch):
    """The host build in the place of ``native.lib`` for one test."""
    monkeypatch.setattr(native, "lib", lambda: host_build)
    return host_build


def host_occlusion(scene, o, d, t_min, t_max):
    """B3 on the host: bool [N]."""
    out = torch.full((o.shape[0],), -1, dtype=torch.int32)
    XI.launch_occlusion(scene, o, d, t_min, t_max, out)
    assert ((out == 0) | (out == 1)).all()
    return out.bool()


def host_gbuffer(scene, o, d, t_min=1e-4):
    """B1 on the host: G [G.ROWS, N]."""
    out = torch.full((MK.G.ROWS, o.shape[0]), -7.0)
    MK.launch_gbuffer(scene, o, d, t_min, out)
    return out


def host_stream_closest(scene, o, d, t_min=1e-4, t_max=INF):
    """B8 on the host: (t [N], slot [N])."""
    t = torch.full((o.shape[0],), -7.0)
    tri = torch.full((o.shape[0],), -7, dtype=torch.int32)
    ST.launch_stream_closest(scene, o, d, t_min, t_max, t, tri)
    return t, tri


def host_stream_occlusion(scene, o, d, t_min=1e-4, t_max=INF):
    """B9 on the host: bool [N]."""
    out = torch.full((o.shape[0],), -1, dtype=torch.int32)
    ST.launch_occlusion_stream(scene, o, d, t_min, t_max, out)
    assert ((out == 0) | (out == 1)).all()
    return out.bool()


def host_bounce_trace(scene, state, cfg, spread_angle):
    """B4 at bounce 0 on the host: (state [STATE_ROWS, N], surf [SURF_ROWS, N])."""
    out = torch.full_like(state, -7.0)
    surf = torch.full((MK.SURF_ROWS, state.shape[1]), -7.0)
    MK.launch_bounce_trace(scene, state, 0, cfg, True, spread_angle, out, surf)
    return out, surf


def host_bounce_shade(scene, state, surf, lsets, seed, cfg, rt, bounce=0, pix0=0):
    """B5 at ``bounce`` on the host: state [STATE_ROWS, N]. ``lsets``: the
    light sets, or with cfg.nee_mode="wops" the WoPS table; ``pix0``: the
    rays' global offset."""
    out = torch.full_like(state, -7.0)
    MK.launch_bounce_shade(scene, state, surf, lsets, bounce, seed, cfg, True, rt, pix0, out)
    return out


def host_bounce(scene, state, lsets, b, seed, cfg, last, rt=128, pix0=0):
    """B6 at bounce b on the host: state [STATE_ROWS, N]. ``lsets``, ``pix0``:
    as for host_bounce_shade."""
    out = torch.full_like(state, -7.0)
    MK.launch_bounce(scene, state, lsets, b, seed, cfg, last, True, rt, pix0, out)
    return out


def host_ris(gb, lsets, seed, rt, pix0=0):
    """B2 on the host: reservoirs [R_ROWS, N]. ``pix0``: the pixels' global
    offset."""
    out = torch.full((RD.R_ROWS, gb.shape[1]), -7.0)
    RD.launch_ris(gb, lsets, seed, rt, pix0, out)
    return out


@pytest.mark.parametrize("name", RIS_CASES)
def test_ris_on_host(host_kernels, monkeypatch, name):
    """B2 equal to initial_candidates_plain, every row bit for bit, on the
    cases of ris_case (1000 pixels of the box in 8 blocks, the last one
    ragged, every fifth one not valid; 8 sets at tile width 128): the
    sampled sets, entries of pdf 0, a weightless chunk, picks only in the
    first or only in the last chunk, no weight at all, and two-sided
    entries. A pixel that is not valid keeps w_sum 0 and the last entry with
    its target; the pixel whose uniform is 0 picks the first entry of
    positive weight, past checkpoints equal to its target. A tile width that
    the block does not divide and an empty block are refused."""
    gb, lsets = ris_case(name, "cpu")
    got = host_ris(gb, lsets, RIS_SEED, RIS_RT)
    want = RD.initial_candidates_plain(gb, lsets, RIS_SEED, RIS_RT)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ps = lsets.shape[2]
    pick = ris_pick(want, lsets, RIS_RT)
    valid = gb[MK.G.VALID] > 0.5
    lit = valid & (want[9] > 0)
    assert (want[9, ~valid] == 0).all() and (pick[~valid] == ps - 1).all()
    assert (want[13, ~valid] > 0).float().mean() > 0.5
    assert (pick[valid & ~lit] == ps - 1).all()
    picks = pick[lit]
    first, last = {"first_chunk": (0, 8), "last_chunk": (120, ps)}.get(name, (0, ps))
    assert ((picks >= first) & (picks < last)).all()
    if name == "no_weight":
        assert not lit.any()
        return
    assert lit.float().mean() > 0.4
    if name == "zero_chunk":
        assert not ((picks >= 32) & (picks < 64)).any()
    if name in ("sampled", "pdf0", "two_sided"):  # first entries of chunks of 16
        assert ((picks % 16 == 0) & (picks > 0)).sum() > 5
    if name == "last_chunk":  # target 0: the first entry of positive weight, not the last
        u = uniform4(torch.tensor([RIS_U0_PIXEL]), 0, RIS_SEED, salt=0x51E5)[0]
        assert u.item() == 0.0 and want[9, RIS_U0_PIXEL] > 0
        assert 120 <= pick[RIS_U0_PIXEL] < ps - 1
    pytest.raises(RuntimeError, host_ris, gb, lsets, RIS_SEED, 192)
    monkeypatch.setattr(RD, "_RIS_BLOCK", 0)
    pytest.raises(RuntimeError, host_ris, gb, lsets, RIS_SEED, 128)


def _segments(seed, n):
    """Shadow segments from points in the box to points on its ceiling
    light, and rays from the same points in random directions."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-0.95, 0.95, n), r.uniform(0.02, 1.9, n),
                  r.uniform(-0.95, 0.95, n)], -1)
    tgt = np.stack([r.uniform(-0.19, 0.19, n), np.full(n, 1.98), r.uniform(-0.24, 0.24, n)], -1)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return as_t(o), as_t(tgt - o), as_t(d)


@pytest.mark.parametrize("subdivide", [None, 200, 300])
def test_occlusion_kernel_on_host(host_kernels, subdivide):
    """B3 equal to its plain version with 36, 200 and 300 real triangles
    (1, 2 and 3 chunks of the sweep's ring), on 300 shadow segments and 300
    rays (3 blocks, the last one ragged); a negative t_min is refused."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device="cpu")
    o, seg, d = _segments(3, 300)
    for dirs, t_min, t_max in ((seg, 1e-3, 1.0 - 1e-3), (d, 1e-4, INF), (d, 0.0, 0.7)):
        got = host_occlusion(scene, o, dirs, t_min, t_max)
        want = XI.occlusion_plain(scene.woop, o, dirs, t_min, t_max)
        assert torch.equal(got, want)
        assert 0 < got.sum() < got.numel()
    pytest.raises(RuntimeError, host_occlusion, scene, o, seg, -1.0, 1.0)


def _gi_bounce0(scene, res=18, n=300):
    """GI bounce-0 rays from a res^2 G-buffer of the box camera (the first
    n: 3 blocks, the last one ragged) as their initial path state, and the
    camera's pixel spread angle."""
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    o, d = cam.generate_rays(res, res, device="cpu")
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene, o, d), 0x2468ACE1)
    return MK.initial_state(o2[:n], d2[:n]).contiguous(), cam.pixel_spread_angle(res)


@pytest.mark.parametrize("subdivide", [None, 200, 300])
def test_bounce_trace_on_host(host_kernels, subdivide):
    """B4 against its plain version with 36, 200 and 300 real triangles (1,
    2 and 3 chunks of the sweep's ring) on 300 GI bounce-0 rays (3 blocks,
    the last one ragged): alive and the texture id exact, every row to 1e-5
    on the rays that hit and the radiance on all, the hit position of a ray
    that hit bit for bit; a negative t_min is refused."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device="cpu")
    st0, spread = _gi_bounce0(scene)
    cfg = PTConfig(max_bounces=2, min_emissive_bounce=1)
    st, surf = host_bounce_trace(scene, st0, cfg, spread)
    st_p, surf_p = MK.bounce_trace_plain(scene, st0, 0, cfg, True, spread)
    found = st_p[13] > 0.5
    assert 0.3 < found.float().mean() < 1.0
    assert torch.equal(st[13], st_p[13]) and torch.equal(surf[21], surf_p[21])
    assert torch.equal(surf[0:3, found], surf_p[0:3, found])
    assert _close_rays(st[:, found], st_p[:, found]) == 1.0
    assert _close_rays(surf[:, found], surf_p[:, found]) == 1.0
    assert _close_rays(st, st_p, [9, 10, 11]) == 1.0
    pytest.raises(RuntimeError, host_bounce_trace, scene, st0, PTConfig(t_min=-1.0), spread)


def _with_shelf(cpu):
    """``cpu`` with one more triangle in its last real slot: a shelf under
    the ceiling light, the only blocker of many shadow segments and in view
    of the camera, so that a sweep that stops short of the last triangle
    shows."""
    tri = {"v0": [-0.6, 1.5, -0.6], "v1": [0.6, 1.5, -0.6], "v2": [0.0, 1.5, 0.6],
           **{f: [0.0, -1.0, 0.0] for f in ("n0", "n1", "n2")},
           **{f: [0.0, 0.0] for f in ("uv0", "uv1", "uv2")},
           "mat_id": cpu.mat_id[0], "inst_id": cpu.inst_id[0]}
    return dataclasses.replace(cpu, **{
        f: np.concatenate([getattr(cpu, f), np.asarray([v], getattr(cpu, f).dtype)])
        for f, v in tri.items()})


def _past_table(scene):
    """``scene`` telling the kernels of one more real triangle than its
    table holds."""
    return dataclasses.replace(scene, num_tris=scene.woop.shape[1] // 3 + 1)


GBUFFER_SCENES = {
    "box": lambda: _with_shelf(cornell_box()),
    "box200": lambda: _with_shelf(cornell_box(subdivide_to=200)),
    "box300": lambda: _with_shelf(cornell_box(subdivide_to=300)),
    "ties": lambda: repeated_box(5),
}


@pytest.mark.parametrize("name", sorted(GBUFFER_SCENES))
def test_gbuffer_on_host(host_kernels, name):
    """B1 against gbuffer_plain on the box and its subdivisions to 200 and
    300 triangles, each with a shelf in its last slot (37, 201 and 301 real
    triangles: 1, 2 and 3 chunks of the sweep's ring), and on the box with
    each triangle repeated
    5 times (180 slots, where the tie rule decides every hit, across the
    128-slot tie groups for the copies of slots 125-129), on 324 camera rays
    (3 blocks, the last one ragged) and on 300 rays from inside the box in
    random directions: the hit rows (position, VALID, DEPTH, INST, MATID,
    TEXID) equal bit for bit, the normal rows and every row of a ray that
    hit to 1e-5; a negative t_min and a real-triangle count beyond the table
    are refused."""
    scene = upload_scene(GBUFFER_SCENES[name](), device="cpu")
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    o, d = cam.generate_rays(18, 18, device="cpu")
    o_in, _, d_in = _segments(4, 300)
    G = MK.G
    for oo, dd in ((o.contiguous(), d.contiguous()), (o_in, d_in)):
        g = host_gbuffer(scene, oo, dd)
        g_p = MK.gbuffer_plain(scene, oo, dd)
        hit = g_p[G.VALID] > 0.5
        assert 0.5 < hit.float().mean()
        for r in (G.POS, G.POS + 1, G.POS + 2, G.VALID, G.DEPTH, G.INST, G.MATID, G.TEXID):
            assert torch.equal(g[r], g_p[r]), r
        assert _close_rays(g, g_p, slice(G.NS, G.NS + 3)) == 1.0
        assert _close_rays(g[:, hit], g_p[:, hit]) == 1.0
    if name == "ties":  # every hit is the last copy of its triangle within its tie group
        tri = MK.closest_hit_plain(scene.woop, o_in, d_in)[1]
        assert ((tri[tri >= 0] % 5 == 4) | (tri[tri >= 0] == 127)).all()
        assert (tri == 127).any()
    pytest.raises(RuntimeError, host_gbuffer, scene, o, d, t_min=-1.0)
    pytest.raises(RuntimeError, host_gbuffer, _past_table(scene), o, d)


@pytest.mark.parametrize("subdivide", [None, 200, 300])
def test_bounce_shade_on_host(host_kernels, subdivide, monkeypatch):
    """B5 against bounce_shade_plain on the box and its subdivisions to 200
    and 300 triangles, each with a shelf under the light in its last slot
    (37, 201 and 301 real triangles: 1, 2 and 3 chunks of the sweep's ring),
    on 300 GI bounce-0 rays after B4's
    plain version (3 blocks, the last one ragged) at the narrowest tile
    width, rt = 128, with the criteria of the card's
    test_bounce_kernels_match_plain: every row on the rays that found a hit,
    radiance and alive on every ray. The shadow sweep's decision: a ray
    gains the NEE light in B5 exactly where it does in the plain version,
    whose segments go through occlusion_plain; the segments that the plain
    version lights with nothing blocking include both blocked and free ones.
    A tile width off the block and a real-triangle count beyond the table
    are refused."""
    scene = upload_scene(_with_shelf(cornell_box(subdivide_to=subdivide)), device="cpu")
    st0, spread = _gi_bounce0(scene)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1)
    st4, sf4 = MK.bounce_trace_plain(scene, st0, 0, cfg, True, spread)
    lsets = MK.build_light_sets(scene, SEED)
    st5 = host_bounce_shade(scene, st4, sf4, lsets, SEED, cfg, 128)
    st5_p = MK.bounce_shade_plain(scene, st4, sf4, lsets, 0, SEED, cfg, True, 128)
    found = st4[13] > 0.5
    assert 0.3 < found.float().mean() < 1.0
    assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
    assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
    lit = (st5[9:12] != st4[9:12]).any(0)
    lit_p = (st5_p[9:12] != st4[9:12]).any(0)
    assert torch.equal(lit, lit_p)
    monkeypatch.setattr(XI, "occlusion_plain",
                        lambda woop, o, d, t_min, t_max: torch.zeros(o.shape[0], dtype=torch.bool))
    st5_free = MK.bounce_shade_plain(scene, st4, sf4, lsets, 0, SEED, cfg, True, 128)
    free = (st5_free[9:12] != st4[9:12]).any(0)
    assert (free & lit_p).sum() > 20 and (free & ~lit_p).sum() > 5
    assert not (lit_p & ~free).any()
    pytest.raises(RuntimeError, host_bounce_shade, scene, st4, sf4, lsets, SEED, cfg, 100)
    pytest.raises(RuntimeError, host_bounce_shade, _past_table(scene), st4, sf4, lsets, SEED,
                  cfg, 128)


@pytest.mark.parametrize("pix0", [640, 300, 1 << 20])
def test_tile_offset_on_host(host_kernels, pix0):
    """B2, B5 and B6 with a row band's offset ``pix0`` (tile0 = pix0 // 128
    > 0; 300 is no multiple of the tile width) against their plain versions
    with the same offset, on 300 GI bounce-0 rays of the box with a shelf at
    rt = 128: B2 bit for bit, B5 and B6 with the criteria of
    test_bounce_shade_on_host. The offset moves the light sets and the
    random streams: the outputs differ from those at offset 0. A negative
    offset is refused."""
    scene = upload_scene(_with_shelf(cornell_box()), device="cpu")
    st0, spread = _gi_bounce0(scene)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1)
    lsets = MK.build_light_sets(scene, SEED)
    gb, ris_sets = ris_case("sampled", "cpu")
    got = host_ris(gb, ris_sets, RIS_SEED, RIS_RT, pix0=pix0)
    want = RD.initial_candidates_plain(gb, ris_sets, RIS_SEED, RIS_RT, pix0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(want, RD.initial_candidates_plain(gb, ris_sets, RIS_SEED, RIS_RT))
    pytest.raises(RuntimeError, host_ris, gb, ris_sets, RIS_SEED, RIS_RT, pix0=-128)

    st4, sf4 = MK.bounce_trace_plain(scene, st0, 0, cfg, True, spread)
    found = st4[13] > 0.5
    st5 = host_bounce_shade(scene, st4, sf4, lsets, SEED, cfg, 128, pix0=pix0)
    st5_p = MK.bounce_shade_plain(scene, st4, sf4, lsets, 0, SEED, cfg, True, 128, pix0)
    assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
    assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
    lit, lit_p = ((x[9:12] != st4[9:12]).any(0) for x in (st5, st5_p))
    assert torch.equal(lit, lit_p) and lit.any()
    st5_0 = MK.bounce_shade_plain(scene, st4, sf4, lsets, 0, SEED, cfg, True, 128)
    assert not torch.equal(st5_p[3:6], st5_0[3:6])
    pytest.raises(RuntimeError, host_bounce_shade, scene, st4, sf4, lsets, SEED, cfg, 128, pix0=-1)
    f6 = MK.bounce_trace_plain(scene, st5_p, 1, cfg, True)[0][13] > 0.5
    st6 = host_bounce(scene, st5_p, lsets, 1, SEED, cfg, False, pix0=pix0)
    st6_p = MK.bounce_plain(scene, st5_p, lsets, 1, SEED, cfg, False, True, 128, pix0)
    assert _close_rays(st6[:, f6], st6_p[:, f6]) >= 0.999
    assert _close_rays(st6, st6_p, [9, 10, 11, 13]) >= 0.999
    assert torch.equal(*((x[9:12] != st5_p[9:12]).any(0) for x in (st6, st6_p)))


SUN = (0.2, 0.45, 0.87)  # shines in through the box's opening at +z
PATH_OPTIONS = {
    "sky": dict(sky=SkyParams(sun_dir=SUN)),
    "sky_no_sun_nee": dict(sky=SkyParams(sun_dir=SUN), sun_nee=False),
    "regularized_clamped": dict(path_regularization=True, firefly_clamp=0.05),
}


@pytest.mark.parametrize("subdivide", [None, 300])
@pytest.mark.parametrize("opts", sorted(PATH_OPTIONS))
def test_bounce_options_on_host(host_kernels, subdivide, opts):
    """The branches of the path options in B4, B5 and B6 against the plain
    versions, on the box with a shelf in its last slot and on its
    subdivision to 300 triangles (3 chunks of the sweep's ring, where B5 and
    B6 sweep three times), on 300 GI bounce-0 rays (3 blocks, the last one
    ragged) at rt = 128: B4 with the criteria of test_bounce_trace_on_host,
    B5 at bounce 0 and B6 at bounce 1 (where regularization acts) and on its
    trace-only last bounce at 2 with those of test_bounce_shade_on_host. The
    rays that escape through the opening gather the sky in B4; with sun NEE
    the sun lights rays with nothing in its way and not the ones it leaves
    in shadow, and both kinds occur."""
    scene = upload_scene(_with_shelf(cornell_box(subdivide_to=subdivide)), device="cpu")
    st0, spread = _gi_bounce0(scene)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1, **PATH_OPTIONS[opts])
    lsets = MK.build_light_sets(scene, SEED)
    st4, sf4 = host_bounce_trace(scene, st0, cfg, spread)
    st4_p, sf4_p = MK.bounce_trace_plain(scene, st0, 0, cfg, True, spread)
    found = st4_p[13] > 0.5
    assert torch.equal(st4[13], st4_p[13]) and torch.equal(sf4[0:3, found], sf4_p[0:3, found])
    assert _close_rays(st4, st4_p) == 1.0 and _close_rays(sf4[:, found], sf4_p[:, found]) == 1.0
    escaped = (st4_p[9:12] != st0[9:12]).any(0) & ~found
    assert escaped.sum() > 10 if cfg.sky is not None else not escaped.any()

    st5 = host_bounce_shade(scene, st4_p, sf4_p, lsets, SEED, cfg, 128)
    st5_p = MK.bounce_shade_plain(scene, st4_p, sf4_p, lsets, 0, SEED, cfg, True, 128)
    assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
    assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
    lit, lit_p = ((x[9:12] != st4_p[9:12]).any(0) for x in (st5, st5_p))
    assert torch.equal(lit, lit_p)
    if cfg.sky is not None and cfg.sun_nee:
        no_sun = dataclasses.replace(cfg, sun_nee=False)
        sun_lit = (st5_p != MK.bounce_shade_plain(scene, st4_p, sf4_p, lsets, 0, SEED, no_sun,
                                                  True, 128))[9:12].any(0)
        s = torch.from_numpy(sun_direction(cfg.sky))
        facing = found & ((sf4_p[3:6] * s[:, None]).sum(0) > 1e-6)
        assert (facing & sun_lit).sum() > 10 and (facing & ~sun_lit).sum() > 10
        assert not (sun_lit & ~facing).any()
    st5 = host_bounce_shade(scene, st4_p, sf4_p, lsets, SEED, cfg, 128, bounce=1)
    st5_1 = MK.bounce_shade_plain(scene, st4_p, sf4_p, lsets, 1, SEED, cfg, True, 128)
    assert _close_rays(st5[:, found], st5_1[:, found]) >= 0.999
    assert _close_rays(st5, st5_1, [9, 10, 11, 13]) >= 0.999

    for b, last in ((1, False), (2, True)):
        f6 = MK.bounce_trace_plain(scene, st5_p, b, cfg, True)[0][13] > 0.5
        st6 = host_bounce(scene, st5_p, lsets, b, SEED, cfg, last)
        st6_p = MK.bounce_plain(scene, st5_p, lsets, b, SEED, cfg, last, True, 128)
        assert _close_rays(st6[:, f6], st6_p[:, f6]) >= 0.999
        assert _close_rays(st6, st6_p, [9, 10, 11, 13]) >= 0.999
        assert torch.equal(*((x[9:12] != st5_p[9:12]).any(0) for x in (st6, st6_p)))


@pytest.mark.parametrize("subdivide", [None, 300])
@pytest.mark.parametrize("sun", [False, True], ids=["no_sky", "sun_nee"])
def test_wops_bounce_on_host(host_kernels, subdivide, sun):
    """The WoPS instances of B5 (bounce 0) and B6 (bounce 1) against their
    plain versions on the box with three wall lights of unequal power
    (multi_light_box; its subdivision to 300 triangles: 3 chunks of the
    sweep's ring), with a shelf in the last slot, on 300 GI bounce-0 rays
    at rt = 128, with and without sun NEE, with the criteria of
    test_bounce_shade_on_host: the same rays gain the NEE light, and the
    alias table redirects a share of the picks."""
    scene = upload_scene(_with_shelf(multi_light_box(subdivide_to=subdivide)), device="cpu")
    st0, spread = _gi_bounce0(scene)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1, nee_mode="wops",
                   sky=SkyParams(sun_dir=SUN) if sun else None)
    table = MK.wops_table(scene)
    st4, sf4 = MK.bounce_trace_plain(scene, st0, 0, cfg, True, spread)
    found = st4[13] > 0.5
    st5 = host_bounce_shade(scene, st4, sf4, table, SEED, cfg, 128)
    st5_p = MK.bounce_shade_plain(scene, st4, sf4, table, 0, SEED, cfg, True, 128)
    assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
    assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
    lit, lit_p = ((x[9:12] != st4[9:12]).any(0) for x in (st5, st5_p))
    assert torch.equal(lit, lit_p) and lit.float().mean() > 0.1
    u = MK.bounce_uniforms(st0.shape[1], 0, SEED, wops=True)
    redirected = MK.wops_pick(table, scene.num_emissives, u[0], u[5])[1]
    assert (redirected & found).sum() > 10  # the alias is taken
    f6 = MK.bounce_trace_plain(scene, st5_p, 1, cfg, True)[0][13] > 0.5
    st6 = host_bounce(scene, st5_p, table, 1, SEED, cfg, False)
    st6_p = MK.bounce_plain(scene, st5_p, table, 1, SEED, cfg, False, True, 128)
    assert _close_rays(st6[:, f6], st6_p[:, f6]) >= 0.999
    assert _close_rays(st6, st6_p, [9, 10, 11, 13]) >= 0.999
    assert torch.equal(*((x[9:12] != st5_p[9:12]).any(0) for x in (st6, st6_p)))
    # a table narrower than its emissive count is refused
    more = dataclasses.replace(scene, num_emissives=table.shape[0] + 1)
    pytest.raises(RuntimeError, host_bounce_shade, more, st4, sf4, table, SEED, cfg, 128)


def _close_material(k, p, found):
    """The criteria of test_bounce_shade_on_host on a scene with glass of
    roughness 0.05, whose GGX peak (alpha^2 = 6.25e-6) turns an ulp of the
    half vector (rsqrt rounds differently in the host build and in
    PyTorch) into percents of the sampled pdf: every row but the pdf (row
    12) to 1e-5 on 99.9% of the rays that found a hit, the pdf to 1e-5 on
    99% of them and to 2% on all; radiance and alive to 1e-5 on 99.9% of
    all rays."""
    rows = [r for r in range(MK.STATE_ROWS) if r != 12]
    assert _close_rays(k[:, found], p[:, found], rows) >= 0.999
    assert _close_rays(k[:, found], p[:, found], [12]) >= 0.99
    assert torch.isclose(k[12, found], p[12, found], rtol=2e-2, atol=1e-5).all()
    assert _close_rays(k, p, [9, 10, 11, 13]) >= 0.999


@pytest.mark.parametrize("case", sorted(c for c in MATERIAL_CASES if "2000" not in c))
def test_material_bounce_on_host(host_kernels, case):
    """The material instances of B5 (bounce 0) and B6 (bounce 1, and its
    trace-only last bounce at 2) against their plain versions on the box
    with a glass block and a coated block (``lobes_box``: each lobe alone
    and both; with a shelf in the last slot; at 300 triangles also with the
    sky, sun NEE and the path options, and with WoPS NEE), on 300 GI
    bounce-0 rays at rt = 128, with the criteria of ``_close_material``;
    the same rays gain the NEE light. The BSDF samples go below the surface
    (transmission) where the scene has glass, and bounce 1 meets the glass
    from inside (eta > 1), so both faces of the interface are driven."""
    lobes, subdivide, opts = MATERIAL_CASES[case]
    scene = upload_scene(_with_shelf(lobes_box(lobes, subdivide)), device="cpu")
    assert scene.has_transmission == ("glass" in lobes) and scene.has_coat == ("coat" in lobes)
    st0, spread = _gi_bounce0(scene)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1, **opts)
    lsets = MK.wops_table(scene) if cfg.nee_mode == "wops" else MK.build_light_sets(scene, SEED)
    st4, sf4 = MK.bounce_trace_plain(scene, st0, 0, cfg, True, spread)
    found = st4[13] > 0.5
    st5 = host_bounce_shade(scene, st4, sf4, lsets, SEED, cfg, 128)
    st5_p = MK.bounce_shade_plain(scene, st4, sf4, lsets, 0, SEED, cfg, True, 128)
    _close_material(st5, st5_p, found)
    lit, lit_p = ((x[9:12] != st4[9:12]).any(0) for x in (st5, st5_p))
    assert torch.equal(lit, lit_p) and lit.float().mean() > 0.1
    below = found & (st5_p[13] > 0.5) & ((st5_p[3:6] * sf4[6:9]).sum(0) < 0.0)
    assert (below.sum() > 3) == scene.has_transmission
    st_t1, sf_t1 = MK.bounce_trace_plain(scene, st5_p, 1, cfg, True)
    f6 = st_t1[13] > 0.5
    if scene.has_transmission:
        assert (f6 & (sf_t1[16] > 1.0)).sum() > 3  # rays inside the glass meet its back faces
    for b, last in ((1, False), (2, True)):
        if b == 2:
            f6 = MK.bounce_trace_plain(scene, st5_p, b, cfg, True)[0][13] > 0.5
        st6 = host_bounce(scene, st5_p, lsets, b, SEED, cfg, last)
        st6_p = MK.bounce_plain(scene, st5_p, lsets, b, SEED, cfg, last, True, 128)
        _close_material(st6, st6_p, f6)
        assert torch.equal(*((x[9:12] != st5_p[9:12]).any(0) for x in (st6, st6_p)))


def _deep():
    """The box bisected to 56 triangles, each repeated 100 times, in 56
    clusters of 128 slots put in a chain: the cluster tree 55 deep, the
    walk 61 stack entries (61 KiB of B8's shared memory a block, past the
    48 KiB a launch gets unasked)."""
    scene = upload_scene(repeated_box(100, 56), device="cpu", cluster_size=128)
    return with_cluster_tree(scene, TB.chain_tree(scene.cluster_aabb.numpy()))


CLUSTERED = {
    "box546": lambda: upload_scene(subdivide_scene(cornell_box(), 500), device="cpu",
                                   cluster_size=128),
    "ties": lambda: upload_scene(repeated_box(160), device="cpu", cluster_size=128),
    "deep": _deep,
}


@pytest.mark.parametrize("name", sorted(CLUSTERED))
def test_stream_kernels_on_host(host_kernels, name):
    """B8 (t and slot) and B9 equal to their plain versions on the
    546-triangle box and on the box with each triangle repeated 160 times
    (5760 slots, where the tie rule (t, cluster, -slot) decides every hit
    among copies in two or more clusters), both clustered by 128, and on a
    scene of repeated triangles with its clusters in a chain (the deepest
    trees, beyond 48 KiB of B8's stack a block): camera rays
    from inside the box, rays leaving their hits in random directions
    (those that missed from their far end, near the float range), and
    shadow segments. A negative t_min and a stack out of range are
    refused."""
    scene = CLUSTERED[name]()
    assert scene.cluster_aabb is not None
    if name == "deep":
        assert scene.walk_stack == 61 and scene.walk_nodes.shape[0] == 2799
    o, seg, d = _segments(5, 300)
    t, tri = host_stream_closest(scene, o, d)
    t_p, tri_p = ST.stream_closest_plain(scene, o, d)
    assert torch.equal(tri, tri_p) and torch.equal(t, t_p)
    assert 0.5 < (tri_p >= 0).float().mean() < 1.0
    if name == "ties":  # the winner's 160 copies lie in more than one cluster
        w = scene.woop.reshape(12, -1)
        for s in tri_p[tri_p >= 0][:20].tolist():
            copies = torch.nonzero((w == w[:, s : s + 1]).all(0))[:, 0]
            assert len(copies) == 160 and len((copies // 128).unique()) > 1
    r = np.random.default_rng(7)
    d2 = torch.from_numpy(r.normal(size=(300, 3)).astype(np.float32))
    d2 = (d2 / d2.norm(dim=1, keepdim=True)).contiguous()
    o2 = (o + (t_p - 1e-3)[:, None] * d).contiguous()
    o2[:5] = o[:5] + (INF - 1e-3) * d[:5]  # far ends of missed rays
    for oo, dd, t_min, t_max in ((o2, d2, 1e-4, INF), (o, d, 1e-3, 0.5), (o, d, 0.0, INF)):
        t, tri = host_stream_closest(scene, oo, dd, t_min, t_max)
        t_p, tri_p = ST.stream_closest_plain(scene, oo, dd, t_min, t_max)
        assert torch.equal(tri, tri_p) and torch.equal(t, t_p)
    for dirs, t_min, t_max in ((seg, 1e-3, 1.0 - 1e-3), (d2, 1e-4, INF)):
        got = host_stream_occlusion(scene, o, dirs, t_min, t_max)
        assert torch.equal(got, ST.occlusion_stream_plain(scene, o, dirs, t_min, t_max))
        assert 0 < got.sum() < got.numel()
    got = host_stream_occlusion(scene, o2, d2, 1e-4, INF)
    assert torch.equal(got, ST.occlusion_stream_plain(scene, o2, d2, 1e-4, INF))
    for stack, t_min in ((scene.walk_stack, -1.0), (0, 1e-4), (WALK_STACK_MAX + 1, 1e-4)):
        refused = dataclasses.replace(scene, walk_stack=stack)
        pytest.raises(RuntimeError, host_stream_closest, refused, o, d, t_min)
        pytest.raises(RuntimeError, host_stream_occlusion, refused, o, seg, t_min, 1.0)


@pytest.mark.parametrize("n_tris", [36, LEAF_SIZE])
def test_stream_closest_on_host_one_cluster(host_kernels, n_tris):
    """B8 equal to its plain version where the whole scene is one cluster of
    128 slots: the cluster tree is a single leaf, so B8's root is the
    sub-tree's (36 triangles) or, where the cluster fits in one leaf
    (LEAF_SIZE triangles), a node above that leaf."""
    box = cornell_box()
    cpu = dataclasses.replace(
        box, **{f: getattr(box, f)[:n_tris] for f in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0",
                                                      "uv1", "uv2", "mat_id", "inst_id")},
        emissive_tris=box.emissive_tris[box.emissive_tris < n_tris])
    scene = upload_scene(cpu, device="cpu", cluster_size=128)
    assert scene.cluster_aabb.shape[0] == 1
    leaves = -(-n_tris // LEAF_SIZE)  # a node above each pair of subtrees
    assert scene.walk_nodes.shape[0] == max(leaves - 1, 1)
    o, _, d = _segments(9, 300)
    t, tri = host_stream_closest(scene, o, d)
    t_p, tri_p = ST.stream_closest_plain(scene, o, d)
    assert torch.equal(tri, tri_p) and torch.equal(t, t_p)
    assert (tri_p >= 0).any()


def host_atrous(img, nrm, depth, valid, step):
    """One a-trous pass on the host, each input through its plane and row
    strides: [3, H, W]."""
    out = torch.full((3, *depth.shape), -7.0)
    DN.launch_atrous(img, nrm, depth, valid, step, DN.ATrousConfig(), out)
    return out


@pytest.mark.parametrize("step", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(24, 40), (7, 5), (1, 33), (33, 1), (17, 300)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_atrous_on_host(host_kernels, shape, step):
    """A pass at each step on row and column slices of larger planes against
    the plain pass, on a 24x40 image, on images smaller than the taps'
    shifts and on ragged blocks: every pixel to 1e-5, an invalid pixel's
    colour kept bit for bit."""
    h, w = shape
    big = atrous_case(h + 5, w + 3, seed=h + w)
    img, nrm, depth, valid = (t[..., 3 : 3 + h, 1 : 1 + w] for t in big)
    got = host_atrous(img, nrm, depth, valid, step)
    want = DN.atrous_iteration_plain(img, nrm, depth, valid.to(torch.float32), step)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[:, ~valid], img[:, ~valid])
    assert not torch.equal(got[:, valid], img[:, valid])


def test_launch_on_host(host_kernels, monkeypatch):
    """``native.launch`` with the host build: an a-trous pass on CPU tensors
    calls its entry point once, with None as the stream, and counts one
    launch; a negative size, which only the entry point is told, is refused
    with RuntimeError and not counted."""
    streams = []
    entry = host_kernels.zr_atrous
    monkeypatch.setattr(native, "lib", lambda: SimpleNamespace(
        zr_atrous=lambda *args: streams.append(args[-1]) or entry(*args)))
    img, nrm, depth, valid = atrous_case(7, 5, seed=1)
    before = native.launches.copy()
    got = host_atrous(img, nrm, depth, valid, 2)
    assert streams == [None] and native.launches - before == Counter(zr_atrous=1)
    cfg = DN.ATrousConfig()
    with pytest.raises(RuntimeError, match="zr_atrous"):
        native.launch("zr_atrous", img.device, img, img.stride(0), img.stride(1), nrm,
                      nrm.stride(0), nrm.stride(1), depth, depth.stride(0), valid,
                      valid.stride(0), got, -1, 5, 2, cfg.sigma_color, cfg.sigma_normal,
                      cfg.sigma_depth)
    assert streams == [None, None] and native.launches - before == Counter(zr_atrous=1)


# The wavefront path trace's vertex kernel (csrc/wavefront.cu) on the
# 546-triangle box clustered by 128 (and the materials box split and
# clustered the same way), with each case's PTConfig fields and
# trace_reference arguments: the restir_di frame's path trace
# (render.frame), GI's initial samples (ops.restir_gi l2_cfg; with the
# stochastic multi-bounce kill at two bounces), ReSTIR PT's suffix
# (max_bounces = 0), glass and a coat with path regularization and the
# firefly clamp, and a row band's pixel offset.
WAVEFRONT_CASES = {
    "di": ("box546", dict(max_bounces=4, min_emissive_bounce=2, min_nee_bounce=1), {}),
    "gi": ("box546", dict(max_bounces=1, min_emissive_bounce=1), dict(return_first_hit=True)),
    "gi_smb": ("box546", dict(max_bounces=2, min_emissive_bounce=1),
               dict(return_first_hit=True, smb_kill=True)),
    "pt_suffix": ("box546", dict(max_bounces=0), {}),
    "materials": ("materials546", dict(max_bounces=3, rr_start=1, min_emissive_bounce=1,
                                       path_regularization=True, firefly_clamp=0.05),
                  dict(return_first_hit=True)),
    "pix0": ("box546", dict(max_bounces=4, min_emissive_bounce=2, min_nee_bounce=1),
             dict(pix0=3 * 4096 + 5)),
}
WAVEFRONT_SCENES = {
    "box546": lambda: subdivide_scene(cornell_box(), 500),
    "materials546": lambda: materials_box(500),
}


@pytest.fixture(scope="module")
def wavefront_scenes():
    return {k: upload_scene(f(), device="cpu", cluster_size=128)
            for k, f in WAVEFRONT_SCENES.items()}


def _wavefront_rays(n_side=64):
    """The box camera's rays, every seventh parked as GI parks its dead
    rays (``ops.pathtracer.park``)."""
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    o, d = cam.generate_rays(n_side, n_side, device="cpu")
    return PT.park(torch.arange(o.shape[0]) % 7 != 3, o, d)


def _host_walks(monkeypatch):
    """B8 and B9 of ``accel.stream`` launched from the host build."""
    monkeypatch.setattr(ST, "stream_closest", host_stream_closest)
    monkeypatch.setattr(ST, "occlusion_stream", host_stream_occlusion)


def _wavefront_case(scenes, case):
    name, fields, kw = WAVEFRONT_CASES[case]
    scene = scenes[name]
    o, d = _wavefront_rays()
    kw = dict(kw)
    if kw.get("smb_kill"):
        kw["smb_kill"] = uniform4(torch.arange(o.shape[0]), 97, SEED, salt=0x53B0)[0] < 0.5
    return scene, o, d, PTConfig(**fields), kw


@pytest.mark.parametrize("case", sorted(WAVEFRONT_CASES))
def test_wavefront_on_host(host_kernels, wavefront_scenes, monkeypatch, case):
    """The kernel path of trace_reference (B8, the vertex kernel, B9 a
    bounce, with the host builds of all three) against the plain wavefront
    on 4,096 camera rays: the bounce-0 ShadedHit bit for bit (the
    Moller-Trumbore epilogue's operations are exact on both); the radiance
    of 90% of the rays bit for bit, of 99.9% to 1e-4 relative and of every
    ray to 1e-2 (1e-6 absolute). The host's cosf, sinf and rsqrtf (1 /
    sqrtf here) round an ulp away from PyTorch's CPU kernels in the BSDF
    samples, and the ulp grows along the later vertices of a path (on the
    card both sides use the card's functions). One vertex launch a bounce;
    the random streams follow ``pix0``."""
    scene, o, d, cfg, kw = _wavefront_case(wavefront_scenes, case)
    want = PT.trace_reference_plain(scene, o, d, SEED, cfg, **kw)
    _host_walks(monkeypatch)
    before = native.launches["zr_wavefront_vertex"]
    got = PT.trace_wavefront(scene, o, d, SEED, cfg, **kw)
    assert native.launches["zr_wavefront_vertex"] == before + cfg.max_bounces + 1
    if kw.get("return_first_hit"):
        (want, sh_want), (got, sh_got) = want, got
        for a, b in zip(sh_got, sh_want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert (want.sum(1) > 0).sum() > 10
    assert (got == want).all(1).float().mean() >= 0.9
    assert torch.isclose(got, want, rtol=1e-4, atol=1e-6).all(1).float().mean() >= 0.999
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("kind", ["clustered", "dense", "cutout", "textures", "sky"])
def test_wavefront_dispatch(wavefront_scenes, tmp_path, monkeypatch, kind):
    """``wavefront_eligible``: the vertex kernel takes trace_reference's
    bounces on a clustered scene only, and not with alpha cutout, with
    ``textures`` or with a sky. On CPU tensors trace_reference takes the
    plain wavefront in every case and never enters the kernel path."""
    from zetaray_tpu_torch.scene.procedural import cutout_box, textured_box
    from zetaray_tpu_torch.scene.textures import load_scene_textures

    cfg, textures = PTConfig(max_bounces=1), None
    scene = wavefront_scenes["box546"]
    if kind == "dense":
        scene = upload_scene(cornell_box(), device="cpu")
    elif kind == "cutout":
        scene = upload_scene(cutout_box(tmp_path), device="cpu", cluster_size=128)
        assert scene.has_cutout
    elif kind == "textures":
        cpu = textured_box(tmp_path)
        scene = upload_scene(cpu, device="cpu", cluster_size=128)
        textures = load_scene_textures(cpu, device="cpu")
    elif kind == "sky":
        cfg = PTConfig(max_bounces=1, sky=SkyParams(sun_dir=(0.2, 0.45, 0.87)))
    assert PT.wavefront_eligible(scene, cfg, textures) == (kind == "clustered")

    def refuse(*a, **kw):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(PT, "trace_wavefront", refuse)
    o, d = (x[::64].contiguous() for x in _wavefront_rays())
    before = native.launches["zr_wavefront_vertex"]
    rad = PT.trace_reference(scene, o, d, SEED, cfg, textures=textures)
    assert rad.shape == o.shape and native.launches["zr_wavefront_vertex"] == before


def test_wavefront_ray_counter_adds_no_operation_or_sync(host_kernels, wavefront_scenes,
                                                         monkeypatch):
    """The vertex kernel's ray count (``stats.count_rays("wavefront", n)``,
    beside B8's and B9's) comes from shapes on the host: the kernel path
    runs the same operators and counts the same syncs in a profiled frame
    with it as without it, hands it Python ints, and the frame's record
    holds the rays of each kernel: max_bounces + 1 vertex launches and B8
    launches, and a B9 launch per NEE bounce."""
    from zetaray_tpu_torch.utils import stats as TST
    from zetaray_tpu_torch.utils.stats import FrameStats

    scene, o, d, cfg, _ = _wavefront_case(wavefront_scenes, "di")
    _host_walks(monkeypatch)
    handed = []
    count = FrameStats.count_rays

    def spy(self, kernel, n):
        handed.append(type(n))
        count(self, kernel, n)

    def profiled():
        rec = FrameStats()
        monkeypatch.setattr(TST, "stats", rec)
        monkeypatch.setattr(PT, "stats", rec)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with rec.frame():
                PT.trace_wavefront(scene, o, d, SEED, cfg)
        ops = [e.name for e in prof.events() if e.name.startswith("aten::")]
        return sorted(ops), rec.last

    PT.trace_wavefront(scene, o, d, SEED, cfg)  # the walks' rows, cached
    monkeypatch.setattr(FrameStats, "count_rays", spy)
    ops_on, fr_on = profiled()
    monkeypatch.setattr(FrameStats, "count_rays", lambda self, kernel, n: None)
    ops_off, fr_off = profiled()
    n = o.shape[0]
    assert fr_on.profiled and not fr_off.rays
    assert fr_on.rays == {"B8": 5 * n, "wavefront": 5 * n, "B9": 3 * n}
    assert set(handed) == {int} and len(handed) == 13
    assert ops_on == ops_off and fr_on.syncs == fr_off.syncs
