"""Primary-hit G-buffer (kernel B1) and the presampled light sets.

Layouts shared with the JAX package's ``accel/megakernel.py``: the 40-row G-buffer
``G`` and the ``[NS, LSET_ROWS, PS]`` light sets.

``gbuffer`` replaces the TPU kernel ``_gbuffer_kernel``
(the JAX package's ``accel/megakernel.py``, closest hit in ``_closest_soa``) with
``csrc/gbuffer.cu``. On the card it is bound by arithmetic, not bytes: every
ray tests every triangle (Woop transform, one IEEE division, edge tests),
about 40 float operations per pair, while the rays and the 40 output rows
are a few hundred bytes each. The kernel keeps that arithmetic fed: one
thread per ray, triangles streamed through shared memory in 128-wide chunks
read as broadcasts, the division only for planes the ray crosses, and the
edge tests cut short. The one-hot-matmul attribute fetch of the TPU is
gone: after the loop each thread reads its winner's attribute row by index.
Measured on an H100 80GB HBM3 (700 W): 5.6 ms for 512^2 rays against 8192
triangles, about 380 G ray-triangle tests per second.
"""

from __future__ import annotations

import torch

from ..core import vec3 as v3
from ..core.rng import uniform4
from ..core.rows import stack_rows
from ..core.vec3 import V3
from ..ops.lights import sample_emissive
from ..scene.scene import A
from .. import native

INF = 3.0e38
LSET_ROWS = 16  # 0-2 pos | 3-5 ng | 6-8 Le | 9 pdf_area | 10 two_sided
PS = 128  # presampled light samples per set
NS = 64  # number of presampled sets
TRI_CHUNK = 128  # triangle chunk of the closest-hit tie rule
RAY_CHUNK = 1 << 16  # rays per step of the plain version (bounds its memory)


class G:
    """G-buffer rows ([G.ROWS, N] float32)."""

    POS = 0  # 3
    NS = 3  # 3 shading normal (flipped toward the viewer)
    NG = 6  # 3 geometric normal (flipped)
    BASE = 9  # 3
    METAL = 12
    ROUGH = 13
    IOR = 14
    VALID = 15
    DEPTH = 16
    WO = 17  # 3 unit direction toward the camera
    EMISS = 20  # 3 emitted radiance toward the camera
    EM_PDF_AREA = 23
    UV = 24  # 2
    TEXID = 26
    TRANS = 27
    ETA = 28
    COATW = 29
    COATR = 30
    MATID = 31
    TANG = 32  # 3
    UVDENS = 35
    INST = 36
    ROWS = 40


def tri_hits(w: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_min, t_max):
    """Woop test of rays [R, 3] against a chunk w [4, 3, C]: (t, u, v), each
    [R, C], t = INF where the ray misses or t is outside (t_min, t_max)."""

    def local(r):
        lo = (w[0, r] * o[:, 0:1] + w[1, r] * o[:, 1:2]) + w[2, r] * o[:, 2:3] + w[3, r]
        ld = (w[0, r] * d[:, 0:1] + w[1, r] * d[:, 1:2]) + w[2, r] * d[:, 2:3]
        return lo, ld

    ou, du = local(0)
    ov, dv = local(1)
    ow, dw = local(2)
    par = torch.abs(dw) < 1e-12
    t = -ow / torch.where(par, 1.0, dw)
    u = ou + t * du
    v = ov + t * dv
    valid = (~par) & (t > t_min) & (t < t_max) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(valid, t, INF), u, v


def closest_hit_plain(woop: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_min=1e-4):
    """Closest hit by chunks of 128 triangles with the kernel's tie rule:
    (t [N], tri [N] int64 (-1 = miss), u [N], v [N])."""
    n = o.shape[0]
    tp = woop.shape[1] // 3
    w3 = woop.reshape(4, 3, tp)
    best_t = torch.full((n,), INF, dtype=torch.float32, device=o.device)
    best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    bu = torch.zeros((n,), dtype=torch.float32, device=o.device)
    bv = torch.zeros_like(bu)
    for r0 in range(0, n, RAY_CHUNK):
        rs = slice(r0, min(n, r0 + RAY_CHUNK))
        for c0 in range(0, tp, TRI_CHUNK):
            t, u, v = tri_hits(w3[:, :, c0 : c0 + TRI_CHUNK], o[rs], d[rs], t_min, INF)
            tmin = t.min(1).values
            col = torch.arange(t.shape[1], device=o.device)
            idx = torch.where(t == tmin[:, None], col, -1).max(1).values
            better = tmin < best_t[rs]
            pick = idx.clamp_min(0)[:, None]
            best_t[rs] = torch.where(better, tmin, best_t[rs])
            best[rs] = torch.where(better, c0 + idx, best[rs])
            bu[rs] = torch.where(better, u.gather(1, pick)[:, 0], bu[rs])
            bv[rs] = torch.where(better, v.gather(1, pick)[:, 0], bv[rs])
    return best_t, best, bu, bv


def gbuffer_plain(scene, o: torch.Tensor, d: torch.Tensor, t_min=1e-4) -> torch.Tensor:
    """The plain PyTorch version of the G-buffer kernel: [G.ROWS, N]."""
    n = o.shape[0]
    t_hit, tri, bu, bv = closest_hit_plain(scene.woop, o, d, t_min)
    hit = tri >= 0
    at = torch.where(hit[:, None], scene.tri_attrs[tri.clamp_min(0)], 0.0).T
    ov = V3(o[:, 0], o[:, 1], o[:, 2])
    dv = V3(d[:, 0], d[:, 1], d[:, 2])
    ng_raw = v3.from_rows(at, A.NG)
    front = -v3.dot(dv, ng_raw) > 0.0
    sgn = torch.where(front, 1.0, -1.0)
    ng = ng_raw * sgn
    w0 = 1.0 - bu - bv
    ns = v3.normalize(
        v3.from_rows(at, A.N0) * w0 + v3.from_rows(at, A.N1) * bu + v3.from_rows(at, A.N2) * bv
    ) * sgn
    ns = v3.where(v3.dot(ns, ng) < 0.0, -ns, ns)
    pos = ov + dv * t_hit
    le_gain = torch.where(hit & ((at[A.DOUBLE] > 0.5) | front), 1.0, 0.0)
    ior = torch.clamp_min(at[A.IOR], 1.01)
    neg1 = lambda x: torch.where(hit, x, -1.0)
    rows = {
        G.POS: pos.x, G.POS + 1: pos.y, G.POS + 2: pos.z,
        G.NS: ns.x, G.NS + 1: ns.y, G.NS + 2: ns.z,
        G.NG: ng.x, G.NG + 1: ng.y, G.NG + 2: ng.z,
        G.BASE: at[A.BASE], G.BASE + 1: at[A.BASE + 1], G.BASE + 2: at[A.BASE + 2],
        G.METAL: at[A.METAL], G.ROUGH: at[A.ROUGH], G.IOR: ior,
        G.VALID: hit.to(torch.float32),
        G.DEPTH: torch.where(hit, t_hit, 0.0),
        G.WO: -dv.x, G.WO + 1: -dv.y, G.WO + 2: -dv.z,
        G.EMISS: at[A.EMISS] * le_gain, G.EMISS + 1: at[A.EMISS + 1] * le_gain,
        G.EMISS + 2: at[A.EMISS + 2] * le_gain,
        G.EM_PDF_AREA: at[A.EM_PDF_AREA],
        G.UV: w0 * at[A.UV0] + bu * at[A.UV1] + bv * at[A.UV2],
        G.UV + 1: w0 * at[A.UV0 + 1] + bu * at[A.UV1 + 1] + bv * at[A.UV2 + 1],
        G.TEXID: neg1(at[A.TEXID]),
        G.TRANS: at[A.TRANS],
        G.ETA: torch.where(front, 1.0 / ior, ior),
        G.COATW: at[A.COATW], G.COATR: at[A.COATR],
        G.MATID: neg1(at[A.MATID]),
        G.TANG: at[A.TANG], G.TANG + 1: at[A.TANG + 1], G.TANG + 2: at[A.TANG + 2],
        G.UVDENS: at[A.UVDENS],
        G.INST: neg1(at[A.INSTID]),
    }
    return stack_rows(G.ROWS, rows)


def gbuffer(scene, o: torch.Tensor, d: torch.Tensor, t_min=1e-4) -> torch.Tensor:
    """Primary-hit G-buffer: rays o, d [N, 3] -> [G.ROWS, N].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if o.device.type == "cpu":
        return gbuffer_plain(scene, o, d, t_min)
    n = o.shape[0]
    tp = scene.woop.shape[1] // 3
    native.require_cuda(o, "o", torch.float32, (n, 3))
    native.require_cuda(d, "d", torch.float32, (n, 3))
    native.require_cuda(scene.woop, "woop", torch.float32, (4, 3 * tp))
    native.require_cuda(scene.tri_attrs, "tri_attrs", torch.float32, (tp, A.WIDTH))
    if tp % TRI_CHUNK:
        raise ValueError(f"triangle count {tp} is not padded to a multiple of {TRI_CHUNK}")
    out = torch.empty((G.ROWS, n), dtype=torch.float32, device=o.device)
    err = native.lib().zr_gbuffer(
        o.data_ptr(), d.data_ptr(), scene.woop.data_ptr(), scene.tri_attrs.data_ptr(),
        out.data_ptr(), n, tp, t_min, native.stream_ptr(o.device),
    )
    native.check(err, "gbuffer")
    gbuffer.launches += 1
    return out


gbuffer.launches = 0


def build_light_sets(scene, seed: int, ns: int = NS, ps: int = PS) -> torch.Tensor:
    """Presampled emissive sets [ns, LSET_ROWS, ps] (salt 0xBEEF)."""
    n = ns * ps
    pix = torch.arange(n, dtype=torch.int64, device=scene.device)
    ls = sample_emissive(scene, uniform4(pix, 0, seed, salt=0xBEEF))
    rows = torch.zeros((LSET_ROWS, n), dtype=torch.float32, device=scene.device)
    rows[0:3] = ls.pos.T
    rows[3:6] = ls.ng.T
    rows[6:9] = ls.le.T
    rows[9] = ls.pdf_area
    rows[10] = ls.two_sided.to(torch.float32)
    return rows.reshape(LSET_ROWS, ns, ps).permute(1, 0, 2).contiguous()
