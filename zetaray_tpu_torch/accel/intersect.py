"""Any-hit occlusion queries (kernel B3).

``occlusion`` replaces the TPU kernel ``_occlusion_kernel``
(the JAX package's ``accel/pallas_kernels.py``, launched by ``occlusion_pallas``)
with ``csrc/occlusion.cu``. Like the G-buffer kernel it is bound by the
per-pair Woop arithmetic, not by bytes. The TPU swept every ray tile over
every triangle chunk; on the card each thread stops at its ray's first hit
and a block leaves the triangle loop once all its rays are occluded. That
saves work only where most rays are blocked: for the Cornell box's shadow
segments (about 73% unoccluded) it runs as long as the G-buffer kernel
(5.6 ms at 512^2 against 8192 triangles on an H100 80GB HBM3, 700 W).
"""

from __future__ import annotations

import torch

from .. import native
from .megakernel import INF, TRI_CHUNK, RAY_CHUNK, tri_hits


def occlusion_plain(woop: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_min, t_max):
    """The plain PyTorch version: bool [N], True where a hit lies in (t_min, t_max)."""
    n = o.shape[0]
    tp = woop.shape[1] // 3
    w3 = woop.reshape(4, 3, tp)
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for r0 in range(0, n, RAY_CHUNK):
        rs = slice(r0, min(n, r0 + RAY_CHUNK))
        for c0 in range(0, tp, TRI_CHUNK):
            t, _, _ = tri_hits(w3[:, :, c0 : c0 + TRI_CHUNK], o[rs], d[rs], t_min, t_max)
            occ[rs] |= (t < INF).any(1)
    return occ


def occlusion(woop: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_min=1e-4, t_max=INF):
    """Any-hit query of rays or segments o, d [N, 3] against woop [4, 3*Tp].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if o.device.type == "cpu":
        return occlusion_plain(woop, o, d, t_min, t_max)
    n = o.shape[0]
    tp = woop.shape[1] // 3
    native.require_cuda(o, "o", torch.float32, (n, 3))
    native.require_cuda(d, "d", torch.float32, (n, 3))
    native.require_cuda(woop, "woop", torch.float32, (4, 3 * tp))
    if tp % TRI_CHUNK:
        raise ValueError(f"triangle count {tp} is not padded to a multiple of {TRI_CHUNK}")
    out = torch.empty((n,), dtype=torch.int32, device=o.device)
    err = native.lib().zr_occlusion(
        o.data_ptr(), d.data_ptr(), woop.data_ptr(), out.data_ptr(), n, tp,
        float(t_min), float(t_max), native.stream_ptr(o.device),
    )
    native.check(err, "occlusion")
    occlusion.launches += 1
    return out.bool()


occlusion.launches = 0


def intersect_occluded(scene, o: torch.Tensor, d: torch.Tensor, t_min=1e-4, t_max=None):
    """Occlusion against the scene's triangles (the dense path)."""
    return occlusion(scene.woop, o.contiguous(), d.contiguous(), t_min,
                     INF if t_max is None else t_max)
