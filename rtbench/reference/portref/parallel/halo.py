"""Row-halo exchange for row-band sharding over ``torch.distributed``, as the
JAX package's ``parallel/halo.py``.

A sharded frame gives each rank a band of ``h_local`` consecutive image
rows. Stencil passes (spatial reuse, temporal reprojection, a-trous, TAA,
the upscaler, RCAS) read a bounded number of rows beyond the band; each
exchange extends a band by ``halo`` rows on both sides, taken from the
neighbouring ranks.

The exchange is circular, as the JAX one is (which matches ``torch.roll``):
rank 0's top halo is the last rank's bottom rows. A circular stencil (the
a-trous and firefly rolls) on a halo-extended band then equals the whole
image's, and gather-based consumers clamp their coordinates to the image
and never read the wrapped rows. ``halo_exchange_rows_clamped`` replicates
the image's first and last rows instead, for consumers whose whole-image
form clamps at the border (the resamplers, RCAS's cross).

The JAX exchange is a ``ppermute`` ring over the TPU's interconnect. Here
every rank contributes its top and bottom strips (its whole band when the
halo is taller than the band) to one ``all_gather`` and takes its
neighbours' strips from the result. ``all_gather`` and ``all_reduce`` are
the collectives that both NCCL and gloo offer; gloo's ``all_gather`` takes
host tensors only, so with gloo a CUDA tensor is copied to the host for
either collective and the result copied back. A neighbour-only ring (NCCL's
``batch_isend_irecv``) would move (n_shards - 1) times fewer bytes.

``stats`` counts the collectives, the bytes each rank receives from the
others in them and, where gloo stages CUDA tensors through the host, the
seconds from the card's last queued work to the result's return to it (the
card is synchronized before and after: the copies to the host wait for it
anyway); NCCL's collectives run in the stream and are not timed here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

stats = {"bytes": 0, "calls": 0, "seconds": 0.0}


@dataclass(frozen=True)
class ShardCtx:
    """The row-band sharding of one frame: the process group, this rank,
    the number of ranks (bands), the image rows of a band and the rows a
    temporal pass may reach beyond its band (``halo``)."""

    group: object  # a torch.distributed process group; None: the default group
    rank: int
    n_shards: int
    h_local: int
    halo: int = 16

    @property
    def row0(self) -> int:
        """The global image row of this rank's first row."""
        return self.rank * self.h_local


def _take(x, sl, row_axis: int):
    idx = [slice(None)] * x.ndim
    idx[row_axis] = sl
    return x[tuple(idx)]


def _host_staged(x: torch.Tensor, ctx: ShardCtx) -> bool:
    """Whether a collective on ``x`` goes through the host: gloo takes host
    tensors only for ``all_gather``, and both collectives take one path."""
    return x.is_cuda and dist.get_backend(ctx.group) == "gloo"


def _count(sent: torch.Tensor, ctx: ShardCtx, t0, device) -> None:
    """Count a collective of ``sent`` (one rank's part); with ``t0`` its
    host-staged time up to its result's arrival on ``device``."""
    if t0 is not None:
        torch.cuda.synchronize(device)
        stats["seconds"] += time.perf_counter() - t0
    stats["bytes"] += sent.numel() * sent.element_size() * (ctx.n_shards - 1)
    stats["calls"] += 1


def _start(x: torch.Tensor, staged: bool):
    if not staged:
        return None
    torch.cuda.synchronize(x.device)
    return time.perf_counter()


def all_gather(x: torch.Tensor, ctx: ShardCtx) -> list[torch.Tensor]:
    """Every rank's ``x`` (of one shape), in rank order, on ``x``'s device
    (a bool mask travels as bytes)."""
    staged = _host_staged(x, ctx)
    t0 = _start(x, staged)
    src = x.contiguous()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(ctx.n_shards)]
    dist.all_gather(parts, src, group=ctx.group)
    out = [p.to(device=x.device, dtype=x.dtype) for p in parts]
    _count(src, ctx, t0, x.device)
    return out


def all_reduce_sum(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor on ``x``'s device)."""
    if ctx.n_shards == 1:
        return x.clone()
    staged = _host_staged(x, ctx)
    t0 = _start(x, staged)
    red = x.detach().clone()
    if staged:
        red = red.cpu()
    dist.all_reduce(red, op=dist.ReduceOp.SUM, group=ctx.group)
    out = red.to(x.device)
    _count(red, ctx, t0, x.device)
    return out


def halo_exchange_rows(x: torch.Tensor, halo: int, ctx: ShardCtx, row_axis: int = 0):
    """``x`` (this rank's band along ``row_axis``) extended by ``halo`` image
    rows on both sides, circularly. A halo taller than the band reaches
    across several ranks; with one rank the band wraps onto itself."""
    h_loc = x.shape[row_axis]
    n = ctx.n_shards
    gather = (lambda t: [t]) if n == 1 else (lambda t: all_gather(t, ctx))
    if halo <= h_loc:
        # each rank sends its first and last ``halo`` rows
        strips = gather(torch.cat([_take(x, slice(None, halo), row_axis),
                                   _take(x, slice(h_loc - halo, None), row_axis)], row_axis))
        top = _take(strips[(ctx.rank - 1) % n], slice(halo, None), row_axis)
        bot = _take(strips[(ctx.rank + 1) % n], slice(None, halo), row_axis)
    else:
        bands = gather(x)
        hops = -(-halo // h_loc)
        above = torch.cat([bands[(ctx.rank - hops + j) % n] for j in range(hops)], row_axis)
        below = torch.cat([bands[(ctx.rank + 1 + j) % n] for j in range(hops)], row_axis)
        top = _take(above, slice(above.shape[row_axis] - halo, None), row_axis)
        bot = _take(below, slice(None, halo), row_axis)
    return torch.cat([top, x, bot], row_axis)


def halo_exchange_flat(arr: torch.Tensor, width: int, halo: int, ctx: ShardCtx):
    """SoA rows [R, h_local * width] -> [R, (h_local + 2 halo) * width]."""
    rows = arr.shape[0]
    h_loc = arr.shape[1] // width
    ext = halo_exchange_rows(arr.reshape(rows, h_loc, width), halo, ctx, row_axis=1)
    return ext.reshape(rows, (h_loc + 2 * halo) * width)


def halo_exchange_rows_clamped(x: torch.Tensor, halo: int, ctx: ShardCtx,
                               row_axis: int = 0):
    """As ``halo_exchange_rows``, but the halo rows above the image's first
    row and below its last replicate that row (the first and the last rank;
    the other ranks' halos are the circular ones)."""
    ext = halo_exchange_rows(x, halo, ctx, row_axis)
    rows = ext.shape[row_axis]
    h_loc = x.shape[row_axis]
    lo = halo if ctx.rank == 0 else 0
    hi = halo + h_loc - 1 if ctx.rank == ctx.n_shards - 1 else rows - 1
    if lo == 0 and hi == rows - 1:
        return ext
    src = torch.clamp(torch.arange(rows, device=x.device), lo, hi)
    return torch.index_select(ext, row_axis, src)
