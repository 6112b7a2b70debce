"""Row-band sharded frames over ``torch.distributed``, as the JAX package's
``parallel/mesh.py``.

The JAX package shards a frame's image rows over a 1D device mesh under
``shard_map``; here each band is a process (a rank) of a
``torch.distributed`` group, one card a rank. The scene is replicated on
every rank. Each rank renders its band with global pixel ids, so every
random stream and light-set pick is the one the whole image draws there,
exchanges halo rows for every stencil pass (``parallel.halo``) and reduces
the exposure statistics over the group.

    tiles = init_tiles(world, rank, "tcp://localhost:29500", pick_backend(world))
    out, state = render_frame_restir_sharded(tiles, scene, camera, seed, cfg, state)
    image = gather_rows(out["hdr"], tiles)

``pick_backend`` is the rule of ``chip_smoke.py``: NCCL where every rank
has a card of its own, else gloo, with rank r on ``cuda:{r % cards}``
(NCCL refuses two ranks on one card). A band of a sharded frame equals
those rows of the whole frame where the band and the image pick the same
tile width (``render.frame.pick_rt``): the JAX tests' condition.

``run_ranks`` spawns a world of ranks in fresh processes, with a time limit
that ends them all; any rank's exception fails the call.

The JAX ``render_frame(shard_rays=...)`` is a layout hint for XLA's
partitioner and has no counterpart here: a band's rays are its own tensors.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, fields
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import native
from ..ops.pathtracer import trace
from ..render.frame import (
    FrameState, RenderConfig, _inscatter, _lens_u, _postprocess, pick_rt, render_frame_restir,
)
from .halo import ShardCtx, all_gather


@dataclass(frozen=True)
class Tiles:
    """One rank of a row-band world: its process group (None: the default
    group), rank, world size, device and backend."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str

    def shard(self, rows: int, halo: int = 16) -> ShardCtx:
        """The ``ShardCtx`` of an image of ``rows`` rows split over the world."""
        if rows % self.world:
            raise ValueError(f"{rows} image rows do not split into {self.world} bands")
        return ShardCtx(self.group, self.rank, self.world, rows // self.world, halo)


def pick_backend(world: int) -> str:
    """NCCL where the machine has a card for each of ``world`` ranks, else
    gloo (the ranks share cards)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_tiles(world: int, rank: int, init_method: str, backend: str, device=None,
               timeout: float = 300.0) -> Tiles:
    """Join the world's process group as ``rank`` (``init_method``: a
    ``tcp://`` address or a ``file://`` store; ``timeout`` seconds bound
    every collective). ``device``: where the rank renders; by default the
    card ``cuda:{rank % device_count}`` (without CUDA it raises unless
    ``device="cpu"`` is named, as ``native.default_device``)."""
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout))
    dev = native.default_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a card for each rank")
    return Tiles(None, rank, world, dev, backend)


def render_frame_sharded(tiles: Tiles, scene, camera, seed: int, cfg: RenderConfig):
    """One plain path-traced frame (``render.frame.render_frame``) with the
    image's rows split over the world: each rank traces its band's rays with
    their global ids (``pix0``; the band's tile width, ``pick_rt``), the
    bands are gathered, and every rank post-processes the whole image.
    Returns {"hdr": [H, W, 3] float32, "ldr": [H, W, 3] uint8}, the whole
    image, on every rank."""
    cfg.check_ported()
    w, h = cfg.width, cfg.height
    ctx = tiles.shard(h)
    dev = scene.device
    pix0 = ctx.row0 * w
    lens = _lens_u(camera, seed, w * h, dev)  # drawn by global pixel id
    if lens is not None:
        lens = lens[pix0 : pix0 + ctx.h_local * w]
    o, d = camera.generate_rays(w, h, lens, device=dev, rows=(ctx.row0, ctx.h_local))
    hdr = trace(scene, o, d, seed, cfg.pt, rt=pick_rt(ctx.h_local * w), rows_out=True,
                pix0=pix0).reshape(3, ctx.h_local, w)
    if cfg.volumetrics is not None and cfg.pt.sky is not None:
        from ..accel.megakernel import gbuffer

        hdr = _inscatter(scene, camera, gbuffer(scene, o, d), hdr, cfg, ctx.row0, h)
    hdr = torch.cat(all_gather(hdr, ctx), 1)
    ldr = _postprocess(hdr, cfg)
    return {"hdr": hdr.permute(1, 2, 0), "ldr": ldr.permute(1, 2, 0)}


def render_frame_restir_sharded(tiles: Tiles, scene, camera, seed: int, cfg: RenderConfig,
                                state: FrameState | None = None, halo: int = 16,
                                textures=None, motion=None):
    """One ``render_frame_restir`` frame split over the world by rows of
    the rendered image (the render resolution where ``render_scale`` < 1).
    Returns (this rank's band of the outputs, its band of the FrameState),
    which feeds its next call. ``halo`` bounds how far temporal reuse, TAA
    and the upscaler reach beyond a band: reuse beyond it is dropped."""
    if cfg.height % tiles.world:
        raise ValueError(f"{cfg.height} image rows do not split into {tiles.world} bands")
    _, h = cfg.render_size()
    return render_frame_restir(scene, camera, seed, cfg, state, textures=textures,
                               motion=motion, shard=tiles.shard(h, halo))


# the pixel axis of each FrameState table (history and locks are images)
_STATE_AXES = {"reservoirs": 1, "gi_reservoirs": 1, "gbuf": 1, "sky_reservoirs": 1,
               "history": 1, "upscale_lock": 0}


def gather_rows(x, tiles: Tiles, row_axis: int = 0):
    """The whole image from every rank's band: a tensor (its rows along
    ``row_axis``), a dict of them (a frame's outputs) or a ``FrameState``
    (each table along its pixel axis; the camera is every rank's)."""
    ctx = ShardCtx(tiles.group, tiles.rank, tiles.world, 0)
    if isinstance(x, dict):
        return {k: gather_rows(v, tiles, row_axis) for k, v in x.items()}
    if isinstance(x, FrameState):
        return FrameState(**{
            f.name: (getattr(x, f.name) if f.name not in _STATE_AXES
                     or getattr(x, f.name) is None
                     else gather_rows(getattr(x, f.name), tiles, _STATE_AXES[f.name]))
            for f in fields(FrameState)
        })
    return torch.cat(all_gather(x, ctx), row_axis)


def _to_host(x):
    """``x`` with its tensors as numpy arrays (passed between processes by value)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_entry(target: str, rank: int, world: int, init_method: str, args: tuple, out,
                blocked: tuple) -> None:
    for name in blocked:
        sys.modules[name] = None  # importing it raises in this process
    try:
        module, fn = target.split(":")
        result = getattr(importlib.import_module(module), fn)(rank, world, init_method, *args)
        out.put((rank, True, _to_host(result)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target: str, world: int, args: tuple = (), timeout: float = 600.0,
              blocked: tuple = ()) -> list:
    """Run ``target`` ("module:function", called as fn(rank, world,
    init_method, *args)) in ``world`` fresh processes and return their
    results in rank order, tensors as numpy arrays. ``init_method`` is a
    file store in a new temporary directory. Each process first makes the
    modules ``blocked`` unimportable. Any rank's exception, or ``timeout``
    seconds, ends every rank and raises; no process outlives the call."""
    ctx = mp.get_context("spawn")
    results, out = {}, ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(target, r, world, init, args, out, tuple(blocked)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{target}: {world} ranks did not finish in {timeout} s")
                try:
                    rank, ok, payload = out.get(timeout=min(left, 2.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"{target}: a rank exited with {dead[0]}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"{target}: rank {rank} failed:\n{payload}")
                results[rank] = payload
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [results[r] for r in range(world)]
