"""The ranks of the port's row-band sharded tests (``test_torch_halo.py``,
``test_torch_parallel.py``): functions that ``parallel.mesh.run_ranks``
calls in fresh processes, gloo on the CPU, with JAX made unimportable
(``blocked=("jax",)``): the sharded port runs alone. Each returns numpy
arrays to the test, which holds them to the JAX package or to the port's
whole-image frames.
"""

import numpy as np
import torch

from zetaray_tpu_torch.parallel import halo as HX
from zetaray_tpu_torch.parallel import mesh
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from zetaray_tpu_torch.scene.scene import upload_scene

BLOCKED = ("jax",)


def camera(k: int, width: int, height: int, lens: bool = False) -> Camera:
    """Frame k's camera: the box's framing at the image's aspect, the eye
    drifting right and up (so reprojections move across rows), Halton
    jitter; with ``lens`` a thin lens focused on the boxes."""
    eye = (CAMERA_EYE[0] + 0.03 * k, CAMERA_EYE[1] + 0.02 * k, CAMERA_EYE[2])
    opts = dict(f_stop=2.8, focal_length_mm=50.0, focus_dist=3.5) if lens else {}
    return Camera.look_at(eye, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=width / height,
                          **opts).with_jitter(k)


def _tiles(rank, world, init_method):
    torch.set_num_threads(1)
    return mesh.init_tiles(world, rank, init_method, "gloo", device="cpu", timeout=120.0)


def halo_cases(rank, world, init_method, cases):
    """Each case (name, x [H, ...] or [R, H * W], halo, row_axis, kind):
    this rank's band of x through ``kind`` ("rows", "flat" or "clamped")."""
    tiles = _tiles(rank, world, init_method)
    out = {}
    for name, x, halo, row_axis, kind in cases:
        x = torch.from_numpy(x)
        if kind == "flat":
            width = x.shape[1] // (world * 4)  # the flat cases hold 4 rows a rank
            n = x.shape[1] // world
            ctx = tiles.shard(world * 4, halo)
            out[name] = HX.halo_exchange_flat(x[:, rank * n : (rank + 1) * n], width, halo, ctx)
            continue
        rows = x.shape[row_axis] // world
        band = x.narrow(row_axis, rank * rows, rows)
        ctx = tiles.shard(x.shape[row_axis], halo)
        fn = HX.halo_exchange_rows_clamped if kind == "clamped" else HX.halo_exchange_rows
        out[name] = fn(band, halo, ctx, row_axis)
    return out


def frames(rank, world, init_method, specs):
    """Each spec (name, cfg, seeds, lens): the frames of ``seeds`` chained
    through ``render_frame_restir_sharded`` (a name starting "plain":
    ``render_frame_sharded``) on the box; the gathered HDR and LDR of each
    frame, the gathered last state's tables and the bytes each rank's
    exchanges received."""
    tiles = _tiles(rank, world, init_method)
    scene = upload_scene(cornell_box(), device="cpu")
    out = {}
    for name, cfg, seeds, lens in specs:
        state = None
        HX.stats["bytes"] = 0
        for k, seed in enumerate(seeds):
            cam = camera(k, cfg.width, cfg.height, lens)
            if name.startswith("plain"):
                res = mesh.render_frame_sharded(tiles, scene, cam, seed, cfg)
            else:
                res, state = mesh.render_frame_restir_sharded(tiles, scene, cam, seed, cfg,
                                                              state)
                res = mesh.gather_rows(res, tiles)
            out[name, k] = {"hdr": res["hdr"], "ldr": res["ldr"]}
        if state is not None:
            whole = mesh.gather_rows(state, tiles)
            out[name, "state"] = {k: getattr(whole, k) for k in mesh._STATE_AXES
                                  if getattr(whole, k) is not None}
        out[name, "bytes"] = HX.stats["bytes"]
    return out


def jax_state_frames(rank, world, init_method, cfg, seeds, cams, states):
    """Frame k of the port, sharded, from the JAX package's sharded state
    after frame k - 1 (``states``: whole-image numpy tables, None for frame
    0; ``cams``: the JAX cameras as ``interop`` dicts)."""
    from zetaray_tpu_torch.interop import camera_from_arrays, frame_state_from_arrays

    tiles = _tiles(rank, world, init_method)
    scene = upload_scene(cornell_box(), device="cpu")
    w, h = cfg.render_size()
    rows = h // world
    out = []
    for k, seed in enumerate(seeds):
        state = None
        if states[k] is not None:
            whole = dict(states[k])
            for key, axis in mesh._STATE_AXES.items():
                if whole.get(key) is not None:
                    a = np.asarray(whole[key])
                    n = a.shape[axis] // world
                    whole[key] = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)
            state = frame_state_from_arrays(whole, device="cpu")
        res, new_state = mesh.render_frame_restir_sharded(tiles, scene,
                                                          camera_from_arrays(cams[k]), seed,
                                                          cfg, state)
        gathered = mesh.gather_rows(new_state, tiles)
        out.append({"hdr": mesh.gather_rows(res["hdr"], tiles),
                    "gi_reservoirs": gathered.gi_reservoirs, "rows": rows})
    return out
