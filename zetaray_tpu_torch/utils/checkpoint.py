"""Frame-state checkpoint and resume, as the JAX package's
``utils/checkpoint.py``.

The temporal ``FrameState`` (reservoirs, the packed temporal G-buffer, the
TAA history, the previous camera, SkyDI's reservoirs and the upscaler's
locks where the frame has them) and the tweakable params' values go to one
``.npz``. The file is the JAX package's: the same keys and layouts, so a
checkpoint written by either package loads into the other. Where the
layouts differ, the file keeps the JAX one: the history is saved [H, W, 3]
(the port holds it [3, H, W]). Every float row is stored bit for bit, so
the packed G-buffer's normal bits and ReSTIR PT's seed bits survive.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import native


def save_frame_state(path: str, state, params_snapshot: dict | None = None) -> None:
    """Write ``state`` (a ``render.frame.FrameState``) and, where given, the
    params snapshot to ``path`` (``numpy.savez_compressed``)."""
    host = lambda t: t.detach().cpu().numpy()
    cam = state.camera_prev
    payload = {
        "reservoirs": host(state.reservoirs),
        "gi_reservoirs": host(state.gi_reservoirs),
        "gbuf": host(state.gbuf),
        "history": host(state.history.permute(1, 2, 0)),
        "cam_eye": np.asarray(cam.eye),
        "cam_right": np.asarray(cam.right),
        "cam_up": np.asarray(cam.up),
        "cam_forward": np.asarray(cam.forward),
        "cam_scalars": np.asarray(
            [float(cam.tan_half_fov), float(cam.aspect), float(cam.lens_radius),
             float(cam.focus_dist), float(cam.jitter[0]), float(cam.jitter[1])], np.float64),
    }
    if state.sky_reservoirs is not None:
        payload["sky_reservoirs"] = host(state.sky_reservoirs)
    if state.upscale_lock is not None:
        payload["upscale_lock"] = host(state.upscale_lock)
    if params_snapshot is not None:
        payload["params_json"] = np.frombuffer(json.dumps(params_snapshot).encode(), np.uint8)
    np.savez_compressed(path, **payload)


def load_frame_state(path: str, device=None):
    """(``FrameState`` on ``device``, params snapshot or None) from a
    checkpoint of either package. ``device``: default the card
    (``native.default_device``)."""
    from ..render.frame import FrameState
    from ..scene.camera import Camera

    device = native.default_device(device)
    z = np.load(path, allow_pickle=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    s = z["cam_scalars"]
    cam = Camera(
        eye=z["cam_eye"].astype(np.float32), right=z["cam_right"].astype(np.float32),
        up=z["cam_up"].astype(np.float32), forward=z["cam_forward"].astype(np.float32),
        tan_half_fov=float(s[0]), aspect=float(s[1]), lens_radius=float(s[2]),
        focus_dist=float(s[3]), jitter=(float(s[4]), float(s[5])),
    )
    state = FrameState(
        reservoirs=t(z["reservoirs"]), gi_reservoirs=t(z["gi_reservoirs"]), gbuf=t(z["gbuf"]),
        camera_prev=cam, history=t(z["history"]).permute(2, 0, 1).contiguous(),
        sky_reservoirs=t(z["sky_reservoirs"]) if "sky_reservoirs" in z else None,
        upscale_lock=t(z["upscale_lock"]) if "upscale_lock" in z else None,
    )
    params = json.loads(bytes(z["params_json"]).decode()) if "params_json" in z else None
    return state, params
