"""Carry scenes, cameras and frame state over from the JAX package.

Each converter takes numpy arrays (for example ``np.asarray`` of each field
of the JAX object) and never imports JAX, so a test can start the port from
exactly the state the JAX frame reached.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .render.frame import FrameState
from .scene.camera import Camera
from .scene.scene import SceneBuffers, buffers_from_arrays


def scene_from_arrays(d: dict, device=None) -> SceneBuffers:
    """Fields of a JAX ``SceneBuffers`` (numpy arrays and Python scalars)
    -> the port's scene on ``device`` (default: the card). Dense and
    clustered scenes are ported, with glass and coated materials and alpha
    cutout (the ``has_transmission``/``has_coat``/``has_cutout`` flags and
    the ``alpha_tex`` atlas are taken over). A clustered scene gets its
    traversal tree from ``cluster_aabb``, and the TPU-only ``woop_stream``,
    ``stream_attrs`` and ``stream_tcap`` are not read."""
    return buffers_from_arrays(d, device)


def camera_from_arrays(d: dict) -> Camera:
    """Fields of a JAX ``Camera`` -> the port's camera."""
    vec = lambda k: np.asarray(d[k], np.float32).reshape(3)
    jitter = np.asarray(d.get("jitter", (0.0, 0.0)), np.float64).reshape(2)
    return Camera(
        eye=vec("eye"), right=vec("right"), up=vec("up"), forward=vec("forward"),
        tan_half_fov=float(d["tan_half_fov"]), aspect=float(d["aspect"]),
        lens_radius=float(d.get("lens_radius", 0.0)),
        focus_dist=float(d.get("focus_dist", 1.0)),
        jitter=(float(jitter[0]), float(jitter[1])),
    )


def frame_state_from_arrays(d: dict, device=None) -> FrameState:
    """Fields of a JAX ``FrameState`` (``camera_prev`` as a dict of camera
    fields) -> the port's state on ``device`` (default: the card). The
    indirect reservoirs may be ReSTIR GI's 16 rows or ReSTIR PT's 58; the
    rows are copied bit for bit (PT's SRCSEED row holds u32 bits), and so
    are SkyDI's ``sky_reservoirs`` and the upscaler's ``upscale_lock`` where
    the state has them."""
    device = native.default_device(device)
    t = lambda k: torch.from_numpy(np.array(d[k], np.float32)).to(device)
    opt = lambda k: None if d.get(k) is None else t(k)
    return FrameState(
        reservoirs=t("reservoirs"), gi_reservoirs=t("gi_reservoirs"), gbuf=t("gbuf"),
        camera_prev=camera_from_arrays(d["camera_prev"]), history=t("history"),
        sky_reservoirs=opt("sky_reservoirs"), upscale_lock=opt("upscale_lock"),
    )
