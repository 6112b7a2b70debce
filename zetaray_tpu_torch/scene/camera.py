"""Pinhole and thin-lens camera with Halton TAA jitter, as the JAX package's
``scene/camera.py``.

The camera is a small frozen record of host values (numpy float32 vectors
and Python floats). Ray generation runs on the card unless the caller names
another device, reprojection on the device of the points it is given, both
in float32 -- the precision the JAX frame traces the camera's scalars at.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import native
from ..core import transforms as T
from ..core.sampling import halton_jitter, square_to_disk_concentric


@dataclass(frozen=True)
class Camera:
    eye: np.ndarray  # [3]
    right: np.ndarray  # [3] unit
    up: np.ndarray  # [3] unit
    forward: np.ndarray  # [3] unit
    tan_half_fov: float  # vertical
    aspect: float  # width / height
    lens_radius: float = 0.0  # 0 => pinhole
    focus_dist: float = 1.0
    jitter: tuple[float, float] = (0.0, 0.0)  # sub-pixel, in pixels

    @staticmethod
    def look_at(
        eye, target, up=(0.0, 1.0, 0.0), vfov_deg: float = 60.0,
        aspect: float = 16.0 / 9.0, f_stop: float = 0.0,
        focal_length_mm: float = 50.0, focus_dist: float | None = None,
    ) -> "Camera":
        m = T.look_at(eye, target, up)
        lens_radius = 0.0
        if f_stop > 0.0:
            lens_radius = (focal_length_mm / 1000.0) / (2.0 * f_stop)
        fd = focus_dist
        if fd is None:
            fd = float(np.linalg.norm(np.asarray(target, float) - np.asarray(eye, float)))
        return Camera(
            eye=m[:3, 3].astype(np.float32),
            right=m[:3, 0].astype(np.float32),
            up=m[:3, 1].astype(np.float32),
            forward=(-m[:3, 2]).astype(np.float32),
            tan_half_fov=float(np.tan(np.radians(vfov_deg) * 0.5)),
            aspect=aspect,
            lens_radius=lens_radius,
            focus_dist=fd,
        )

    def with_jitter(self, frame: int) -> "Camera":
        return replace(self, jitter=halton_jitter(frame))

    def pixel_spread_angle(self, height: int) -> float:
        """Angle one pixel subtends, for ray cones."""
        return 2.0 * self.tan_half_fov / height

    def _vec(self, name: str, device) -> torch.Tensor:
        return torch.tensor(np.asarray(getattr(self, name), np.float32), device=device)

    def _scalar(self, v: float, device) -> torch.Tensor:
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    def generate_rays(self, width: int, height: int, lens_u: torch.Tensor | None = None,
                      device=None, rows: tuple[int, int] | None = None):
        """Primary rays through pixel centres (+ jitter): ([N, 3], [N, 3]) on
        ``device`` (default: the card; ``native.default_device``).
        ``lens_u`` ([N, 2] uniforms) moves each origin onto the lens disk
        and aims it at the pixel's point on the focus plane where
        ``lens_radius`` > 0 (thin-lens depth of field); without it the
        rays leave the eye. ``rows`` = (row0, n_rows): only the rays of
        that band of image rows of the ``width`` x ``height`` image."""
        device = native.default_device(device)
        f32 = torch.float32
        jx = self._scalar(self.jitter[0], device)
        jy = self._scalar(self.jitter[1], device)
        thf = self._scalar(self.tan_half_fov, device)
        aspect = self._scalar(self.aspect, device)
        px = (torch.arange(width, dtype=f32, device=device) + 0.5 + jx) / width
        row0, n_rows = (0, height) if rows is None else rows
        py = (torch.arange(n_rows, dtype=f32, device=device) + row0 + 0.5 + jy) / height
        sx = (2.0 * px - 1.0) * (aspect * thf)
        sy = (1.0 - 2.0 * py) * thf
        sx = sx[None, :].expand(n_rows, width).reshape(-1)
        sy = sy[:, None].expand(n_rows, width).reshape(-1)
        right, up, fwd = (self._vec(k, device) for k in ("right", "up", "forward"))
        d = sx[:, None] * right + sy[:, None] * up + fwd
        eye = self._vec("eye", device)
        if self.lens_radius > 0.0 and lens_u is not None:
            p_focus = eye + d * self._scalar(self.focus_dist, device)
            disk = square_to_disk_concentric(lens_u.to(device)) * self._scalar(
                self.lens_radius, device)
            o = eye + disk[:, 0:1] * right + disk[:, 1:2] * up
            d = p_focus - o
        else:
            o = eye.expand(d.shape).contiguous()
        nrm = torch.sqrt((d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2]) + d[:, 2:3] * d[:, 2:3])
        return o, d / nrm

    def project(self, p: torch.Tensor, width: int, height: int):
        """World points [N, 3] -> (px, py, depth along forward)."""
        dev = p.device
        rel = p - self._vec("eye", dev)

        def along(name):
            a = self._vec(name, dev)
            return (rel[:, 0] * a[0] + rel[:, 1] * a[1]) + rel[:, 2] * a[2]

        u, v, w = along("right"), along("up"), along("forward")
        thf = self._scalar(self.tan_half_fov, dev)
        aspect = self._scalar(self.aspect, dev)
        w_safe = torch.clamp_min(w, 1e-6)
        sx = u / (w_safe * aspect * thf)
        sy = v / (w_safe * thf)
        px = (sx + 1.0) * 0.5 * width - 0.5
        py = (1.0 - sy) * 0.5 * height - 0.5
        return px, py, w
