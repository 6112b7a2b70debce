"""Froxel volumetric inscattering, as the JAX package's ``ops/volumetrics.py``.

A frustum-aligned grid of X x Y screen tiles by Z depth slices spaced by a
power of the depth. Each froxel samples the atmosphere's density at its
altitude, the sun's transmittance down to it and, with ``sun_shadows``, one
occlusion segment toward the sun in (1e-3, 1e8) (kernel B3 on a dense
scene, B9 on a clustered one: 12,288 segments on the default 24 x 16 x 32
grid). In-scattered radiance and view transmittance accumulate front to
back along each tile's ray (a ``cumsum`` over the slices); the compositing
samples the grid trilinearly at each pixel's depth and applies
``color * Tr + Ls``.

The atmosphere works in km; ``unit_to_km`` converts scene units and
``density_scale`` thickens the medium for room-sized scenes. The sky
constants and the Mie phase are ``ops.sky``'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..accel.intersect import intersect_occluded
from ..accel.megakernel import G
from ..core.sampling import halton
from .sky import (
    _BETA_M, _BETA_R, _MIE_G, _MIE_H, _RAYLEIGH_H, _div, _phase_mie, _phase_rayleigh,
    sun_direction, sun_irradiance,
)


@dataclass(frozen=True)
class VolumetricsConfig:
    """Field names and defaults follow the JAX package."""

    grid: tuple = (24, 16, 32)  # (X, Y, Z slices)
    near: float = 0.05
    far: float = 30.0  # scene units
    depth_exp: float = 2.0  # slice spacing: depth ~ (k / Z) ** depth_exp
    unit_to_km: float = 0.001  # scene units -> km
    density_scale: float = 1.0  # medium boost for small scenes
    sun_shadows: bool = True  # one occlusion segment a froxel
    mie_only: bool = False  # no Rayleigh scattering


def _slice_depths(cfg: VolumetricsConfig, device) -> torch.Tensor:
    """[Z + 1] view-forward depths of the slice boundaries."""
    z = cfg.grid[2]
    k = torch.arange(z + 1, dtype=torch.float32, device=device)
    return cfg.near + (_div(k, z) ** cfg.depth_exp) * (cfg.far - cfg.near)


def froxel_points(camera, cfg: VolumetricsConfig, device, frame_idx: int = 0):
    """The froxels' sample points [Z, X*Y, 3], with the tiles' rays
    (directions [X*Y, 3]) and their slice lengths along the ray [Z, X*Y]."""
    x, y, z = cfg.grid
    o, d = camera.generate_rays(x, y, device=device)
    fwd = torch.tensor(np.asarray(camera.forward, np.float32), device=device)
    cosz = torch.clamp_min((d[:, 0] * fwd[0] + d[:, 1] * fwd[1]) + d[:, 2] * fwd[2], 1e-3)
    edges = _slice_depths(cfg, device)
    z0 = edges[:-1][:, None] / cosz[None, :]
    ds = (edges[1:] - edges[:-1])[:, None] / cosz[None, :]
    # the sample's place in its slice: Halton jitter of the frame
    t_mid = z0 + float(halton(int(frame_idx) % 8 + 1, 0)) * ds
    return o[None, :, :] + d[None, :, :] * t_mid[..., None], d, ds


def sun_segments(pos: torch.Tensor, sky):
    """The froxels' sun-shadow segments: origins [M, 3] and the sun's unit
    direction [M, 3], tested in (1e-3, 1e8)."""
    o = pos.reshape(-1, 3)
    sun = torch.tensor(sun_direction(sky), device=pos.device)
    return o, sun[None, :].expand(o.shape[0], 3).contiguous()


def build_froxels(scene, camera, sky, cfg: VolumetricsConfig, frame_idx: int = 0) -> dict:
    """{"ls": [Z, Y, X, 3] in-scattered radiance camera -> slice end,
    "tr": [Z, Y, X, 3] view transmittance camera -> slice end}."""
    x, y, z = cfg.grid
    dev = scene.device
    pos, d, ds = froxel_points(camera, cfg, dev, frame_idx)

    # the atmosphere's density at the sample's altitude
    h_km = torch.clamp_min(pos[..., 1] * cfg.unit_to_km, 0.0)
    dens_r = torch.exp(-_div(h_km, _RAYLEIGH_H)) * cfg.density_scale
    if cfg.mie_only:
        dens_r = dens_r * 0.0
    dens_m = torch.exp(-_div(h_km, _MIE_H)) * cfg.density_scale

    sun = sun_direction(sky)
    sun_mu = max(float(sun[1]), 1e-2)
    # the sun's transmittance down to the sample (flat atmosphere)
    sun_path_r = _RAYLEIGH_H / sun_mu * dens_r
    sun_path_m = _MIE_H / sun_mu * dens_m
    beta_r = torch.tensor(_BETA_R, device=dev)
    beta_m = torch.tensor(_BETA_M, device=dev)
    tr_sun = torch.exp(-(beta_r * sun_path_r[..., None] + beta_m * sun_path_m[..., None]))
    if cfg.sun_shadows:
        occ = intersect_occluded(scene, *sun_segments(pos, sky), t_min=1e-3, t_max=1e8)
        tr_sun = tr_sun * (~occ).reshape(z, x * y)[..., None].to(torch.float32)

    ds_km = ds * cfg.unit_to_km
    dtau = (beta_r * dens_r[..., None] + beta_m * dens_m[..., None]) * ds_km[..., None]
    tau = torch.cumsum(dtau, 0)
    tr = torch.exp(-tau)  # camera -> slice end
    tr_mid = torch.exp(-(tau - 0.5 * dtau))  # to the slice's own sample

    cos_theta = (d[:, 0] * float(sun[0]) + d[:, 1] * float(sun[1])) + d[:, 2] * float(sun[2])
    ph_r = _phase_rayleigh(cos_theta)[None, :, None]
    ph_m = _phase_mie(cos_theta, _MIE_G)[None, :, None]
    sigma_s = beta_r * dens_r[..., None] * ph_r + beta_m * dens_m[..., None] * ph_m
    # a directional light scatters the sun's irradiance, as surface NEE does
    e_sun = torch.tensor(sun_irradiance(sky), device=dev)
    s_slice = e_sun * tr_sun * sigma_s * ds_km[..., None] * tr_mid
    ls = torch.cumsum(s_slice, 0)
    return {"ls": ls.reshape(z, y, x, 3), "tr": tr.reshape(z, y, x, 3)}


def _trilinear(grid: torch.Tensor, u, v, s) -> torch.Tensor:
    """grid [Z, Y, X, 3] at screen coordinates u, v in [0, 1] and fractional
    slice index s: [N, 3]."""
    zn, yn, xn, _ = grid.shape
    fx = torch.clamp(u * xn - 0.5, 0.0, xn - 1.0)
    fy = torch.clamp(v * yn - 0.5, 0.0, yn - 1.0)
    fz = torch.clamp(s, 0.0, zn - 1.0)
    x0, y0, z0 = (torch.floor(f).to(torch.int64) for f in (fx, fy, fz))
    x1 = torch.clamp_max(x0 + 1, xn - 1)
    y1 = torch.clamp_max(y0 + 1, yn - 1)
    z1 = torch.clamp_max(z0 + 1, zn - 1)
    wx, wy, wz = ((f - i)[:, None] for f, i in ((fx, x0), (fy, y0), (fz, z0)))
    flat = grid.reshape(-1, 3)
    at = lambda zi, yi, xi: flat[(zi * yn + yi) * xn + xi]
    c00 = at(z0, y0, x0) * (1 - wx) + at(z0, y0, x1) * wx
    c01 = at(z0, y1, x0) * (1 - wx) + at(z0, y1, x1) * wx
    c10 = at(z1, y0, x0) * (1 - wx) + at(z1, y0, x1) * wx
    c11 = at(z1, y1, x0) * (1 - wx) + at(z1, y1, x1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def slice_of_depth(zv: torch.Tensor, cfg: VolumetricsConfig) -> torch.Tensor:
    """View-forward depth -> fractional slice index (the inverse mapping)."""
    t = torch.clamp(_div(zv - cfg.near, max(cfg.far - cfg.near, 1e-6)), 0.0, 1.0)
    return t ** (1.0 / cfg.depth_exp) * cfg.grid[2] - 0.5


def apply_inscattering(hdr, gbuf, camera, froxels: dict, cfg: VolumetricsConfig,
                       width: int, height: int, row0: int = 0) -> torch.Tensor:
    """hdr [3, H, W] -> hdr * Tr(depth) + Ls(depth), each pixel at its
    primary hit's view depth (the grid's far plane where the ray missed).
    A row band of a ``height``-row image passes the image row of its first
    row as ``row0``."""
    _, h, w = hdr.shape
    dev = hdr.device
    xs = _div(torch.arange(w, dtype=torch.float32, device=dev) + 0.5, w)
    ys = _div(torch.arange(h, dtype=torch.float32, device=dev) + row0 + 0.5, height)
    u = xs.repeat(h)
    v = torch.repeat_interleave(ys, w)
    valid = gbuf[G.VALID] > 0.5
    # the stored depth is the ray parameter; view-forward z = t * cos
    fwd = [float(c) for c in np.asarray(camera.forward, np.float32)]
    cosz = torch.clamp_min(-((gbuf[G.WO] * fwd[0] + gbuf[G.WO + 1] * fwd[1])
                             + gbuf[G.WO + 2] * fwd[2]), 1e-3)
    s = slice_of_depth(torch.where(valid, gbuf[G.DEPTH] * cosz, cfg.far), cfg)
    tr = _trilinear(froxels["tr"], u, v, s)
    ls = _trilinear(froxels["ls"], u, v, s)
    return (hdr.reshape(3, h * w) * tr.T + ls.T).reshape(3, h, w)
