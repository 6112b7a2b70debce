"""Sun and sky, as the JAX package's ``ops/sky.py``: a single-scattering
atmosphere integrated into a sky-view LUT, and the closed-form sky that the
path kernels B4-B6 evaluate for rays that miss the scene.

- ``build_sky_view_lut`` + ``sample_sky_lut``: numerical single scattering
  (Rayleigh + Mie, exponential atmosphere) into a lat/long LUT;
- ``sky_radiance``: the closed-form approximation of the same model, with
  or without the sun disk;
- ``sun_disk`` and ``sun_irradiance``: the sun's smooth-edged disk and the
  irradiance it gives a surface facing it (the sun NEE's light).

Every function follows its JAX counterpart operation for operation. The
sun's direction is normalised in float64 with numpy, then cast to float32,
as the JAX package does. A division by a constant goes through a tensor
divisor (``_div``): PyTorch on CUDA multiplies by the reciprocal of a Python
scalar divisor, which would round differently on the card than on the CPU.

``kernel_constants`` hands the kernels the float32 values of one
``SkyParams``; the parameters that do not depend on it are written into the
kernels' ``layout.h`` (``native.layout_header``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import vec3 as v3
from ..core.vec3 import V3

# Earth-like constants (km)
_PLANET_R = 6360.0
_ATMOS_R = 6460.0
_RAYLEIGH_H = 8.0
_MIE_H = 1.2
_BETA_R = np.array([5.802e-3, 13.558e-3, 33.1e-3], np.float32)  # /km
_BETA_M = np.array([3.996e-3, 3.996e-3, 3.996e-3], np.float32)
_MIE_G = 0.8

# Sun disk radiance = intensity * SUN_RADIANCE_SCALE; the sun's direct
# irradiance is then a few times the whole sky's.
SUN_RADIANCE_SCALE = 2500.0
SUN_COLOR = (1.0, 0.96, 0.9)


@dataclass(frozen=True)
class SkyParams:
    """Field names and defaults follow the JAX package."""

    sun_dir: tuple = (0.32, 0.92, 0.22)  # toward the sun; normalised on use
    sun_intensity: float = 20.0
    sun_angular_radius: float = 0.00465  # radians
    ground_albedo: float = 0.3


def sun_direction(params: SkyParams) -> np.ndarray:
    """The unit direction toward the sun, float32 [3] (normalised in float64)."""
    sun = np.asarray(params.sun_dir, np.float64)
    return (sun / np.linalg.norm(sun)).astype(np.float32)


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s with an IEEE division on every device (see the module notes)."""
    return x / torch.full_like(x, s)


def _rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    """s / x as one IEEE division (``s / x`` is ``x.reciprocal() * s``)."""
    return torch.full_like(x, s) / x


def _phase_rayleigh(c):
    return 3.0 / (16.0 * math.pi) * (1.0 + c * c)


def _phase_mie(c, g=_MIE_G):
    g2 = g * g
    den = 1.0 + g2 - 2.0 * g * c
    return _rdiv(1.0 - g2, 4.0 * math.pi * den * torch.sqrt(torch.clamp_min(den, 1e-6)))


def _atmosphere_intersect(h0, mu):
    """March distance from altitude h0 along cos-zenith mu: to the top of
    the atmosphere, or to the ground for rays below the horizon."""
    r = _PLANET_R + h0
    b = r * mu
    disc_a = b * b - (r * r - _ATMOS_R * _ATMOS_R)
    t_atm = -b + torch.sqrt(torch.clamp_min(disc_a, 0.0))
    disc_g = b * b - (r * r - _PLANET_R * _PLANET_R)
    t_gnd = -b - torch.sqrt(torch.clamp_min(disc_g, 0.0))
    hits_ground = (disc_g > 0.0) & (t_gnd > 0.0)
    return torch.where(hits_ground, t_gnd, t_atm)


def build_sky_view_lut(params: SkyParams, width=256, height=128, steps=32,
                       device="cpu") -> torch.Tensor:
    """Numerical single-scattering sky-view LUT [height, width, 3]: rows are
    the view zenith (0 = up), columns the azimuth relative to the sun."""
    sun = np.asarray(params.sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    cos_sun_z = sun[1]
    f32 = dict(dtype=torch.float32, device=device)

    vz = torch.linspace(0.0, math.pi, height, **f32)  # view zenith angle
    az = torch.linspace(0.0, 2.0 * math.pi, width, **f32)  # azimuth from the sun
    zz, aa = torch.meshgrid(vz, az, indexing="ij")
    mu = torch.cos(zz)
    # the view direction with the sun in the x/y plane (sun azimuth 0)
    sun_xz = float(np.sqrt(max(1e-12, 1.0 - cos_sun_z * cos_sun_z)))
    cos_view_sun = mu * float(cos_sun_z) + torch.sin(zz) * torch.cos(aa) * sun_xz

    h0 = 0.2  # camera altitude km
    t_max = _atmosphere_intersect(h0, mu)
    beta_r = torch.tensor(_BETA_R, **f32)
    beta_m = torch.tensor(_BETA_M, **f32)
    beta_m_ext = beta_m * 1.11
    sun_mu = np.float32(np.clip(cos_sun_z, 0.02, 1.0))  # a float32 scalar, as in JAX
    path_r, path_m = float(np.float32(_RAYLEIGH_H) / sun_mu), float(np.float32(_MIE_H) / sun_mu)
    phase_r = _phase_rayleigh(cos_view_sun)[..., None]
    phase_m = _phase_mie(cos_view_sun)[..., None]
    dt = _div(t_max, float(steps))

    l_acc = torch.zeros((height, width, 3), **f32)
    tr = torch.ones((height, width, 3), **f32)
    for i in range(steps):  # the JAX LUT's fori_loop
        t = (i + 0.5) / steps * t_max
        r = torch.sqrt((_PLANET_R + h0) ** 2 + t * t + 2.0 * (_PLANET_R + h0) * t * mu)
        h = torch.clamp_min(r - _PLANET_R, 0.0)
        dens_r = torch.exp(-_div(h, _RAYLEIGH_H))
        dens_m = torch.exp(-_div(h, _MIE_H))
        ext = beta_r * dens_r[..., None] + beta_m_ext * dens_m[..., None]
        tr_step = torch.exp(-ext * dt[..., None])
        # the sun's transmittance from the sample (flat approximation)
        sun_path_r = path_r * dens_r
        sun_path_m = path_m * dens_m
        tr_sun = torch.exp(-(beta_r * sun_path_r[..., None] + beta_m_ext * sun_path_m[..., None]))
        scat = beta_r * dens_r[..., None] * phase_r + beta_m * dens_m[..., None] * phase_m
        l_acc = l_acc + tr * tr_sun * scat * dt[..., None]
        tr = tr * tr_step
    return l_acc * params.sun_intensity


def sample_sky_lut(lut: torch.Tensor, d: torch.Tensor, params: SkyParams) -> torch.Tensor:
    """The LUT at directions d [N, 3] (nearest texel) plus the sun disk: [N, 3]."""
    h, w, _ = lut.shape
    sun = np.asarray(params.sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    zen = torch.arccos(torch.clamp(d[:, 1], -1.0, 1.0))
    # azimuth relative to the sun
    sun_flat = torch.tensor([sun[0], 0.0, sun[2]], dtype=torch.float32, device=d.device)
    sun_flat = sun_flat / torch.clamp_min(torch.sqrt((sun_flat * sun_flat).sum()), 1e-6)
    sx, sz = float(sun_flat[0]), float(sun_flat[2])
    d_norm = torch.clamp_min(torch.sqrt(d[:, 0] * d[:, 0] + d[:, 2] * d[:, 2]), 1e-6)
    cos_az = torch.clamp((d[:, 0] * sx + d[:, 2] * sz) / d_norm, -1.0, 1.0)
    az = torch.arccos(cos_az)
    iy = torch.clamp((_div(zen, math.pi) * (h - 1)).to(torch.int64), 0, h - 1)
    ix = torch.clamp((_div(az, math.pi) * 0.5 * (w - 1)).to(torch.int64), 0, w - 1)
    return lut[iy, ix] + sun_disk(d, params)


def sun_irradiance(params: SkyParams) -> np.ndarray:
    """Irradiance from the sun disk on a surface facing it, float32 [3]."""
    omega = np.pi * params.sun_angular_radius**2
    return (params.sun_intensity * SUN_RADIANCE_SCALE * omega * np.asarray(SUN_COLOR)
            ).astype(np.float32)


def _disk_den(params: SkyParams) -> float:
    """The width of the disk's smooth edge in its cosine: max(1e-6, 1 - cos r)."""
    return max(1e-6, 1.0 - float(np.cos(params.sun_angular_radius)))


def _disk_edge(c: torch.Tensor, params: SkyParams) -> torch.Tensor:
    cos_r = float(np.cos(params.sun_angular_radius))
    return torch.clamp(_div(c - cos_r, _disk_den(params)) * 4.0, 0.0, 1.0)


def sun_disk(d: torch.Tensor, params: SkyParams) -> torch.Tensor:
    """The sun's radiance toward directions d [N, 3] (a smooth-edged disk): [N, 3]."""
    s = sun_direction(params)
    c = d[:, 0] * float(s[0]) + d[:, 1] * float(s[1]) + d[:, 2] * float(s[2])
    disk = _disk_edge(c, params) * params.sun_intensity * SUN_RADIANCE_SCALE
    return disk[:, None] * torch.tensor(SUN_COLOR, dtype=torch.float32, device=d.device)


def sky_radiance(d: V3, params: SkyParams, with_disk: bool = True) -> V3:
    """The closed-form sky toward directions d (a V3 of [N]): a Rayleigh
    gradient, a Mie glow around the sun and, ``with_disk``, the sun disk
    (off where the sun is sampled by NEE, so that BSDF rays do not count it
    twice)."""
    s = sun_direction(params)
    c = torch.clamp(v3.dot(d, V3(*(torch.full_like(d.x, float(x)) for x in s))), -1.0, 1.0)
    up = torch.clamp(d.y, -1.0, 1.0)
    # optical-depth proxy: a longer path near the horizon
    m = 1.0 / torch.clamp_min(up * 0.8 + 0.22, 0.05)
    beta_r = _BETA_R * _RAYLEIGH_H
    ray = _phase_rayleigh(c) * m
    mie = _phase_mie(c) * m * float(_BETA_M[0] * _MIE_H * 2.2)
    r = ray * float(beta_r[0]) + mie
    g = ray * float(beta_r[1]) + mie
    b = ray * float(beta_r[2]) + mie
    horizon_fade = torch.clamp((up + 0.08) * 12.0, 0.0, 1.0)
    scale = params.sun_intensity * horizon_fade
    if not with_disk:
        return V3(r * scale, g * scale, b * scale)
    disk = _disk_edge(c, params) * params.sun_intensity * SUN_RADIANCE_SCALE
    return V3(r * scale + disk * SUN_COLOR[0], g * scale + disk * SUN_COLOR[1],
              b * scale + disk * SUN_COLOR[2])


def layout_constants() -> dict:
    """The closed-form sky's parameters that no ``SkyParams`` changes, as
    the float32 values the kernels use ({C name: value})."""
    g = _MIE_G
    g2 = g * g
    beta_r = _BETA_R * _RAYLEIGH_H
    vals = {
        "SKY_RAYLEIGH": 3.0 / (16.0 * math.pi), "SKY_MIE_A": 1.0 + g2, "SKY_MIE_B": 2.0 * g,
        "SKY_MIE_NUM": 1.0 - g2, "SKY_FOUR_PI": 4.0 * math.pi,
        "SKY_MIE_K": float(_BETA_M[0] * _MIE_H * 2.2),
        "SKY_BETA_R0": float(beta_r[0]), "SKY_BETA_R1": float(beta_r[1]),
        "SKY_BETA_R2": float(beta_r[2]), "SKY_SUN_SCALE": SUN_RADIANCE_SCALE,
    }
    return {k: float(np.float32(v)) for k, v in vals.items()}


def kernel_constants(params: SkyParams) -> list[float]:
    """One ``SkyParams`` as the kernels read it, each value float32: the sun
    direction (3), the sky's intensity, cos of the disk's angular radius,
    max(1e-6, 1 - that cosine) (the divisor of ``_disk_edge``), SUN_COLOR
    (3) and ``sun_irradiance`` (3)."""
    vals = [*sun_direction(params), params.sun_intensity,
            float(np.cos(params.sun_angular_radius)), _disk_den(params), *SUN_COLOR,
            *sun_irradiance(params)]
    return [float(np.float32(v)) for v in vals]
