"""Spherical harmonics (bands 0-2), as the JAX package's ``core/sh.py``: the
reference's SH stdlib (Common/SH.hlsli:1-85, after Sloan "Stupid SH
Tricks" 2008).

The Cartesian real SH basis, the clamped-cosine (irradiance) convolution
constants, projection and reconstruction, and a diffuse sky light probe:
the sky dome projected into 9 RGB coefficients convolved for irradiance
E(n). Every function broadcasts over leading dims, on the device of its
inputs. The probe's sample directions come from the port's own random
stream (``core.rng.uniform4``), not from ``jax.random``.
"""

from __future__ import annotations

import math

import torch

# Zonal SH coefficients of f(theta) = max(cos theta, 0) and the SH
# convolution weights lambda_l = sqrt(4 pi / (2l + 1)) (SH.hlsli:5-23).
COS_THETA_SH = (0.8862268925, 1.0233267546, 0.4954159260)
LAMBDA_L = (3.544907701, 2.046653415, 1.585330919)
# lambda_l * cos_theta_sh_l: the irradiance convolution kernel A_l
# (SH.hlsli LAMBDA_LxCOS_THETA_SH; == pi, 2pi/3, pi/4 for l = 0, 1, 2)
A_L = (3.141592536, 2.094395197, 0.785398185)
PROBE_SALT = 0x5348  # the fourth pcg4d counter of the probe's directions


def sh_basis9(w: torch.Tensor) -> torch.Tensor:
    """Real SH basis, bands 0-2, at unit directions w [..., 3]: [..., 9] in
    the order (00, 1-1, 10, 11, 2-2, 2-1, 20, 21, 22), the Cartesian forms
    of SH.hlsli's SHBasis* functions."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([
        0.2820947917738781 * torch.ones_like(x),
        0.4886025119029199 * y,
        0.4886025119029199 * z,
        0.4886025119029199 * x,
        1.0925484305920792 * x * y,
        1.0925484305920792 * y * z,
        0.31539156525252 * (3.0 * z * z - 1.0),
        1.0925484305920792 * x * z,
        0.5462742152960396 * (x * x - y * y),
    ], -1)


def project_to_sh1(w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """First-band projection y_i(w) * f (SH.hlsli ProjectToSH1): [..., 4] =
    the (00, 1-1, 10, 11) coefficients."""
    return sh_basis9(w)[..., :4] * f[..., None]


def project_function(dirs: torch.Tensor, values: torch.Tensor, weights=None) -> torch.Tensor:
    """Quadrature projection of a spherical function onto 9 SH
    coefficients: dirs [N, 3] unit directions, values [N] or [N, C],
    weights [N] the solid angle of each sample (default: uniform over the
    sphere, 4 pi / N). Returns [9] or [9, C]."""
    v = values if values.ndim > 1 else values[:, None]
    if weights is None:
        weights = torch.full((dirs.shape[0],), 4.0 * math.pi / dirs.shape[0],
                             dtype=dirs.dtype, device=dirs.device)
    coeffs = torch.einsum("ni,nc,n->ic", sh_basis9(dirs), v, weights)
    return coeffs if values.ndim > 1 else coeffs[:, 0]


def eval_sh9(coeffs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The projected function at directions w [..., 3]: coeffs [9] or
    [9, C] -> [...] or [..., C]."""
    y = sh_basis9(w)
    if coeffs.ndim == 1:
        return y @ coeffs
    return torch.einsum("...i,ic->...c", y, coeffs)


def irradiance_sh9(coeffs: torch.Tensor) -> torch.Tensor:
    """Radiance SH convolved with the clamped-cosine kernel: coefficients
    that evaluate to diffuse irradiance E(n) (divide by pi for Lambertian
    outgoing radiance). [9] or [9, C]."""
    a = torch.tensor([A_L[0]] + [A_L[1]] * 3 + [A_L[2]] * 5, dtype=torch.float32,
                     device=coeffs.device)
    return coeffs * (a if coeffs.ndim == 1 else a[:, None])


def probe_directions(n_samples: int, seed: int, device=None) -> torch.Tensor:
    """[n_samples, 3] directions uniform over the sphere, from
    ``uniform4(i, 0, seed, PROBE_SALT)``, on ``device`` (default: the card,
    as ``native.default_device`` resolves it)."""
    from .. import native
    from .rng import uniform4

    dev = native.default_device(device)
    u0, u1, _, _ = uniform4(torch.arange(n_samples, device=dev), 0, seed, PROBE_SALT)
    z = 1.0 - 2.0 * u0
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = (2.0 * math.pi) * u1
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def sky_irradiance_probe(sky, n_samples: int = 4096, seed: int = 7, device=None):
    """The sky dome (``ops.sky``'s analytic model, no sun disk) projected
    into 9 RGB coefficients convolved for irradiance -- a diffuse sky light
    probe, [9, 3] on ``device`` (default: the card); evaluate it with
    ``eval_sh9(probe, normals)``."""
    from ..ops import sky as SK
    from .vec3 import V3

    dirs = probe_directions(n_samples, seed, device)
    rad = SK.sky_radiance(V3(dirs[:, 0], dirs[:, 1], dirs[:, 2]), sky, with_disk=False)
    return irradiance_sh9(project_function(dirs, torch.stack([rad.x, rad.y, rad.z], -1)))
