"""SoA shading math, as the JAX package's ``ops/shading_soa.py`` for opaque materials.

Lambert diffuse plus GGX reflection (height-correlated Smith, Schlick
Fresnel) with the Kulla-Conty multiple-scattering term, its one-sample
lobe-mixture sampler (GGX VNDF or cosine hemisphere) and the power
heuristic, over ``V3``s of tensors. The operations follow the JAX package in the same order, so the
two agree to float rounding. The transmission and coat lobes are not ported
yet: ``upload_scene`` refuses materials that need them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import vec3 as v3
from ..core.vec3 import V3

_MIN_ALPHA = 1e-4
_INV_PI = 1.0 / 3.14159265358979


class MatSoA(NamedTuple):
    base: V3
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor


class Frame(NamedTuple):
    t: V3
    b: V3
    n: V3

    def to_local(self, w: V3) -> V3:
        return V3(v3.dot(w, self.t), v3.dot(w, self.b), v3.dot(w, self.n))

    def to_world(self, w: V3) -> V3:
        return self.t * w.x + self.b * w.y + self.n * w.z


def make_frame(n: V3) -> Frame:
    """Duff et al. branchless orthonormal basis around ``n``."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = V3(b, s + n.y * n.y * a, -n.y)
    return Frame(t, bt, n)


def _f0_from_ior(ior):
    r = (ior - 1.0) / (ior + 1.0)
    return r * r


def _fresnel(f0: V3, cos_h) -> V3:
    m = torch.clamp(1.0 - cos_h, 0.0, 1.0)
    m5 = (m * m) * (m * m) * m
    return f0 + (v3.splat(1.0) - f0) * m5


def _ggx_d(a2, cos_h):
    c2 = cos_h * cos_h
    den = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(3.14159265 * den * den, 1e-12)


def _smith_lambda(a2, cos_t):
    c2 = torch.clamp(cos_t * cos_t, 1e-8, 1.0)
    return 0.5 * (torch.sqrt(1.0 + a2 * (1.0 - c2) / c2) - 1.0)


def _g1(a2, c):
    return 1.0 / (1.0 + _smith_lambda(a2, c))


def _g2(a2, co, ci):
    return 1.0 / (1.0 + _smith_lambda(a2, co) + _smith_lambda(a2, ci))


def _lobe_params(mat: MatSoA):
    alpha = torch.clamp_min(mat.roughness * mat.roughness, _MIN_ALPHA)
    f0d = _f0_from_ior(mat.ior)
    m = mat.metallic
    f0 = V3(
        f0d * (1.0 - m) + mat.base.x * m,
        f0d * (1.0 - m) + mat.base.y * m,
        f0d * (1.0 - m) + mat.base.z * m,
    )
    return alpha, f0, mat.base * (1.0 - m)


def _lobe_probs(f0: V3, kd: V3, cos_o):
    """(q_spec, q_diff): one-sample lobe selection probabilities."""
    s = v3.luminance(_fresnel(f0, cos_o))
    d = v3.luminance(kd)
    q_s = torch.clamp(s / torch.clamp_min(s + d, 1e-8), 0.05, 1.0)
    return q_s, 1.0 - q_s


def _fit_ggx_albedo_poly(deg: int = 3):
    """Polynomial fit of the single-scatter GGX directional albedo E(mu, a)
    and its cosine-weighted average, by VNDF quadrature (numpy, at import).
    The same computation as the JAX package, so the coefficients agree."""
    nmu, na = 32, 32
    mu = np.linspace(0.02, 1.0, nmu)
    al = np.linspace(0.04, 1.0, na)
    ns = 48
    g1, g2g = np.meshgrid(
        (np.arange(ns) + 0.5) / ns, (np.arange(ns) + 0.5) / ns, indexing="ij"
    )
    u1 = g1.reshape(-1)
    u2 = g2g.reshape(-1)

    def lam(a2, c):
        c2 = np.clip(c * c, 1e-8, 1.0)
        return 0.5 * (np.sqrt(1.0 + a2 * (1.0 - c2) / c2) - 1.0)

    e = np.zeros((nmu, na))
    for i, m in enumerate(mu):
        so = np.sqrt(max(1.0 - m * m, 0.0))
        for k, a in enumerate(al):
            alpha = a * a
            a2 = alpha * alpha
            vx, vy, vz = so * alpha, 0.0, m
            vl = np.sqrt(vx * vx + vy * vy + vz * vz)
            vx, vy, vz = vx / vl, vy / vl, vz / vl
            lensq = vx * vx + vy * vy
            if lensq > 1e-12:
                inv = 1.0 / np.sqrt(lensq)
                t1 = np.array([-vy * inv, vx * inv, 0.0])
            else:
                t1 = np.array([1.0, 0.0, 0.0])
            t2 = np.cross(np.array([vx, vy, vz]), t1)
            r = np.sqrt(u1)
            phi = 2.0 * np.pi * u2
            p1 = r * np.cos(phi)
            p2 = r * np.sin(phi)
            s = 0.5 * (1.0 + vz)
            p2 = (1.0 - s) * np.sqrt(np.maximum(0.0, 1.0 - p1 * p1)) + s * p2
            p3 = np.sqrt(np.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))
            nh = (
                p1[:, None] * t1[None]
                + p2[:, None] * t2[None]
                + p3[:, None] * np.array([vx, vy, vz])[None]
            )
            h = np.stack(
                [alpha * nh[:, 0], alpha * nh[:, 1], np.maximum(nh[:, 2], 1e-6)], -1
            )
            h /= np.linalg.norm(h, axis=-1, keepdims=True)
            wo = np.array([so, 0.0, m])
            wi = 2.0 * (h @ wo)[:, None] * h - wo
            up = wi[:, 2] > 1e-6
            g2 = 1.0 / (1.0 + lam(a2, m) + lam(a2, np.clip(wi[:, 2], 1e-6, 1.0)))
            g1v = 1.0 / (1.0 + lam(a2, m))
            e[i, k] = np.mean(np.where(up, g2 / g1v, 0.0))
    e = np.clip(e, 1e-3, 1.0)

    mm, aa = np.meshgrid(mu, al, indexing="ij")
    basis = np.stack(
        [mm**i * aa**j for i in range(deg + 1) for j in range(deg + 1)], -1
    ).reshape(-1, (deg + 1) ** 2)
    coef, *_ = np.linalg.lstsq(basis, e.reshape(-1), rcond=None)
    dmu = mu[1] - mu[0]
    e_avg = 2.0 * np.sum(e * mu[:, None] * dmu, axis=0)
    basis_a = np.stack([al**j for j in range(deg + 2)], -1)
    coef_a, *_ = np.linalg.lstsq(basis_a, e_avg, rcond=None)
    return tuple(float(c) for c in coef), tuple(float(c) for c in coef_a), deg


_GGX_E_COEF, _GGX_EAVG_COEF, _GGX_E_DEG = _fit_ggx_albedo_poly()


def ggx_albedo(cos_o, rough):
    """Fitted single-scatter GGX directional albedo E(cos_o, roughness)."""
    d = _GGX_E_DEG
    out = 0.0
    idx = 0
    mi = torch.clamp(cos_o, 0.02, 1.0)
    ai = torch.clamp(rough, 0.04, 1.0)
    mp = 1.0
    for _i in range(d + 1):
        ap = 1.0
        for _j in range(d + 1):
            out = out + _GGX_E_COEF[idx] * mp * ap
            idx += 1
            ap = ap * ai
        mp = mp * mi
    return torch.clamp(out, 0.05, 1.0)


def ggx_albedo_avg(rough):
    """Fitted cosine-weighted average GGX albedo E_avg(roughness)."""
    ai = torch.clamp(rough, 0.04, 1.0)
    out = 0.0
    ap = 1.0
    for c in _GGX_EAVG_COEF:
        out = out + c * ap
        ap = ap * ai
    return torch.clamp(out, 0.05, 1.0)


def _ms_lobe(f0: V3, rough, cos_o, cos_i) -> V3:
    """Kulla-Conty multiple-scattering lobe for GGX reflection."""
    e_o = ggx_albedo(cos_o, rough)
    e_i = ggx_albedo(cos_i, rough)
    e_avg = ggx_albedo_avg(rough)
    ms = (1.0 - e_o) * (1.0 - e_i) / (3.14159265 * torch.clamp_min(1.0 - e_avg, 1e-4))
    f_avg = f0 + (v3.splat(1.0) - f0) * (1.0 / 21.0)

    def fres(fa):
        return fa * fa * e_avg / torch.clamp_min(1.0 - fa * (1.0 - e_avg), 1e-4)

    return V3(ms * fres(f_avg.x), ms * fres(f_avg.y), ms * fres(f_avg.z))


def bsdf_eval(mat: MatSoA, wo: V3, wi: V3):
    """(f [V3], pdf) in the local frame; zero below the surface."""
    alpha, f0, kd = _lobe_params(mat)
    a2 = alpha * alpha
    cos_o = torch.clamp_min(wo.z, 1e-6)
    q_s, q_d = _lobe_probs(f0, kd, cos_o)
    up = wi.z > 1e-6
    cos_i = torch.clamp_min(wi.z, 1e-6)

    h = v3.normalize(wo + wi, eps=1e-24)
    cos_h = torch.clamp(h.z, 0.0, 1.0)
    odoth = torch.clamp_min(v3.dot(wo, h), 1e-6)
    dt = _ggx_d(a2, cos_h)
    g2 = _g2(a2, cos_o, cos_i)
    fr = _fresnel(f0, odoth)
    f_ms = _ms_lobe(f0, mat.roughness, cos_o, cos_i)
    f_refl = fr * (dt * g2 / (4.0 * cos_o * cos_i)) + f_ms + kd * _INV_PI
    pdf_spec = _g1(a2, cos_o) * dt / (4.0 * cos_o)
    pdf_refl = q_s * pdf_spec + q_d * (cos_i * _INV_PI)

    zero = torch.zeros_like(cos_o)
    f = v3.where(up, f_refl, V3(zero, zero, zero))
    return f, torch.where(up, pdf_refl, 0.0)


def _cosine_hemisphere(u1, u2) -> V3:
    """Concentric-disk cosine-weighted hemisphere direction."""
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    cond = torch.abs(a) > torch.abs(b)
    r = torch.where(cond, a, b)
    safe = torch.where(r == 0.0, 1.0, r)
    phi = torch.where(
        cond, (math.pi / 4.0) * (b / safe), (math.pi / 2.0) - (math.pi / 4.0) * (a / safe)
    )
    phi = torch.where(r == 0.0, 0.0, phi)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    return V3(x, y, z)


def _ggx_vndf(wo: V3, alpha, u1, u2) -> V3:
    """Heitz 2018 visible-normal sample of the GGX half vector."""
    v = v3.normalize(V3(wo.x * alpha, wo.y * alpha, wo.z))
    lensq = v.x * v.x + v.y * v.y
    safe = torch.rsqrt(torch.clamp_min(lensq, 1e-20))
    big = lensq > 1e-12
    t1 = V3(torch.where(big, -v.y * safe, 1.0), torch.where(big, v.x * safe, 0.0),
            torch.zeros_like(v.x))
    t2 = v3.cross(v, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = t1 * p1 + t2 * p2 + v * p3
    return v3.normalize(V3(alpha * nh.x, alpha * nh.y, torch.clamp_min(nh.z, 1e-6)))


def bsdf_sample(mat: MatSoA, wo: V3, u1, u2, u3):
    """Sample wi from the two-lobe mixture (GGX reflection or diffuse).
    Returns (wi [V3], weight f*|cos|/pdf [V3], pdf)."""
    alpha, f0, kd = _lobe_params(mat)
    cos_o = torch.clamp_min(wo.z, 1e-6)
    q_s, _ = _lobe_probs(f0, kd, cos_o)
    pick_spec = u1 < q_s
    h = _ggx_vndf(wo, alpha, u2, u3)
    wi_spec = h * (2.0 * v3.dot(wo, h)) - wo
    wi_diff = _cosine_hemisphere(u2, u3)
    wi = v3.where(pick_spec, wi_spec, wi_diff)
    f, pdf = bsdf_eval(mat, wo, wi)
    good = (pdf > 1e-12) & (wi.z > 1e-6)
    scale = torch.where(good, torch.abs(wi.z) / torch.clamp_min(pdf, 1e-12), 0.0)
    return wi, f * scale, torch.where(good, pdf, 0.0)


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-20)
