"""SoA shading math, as the JAX package's ``ops/shading_soa.py``.

Lambert diffuse plus GGX reflection (height-correlated Smith, Schlick
Fresnel) with the Kulla-Conty multiple-scattering term, the rough
dielectric transmission lobe (Walter 2007), the OpenPBR-style coat (a GGX
layer that attenuates the base by its Fresnel on both directions), their
one-sample lobe-mixture sampler (GGX VNDF, cosine hemisphere or refraction
through the sampled half vector) and the power heuristic, over ``V3``s of
tensors. The operations follow the JAX package in the same order, so the
two agree to float rounding.

A ``MatSoA`` field left ``None`` leaves its lobe out, as in JAX:
``transmission`` (with ``eta``) the transmission lobe, ``coat`` (with
``coat_roughness``) the coat. Callers pass them where the scene has such
materials (``SceneBuffers.has_transmission`` / ``has_coat``); without them
only the opaque lobes are evaluated, with none of the other lobes' work.
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
    # transmission weight [0, 1] and the relative IOR along the ray (eta =
    # eta_incident / eta_transmitted: entering glass 1 / ior); None leaves
    # the transmission lobe out
    transmission: torch.Tensor | None = None
    eta: torch.Tensor | None = None
    # coat weight [0, 1] and the coat's GGX roughness; None leaves the coat out
    coat: torch.Tensor | None = None
    coat_roughness: torch.Tensor | None = None

    def trans(self):
        return self.transmission if self.transmission is not None else \
            torch.zeros_like(self.metallic)

    def eta_rel(self):
        return self.eta if self.eta is not None else 1.0 / self.ior


def material(base: V3, metallic, roughness, ior, transmission, eta, coat, coat_roughness,
             trans: bool, coated: bool) -> MatSoA:
    """A ``MatSoA`` with the transmission lobe (``transmission``, ``eta``)
    only where ``trans`` and the coat (``coat``, ``coat_roughness``) only
    where ``coated``: the scene-wide flags that the JAX package passes as
    static ``trans``/``coat`` (``SceneBuffers.has_transmission`` /
    ``has_coat``)."""
    return MatSoA(base, metallic, roughness, ior,
                  transmission=transmission if trans else None, eta=eta if trans else None,
                  coat=coat if coated else None, coat_roughness=coat_roughness if coated else None)


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
    """(alpha, f0, kd, kt); kt is None where the transmission lobe is left out."""
    alpha = torch.clamp_min(mat.roughness * mat.roughness, _MIN_ALPHA)
    f0d = _f0_from_ior(mat.ior)
    m = mat.metallic
    f0 = V3(
        f0d * (1.0 - m) + mat.base.x * m,
        f0d * (1.0 - m) + mat.base.y * m,
        f0d * (1.0 - m) + mat.base.z * m,
    )
    if mat.transmission is None:
        return alpha, f0, mat.base * (1.0 - m), None
    t = mat.transmission
    return alpha, f0, mat.base * ((1.0 - m) * (1.0 - t)), mat.base * ((1.0 - m) * t)


def _lobe_probs(f0: V3, kd: V3, kt, cos_o):
    """(q_spec, q_diff, q_trans): one-sample lobe selection probabilities
    (q_trans None without the transmission lobe)."""
    s = v3.luminance(_fresnel(f0, cos_o))
    d = v3.luminance(kd)
    if kt is None:
        q_s = torch.clamp(s / torch.clamp_min(s + d, 1e-8), 0.05, 1.0)
        return q_s, 1.0 - q_s, None
    t = v3.luminance(kt)
    tot = torch.clamp_min(s + d + t, 1e-8)
    q_s = torch.clamp(s / tot, 0.05, 1.0)
    q_t = t / tot * (1.0 - q_s) / torch.clamp_min(1.0 - s / tot, 1e-8)
    q_t = torch.minimum(q_t, 1.0 - q_s)
    q_d = torch.clamp_min(1.0 - q_s - q_t, 0.0)
    return q_s, q_d, q_t


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


_COAT_F0 = 0.04  # the coat's IOR 1.5


def _fresnel_s(f0, cos_h):
    m = torch.clamp(1.0 - cos_h, 0.0, 1.0)
    m5 = (m * m) * (m * m) * m
    return f0 + (1.0 - f0) * m5


def _fresnel_scalar_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel; eta = eta_i / eta_t; 1 at total
    internal reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    r_par = (cos_i - eta * cos_t) / torch.clamp_min(cos_i + eta * cos_t, 1e-8)
    r_perp = (eta * cos_i - cos_t) / torch.clamp_min(eta * cos_i + cos_t, 1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def _transmission_terms(mat: MatSoA, wo: V3, wi: V3, alpha, kt: V3):
    """The rough dielectric BTDF (Walter 2007, pbrt's form with eta =
    eta_i / eta_t along the ray) and its half-vector pdf for wi.z < 0:
    (f_t, pdf_t, Fresnel, h)."""
    eta = mat.eta_rel()
    inv_eta = 1.0 / eta
    a2 = alpha * alpha
    cos_o = torch.clamp_min(wo.z, 1e-6)
    cos_i = torch.clamp_min(-wi.z, 1e-6)
    h = v3.normalize(wo + wi * inv_eta, eps=1e-24)
    h = v3.where(h.z < 0.0, -h, h)
    odoth = v3.dot(wo, h)
    idoth = v3.dot(wi, h)
    valid = (odoth > 1e-6) & (idoth < -1e-6)
    dt = _ggx_d(a2, torch.clamp(h.z, 0.0, 1.0))
    g2 = _g2(a2, cos_o, cos_i)
    fr = _fresnel_scalar_dielectric(odoth, eta)
    denom = odoth + inv_eta * idoth
    denom2 = torch.clamp_min(denom * denom, 1e-12)
    # Walter's eta_t^2 cancels against the radiance transport factor
    scale = (
        (1.0 - fr) * dt * g2 * torch.abs(idoth) * torch.abs(odoth)
        / (cos_o * cos_i * denom2)
    )
    f_t = kt * torch.where(valid, scale, 0.0)
    dwh_dwi = torch.abs(idoth) * (inv_eta * inv_eta) / denom2
    pdf_t = _g1(a2, cos_o) * dt * torch.clamp_min(odoth, 0.0) / cos_o * dwh_dwi
    return f_t, torch.where(valid, pdf_t, 0.0), fr, h


def _coat_q(mat: MatSoA, cos_o):
    """The coat's sampling probability (None without the coat)."""
    if mat.coat is None:
        return None
    return torch.clamp(mat.coat * _fresnel_s(_COAT_F0, cos_o) * 2.0, 0.0, 0.5)


def bsdf_eval(mat: MatSoA, wo: V3, wi: V3):
    """(f [V3], pdf) in the local frame. wi.z > 0: [the coat's GGX layer +]
    GGX reflection with the multiple-scattering term + Lambert diffuse
    (diffuse and transmission split by the transmission weight); wi.z < 0:
    the rough dielectric transmission; zero below the surface without it.
    The coat layers by Fresnel-weighted albedo scaling:
    f = f_coat + (1 - cw Fc(o)) (1 - cw Fc(i)) f_base."""
    alpha, f0, kd, kt = _lobe_params(mat)
    a2 = alpha * alpha
    cos_o = torch.clamp_min(wo.z, 1e-6)
    q_s, q_d, q_t = _lobe_probs(f0, kd, kt, cos_o)
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

    q_c = _coat_q(mat, cos_o)
    if q_c is not None:
        cw = mat.coat
        ca = torch.clamp_min(mat.coat_roughness * mat.coat_roughness, _MIN_ALPHA)
        ca2 = ca * ca
        fc_o = cw * _fresnel_s(_COAT_F0, cos_o)
        fc_i = cw * _fresnel_s(_COAT_F0, cos_i)
        dt_c = _ggx_d(ca2, cos_h)
        g2_c = _g2(ca2, cos_o, cos_i)
        f_coat = cw * _fresnel_s(_COAT_F0, odoth) * dt_c * g2_c / (4.0 * cos_o * cos_i)
        att = (1.0 - fc_o) * (1.0 - fc_i)
        f_refl = V3(f_coat + att * f_refl.x, f_coat + att * f_refl.y, f_coat + att * f_refl.z)
        pdf_coat = _g1(ca2, cos_o) * dt_c / (4.0 * cos_o)
        pdf_refl = q_c * pdf_coat + (1.0 - q_c) * pdf_refl

    zero = torch.zeros_like(cos_o)
    if kt is None:  # opaque: no transmission lobe
        f = v3.where(up, f_refl, V3(zero, zero, zero))
        return f, torch.where(up, pdf_refl, 0.0)

    down = wi.z < -1e-6
    f_tr, pdf_tr_h, _, _ = _transmission_terms(mat, wo, wi, alpha, kt)
    if q_c is not None:
        # the coat attenuates the transmitted energy on both interfaces
        att_t = (1.0 - fc_o) * (
            1.0 - mat.coat * _fresnel_s(_COAT_F0, torch.clamp_min(-wi.z, 1e-6))
        )
        f_tr = f_tr * att_t
        pdf_tr = (1.0 - q_c) * q_t * pdf_tr_h
    else:
        pdf_tr = q_t * pdf_tr_h
    f = v3.where(up, f_refl, v3.where(down, f_tr, V3(zero, zero, zero)))
    pdf = torch.where(up, pdf_refl, torch.where(down, pdf_tr, 0.0))
    return f, pdf


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
    """Sample wi from the one-sample mixture {coat, GGX reflection, diffuse,
    GGX transmission}: the coat first (probability q_c), then the base
    mixture on u1 rescaled. Total internal reflection on a transmission pick
    kills the sample. Returns (wi [V3], weight f*|cos|/pdf [V3], pdf)."""
    alpha, f0, kd, kt = _lobe_params(mat)
    cos_o = torch.clamp_min(wo.z, 1e-6)
    q_s, _, q_t = _lobe_probs(f0, kd, kt, cos_o)

    q_c = _coat_q(mat, cos_o)
    if q_c is not None:
        pick_coat = u1 < q_c
        u1 = torch.clamp((u1 - q_c) / torch.clamp_min(1.0 - q_c, 1e-6), 0.0, 1.0)
        ca = torch.clamp_min(mat.coat_roughness * mat.coat_roughness, _MIN_ALPHA)
        h_c = _ggx_vndf(wo, ca, u2, u3)
        wi_coat = h_c * (2.0 * v3.dot(wo, h_c)) - wo
    pick_spec = u1 < q_s
    h = _ggx_vndf(wo, alpha, u2, u3)
    wi_spec = h * (2.0 * v3.dot(wo, h)) - wo
    wi_diff = _cosine_hemisphere(u2, u3)

    if kt is None:  # opaque: two lobes (and the coat)
        wi = v3.where(pick_spec, wi_spec, wi_diff)
        if q_c is not None:
            wi = v3.where(pick_coat, wi_coat, wi)
        f, pdf = bsdf_eval(mat, wo, wi)
        good = (pdf > 1e-12) & (wi.z > 1e-6)
        scale = torch.where(good, torch.abs(wi.z) / torch.clamp_min(pdf, 1e-12), 0.0)
        return wi, f * scale, torch.where(good, pdf, 0.0)

    pick_trans = (u1 >= q_s) & (u1 < q_s + q_t)
    # refraction through the sampled half vector
    eta = mat.eta_rel()
    odoth = v3.dot(wo, h)
    sin2_t = eta * eta * (1.0 - odoth * odoth)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wi_trans = (h * (eta * odoth - cos_t)) - wo * eta

    wi = v3.where(pick_spec, wi_spec, v3.where(pick_trans, wi_trans, wi_diff))
    if q_c is not None:
        wi = v3.where(pick_coat, wi_coat, wi)
        pick_trans = pick_trans & ~pick_coat
    f, pdf = bsdf_eval(mat, wo, wi)
    hemi_ok = (pick_trans & (wi.z < -1e-6) & ~tir) | (~pick_trans & (wi.z > 1e-6))
    good = (pdf > 1e-12) & hemi_ok
    scale = torch.where(good, torch.abs(wi.z) / torch.clamp_min(pdf, 1e-12), 0.0)
    return wi, f * scale, torch.where(good, pdf, 0.0)


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-20)
