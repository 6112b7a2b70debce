"""Temporal upscaling (TAAU) and RCAS sharpening, as the JAX package's
``ops/upscale.py``: the frame renders at ``render_scale`` of the display
size and ``taau_resolve`` reconstructs the display image from the jittered
render-res frame and the display-res history.

- Each display pixel samples the render-res planes (colour, validity, the
  depth-dilated motion, the positions for the depth clip and the 3x3
  neighbourhood's min and max) bilinearly at its jittered sample
  coordinate. The coordinate is a fixed affine of the pixel's row and
  column, so the resample is separable: rows first, then columns, in the
  association of the JAX package's two matmuls (a direct 4-tap bilinear
  rounds differently). Here both passes are gathers of two taps.
- The history is reprojected by the sampled motion and resampled with
  Catmull-Rom (``ops.taa.catmull_rom_p``); the previous luminance locks
  bilinearly at the same place.
- The history is clamped to the neighbourhood range unless locked, dropped
  where the reprojected depth disagrees with the previous frame's (depth
  clip) and blended with a weight that grows with the pixel's closeness to
  a current sample; new locks form where a confident sample's luminance
  leaves its neighbourhood's range.

Two thresholds decide a pixel outright: a sampled validity above 0.99 and
the lock test (``conf > 0.7``, current luminance beyond 1.05 times the
neighbourhood's top or 0.95 times its bottom). An ulp of their inputs
flips such a pixel, so parity with the JAX package holds shares of pixels
there. Divisions by constants go through a tensor divisor
(``ops.sky._div``).

Row bands (``render.frame`` with ``shard``), the JAX function's hooks: a
call makes the display rows [``out_row0``, ``out_row0 + out_rows``); the
render-res planes hold the rows from render row ``lr_row0`` on (the band
and an edge-clamped halo; ``hr_full`` the render height), the history and
the locks the display rows from ``hist_row0`` on. Every resample clamps at
the image's rows before it reads the band, so a band equals those rows of
the whole image while the reprojection stays within the halo.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .post import luminance_p
from .sky import _div
from .taa import _depth_dilated_motion, _neighborhood_minmax_p, catmull_rom_p


@dataclass(frozen=True)
class UpscaleConfig:
    blend: float = 0.1  # base current-frame weight
    clamp: bool = True
    sigma: float = 0.45  # Gaussian splat radius, in render-res texels
    depth_dilate: bool = True
    # depth clip: relative depth tolerance of the reprojection against the
    # previous frame's depth plane; 0 turns it off
    depth_clip_tol: float = 0.1
    # auto-reactive mask: how far luminance divergence raises the current
    # frame's weight; 0 turns it off
    reactive_scale: float = 0.0
    locks: bool = True  # luminance locks on thin features
    lock_decay: float = 0.1  # per-frame lock decay
    rcas_sharpness: float = 0.0  # RCAS after the tonemap (render.frame); 0 = off


def _axis_taps(p: torch.Tensor, n: int):
    """The two taps and weights of a bilinear resample of a length-n axis
    at positions p, with the JAX package's edge rule: x0 = clip(floor(p)),
    x1 = min(x0 + 1, n - 1), f = clip(p - x0, 0, 1); where the two taps are
    one texel its weight is (1 - f) + f, the sum the JAX weight matrix
    holds there."""
    x0 = torch.clamp(torch.floor(p), 0, n - 1)
    f = torch.clamp(p - x0, 0.0, 1.0)
    i0 = x0.to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    same = i1 == i0
    return i0, i1, torch.where(same, (1.0 - f) + f, 1.0 - f), torch.where(same, 0.0, f)


def _sep_bilinear(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, row0: int = 0,
                  h_full: int | None = None) -> torch.Tensor:
    """Separable bilinear resample of planes [C, h, w] at rows ys [OH] and
    columns xs [OW] (render-res texel coordinates): rows, then columns.
    Returns [C, OH, OW]. A band of an ``h_full``-row image from row ``row0``
    takes its taps and weights at image rows, then reads the band."""
    _, h, w = imgs.shape
    y0, y1, wy0, wy1 = _axis_taps(ys, h if h_full is None else h_full)
    y0, y1 = (torch.clamp(y - row0, 0, h - 1) for y in (y0, y1))
    t = imgs[:, y0, :] * wy0[None, :, None] + imgs[:, y1, :] * wy1[None, :, None]
    x0, x1, wx0, wx1 = _axis_taps(xs, w)
    return t[:, :, x0] * wx0 + t[:, :, x1] * wx1


def _bilinear_p(plane: torch.Tensor, px: torch.Tensor, py: torch.Tensor, row0: int = 0,
                h_full: int | None = None) -> torch.Tensor:
    """Bilinear sample of one [H, W] plane at texel coordinates px, py [N],
    border-clamped: rows of two lerps, then one between them. A band of an
    ``h_full``-row plane whose first row is row ``row0`` samples at image
    coordinates, as ``taa.catmull_rom_p``."""
    h, w = plane.shape
    hf = h if h_full is None else h_full
    x0 = torch.clamp(torch.floor(px), 0, w - 1)
    y0 = torch.clamp(torch.floor(py), 0, hf - 1)
    fx = torch.clamp(px - x0, 0.0, 1.0)
    fy = torch.clamp(py - y0, 0.0, 1.0)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    x1i, y1i = torch.clamp_max(x0i + 1, w - 1), torch.clamp_max(y0i + 1, hf - 1)
    y0i, y1i = (torch.clamp(y - row0, 0, h - 1) for y in (y0i, y1i))
    flat = plane.reshape(-1)
    at = lambda yi, xi: flat[yi * w + xi]
    top = at(y0i, x0i) * (1.0 - fx) + at(y0i, x1i) * fx
    bot = at(y1i, x0i) * (1.0 - fx) + at(y1i, x1i) * fx
    return top * (1.0 - fy) + bot * fy


def taau_resolve(curr_lr, history, pos_lr, valid_lr, depth_lr, prev_cam, jitter, out_w: int,
                 out_h: int, cfg: UpscaleConfig = UpscaleConfig(), prev_depth_lr=None,
                 lock=None, out_row0: int = 0, out_rows: int | None = None, lr_row0: int = 0,
                 hr_full: int | None = None, hist_row0: int = 0):
    """One temporal-upscale step.

    curr_lr [3, hr, wr]: this frame's render-res colour, rendered with the
    sub-pixel ``jitter`` (render-res pixels); history [3, out_h, out_w]: the
    display-res output of the last frame, or None on the first; pos_lr
    [3, hr, wr], valid_lr and depth_lr [hr, wr]: the render-res G-buffer
    planes; prev_cam: the last frame's camera. ``prev_depth_lr``: the last
    frame's render-res depth plane (enables the depth clip); ``lock``: the
    last luminance-lock plane [out_h, out_w]. Returns (the display image
    [3, out_h, out_w], the new lock plane, or None without ``cfg.locks``).
    Row bands: ``out_row0``, ``out_rows``, ``lr_row0``, ``hr_full`` and
    ``hist_row0`` (module docstring); the planes of the previous frame
    (``prev_depth_lr``, ``lock``) start where ``curr_lr`` and ``history``
    start.
    """
    _, hr, wr = curr_lr.shape
    dev = curr_lr.device
    f32 = dict(dtype=torch.float32, device=dev)
    out_rows = out_h if out_rows is None else out_rows
    hr_full = hr if hr_full is None else hr_full
    sx = wr / out_w
    sy = hr_full / out_h

    # display-pixel centres in render-res texel coordinates
    xs = (torch.arange(out_w, **f32) + 0.5) * sx - 0.5
    ys = (torch.arange(out_rows, **f32) + out_row0 + 0.5) * sy - 0.5
    px = xs.repeat(out_rows)
    py = ys.repeat_interleave(out_w)

    jx = torch.tensor(float(jitter[0]), **f32)
    jy = torch.tensor(float(jitter[1]), **f32)
    spx = xs - jx  # per display column: the render-res sample coordinate
    spy = ys - jy  # per display row
    # clamped to the image's rows before the band's rows are taken: a halo
    # row beyond the image replicates the edge row's data, not its stencils
    spy_c = torch.clamp(spy, 0.0, hr_full - 1.0)
    rows_lr = dict(row0=lr_row0, h_full=hr_full)

    # confidence: a Gaussian of the distance to the nearest jittered sample
    inv2s = 1.0 / (2.0 * cfg.sigma * cfg.sigma)
    dx = spx - torch.round(spx)
    dy = spy - torch.round(spy)
    conf = (torch.exp(-dy * dy * inv2s)[:, None]
            * torch.exp(-dx * dx * inv2s)[None, :]).reshape(-1)

    zeros_lock = torch.zeros((out_rows, out_w), **f32) if cfg.locks else None
    if history is None:
        return _sep_bilinear(curr_lr, spy_c, spx, **rows_lr), zeros_lock

    # per render-res texel motion: display-space offset between its jittered
    # sample and its reprojection, optionally depth-dilated
    p_lr, pp_lr, zf_lr = prev_cam.project(pos_lr.reshape(3, -1).T, out_w, out_h)
    tx = _div(torch.arange(wr, **f32) + 0.5 + jx, wr) * out_w - 0.5
    # a halo row beyond the image replicates the edge row: its own row there
    row_g = torch.clamp(torch.arange(hr, **f32) + lr_row0, 0.0, hr_full - 1.0)
    ty = _div(row_g + 0.5 + jy, hr_full) * out_h - 0.5
    m_lr = torch.stack([(p_lr - tx.repeat(hr)).reshape(hr, wr),
                        (pp_lr - ty.repeat_interleave(wr)).reshape(hr, wr)], 0)
    ok_lr = valid_lr & (zf_lr.reshape(hr, wr) > 0)
    if cfg.depth_dilate:
        m_lr = _depth_dilated_motion(m_lr, depth_lr, ok_lr)
    m_lr = torch.where(ok_lr[None], m_lr, 0.0)

    # one separable resample of every plane: colour (3), valid (1), motion
    # (2) [, positions (3)] [, neighbourhood min and max (3 + 3)]
    want_clip = prev_depth_lr is not None and cfg.depth_clip_tol > 0.0
    planes = [curr_lr, valid_lr[None].to(torch.float32), m_lr]
    if want_clip:
        planes.append(pos_lr.reshape(3, hr, wr))
    if cfg.clamp or cfg.locks:
        planes.extend(_neighborhood_minmax_p(curr_lr))
    smp = _sep_bilinear(torch.cat(planes, 0), spy_c, spx, **rows_lr)
    smp = smp.reshape(smp.shape[0], -1)
    cur = smp[0:3]
    valid_s = smp[3] > 0.99
    m_s = smp[4:6]
    k = 9 if want_clip else 6
    lo, hi = smp[k : k + 3], smp[k + 3 : k + 6]

    # back to display coordinates, moved by the sampled motion
    hpx = (_div(px + 0.5, sx) - 0.5) + m_s[0]
    hpy = (_div(py + 0.5, sy) - 0.5) + m_s[1]
    hpy_l = hpy - hist_row0
    inside = ((hpx >= -0.5) & (hpx <= out_w - 0.5) & (hpy >= -0.5) & (hpy <= out_h - 0.5)
              & (hpy_l >= -0.5) & (hpy_l <= history.shape[1] - 0.5))
    hpx_c = torch.clamp(hpx, 0.0, out_w - 1.0)
    hpy_c = torch.clamp(hpy, 0.0, out_h - 1.0)
    hist = catmull_rom_p(history, hpx_c, hpy_c, hist_row0, out_h)

    # depth clip: the reprojected sample's distance from the last eye must
    # match the last frame's depth there, else the history is another
    # surface's and is dropped
    disocc = torch.zeros_like(valid_s)
    if want_clip:
        eye = torch.tensor(prev_cam.eye, **f32)
        rel = smp[6:9] - eye[:, None]
        depth_est = torch.sqrt(torch.clamp_min((rel[0] * rel[0] + rel[1] * rel[1])
                                               + rel[2] * rel[2], 1e-12))
        prev_d = _bilinear_p(prev_depth_lr, (hpx + 0.5) * sx - 0.5, (hpy + 0.5) * sy - 0.5,
                             lr_row0, hr_full)
        disocc = torch.abs(prev_d - depth_est) > cfg.depth_clip_tol * depth_est

    # the last lock plane where the pixel came from (locks follow their feature)
    lock_prev = torch.zeros_like(conf)
    if cfg.locks and lock is not None:
        lock_prev = torch.where(inside & ~disocc,
                                _bilinear_p(lock, hpx_c, hpy_c, hist_row0, out_h), 0.0)
    if cfg.clamp:
        hist_cl = torch.minimum(torch.maximum(hist, lo), hi)
        hist = hist_cl + (hist - hist_cl) * lock_prev[None, :]

    react = torch.zeros_like(conf)
    if cfg.reactive_scale > 0.0:
        lum_c, lum_h = luminance_p(cur), luminance_p(hist)
        react = torch.abs(lum_c - lum_h) / torch.clamp_min(torch.maximum(lum_c, lum_h), 1e-3)

    ok = inside & valid_s & ~disocc
    alpha = torch.clamp(cfg.blend * (0.25 + 0.75 * conf) + react * cfg.reactive_scale,
                        0.02, 1.0)
    out = torch.where(ok[None, :], alpha[None, :] * cur + (1.0 - alpha[None, :]) * hist, cur)

    new_lock = None
    if cfg.locks:
        # locks form where a confident current sample leaves the
        # neighbourhood's luminance range
        lum_c, lum_lo, lum_hi = luminance_p(cur), luminance_p(lo), luminance_p(hi)
        feature = (lum_c > lum_hi * 1.05) | (lum_c < lum_lo * 0.95)
        create = (feature & (conf > 0.7)).to(torch.float32)
        keep = (ok & (react < 0.5)).to(torch.float32)
        new_lock = torch.clamp(torch.maximum(lock_prev * (1.0 - cfg.lock_decay) * keep, create),
                               0.0, 1.0).reshape(out_rows, out_w)
    return out.reshape(3, out_rows, out_w), new_lock


def rcas_p(img: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """Robust contrast-adaptive sharpening (FidelityFX RCAS) of a planar
    [3, H, W] image in about [0, 1]: with the cross neighbours b, d, f, h
    (edge-clamped) and centre c, the negative lobe is limited so that no
    channel under- or overshoots, times ``sharpness``; out = (lobe (b + d +
    f + h) + c) / (4 lobe + 1)."""
    c = img
    b = torch.cat([img[:, :1], img[:, :-1]], 1)
    h = torch.cat([img[:, 1:], img[:, -1:]], 1)
    d = torch.cat([img[:, :, :1], img[:, :, :-1]], 2)
    f = torch.cat([img[:, :, 1:], img[:, :, -1:]], 2)
    mn = torch.minimum(torch.minimum(b, d), torch.minimum(f, h))
    mx = torch.maximum(torch.maximum(b, d), torch.maximum(f, h))
    hit_min = torch.minimum(mn, c) / torch.clamp_min(4.0 * mx, 1e-6)
    hit_max = (1.0 - torch.maximum(mx, c)) / torch.clamp_max(4.0 * mn - 4.0, -1e-6)
    lobe_c = torch.maximum(-hit_min, hit_max)
    limit = 0.25 - 1.0 / 16.0
    lobe = torch.clamp(torch.max(lobe_c, 0).values, -limit, 0.0) * float(sharpness)
    return (lobe[None] * (((b + d) + f) + h) + c) / (4.0 * lobe[None] + 1.0)
