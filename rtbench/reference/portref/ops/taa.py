"""Temporal anti-aliasing and progressive accumulation, as the JAX package's
``ops/taa.py``: depth-dilated motion, Catmull-Rom history resample (or the
nearest history texel), 3x3 neighbourhood clamp and the blend, each set by
``TAAConfig`` (the defaults are the frame's: every option on, blend 0.1).
Planar [3, H, W] images; ``taa_resolve`` is the channel-last form and
``accumulate`` the running average of a static camera. The frames take the
defaults: ``RenderConfig`` has no TAA field, as in JAX.

Row bands (``render.frame`` with ``shard``): ``taa_resolve_p`` takes the
current planes extended by ``ext`` edge-clamped halo rows, so that the
depth dilation and the neighbourhood clamp see the rows beyond the band,
and a history band that starts at image row ``hist_row0``. (The JAX
function extends only the colour for the clamp and dilates within the
band.) The resamplers clamp at the image's rows, then read the band.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class TAAConfig:
    blend: float = 0.1  # weight of the current frame
    clamp: bool = True  # clamp the history to the current 3x3 neighbourhood
    # Catmull-Rom history resample (TAA.hlsl); False fetches the nearest texel
    catmull_rom: bool = True
    # reproject by the closest-depth pixel of the 3x3 neighbourhood's motion
    depth_dilate: bool = True


def _pad_edge(img, before: int, after: int):
    """Edge-replicate the last two axes of [C, H, W]."""
    return F.pad(img[None], (before, after, before, after), mode="replicate")[0]


def _neighborhood_minmax_p(img):
    """[3, H, W] -> per-pixel 3x3 min and max (edge-clamped borders)."""
    _, h, w = img.shape
    p = _pad_edge(img, 1, 1)
    lo = img
    hi = img
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            n = p[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            lo = torch.minimum(lo, n)
            hi = torch.maximum(hi, n)
    return lo, hi


def _cubic_w(f):
    """Catmull-Rom weights of the 4 taps around offset f in [0, 1)."""
    f2 = f * f
    f3 = f2 * f
    return (
        -0.5 * f3 + f2 - 0.5 * f,
        1.5 * f3 - 2.5 * f2 + 1.0,
        -1.5 * f3 + 2.0 * f2 + 0.5 * f,
        0.5 * f3 - 0.5 * f2,
    )


def catmull_rom_p(img, px, py, row0: int = 0, h_full: int | None = None):
    """Catmull-Rom resample of [3, H, W] at texel coordinates px, py [N]
    (0.0 = centre of texel 0), border-clamped. Returns [3, N]. A band of
    rows of an ``h_full``-row image, whose first row is image row ``row0``,
    resamples at image coordinates: the taps clamp at the image's rows and
    then read the band (at its edge beyond it)."""
    _, h, w = img.shape
    hf = h if h_full is None else h_full
    pxc = torch.clamp(px, 0.0, w - 1.0)
    pyc = torch.clamp(py, 0.0, hf - 1.0)
    x1 = torch.floor(pxc)
    y1 = torch.floor(pyc)
    wx = _cubic_w(pxc - x1)
    wy = _cubic_w(pyc - y1)
    xi = x1.to(torch.int64)
    yi = y1.to(torch.int64)
    flat = img.reshape(3, -1)
    out = torch.zeros((3, px.shape[0]), dtype=img.dtype, device=img.device)
    for j in range(4):
        row = torch.clamp(torch.clamp(yi + (j - 1), 0, hf - 1) - row0, 0, h - 1) * w
        for i in range(4):
            tap = flat.index_select(1, row + torch.clamp(xi + (i - 1), 0, w - 1))
            out = out + tap * (wy[j] * wx[i])
    return out


def _depth_dilated_motion(motion, depth, valid):
    """Adopt each pixel's 3x3 closest-depth neighbour's motion [2, H, W]."""
    h, w = depth.shape
    d0 = torch.where(valid, depth, 3.0e38)
    pd = _pad_edge(d0[None], 1, 1)[0]
    pm = _pad_edge(motion, 1, 1)
    best_d = d0
    best_m = motion
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nd = pd[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            nm = pm[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            closer = nd < best_d
            best_d = torch.where(closer, nd, best_d)
            best_m = torch.where(closer[None], nm, best_m)
    return best_m


def taa_resolve_p(curr, history, world_pos, valid, prev_cam, depth=None, row0: int = 0,
                  height_full: int | None = None, hist_row0: int = 0, ext: int = 0,
                  cfg: TAAConfig = TAAConfig()):
    """One TAA step: curr, history, world_pos [3, H, W]; valid [H, W];
    prev_cam the previous frame's camera; depth [H, W], or None for no
    depth dilation (as ``cfg.depth_dilate=False``). Returns the resolved
    colour.

    Row bands of an image of ``height_full`` rows: curr, world_pos, valid and
    depth hold the band (``row0`` its first image row) and ``ext``
    edge-clamped halo rows above and below it; history holds rows from image
    row ``hist_row0`` on. Returns the band's rows. A reprojection that lands
    beyond the history's rows is not taken."""
    _, he, w = curr.shape
    h = he - 2 * ext
    hf = he if height_full is None else height_full
    dev = curr.device
    inner = slice(ext, ext + h)
    px, py, zfwd = prev_cam.project(world_pos.reshape(3, -1).T, w, hf)
    if cfg.depth_dilate and depth is not None:
        xg = torch.arange(w, dtype=torch.float32, device=dev).repeat(he)
        # a halo row beyond the image replicates the edge row: its own row there
        yg = torch.clamp(torch.arange(he, dtype=torch.float32, device=dev) + (row0 - ext), 0.0,
                         hf - 1.0).repeat_interleave(w)
        m = torch.stack([(px - xg).reshape(he, w), (py - yg).reshape(he, w)], 0)
        m = _depth_dilated_motion(m, depth, valid)[:, inner]
        px = xg[: h * w] + m[0].reshape(-1)
        py = yg.reshape(he, w)[inner].reshape(-1) + m[1].reshape(-1)
    else:
        px, py = (x.reshape(he, w)[inner].reshape(-1) for x in (px, py))
    zfwd = zfwd.reshape(he, w)[inner].reshape(-1)
    inside = (
        (px >= -0.5) & (px <= w - 0.5) & (py >= -0.5) & (py <= hf - 0.5) & (zfwd > 0)
    )
    ry = torch.round(py)
    hr = history.shape[1]
    inside = inside & (ry >= 0) & (ry <= hf - 1)
    inside = inside & (ry >= hist_row0) & (ry <= hist_row0 + hr - 1)
    if cfg.catmull_rom:
        hist = catmull_rom_p(history, px, torch.clamp(py, 0.0, hf - 1.0), hist_row0, hf)
    else:
        iy = torch.clamp(ry - hist_row0, 0, hr - 1).to(torch.int64)
        ix = torch.clamp(torch.round(px), 0, w - 1).to(torch.int64)
        hist = history.reshape(3, -1).index_select(1, iy * w + ix)
    hist = hist.reshape(3, h, w)
    if cfg.clamp:
        lo, hi = (x[:, inner] for x in _neighborhood_minmax_p(curr))
        hist = torch.minimum(torch.maximum(hist, lo), hi)
    curr = curr[:, inner]
    ok = (inside.reshape(h, w) & valid[inner])[None]
    return torch.where(ok, cfg.blend * curr + (1.0 - cfg.blend) * hist, curr)


def taa_resolve(curr, history, world_pos, valid, prev_cam, cfg: TAAConfig = TAAConfig()):
    """Channel-last form: curr, history, world_pos [H, W, 3]; no depth, so no
    dilation (as the JAX ``taa_resolve``). Returns [H, W, 3]."""
    cl = lambda x: x.permute(2, 0, 1)
    return taa_resolve_p(cl(curr), cl(history), cl(world_pos), valid, prev_cam,
                         cfg=cfg).permute(1, 2, 0)


def accumulate(curr, accum, frame_index):
    """Progressive average: accum_n = (accum_{n-1} * n + curr) / (n + 1)."""
    n = torch.as_tensor(frame_index, device=curr.device).to(torch.float32)
    return (accum * n + curr) / (n + 1.0)
