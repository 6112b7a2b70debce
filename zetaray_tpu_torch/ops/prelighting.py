"""The light voxel grid, as the JAX package's ``ops/prelighting.py``.

A camera-space lattice of voxels, each holding ``slots`` light reservoirs:
every (voxel, slot) runs RIS over ``candidates`` power-sampled points on
emissive triangles (the scene's alias table ``em_prob``/``em_alias``/
``em_pdf``) with target luminance(Le) / dist(voxel centre)^2, culling
lights that face away from every corner of the voxel. The stored pdf is the
winner's target over the voxel's mean RIS weight, an effective area-measure
pdf. The default grid is 32 x 8 x 40 voxels of 8 slots: 81,920 reservoir
rows of 16 floats, each rated over 6 candidates, in one vectorised pass.

The lattice is centred on the camera in x and y and extends forward in z.
Rows ([V*K, LVG_ROWS] float32) follow the presampled light-set entries:
0-2 light position, 3-5 light normal, 6-8 Le, 9 effective pdf_area (0 marks
an empty reservoir), 10 two-sided flag.

``voxel_of_position`` floors camera-space coordinates in float32; XLA on
the CPU fuses the camera-space dot products into multiply-adds and this
module does not, so a point that lies on a voxel face may land in the
neighbouring voxel here.

``estimate_tri_power`` and ``apply_tri_powers`` are the emissive-texture
power round trip of the JAX app (``app.py:190-197``): each emissive
triangle's power integrated over its emissive texture on the device (64
Halton points on the triangle, bilinear on the finest level, their mean),
then the alias table rebuilt on the host from those powers and the light
radiance ``EA.LE`` scaled by the texture's mean, so NEE sees the energy the
powers count. What the frame derives from those tables (the light sets, the
WoPS table, this grid) is built from the scene each frame, so it follows.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..accel.megakernel import G
from ..core.rng import uniform4
from ..core.sampling import build_alias_table, halton, sample_alias, square_to_triangle
from ..scene.scene import A, EA
from .sky import _div

_LUM = (0.2126, 0.7152, 0.0722)
LVG_ROWS = 16  # the presampled light-set entry layout: pos|ng|Le|pdf|two_sided


@dataclass(frozen=True)
class LVGConfig:
    """Field names and defaults follow the JAX package."""

    dim: tuple = (32, 8, 40)  # voxels in camera space (x, y, z forward)
    extents: tuple = (0.6, 0.45, 0.6)  # half extents of a voxel
    slots: int = 8  # reservoirs a voxel (K)
    candidates: int = 6  # RIS candidates a slot
    offset_y: float = 0.1


def _luminance(r, g, b):
    return _LUM[0] * r + _LUM[1] * g + _LUM[2] * b


def estimate_tri_power(scene, texmaps=None, n_samples: int = 64):
    """Power of each real emissive triangle, luminance(Le * mean texture) *
    area * pi, and that mean: (powers [E], mean_rgb [E, 3]) on
    ``scene.device``. The mean is over ``n_samples`` Halton (2, 3) points
    shared by every triangle, bilinear on level 0 of the material's
    emissive texture in the bundle ``texmaps``; ones where a triangle has
    none."""
    e = scene.num_emissives
    dev = scene.device
    if e == 0:
        return (torch.zeros((0,), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.float32, device=dev))
    etri = torch.clamp_min(scene.em_tri[:e].long(), 0)
    c = torch.linalg.cross(scene.e1[etri], scene.e2[etri])
    area = 0.5 * torch.sqrt((c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2])
    le = scene.tri_attrs[etri, A.EMISS : A.EMISS + 3]
    mean_rgb = torch.ones((e, 3), dtype=torch.float32, device=dev)
    if texmaps and texmaps.get("emissive"):
        from ..scene.textures import sample_bilinear

        pts = torch.tensor([[halton(i, 0), halton(i, 1)] for i in range(1, n_samples + 1)],
                           dtype=torch.float32, device=dev)
        b1, b2 = square_to_triangle(pts[:, 0], pts[:, 1])
        b1, b2 = b1[None, :, None], b2[None, :, None]
        w0 = 1.0 - b1 - b2
        uv = (w0 * scene.uv0[etri][:, None, :] + b1 * scene.uv1[etri][:, None, :]
              + b2 * scene.uv2[etri][:, None, :])  # [E, S, 2]
        tex_of = torch.as_tensor(texmaps["ids"]["emissive"], device=dev)[scene.mat_id[etri].long()]
        for idx, mips in sorted(texmaps["emissive"].items()):
            rgba = sample_bilinear(mips[0], uv.reshape(-1, 2)).reshape(e, n_samples, 4)
            mean_rgb = torch.where((tex_of == idx)[:, None], rgba[..., :3].mean(1), mean_rgb)
    lum = _luminance(le[:, 0] * mean_rgb[:, 0], le[:, 1] * mean_rgb[:, 1],
                     le[:, 2] * mean_rgb[:, 2])
    return torch.clamp_min(lum * area * np.pi, 0.0), mean_rgb


def apply_tri_powers(scene, powers, mean_rgb=None):
    """The scene with its emissive alias table rebuilt on the host from
    ``powers`` [E] (``em_prob``, ``em_alias``, ``em_pdf``, ``em_power``, the
    pdf per area in ``em_attrs`` and ``tri_attrs``), and with ``mean_rgb``
    [E, 3] folded into the light radiance ``EA.LE``."""
    e = scene.num_emissives
    if e == 0:
        return scene
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    p = np.maximum(host(powers).astype(np.float64), 0.0)
    prob, alias, pdf = build_alias_table(p)
    ep = scene.em_prob.shape[0]
    dev = scene.device

    def pad(x, dtype=np.float32):
        out = np.zeros((ep,), dtype)
        out[:e] = x
        return torch.from_numpy(out).to(dev)

    pdf_area = (pdf / np.maximum(host(scene.em_area[:e]), 1e-12)).astype(np.float32)
    em_attrs = host(scene.em_attrs).copy()
    em_attrs[:e, EA.PDF_AREA] = pdf_area
    if mean_rgb is not None:
        em_attrs[:e, EA.LE : EA.LE + 3] *= host(mean_rgb).astype(np.float32)
    tri_attrs = scene.tri_attrs.clone()
    tri_attrs[scene.em_tri[:e].long(), A.EM_PDF_AREA] = torch.from_numpy(pdf_area).to(dev)
    return replace(
        scene, em_prob=pad(prob), em_alias=pad(alias, np.int32), em_pdf=pad(pdf),
        em_attrs=torch.from_numpy(em_attrs).to(dev), tri_attrs=tri_attrs,
        em_power=torch.tensor(float(p.sum()), dtype=torch.float32, device=dev),
    )


def _basis(camera, device):
    """The camera's eye, right, up and forward as float32 [3] tensors."""
    return [torch.tensor(np.asarray(getattr(camera, k), np.float32), device=device)
            for k in ("eye", "right", "up", "forward")]


def _to_cam(p: torch.Tensor, camera) -> torch.Tensor:
    """World points [..., 3] -> camera-space (right, up, forward) [..., 3]."""
    eye, r, u, f = _basis(camera, p.device)
    rel = [p[..., i] - eye[i] for i in range(3)]
    along = lambda a: rel[0] * a[0] + rel[1] * a[1] + rel[2] * a[2]
    return torch.stack([along(r), along(u), along(f)], -1)


def voxel_of_position(p: torch.Tensor, camera, cfg: LVGConfig):
    """World positions [..., 3] -> (flat voxel index [...] int64, in-grid mask)."""
    pc = _to_cam(p, camera)
    dx, dy, dz = cfg.dim
    ex, ey, ez = cfg.extents
    ix = torch.floor(_div(pc[..., 0] + dx * ex, 2 * ex)).to(torch.int64)
    iy = torch.floor(_div(pc[..., 1] - cfg.offset_y + dy * ey, 2 * ey)).to(torch.int64)
    iz = torch.floor(_div(pc[..., 2], 2 * ez)).to(torch.int64)
    inside = (ix >= 0) & (ix < dx) & (iy >= 0) & (iy < dy) & (iz >= 0) & (iz < dz)
    flat = (iz * dy + iy) * dx + ix
    return torch.where(inside, flat, 0), inside


def _voxel_centers(camera, cfg: LVGConfig, device):
    """[V, 3] world-space voxel centres, flat in voxel_of_position's
    (z, y, x) order, and the world half-extent axes (right, up, forward)."""
    dx, dy, dz = cfg.dim
    ex, ey, ez = cfg.extents
    ar = lambda k: torch.arange(k, dtype=torch.float32, device=device)
    cx = (ar(dx) + 0.5) * 2 * ex - dx * ex
    cy = (ar(dy) + 0.5) * 2 * ey - dy * ey + cfg.offset_y
    cz = (ar(dz) + 0.5) * 2 * ez
    gz, gy, gx = torch.meshgrid(cz, cy, cx, indexing="ij")
    cam = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    eye, r, u, f = _basis(camera, device)
    world = eye + cam[:, :1] * r + cam[:, 1:2] * u + cam[:, 2:3] * f
    return world, (r * ex, u * ey, f * ez)


def sample_light_points(scene, u):
    """Power-sampled points on emissive triangles from four uniforms [N]
    (alias pick, then barycentrics): (the triangles' ``em_attrs`` rows
    [N, EA.WIDTH], the points [N, 3], their area-measure pdf
    em_pdf / area [N])."""
    e = scene.num_emissives
    idx = sample_alias(scene.em_prob[:e], scene.em_alias[:e], u[0], u[1])
    row = scene.em_attrs[idx]
    e1, e2 = row[:, EA.E1 : EA.E1 + 3], row[:, EA.E2 : EA.E2 + 3]
    b1, b2 = square_to_triangle(u[2], u[3])
    lp = row[:, EA.V0 : EA.V0 + 3] + b1[:, None] * e1 + b2[:, None] * e2
    c = torch.linalg.cross(e1, e2)
    area = 0.5 * torch.sqrt((c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2])
    return row, lp, scene.em_pdf[idx] / torch.clamp_min(area, 1e-12)


def build_light_voxel_grid(scene, camera, seed: int, cfg: LVGConfig = LVGConfig()):
    """The frame's grid on ``scene.device``: [V*K, LVG_ROWS] reservoir rows.
    Slot s of voxel v is row v*K + s; its candidates draw
    ``uniform4(row, c, seed)`` with salts 0x17C0 (light and point) and 0x17C1
    (the RIS pick)."""
    dev = scene.device
    e = scene.num_emissives
    v = int(np.prod(cfg.dim))
    k = cfg.slots
    n = v * k
    if e == 0:
        return torch.zeros((n, LVG_ROWS), dtype=torch.float32, device=dev)

    centers, (ax, ay, az) = _voxel_centers(camera, cfg, dev)
    ctr = torch.repeat_interleave(centers, k, dim=0)  # [N, 3]
    ids = torch.arange(n, dtype=torch.int64, device=dev)

    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                         dtype=torch.float32, device=dev)  # [8, 3]
    corners = (ctr[:, None, :] + signs[None, :, 0:1] * ax + signs[None, :, 1:2] * ay
               + signs[None, :, 2:3] * az)  # [N, 8, 3]
    ctr_cam = _to_cam(ctr, camera)

    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    r_rows = torch.zeros((n, LVG_ROWS), dtype=torch.float32, device=dev)
    w_sum, target_z, count = zero, zero, zero
    for c in range(cfg.candidates):
        u2 = uniform4(ids, c, seed, salt=0x17C1)
        row, lp, pdf_a = sample_light_points(scene, uniform4(ids, c, seed, salt=0x17C0))
        ng, le, two = row[:, EA.NG : EA.NG + 3], row[:, EA.LE : EA.LE + 3], row[:, EA.TWO_SIDED]

        # the light faces a corner of the voxel, is two-sided or lies inside it
        to_c = corners - lp[:, None, :]
        facing = ((to_c[..., 0] * ng[:, None, 0] + to_c[..., 1] * ng[:, None, 1])
                  + to_c[..., 2] * ng[:, None, 2] > 0.0).any(1)
        d_cam = _to_cam(lp, camera) - ctr_cam
        inside = ((torch.abs(d_cam[:, 0]) <= cfg.extents[0])
                  & (torch.abs(d_cam[:, 1]) <= cfg.extents[1])
                  & (torch.abs(d_cam[:, 2]) <= cfg.extents[2]))
        ok = (two > 0.5) | facing | inside

        dl = lp - ctr
        t2 = torch.clamp_min((dl[:, 0] * dl[:, 0] + dl[:, 1] * dl[:, 1]) + dl[:, 2] * dl[:, 2],
                             1e-6)
        target = torch.where(ok, _luminance(le[:, 0], le[:, 1], le[:, 2]) / t2, 0.0)
        w = target / torch.clamp_min(pdf_a, 1e-9)
        w_sum = w_sum + w
        count = count + ok.to(torch.float32)
        take = u2[0] * torch.clamp_min(w_sum, 1e-12) < w
        cand = torch.cat([lp, ng, le, pdf_a[:, None], two[:, None],
                          torch.zeros((n, LVG_ROWS - 11), dtype=torch.float32, device=dev)], 1)
        r_rows = torch.where(take[:, None], cand, r_rows)
        target_z = torch.where(take, target, target_z)

    # the voxel's mean RIS weight over its K slots x C candidates
    w_vox = w_sum.reshape(v, k).sum(1)
    c_vox = count.reshape(v, k).sum(1)
    w_mean = torch.repeat_interleave(w_vox / torch.clamp_min(c_vox, 1.0), k)
    pdf_eff = torch.where(w_mean > 0, target_z / torch.clamp_min(w_mean, 1e-12), 0.0)
    r_rows[:, 9] = pdf_eff
    return r_rows


def sample_lvg_at(lvg: torch.Tensor, p: torch.Tensor, ok, camera, seed: int, cfg: LVGConfig,
                  salt: int = 0x51AB, pix=None):
    """A grid light candidate at positions p [N, 3]: (rows [LVG_ROWS, N],
    valid [N]). The lookup position is jittered by the voxel's extents and a
    uniform slot is taken (``uniform4(i, 0, seed, salt)``, i the global
    pixel id, ``pix`` in a row band); an empty reservoir, a point off the
    grid or ``ok`` False gives valid False."""
    n = p.shape[0]
    if pix is None:
        pix = torch.arange(n, dtype=torch.int64, device=p.device)
    u = uniform4(pix, 0, seed, salt=salt)
    _, r, up, f = _basis(camera, p.device)
    ex = torch.tensor(cfg.extents, dtype=torch.float32, device=p.device)
    jit = (torch.stack(u[0:3], -1) * 2.0 - 1.0) * ex[None, :]
    pj = p + jit[:, 0:1] * r + jit[:, 1:2] * up + jit[:, 2:3] * f
    vox, inside = voxel_of_position(pj, camera, cfg)
    slot = torch.clamp_max((u[3] * cfg.slots).to(torch.int64), cfg.slots - 1)
    rows = lvg[vox * cfg.slots + slot]
    return rows.T, inside & (rows[:, 9] > 0.0) & ok


def sample_lvg(lvg: torch.Tensor, gbuf: torch.Tensor, camera, seed: int, cfg: LVGConfig,
               salt: int = 0x51AB, pix=None):
    """``sample_lvg_at`` at each pixel's primary hit (G-buffer [G.ROWS, N])."""
    p = gbuf[G.POS : G.POS + 3].T
    return sample_lvg_at(lvg, p, gbuf[G.VALID] > 0.5, camera, seed, cfg, salt=salt, pix=pix)
