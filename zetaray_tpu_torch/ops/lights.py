"""Emissive-triangle light sampling, as the JAX package's ``ops/lights.py``.

A power-weighted alias-table pick of an emissive triangle, then a uniform
point on it. The winner's row of the emissive table ``EA`` is read by
index (the JAX package fetches it with a one-hot matmul, which gives the
same values).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.sampling import sample_alias, square_to_triangle
from ..scene.scene import EA


class LightSample(NamedTuple):
    pos: torch.Tensor  # [N, 3] point on the light
    ng: torch.Tensor  # [N, 3] light geometric normal (unit)
    le: torch.Tensor  # [N, 3] radiance
    pdf_area: torch.Tensor  # [N] pdf in area measure
    tri: torch.Tensor  # [N] triangle id
    two_sided: torch.Tensor  # [N] bool


def sample_emissive(scene, u) -> LightSample:
    """``u``: four [N] uniforms (two for the alias pick, two barycentric)."""
    e = scene.num_emissives
    if e == 0:
        raise ValueError("the scene has no emissive triangles to sample")
    k = sample_alias(scene.em_prob[:e], scene.em_alias[:e], u[0], u[1])
    row = scene.em_attrs[k]
    b1, b2 = square_to_triangle(u[2], u[3])
    pos = (
        row[:, EA.V0 : EA.V0 + 3]
        + b1[:, None] * row[:, EA.E1 : EA.E1 + 3]
        + b2[:, None] * row[:, EA.E2 : EA.E2 + 3]
    )
    return LightSample(
        pos=pos,
        ng=row[:, EA.NG : EA.NG + 3],
        le=row[:, EA.LE : EA.LE + 3],
        pdf_area=row[:, EA.PDF_AREA],
        tri=scene.em_tri[k],
        two_sided=row[:, EA.TWO_SIDED] > 0.5,
    )


def pdf_area_to_solid_angle(pdf_area, dist2, cos_light):
    """An area-measure pdf in solid-angle measure at the shading point."""
    return pdf_area * dist2 / torch.clamp_min(cos_light, 1e-8)
