"""Pixel picking (the reference's GPU pick buffer, GBufferRT.h:36-46, and
SceneCore's pick forwarding, SceneCore.h:262-278), as the JAX package's
``render/picking.py``.

A pick is one closest-hit query of the pixel's camera ray, run on demand:
``accel.intersect.intersect_closest_shaded``, which launches the
hand-written kernels on the card -- B7 on a dense scene, B8 and its
epilogue on a clustered one, the alpha-cutout re-trace (B7 or B8 a round)
on a scene with MASK-mode materials. The hit's instance and material are
read from the uploaded scene at the hit's slot, so a clustered upload,
whose slots are in BVH-leaf order, names them right too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..accel.intersect import intersect_closest_shaded


@dataclass(frozen=True)
class PickResult:
    hit: bool
    tri: int  # the hit's triangle slot in the upload (-1 = miss)
    instance: int  # glTF node index (-1 = miss)
    instance_name: str
    material: int
    t: float
    position: tuple


def pick(scene, cpu_scene, camera, px: int, py: int, width: int, height: int) -> PickResult:
    """Pick the surface under pixel (px, py) of a ``width`` x ``height``
    image, on ``scene.device``."""
    o, d = camera.generate_rays(width, height, device=scene.device, rows=(py, 1))
    o1, d1 = o[px : px + 1], d[px : px + 1]
    sh = intersect_closest_shaded(scene, o1, d1)
    tri = int(sh.tri[0])
    if tri < 0:
        return PickResult(False, -1, -1, "", -1, float("inf"), ())
    inst = int(scene.inst_id[tri])
    names = cpu_scene.inst_names
    t = float(sh.t[0])
    p = (o1[0] + torch.tensor(t, dtype=torch.float32, device=o1.device) * d1[0]).tolist()
    return PickResult(
        hit=True, tri=tri, instance=inst,
        instance_name=names[inst] if 0 <= inst < len(names) else "",
        material=int(scene.mat_id[tri]), t=t, position=tuple(p),
    )
