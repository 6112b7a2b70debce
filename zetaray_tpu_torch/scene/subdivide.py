"""Triangle subdivision to scale a scene's triangle count, as the JAX
package's ``scene/subdivide.py``.

Midpoint 1-to-4 splits keep the rendered geometry: positions, normals and
uvs are interpolated on the same surfaces, so a subdivided Cornell box
renders the same image while it exercises the clustered path (kernels
B8/B9). This is how the JAX package builds its large-scene case; the
procedural box's own ``subdivide_to`` bisection serves the dense sizes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .scene import CpuScene


def _split4(a0, a1, a2):
    """One midpoint subdivision of per-vertex data: 3x[T, K] -> 3x[4T, K]."""
    m01 = 0.5 * (a0 + a1)
    m12 = 0.5 * (a1 + a2)
    m20 = 0.5 * (a2 + a0)
    n0 = np.concatenate([a0, m01, m20, m01])
    n1 = np.concatenate([m01, a1, m12, m12])
    n2 = np.concatenate([m20, m12, a2, m20])
    return n0, n1, n2


def subdivide_scene(scene: CpuScene, target_tris: int) -> CpuScene:
    """Split every triangle 1 -> 4 per round until the count reaches
    ``target_tris``. The emissive triangles stay unsplit and move to the
    tail, in index order, so the light table is the input scene's. Returns a
    new CpuScene."""
    is_em = np.zeros(scene.num_tris, bool)
    is_em[scene.emissive_tris] = True
    cols = (scene.v0, scene.v1, scene.v2, scene.n0, scene.n1, scene.n2,
            scene.uv0, scene.uv1, scene.uv2, scene.mat_id, scene.inst_id)
    held = [a[is_em] for a in cols]
    v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id, inst_id = (a[~is_em] for a in cols)
    n_held = int(is_em.sum())
    while v0.shape[0] + n_held < target_tris and v0.shape[0] > 0:
        v0, v1, v2 = _split4(v0, v1, v2)
        n0, n1, n2 = _split4(n0, n1, n2)
        uv0, uv1, uv2 = _split4(uv0, uv1, uv2)
        mat_id = np.tile(mat_id, 4)
        inst_id = np.tile(inst_id, 4)
    n_sub = v0.shape[0]
    v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id, inst_id = (
        np.concatenate([a, b]) for a, b in zip(
            (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id, inst_id), held))
    emissive = n_sub + np.arange(n_held, dtype=np.int64)

    def _norm(n):
        l = np.linalg.norm(n, axis=-1, keepdims=True)
        return (n / np.maximum(l, 1e-20)).astype(np.float32)

    f32 = lambda a: a.astype(np.float32)
    return dataclasses.replace(
        scene,
        v0=f32(v0), v1=f32(v1), v2=f32(v2),
        n0=_norm(n0), n1=_norm(n1), n2=_norm(n2),
        uv0=f32(uv0), uv1=f32(uv1), uv2=f32(uv2),
        mat_id=mat_id.astype(np.int32),
        inst_id=inst_id.astype(np.int32),
        emissive_tris=emissive.astype(np.int32),
    )
