"""Adding and removing instances of a host scene, as the JAX package's
``scene/edit.py``.

``CpuScene`` is the host's truth: ``add_instance`` and ``remove_instance``
return an edited copy, and the caller uploads it again with
``upload_scene`` (a rebuild). Per-frame motion of the instances a scene
already has goes through ``scene.refit.refit_scene`` on the device instead.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..core import transforms as T
from .gltf import GltfMaterial
from .packed import quantize_normals, quantize_uvs
from .scene import CpuScene, MaterialsSoA, _materials_soa


def _append_material(materials: MaterialsSoA, mat: GltfMaterial) -> tuple[MaterialsSoA, int]:
    """Append one material to the SoA table; returns (new_table, index)."""
    single = _materials_soa([mat])

    def cat(a, b):
        if a is None:
            return None
        return np.concatenate([a, b])

    out = MaterialsSoA(
        base_color=cat(materials.base_color, single.base_color),
        metallic=cat(materials.metallic, single.metallic),
        roughness=cat(materials.roughness, single.roughness),
        emissive=cat(materials.emissive, single.emissive),
        ior=cat(materials.ior, single.ior),
        transmission=cat(materials.transmission, single.transmission),
        coat_weight=cat(materials.coat_weight, single.coat_weight),
        coat_roughness=cat(materials.coat_roughness, single.coat_roughness),
        double_sided=cat(materials.double_sided, single.double_sided),
        base_color_tex=cat(materials.base_color_tex, single.base_color_tex),
        normal_tex=cat(materials.normal_tex, single.normal_tex),
        metallic_roughness_tex=cat(
            materials.metallic_roughness_tex, single.metallic_roughness_tex
        ),
        emissive_tex=cat(materials.emissive_tex, single.emissive_tex),
        alpha_cutoff=cat(materials.alpha_cutoff, single.alpha_cutoff),
    )
    return out, len(out.metallic) - 1


def _emissive_tris(materials: MaterialsSoA, mat_id: np.ndarray) -> np.ndarray:
    em_mask = materials.emissive[mat_id].max(axis=-1) > 0.0
    return np.nonzero(em_mask)[0].astype(np.int32)


def add_instance(
    cpu: CpuScene,
    positions: np.ndarray,
    indices: np.ndarray,
    world: np.ndarray | None = None,
    material: "GltfMaterial | int" = 0,
    name: str = "<added>",
    normals: np.ndarray | None = None,
    uvs: np.ndarray | None = None,
) -> CpuScene:
    """SceneCore::AddInstance analog: append a triangle mesh instance.

    ``positions`` [V, 3], ``indices`` [F*3] or [F, 3]; ``world`` 4x4 (or
    None = identity); ``material`` is an existing material index or a new
    GltfMaterial (appended to the table). Vertex normals/uvs go through the
    packed-format quantization exactly like load_scene's. Returns a new
    CpuScene -- re-upload with ``upload_scene`` (TLAS rebuild analog).
    """
    world = np.eye(4) if world is None else np.asarray(world, np.float64)
    idx = np.asarray(indices).reshape(-1, 3).astype(np.int64)
    pos = T.transform_points(world, np.asarray(positions, np.float64))
    if normals is not None:
        nrm_m = T.normal_matrix(world)
        nrm = np.asarray(normals, np.float64) @ nrm_m.T
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    else:
        nrm = None
    a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
    v0, v1, v2 = pos[a], pos[b], pos[c]
    if nrm is not None:
        n0, n1, n2 = nrm[a], nrm[b], nrm[c]
    else:
        g = np.cross(v1 - v0, v2 - v0)
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-20)
        n0 = n1 = n2 = g
    if uvs is not None:
        uv = np.asarray(uvs, np.float32)
        uv0, uv1, uv2 = uv[a], uv[b], uv[c]
    else:
        uv0 = uv1 = uv2 = np.zeros((len(idx), 2), np.float32)

    materials = cpu.materials
    if isinstance(material, GltfMaterial):
        materials, mat_idx = _append_material(materials, material)
    else:
        mat_idx = int(material)
        if not 0 <= mat_idx < len(materials.metallic):
            raise IndexError(f"material index {mat_idx} out of range")

    inst_idx = len(cpu.inst_names)
    f32 = lambda x: np.asarray(x, np.float32)
    catv = lambda old, new: np.concatenate([old, f32(new)])
    mat_id = np.concatenate(
        [cpu.mat_id, np.full(len(idx), mat_idx, np.int32)]
    )
    out = replace(
        cpu,
        v0=catv(cpu.v0, v0), v1=catv(cpu.v1, v1), v2=catv(cpu.v2, v2),
        n0=catv(cpu.n0, quantize_normals(f32(n0))),
        n1=catv(cpu.n1, quantize_normals(f32(n1))),
        n2=catv(cpu.n2, quantize_normals(f32(n2))),
        uv0=catv(cpu.uv0, quantize_uvs(uv0)),
        uv1=catv(cpu.uv1, quantize_uvs(uv1)),
        uv2=catv(cpu.uv2, quantize_uvs(uv2)),
        mat_id=mat_id,
        materials=materials,
        inst_id=np.concatenate(
            [cpu.inst_id, np.full(len(idx), inst_idx, np.int32)]
        ),
        inst_names=list(cpu.inst_names) + [name],
        emissive_tris=_emissive_tris(materials, mat_id),
    )
    return out


def remove_instance(cpu: CpuScene, which: "str | int") -> CpuScene:
    """SceneCore remove analog: drop every triangle of one instance.

    ``which``: instance index or name. Instance indices of the remaining
    triangles are preserved (the name slot is kept as a tombstone) so
    picking/motion tables stay stable, like the reference's persistent
    instance IDs."""
    if isinstance(which, str):
        try:
            target = cpu.inst_names.index(which)
        except ValueError:
            raise KeyError(f"no instance named {which!r}") from None
    else:
        target = int(which)
        if not 0 <= target < len(cpu.inst_names):
            raise IndexError(f"instance index {target} out of range")
    keep = cpu.inst_id != target
    if keep.all():
        raise KeyError(f"instance {which!r} has no triangles")
    names = list(cpu.inst_names)
    names[target] = f"<removed:{names[target]}>"
    mat_id = cpu.mat_id[keep]
    return replace(
        cpu,
        v0=cpu.v0[keep], v1=cpu.v1[keep], v2=cpu.v2[keep],
        n0=cpu.n0[keep], n1=cpu.n1[keep], n2=cpu.n2[keep],
        uv0=cpu.uv0[keep], uv1=cpu.uv1[keep], uv2=cpu.uv2[keep],
        mat_id=mat_id,
        inst_id=cpu.inst_id[keep],
        inst_names=names,
        emissive_tris=_emissive_tris(cpu.materials, mat_id),
    )
