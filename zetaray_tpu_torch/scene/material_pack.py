"""Bit-exact packed Material records (the reference's GPU material format).

The reference stores every material as EIGHT uint32 words with fixed bit
layouts shared between C++ and HLSL (Material.h:29-438; data members at
Material.h:417-427):

  word 0  BaseColorFactor                  rgba8 (unorm)
  word 1  BaseColorTex_Subsurf_CoatWeight  tex16 | subsurface8<<16 | coat_w8<<24
  word 2  NormalTex_TrDepth                tex16 | half(tr_depth)<<16
  word 3  MRTex_SpecRoughness_CoatRoughness tex16 | rough8<<16 | coat_r8<<24
  word 4  EmissiveFactor_NormalScale       rgb8 | normal_scale8<<24
  word 5  EmissiveStrength_IOR             half(strength) | ior16<<16
  word 6  EmissiveTex_AlphaCutoff_CoatIOR  tex16 | cutoff8<<16 | coat_ior8<<24
  word 7  CoatColor_Flags                  rgb8 | flags (bits 24-29:
          METALLIC, DOUBLE_SIDED, TRANSMISSIVE, ALPHA_1, ALPHA_2,
          THIN_WALLED -- Material.h:31-39)

IOR encodings are normalized over [MIN_IOR, MAX_IOR] = [1, 2.5]
(SetSpecularIOR Material.h:183-190; 16-bit for specular, 8-bit for coat).
Metallic and transmission are threshold FLAGS in the reference
(SetMetallic / SetTransmission, Material.h:233-252); the continuous values
live in texture maps. This module packs the port's ``CpuScene`` materials
(``scene.scene.MaterialsSoA``) into the exact word layout (and back), in
numpy, as the JAX package's ``scene/material_pack.py`` does, so the
interchange format matches the reference bit for bit. The shading path
keeps the semantic SoA table; the packed form is the export and parity
record.
"""

from __future__ import annotations

import numpy as np

MIN_IOR = 1.0
MAX_IOR = 2.5
INVALID_ID = (1 << 16) - 1
F_METALLIC = 24
F_DOUBLE_SIDED = 25
F_TRANSMISSIVE = 26
F_ALPHA_1 = 27
F_THIN_WALLED = 29
MIN_METALNESS_METAL = 0.9  # Material.h threshold semantics
MIN_SPEC_TR_TRANSMISSIVE = 0.5


def _unorm8(x):
    return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint32)


def _half_bits(x):
    return np.asarray(x, np.float16).view(np.uint16).astype(np.uint32)


def _ior16(ior):
    t = np.clip((np.asarray(ior) - MIN_IOR) / (MAX_IOR - MIN_IOR), 0.0, 1.0)
    return np.round(t * 65535.0).astype(np.uint32)


def _ior8(ior):
    t = np.clip((np.asarray(ior) - MIN_IOR) / (MAX_IOR - MIN_IOR), 0.0, 1.0)
    return np.round(t * 255.0).astype(np.uint32)


def _tex16(idx):
    i = np.asarray(idx, np.int64)
    return np.where(i < 0, INVALID_ID, i).astype(np.uint32) & 0xFFFF


def pack_materials(m) -> np.ndarray:
    """MaterialsSoA -> [M, 8] uint32 in the reference's exact word layout."""
    n = m.base_color.shape[0]
    w = np.zeros((n, 8), np.uint32)
    bc = m.base_color
    w[:, 0] = (
        _unorm8(bc[:, 0]) | (_unorm8(bc[:, 1]) << 8)
        | (_unorm8(bc[:, 2]) << 16) | (np.uint32(255) << 24)
    )
    coat_w = getattr(m, "coat_weight", np.zeros(n))
    w[:, 1] = (
        _tex16(m.base_color_tex)
        | (np.uint32(0) << 16)  # subsurface: not modeled in our SoA
        | (_unorm8(coat_w) << 24)
    )
    normal_tex = m.normal_tex if m.normal_tex is not None else np.full(n, -1)
    w[:, 2] = _tex16(normal_tex) | (_half_bits(np.zeros(n)) << 16)
    mr_tex = (
        m.metallic_roughness_tex
        if m.metallic_roughness_tex is not None else np.full(n, -1)
    )
    w[:, 3] = (
        _tex16(mr_tex) | (_unorm8(m.roughness) << 16)
        | (_unorm8(getattr(m, "coat_roughness", np.zeros(n))) << 24)
    )
    # emissive factor: direction (rgb in [0,1]); strength carries magnitude
    em = np.asarray(m.emissive, np.float32)
    mag = np.maximum(em.max(axis=-1), 1e-8)
    strength = np.where(em.max(axis=-1) > 0, mag, 1.0)
    fac = np.where(em.max(axis=-1, keepdims=True) > 0, em / mag[:, None], 0.0)
    w[:, 4] = (
        _unorm8(fac[:, 0]) | (_unorm8(fac[:, 1]) << 8)
        | (_unorm8(fac[:, 2]) << 16) | (_unorm8(np.ones(n)) << 24)
    )
    w[:, 5] = _half_bits(strength) | (_ior16(m.ior) << 16)
    em_tex = m.emissive_tex if m.emissive_tex is not None else np.full(n, -1)
    cutoff = (
        m.alpha_cutoff if m.alpha_cutoff is not None else np.zeros(n)
    )
    w[:, 6] = (
        _tex16(em_tex) | (_unorm8(cutoff) << 16) | (_ior8(np.full(n, 1.5)) << 24)
    )
    flags = np.zeros(n, np.uint32)
    flags |= (np.asarray(m.metallic) >= MIN_METALNESS_METAL).astype(np.uint32) << F_METALLIC
    flags |= np.asarray(m.double_sided, np.uint32) << F_DOUBLE_SIDED
    flags |= (
        np.asarray(m.transmission) >= MIN_SPEC_TR_TRANSMISSIVE
    ).astype(np.uint32) << F_TRANSMISSIVE
    alpha_mode = (np.asarray(cutoff) > 0).astype(np.uint32)  # 1 = MASK
    flags |= alpha_mode << F_ALPHA_1
    coat_col = _unorm8(np.full(n, 0.8))
    w[:, 7] = coat_col | (coat_col << 8) | (coat_col << 16) | flags
    return w


def unpack_materials(w: np.ndarray) -> dict:
    """[M, 8] uint32 -> dict of decoded fields (reference Get* semantics)."""
    def u8(word, shift):
        return ((word >> shift) & 0xFF).astype(np.float32) / 255.0

    def tex(word):
        t = (word & 0xFFFF).astype(np.int64)
        return np.where(t == INVALID_ID, -1, t).astype(np.int32)

    strength = (w[:, 5] & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    ior = MIN_IOR + ((w[:, 5] >> 16) & 0xFFFF).astype(np.float32) * (
        (MAX_IOR - MIN_IOR) / 65535.0
    )
    em_fac = np.stack([u8(w[:, 4], 0), u8(w[:, 4], 8), u8(w[:, 4], 16)], -1)
    return {
        "base_color": np.stack(
            [u8(w[:, 0], 0), u8(w[:, 0], 8), u8(w[:, 0], 16)], -1
        ),
        "base_color_tex": tex(w[:, 1]),
        "coat_weight": u8(w[:, 1], 24),
        "normal_tex": tex(w[:, 2]),
        "metallic_roughness_tex": tex(w[:, 3]),
        "roughness": u8(w[:, 3], 16),
        "coat_roughness": u8(w[:, 3], 24),
        "emissive": em_fac * strength[:, None],
        "emissive_strength": strength,
        "ior": ior,
        "emissive_tex": tex(w[:, 6]),
        "alpha_cutoff": u8(w[:, 6], 16),
        "coat_ior": MIN_IOR + ((w[:, 6] >> 24) & 0xFF).astype(np.float32)
        * ((MAX_IOR - MIN_IOR) / 255.0),
        "metallic": ((w[:, 7] >> F_METALLIC) & 1).astype(np.float32),
        "double_sided": ((w[:, 7] >> F_DOUBLE_SIDED) & 1).astype(bool),
        "transmissive": ((w[:, 7] >> F_TRANSMISSIVE) & 1).astype(bool),
        "alpha_mode": ((w[:, 7] >> F_ALPHA_1) & 3).astype(np.int32),
    }
