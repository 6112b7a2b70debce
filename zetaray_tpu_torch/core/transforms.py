"""Host-side camera basis (numpy), as ``look_at`` of the JAX package's ``core/transforms.py``."""

from __future__ import annotations

import numpy as np


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world 4x4. Camera space: +X right, +Y up, -Z forward."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, up)
    n = np.linalg.norm(right)
    if n < 1e-8:
        alt = np.array([0.0, 0.0, 1.0]) if abs(fwd[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        right = np.cross(fwd, alt)
        n = np.linalg.norm(right)
    right = right / n
    upv = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = upv
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m
