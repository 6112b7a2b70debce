"""Host-side transform math in numpy float64, as the JAX package's
``core/transforms.py``: quaternions, SRT composition and decomposition,
normal matrices, camera bases.

Conventions: matrices are row-major, points are column-multiplied
(``M[:3, :3]`` is the linear part, ``M[:3, 3]`` the translation; glTF stores
column-major and the loader transposes); right-handed world, +Y up, the
camera looks down its local -Z; quaternions in glTF order ``[x, y, z, w]``.
"""

from __future__ import annotations

import numpy as np


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    """Quaternion [x, y, z, w] (normalised here) -> 3x3 rotation matrix."""
    x, y, z, w = (float(v) for v in q)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n == 0.0:
        return np.eye(3)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def mat3_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion [x, y, z, w]."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def trs_to_mat4(translation=None, rotation=None, scale=None) -> np.ndarray:
    """A glTF node's TRS as a 4x4 matrix (M = T * R * S)."""
    m = np.eye(4, dtype=np.float64)
    r = quat_to_mat3(rotation) if rotation is not None else np.eye(3)
    s = np.asarray(scale, dtype=np.float64) if scale is not None else np.ones(3)
    m[:3, :3] = r * s[None, :]
    if translation is not None:
        m[:3, 3] = np.asarray(translation, dtype=np.float64)
    return m


def decompose_srt(m: np.ndarray):
    """4x4 affine -> (scale [3], rotation quaternion [x, y, z, w],
    translation [3]). No shear; a negative determinant flips the x scale."""
    m = np.asarray(m, dtype=np.float64)
    t = m[:3, 3].copy()
    lin = m[:3, :3].copy()
    s = np.linalg.norm(lin, axis=0)
    if np.linalg.det(lin) < 0:
        s[0] = -s[0]
    r = lin / s[None, :]
    return s, mat3_to_quat(r), t


def normal_matrix(m: np.ndarray) -> np.ndarray:
    """Inverse transpose of the linear part, which transforms normals."""
    return np.linalg.inv(np.asarray(m)[:3, :3]).T


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


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """A 4x4 affine applied to [N, 3] points."""
    return pts @ m[:3, :3].T + m[:3, 3][None, :]


def transform_dirs(m: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """The linear part of a 4x4 applied to [N, 3] directions (not normalised)."""
    return dirs @ m[:3, :3].T
