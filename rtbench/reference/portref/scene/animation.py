"""Keyframe animation on the host, as the JAX package's ``scene/animation.py``.

Node TRS channels are sampled each frame (glTF 2.0 section 3.11: STEP,
LINEAR with spherical interpolation of rotations, CUBICSPLINE with tangents
scaled by the key interval; times outside the keys clamp to the first or
last key, and ``loop=True`` wraps time by the clip's duration first). The
node hierarchy gives each instance's world matrix at time t, and
``AnimationRig.deltas`` the per-instance transforms from the rest pose to
t, which ``scene.refit.refit_scene`` applies to the uploaded scene on its
device. ``transform_deltas(W_curr, W_prev)`` gives the curr -> prev
transforms the frame's ``motion`` argument takes.
"""

from __future__ import annotations

import numpy as np

from ..core import transforms as T
from .gltf import GltfDoc


def _slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    """Spherical linear interpolation of unit quaternions [x, y, z, w]."""
    d = float(np.dot(q0, q1))
    if d < 0.0:  # shortest arc
        q1 = -q1
        d = -d
    if d > 0.9995:  # nearly parallel: lerp + renormalize
        q = q0 + u * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(th)
    return (np.sin((1.0 - u) * th) * q0 + np.sin(u * th) * q1) / s


def sample_channel(ch, t: float) -> np.ndarray:
    """Evaluate one GltfChannel at time t (seconds). Returns [C]."""
    times = ch.times
    k = len(times)
    if k == 0:
        raise ValueError("empty animation channel")
    cubic = ch.interpolation == "CUBICSPLINE"
    vals = ch.values  # [K, C] or [K, 3, C]

    def value(i):
        return vals[i, 1] if cubic else vals[i]

    if t <= times[0] or k == 1:
        return np.asarray(value(0), np.float64)
    if t >= times[-1]:
        return np.asarray(value(k - 1), np.float64)
    i1 = int(np.searchsorted(times, t, side="right"))
    i0 = i1 - 1
    dt = float(times[i1] - times[i0])
    u = (float(t) - float(times[i0])) / max(dt, 1e-12)
    if ch.interpolation == "STEP":
        return np.asarray(value(i0), np.float64)
    if cubic:
        # glTF 3.11.2: p(u) = h00 v0 + h10 dt b0 + h01 v1 + h11 dt a1
        v0 = vals[i0, 1].astype(np.float64)
        b0 = vals[i0, 2].astype(np.float64)  # out-tangent of key i0
        v1 = vals[i1, 1].astype(np.float64)
        a1 = vals[i1, 0].astype(np.float64)  # in-tangent of key i1
        u2, u3 = u * u, u * u * u
        out = (
            (2 * u3 - 3 * u2 + 1) * v0
            + dt * (u3 - 2 * u2 + u) * b0
            + (-2 * u3 + 3 * u2) * v1
            + dt * (u3 - u2) * a1
        )
        if ch.path == "rotation":
            out /= max(np.linalg.norm(out), 1e-12)
        return out
    # LINEAR
    v0 = np.asarray(value(i0), np.float64)
    v1 = np.asarray(value(i1), np.float64)
    if ch.path == "rotation":
        return _slerp(v0, v1, u)
    return v0 + u * (v1 - v0)


class AnimationRig:
    """Node hierarchy + channels + instance rest poses, ready to sample.

    `instance_worlds(t)` -> [I, 4, 4] world transforms at time t.
    `deltas(t)` -> per-instance (point [I, 3, 4], normal [I, 3, 3]) deltas
    relative to the rest pose, with an identity row appended at index I so
    padding triangles (inst_id = -1) can gather it.
    """

    def __init__(self, doc: GltfDoc, animation: int = 0):
        self.nodes = doc.nodes
        self.traversal = list(doc.traversal)
        self.inst_nodes = [inst.node for inst in doc.instances]
        self.rest_worlds = np.stack(
            [inst.world for inst in doc.instances]
        ) if doc.instances else np.zeros((0, 4, 4))
        anims = doc.animations
        self.animation = (
            anims[animation] if anims and 0 <= animation < len(anims) else None
        )
        # channels grouped per node: {node: {path: channel}}
        self.by_node: dict[int, dict[str, object]] = {}
        if self.animation is not None:
            for ch in self.animation.channels:
                self.by_node.setdefault(ch.node, {})[ch.path] = ch

    @property
    def duration(self) -> float:
        return self.animation.duration if self.animation is not None else 0.0

    @property
    def animated(self) -> bool:
        return bool(self.by_node)

    def node_worlds(self, t: float) -> dict[int, np.ndarray]:
        """World matrices of all traversed nodes at time t."""
        worlds: dict[int, np.ndarray] = {}
        for ni in self.traversal:
            rec = self.nodes[ni]
            chans = self.by_node.get(ni)
            if chans:
                # animated node: TRS base overridden per-channel (a matrix
                # node's base TRS comes from SRT decomposition, spec 5.24)
                if rec.matrix is not None:
                    s, r, tr = T.decompose_srt(rec.matrix)
                else:
                    tr, r, s = rec.translation, rec.rotation, rec.scale
                if "translation" in chans:
                    tr = sample_channel(chans["translation"], t)
                if "rotation" in chans:
                    r = sample_channel(chans["rotation"], t)
                if "scale" in chans:
                    s = sample_channel(chans["scale"], t)
                local = T.trs_to_mat4(tr, r, s)
            elif rec.matrix is not None:
                local = rec.matrix
            else:
                local = T.trs_to_mat4(rec.translation, rec.rotation, rec.scale)
            parent = worlds.get(rec.parent)
            worlds[ni] = local if parent is None else parent @ local
        return worlds

    def instance_worlds(self, t: float, loop: bool = True) -> np.ndarray:
        if loop and self.duration > 0:
            t = float(t) % self.duration
        worlds = self.node_worlds(t)
        out = np.empty_like(self.rest_worlds)
        for i, ni in enumerate(self.inst_nodes):
            out[i] = worlds.get(ni, self.rest_worlds[i])
        return out

    def deltas(self, t: float, loop: bool = True):
        """Per-instance rest->t deltas: (point [I+1, 3, 4], normal
        [I+1, 3, 3]) float32, identity appended for padding gathers."""
        return transform_deltas(self.rest_worlds, self.instance_worlds(t, loop))


def transform_deltas(from_worlds: np.ndarray, to_worlds: np.ndarray):
    """Per-instance world->world deltas D_i = to_i @ from_i^-1.

    Returns (point deltas [I+1, 3, 4], normal deltas [I+1, 3, 3]) float32
    with an identity row appended at index I (padding triangles gather it).
    Applied as p' = D[:, :3] @ p + D[:, 3]; n' = N @ n (then renormalize).
    """
    n = from_worlds.shape[0]
    dp = np.zeros((n + 1, 3, 4), np.float64)
    dn = np.zeros((n + 1, 3, 3), np.float64)
    for i in range(n):
        d = to_worlds[i] @ np.linalg.inv(from_worlds[i])
        dp[i] = d[:3, :4]
        dn[i] = np.linalg.inv(d[:3, :3]).T
    dp[n, :, :3] = np.eye(3)
    dn[n] = np.eye(3)
    return dp.astype(np.float32), dn.astype(np.float32)
