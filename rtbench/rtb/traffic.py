"""The one traffic generator: a closed loop of frames from one viewer.

A traffic file gives the display size and the camera's path; ``--seed``
gives each frame's u32 seed and the phase of the sway. Frame k looks at
the configuration's target from its eye turned by
``sway_deg * sin(2 pi (k + phase) / sway_period)`` degrees about the
vertical axis through the target, with the Halton TAA jitter of frame k.
A window spans several periods, so every seed sweeps nearly the same
angles: seeds change the noise and the order, not the work (with a phase
drawn from the seed and a window shorter than a period, the seed picked
which angles a window saw, and frame times moved with it).
"""

from __future__ import annotations

import math

MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


class Traffic:
    """The frames of one run: ``eye(k)``, ``frame_seed(k)``."""

    def __init__(self, traffic: dict, camera: dict, seed: int):
        self.width, self.height = int(traffic["width"]), int(traffic["height"])
        self.sway_deg = float(traffic["sway_deg"])
        self.period = float(traffic["sway_period_frames"])
        self.in_flight = int(traffic["frames_in_flight"])
        self.warm_frames = int(traffic["warm_frames"])
        self.eye0 = [float(x) for x in camera["eye"]]
        self.target = [float(x) for x in camera["target"]]
        self.vfov = float(camera["vfov_deg"])
        self.seed = int(seed)
        self.phase = (_mix(self.seed & MASK64) >> 11) / float(1 << 53) * self.period

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def angle(self, k: int) -> float:
        """Frame k's sway, radians."""
        return math.radians(self.sway_deg) * math.sin(2.0 * math.pi * (k + self.phase) / self.period)

    def eye(self, k: int) -> tuple:
        a = self.angle(k)
        rx, rz = self.eye0[0] - self.target[0], self.eye0[2] - self.target[2]
        c, s = math.cos(a), math.sin(a)
        return (self.target[0] + c * rx + s * rz, self.eye0[1], self.target[2] - s * rx + c * rz)

    def sampled_frame(self, span: int = 40) -> int:
        """The window frame whose answer the check samples, drawn from the
        seed among the ``span`` frames after the window's fourth."""
        return self.warm_frames + 4 + _mix((self.seed ^ 0x5A5A5A5A) & MASK64) % span

    def frame_seed(self, k: int) -> int:
        return _mix(((self.seed & MASK64) * 0x100000001B3 + k) & MASK64) & 0xFFFFFFFF
