"""Path-tracer settings, as ``PTConfig`` of the JAX package's ``ops/pathtracer.py``.

Only the settings record is ported: the bounce kernels that read it are in
``accel/megakernel.py``. The wavefront tracer (``trace``, the plain PT mode)
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PTConfig:
    """Field names and defaults follow the JAX package."""

    max_bounces: int = 4  # path segments after the primary hit
    rr_start: int = 3  # bounce index where Russian roulette starts
    nee: bool = True  # next-event estimation against emissive lights
    t_min: float = 1e-4
    firefly_clamp: float = 0.0  # 0 = off (clamping is not ported yet)
    # emission at bounce < min_emissive_bounce and NEE at bounce <
    # min_nee_bounce are skipped (the DI/GI split of the frame)
    min_emissive_bounce: int = 0
    min_nee_bounce: int = 0
    sky: object = None  # the sun and sky environment is not ported yet
    sun_nee: bool = True
    light_ns: int = 64  # presampled light sets
    light_ps: int = 128  # samples per set
    nee_mode: str = "wps"  # "wops" (per-ray alias sampling) is not ported yet
    stochastic_multi_bounce: bool = False  # not ported yet
    path_regularization: bool = False  # not ported yet

    def unported(self) -> list[str]:
        """Names of the settings this package does not implement yet."""
        later = {
            "pt.sky (the sun and sky environment, ops.sky)": self.sky is not None,
            f"pt.nee_mode={self.nee_mode!r} (per-ray alias NEE)": self.nee_mode != "wps",
            "pt.stochastic_multi_bounce": self.stochastic_multi_bounce,
            "pt.path_regularization": self.path_regularization,
            "pt.firefly_clamp > 0": self.firefly_clamp > 0.0,
        }
        return [name for name, hit in later.items() if hit]
