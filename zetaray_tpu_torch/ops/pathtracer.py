"""The path tracer, as ``ops/pathtracer.py`` of the JAX package: its settings
``PTConfig`` and ``trace``.

``trace`` runs the fused bounce kernel B6 once per bounce
(``accel.megakernel.trace_megakernel``) on every device; a CPU tensor takes
B6's plain version. The JAX package's wavefront ``trace_reference`` is its
oracle for the CPU and for clustered scenes and has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..accel.megakernel import trace_megakernel


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


def trace(scene, o, d, seed: int, cfg: PTConfig = PTConfig(), rt: int = 1024,
          rows_out: bool = False, light_sets=None):
    """Path-traced radiance of rays o, d [N, 3]: [N, 3] linear HDR, or rows
    [3, N] with ``rows_out``. ``seed`` is the u32 frame seed; ``rt`` the tile
    width that picks each ray's light set. ``light_sets``: the frame's sets,
    used where they are the ones ``seed`` gives (``trace_megakernel``)."""
    return trace_megakernel(scene, o, d, seed, cfg, rt=rt, rows_out=rows_out,
                            light_sets=light_sets)
