"""Host-side emissive power per emissive triangle (alias-table weights)."""

from __future__ import annotations

import numpy as np

_LUM = np.array([0.2126, 0.7152, 0.0722], np.float64)


def emissive_powers(cpu_scene) -> np.ndarray:
    """[E] float64 power weights: luminance(Le) * area * pi."""
    em = cpu_scene.emissive_tris
    areas = cpu_scene.areas()[em]
    le = cpu_scene.materials.emissive[cpu_scene.mat_id[em]].astype(np.float64)
    return np.maximum((le @ _LUM) * areas * np.pi, 0.0)
