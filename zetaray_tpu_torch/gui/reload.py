"""Hot reload: the dxc-shader-reload editor affordance.

The reference's GUI has a "reload shader" button per pass: it re-runs
dxc.exe on the edited HLSL and swaps the PSO live
(PipelineStateLibrary.cpp:201-232). In the port a pass is a Python op
module and, below it, the hand-written CUDA kernels. ``reload_ops``
re-imports the op and render modules that are loaded, leaves first, so
dependents rebind the reloaded names; then, where the library of kernels
is loaded and a ``csrc`` source changed since, ``native.reload_lib`` builds
the library of the new sources (a new hashed name) and loads it -- the
PSO swap. The next frame runs the edited code without restarting the
viewer.

Excluded: ``native`` itself (it holds the loaded libraries), ``core.rows``
and the ``scene`` modules, whose objects the viewer keeps across frames
(the uploaded scene, its textures, the host scene, the camera). The
configs the viewer keeps are instances of classes defined in reloaded
modules, so the caller rebuilds them from the reloaded classes
(``rebuild``) and drops its temporal state, whose layouts may have
changed.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys

from .. import native

_PKG = __name__.rsplit(".", 2)[0]

# dependency order: leaves first so dependents rebind reloaded symbols
RELOAD_ORDER = [
    f"{_PKG}.{m}" for m in (
        "core.packing", "core.sampling", "core.rng", "core.vec3",
        "ops.shading_soa", "ops.lights", "ops.sky",
        "accel.megakernel", "accel.intersect", "accel.stream",
        "ops.pathtracer", "ops.gbuffer_pack", "ops.reservoir_pack", "ops.prelighting",
        "ops.restir_di", "ops.restir_gi", "ops.restir_pt", "ops.skydi", "ops.volumetrics",
        "ops.denoise", "ops.taa", "ops.upscale", "ops.post",
        "render.picking", "render.frame", "profile", "render.graph",
    )
]


def reload_ops() -> list[str]:
    """Reload the op and render modules that are imported, leaves first,
    then the kernels' library where its sources changed. Returns the
    modules reloaded, and ``native`` where the library was rebuilt."""
    reloaded = []
    for name in RELOAD_ORDER:
        mod = sys.modules.get(name)
        if mod is not None:
            importlib.reload(mod)
            reloaded.append(name)
    if native.reload_lib():
        reloaded.append(native.__name__)
    return reloaded


def rebuild(obj):
    """A frozen config (a dataclass instance, its fields rebuilt in turn)
    made again from the class of the same name in its module as it is now,
    so that it is an instance of the reloaded class. Other values are
    returned as they are."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    cls = getattr(sys.modules[type(obj).__module__], type(obj).__qualname__)
    kw = {f.name: rebuild(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init}
    return cls(**kw)
