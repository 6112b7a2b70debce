"""lvg_ms: device time per profiled frame of the kernels launched in the
light voxel grid's passes: its build (``ops.prelighting.build_light_voxel_grid``,
``layers/frame.json``) and the DI grid candidates (``ops.restir_di.lvg_merge``,
``layers/reuse.json``). None where neither ran."""

STAGES = ("rtbench.stage.frame:light voxel grid build", "rtbench.stage.reuse:DI grid candidates")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    v = tr.per_frame_us(lambda op: op["stage"] in STAGES)
    return v * 1e-3 if v > 0 else None
