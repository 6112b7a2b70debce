"""Frame-graph introspection (RenderGraph::DebugDrawGraph analog), as the
JAX package's ``render/graph.py``.

The reference rebuilds an explicit DAG every frame and can draw it with
imnodes (RenderGraph.cpp:1042). Here introspection means two things:

  - ``frame_dag(cfg)``: the logical pass-level DAG for the active
    RenderConfig as Graphviz DOT (what the reference draws), the same text
    as the JAX function's for every mode and option;
  - ``dump_launches(fn, *args)``: what a call really ran on the device --
    its kernel launches in order, each with its count, read by
    ``torch.profiler``. It takes the place of the JAX package's
    ``dump_hlo`` and ``dump_jaxpr``: the port's frame is a sequence of
    launches, not one compiled XLA program, so there is no HLO or jaxpr to
    dump.
"""

from __future__ import annotations

import torch


def frame_dag(cfg) -> str:
    """Graphviz DOT of the logical pass graph for this RenderConfig.

    Mirrors ``render.frame.render_frame_restir``'s actual wiring for every
    mode (pt / restir_di / restir_gi / restir_pt) and every optional
    subsystem (LVG, SkyDI, volumetrics, temporal upscaling) -- the
    reference's DebugDrawGraph always shows the REAL frame
    (RenderGraph.cpp:1042), so this must not fall behind the frame fn.
    """
    edges: list[tuple[str, str]] = []
    nodes = ["camera_rays"]

    def edge(a, b):
        if a not in nodes:
            nodes.append(a)
        if b not in nodes:
            nodes.append(b)
        edges.append((a, b))

    restir = cfg.mode in ("restir_di", "restir_gi", "restir_pt")
    if restir:
        edge("camera_rays", "gbuffer")
        edge("scene", "gbuffer")
        edge("scene", "presample_lights")
        edge("gbuffer", "restir_initial(RIS)")
        edge("presample_lights", "restir_initial(RIS)")
        src_di = "restir_initial(RIS)"
        if cfg.restir.lvg_samples > 0:
            edge("scene", "light_voxel_grid")
            edge("light_voxel_grid", "lvg_merge")
            edge(src_di, "lvg_merge")
            src_di = "lvg_merge"
        if cfg.restir.temporal:
            edge(src_di, "restir_temporal")
            edge("prev_frame_state", "restir_temporal")
            src_di = "restir_temporal"
        edge(src_di, "visibility_reuse")
        edge("visibility_reuse", "restir_spatial")
        edge("restir_spatial", "shade_direct")
        edge("shade_direct", "composite")

        use_skydi = (
            cfg.skydi and cfg.pt.sky is not None
            and cfg.mode in ("restir_gi", "restir_pt")
        )
        if use_skydi:
            edge("gbuffer", "skydi_initial")
            src_sky = "skydi_initial"
            if cfg.skydi_cfg.temporal:
                edge(src_sky, "skydi_temporal")
                edge("prev_frame_state", "skydi_temporal")
                src_sky = "skydi_temporal"
            edge(src_sky, "skydi_spatial")
            edge("skydi_spatial", "shade_sky")
            edge("shade_sky", "composite")

        if not cfg.indirect:
            pass
        elif cfg.mode == "restir_gi":
            edge("gbuffer", "gi_initial(trace)")
            edge("scene", "gi_initial(trace)")
            src_gi = "gi_initial(trace)"
            if cfg.restir_gi.temporal:
                edge(src_gi, "gi_temporal")
                edge("prev_frame_state", "gi_temporal")
                src_gi = "gi_temporal"
            edge(src_gi, "gi_spatial")
            edge("gi_spatial", "shade_indirect")
            edge("shade_indirect", "composite")
        elif cfg.mode == "restir_pt":
            edge("gbuffer", "pt_initial(prefix+suffix trace)")
            edge("scene", "pt_initial(prefix+suffix trace)")
            src_pt = "pt_initial(prefix+suffix trace)"
            if cfg.restir_pt.temporal:
                nm = "pt_temporal(reconnect"
                nm += "+replay)" if cfg.restir_pt.replay else ")"
                edge(src_pt, nm)
                edge("prev_frame_state", nm)
                src_pt = nm
            sp = "pt_spatial(reconnect"
            sp += "+replay)" if cfg.restir_pt.replay else ")"
            edge(src_pt, sp)
            edge(sp, "shade_path")
            edge("shade_path", "composite")
        else:  # restir_di: PT megakernel supplies the indirect term
            edge("camera_rays", "pt_indirect(megakernel)")
            edge("scene", "pt_indirect(megakernel)")
            edge("pt_indirect(megakernel)", "composite")
        src = "composite"
    else:
        edge("camera_rays", "pt(megakernel)")
        edge("scene", "pt(megakernel)")
        src = "pt(megakernel)"

    if cfg.volumetrics is not None and cfg.pt.sky is not None:
        edge("scene", "froxel_grid")
        edge(src, "apply_inscattering")
        edge("froxel_grid", "apply_inscattering")
        src = "apply_inscattering"
    if cfg.firefly_factor > 0.0:
        edge(src, "firefly_filter")
        src = "firefly_filter"
    if restir and cfg.denoise:
        edge(src, "atrous_denoise")
        src = "atrous_denoise"
    upscaled = restir and cfg.render_scale != 1.0
    if upscaled:
        edge(src, "taau_upscale(FSR2 slot)")
        edge("prev_frame_state", "taau_upscale(FSR2 slot)")
        src = "taau_upscale(FSR2 slot)"
    elif restir and cfg.taa:
        edge(src, "taa")
        edge("prev_frame_state", "taa")
        src = "taa"
    edge(src, "auto_exposure")
    edge("auto_exposure", "tonemap+sRGB")
    src = "tonemap+sRGB"
    if upscaled and cfg.upscale_cfg.rcas_sharpness > 0.0:
        # RCAS assumes ~[0,1] signals: runs post-tonemap (_postprocess)
        edge(src, "rcas_sharpen")
        src = "rcas_sharpen"
    edge(src, "display")

    lines = ["digraph frame {", "  rankdir=LR;"]
    for n in nodes:
        lines.append(f'  "{n}" [shape=box];')
    for a, b in edges:
        lines.append(f'  "{a}" -> "{b}";')
    lines.append("}")
    return "\n".join(lines)


def dump_launches(fn, *args, **kwargs) -> str:
    """Run ``fn(*args, **kwargs)`` under ``torch.profiler`` and list the
    device kernels it launched, in launch order, one line a run of launches
    of the same kernel (``name x count``), then the number of launches. On
    the CPU, where there is no device trace, the operators it ran take
    their place. Synchronises the device before it returns."""
    from ..profile import profiled

    prof, _ = profiled(fn, *args, **kwargs)
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    kind = "device kernels"
    if not on_device:  # the CPU: the top-level operators, under the frame's spans
        kind = "operators"
        span = lambda e: e is not None and e.name.startswith("zr.")
        on_device = [e for e in prof.events()
                     if not span(e) and (e.cpu_parent is None or span(e.cpu_parent))]
    events = sorted(on_device, key=lambda e: e.time_range.start)
    runs: list[list] = []
    for e in events:
        if runs and runs[-1][0] == e.name:
            runs[-1][1] += 1
        else:
            runs.append([e.name, 1])
    lines = [f"{name} x {count}" for name, count in runs]
    lines.append(f"{len(events)} {kind}")
    return "\n".join(lines)
