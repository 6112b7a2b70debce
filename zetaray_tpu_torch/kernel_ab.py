"""A/B of the kernels B1 (G-buffer), B2 (RIS), B3 (dense any hit), B4
(bounce trace), B5 (bounce shade), B6 (fused bounce), B7 (closest hit +
attribute row), B8 (clustered closest hit) and B9 (clustered any hit)
against another commit's, on the card, in one process.

    python -m zetaray_tpu_torch.kernel_ab --parent DIR [--out FILE]

DIR is the other commit's package (``git archive <commit> zetaray_tpu_torch``
unpacked; DIR is its ``zetaray_tpu_torch``). It is copied to a temporary
directory outside the checkout and imported there under another name, so
it builds its kernels from its own sources and launches them through its
own wrappers (``accel.megakernel.gbuffer``,
``ops.restir_di.initial_candidates``, ``accel.intersect.intersect_occluded``,
``accel.megakernel.bounce_trace``, ``accel.megakernel.bounce_shade``,
``accel.megakernel.bounce``,
``accel.intersect.intersect_closest_shaded``, ``accel.stream.stream_closest``
and ``accel.stream.occlusion_stream``, whose signatures both commits share)
on its own upload of the same scene.

On the procedural Cornell box (36 triangles in 128 slots) and its
8192-triangle subdivision, at 512^2 rays built as ``chip_smoke.py`` phase 3
builds them (B1 on camera rays, B2 on their G-buffer and the frame's light
sets, B3 on DI shadow segments, B4 on GI bounce-0 rays, B5 on those rays
after B4's plain version, B6 on GI rays at bounce 1 and on its trace-only
last bounce at 2, B7 on ReSTIR PT prefix rays), B2 also on the box's
1920x1080 G-buffer, and on the box split to 139,266 triangles (clustered)
at 256^2 (B8 on camera rays, on bench.py's GI-like rays, on those of them
whose primary ray hit with the rest parked, and on GI bounce-0 rays with
the dead ones parked; B8 with its Woop epilogue, ``accel.stream.
closest_hit_stream``, bench.py's raw rate, on the camera and GI-like rays;
B9 on the DI shadow segments), it prints and writes to FILE (default
``kernel_ab.json``):

- each kernel's registers, stack frame and spills (``nvcc -Xptxas -v``) in
  both builds;
- each kernel's median time under CUDA events, taken in turns (parent, new,
  new, parent), with this checkout's B3 (dense any hit) timed alone beside
  them on the box and at 8192 triangles as the control for the spread
  between calls;
- whether every output of every ray is equal, bit for bit, between builds.

B5 and B6 also run with the sky, sun NEE, path regularization and the
firefly clamp on (``bounce_shade_sky_sun``, ``bounce_sky_sun``), the
instances of the JAX app's ``--sun`` frame.

Needs the card; it raises without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import native
from .accel import intersect as XI
from .accel import megakernel as MK
from .ops import restir_di as RD
from .ops.sky import SkyParams
from .timing import card_line, cuda_ms

SUN = (0.2, 0.45, 0.87)  # in through the box's opening at +z


def import_package(src: Path, into: Path, name: str):
    """The package at src, copied to into/name and imported as ``name``."""
    shutil.copytree(src, into / name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sys.path.insert(0, str(into))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(into))


def ptxas_report(nat) -> str:
    """What ``nvcc -Xptxas -v`` prints for each source of a package's
    ``native`` module: every kernel's registers, stack frame and spills."""
    tmp_dir = Path(tempfile.mkdtemp())
    try:
        (tmp_dir / "layout.h").write_text(nat.layout_header())
        cmds = [[nat._nvcc(), *nat.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-I", str(tmp_dir),
                 "-o", str(tmp_dir / f"{p.stem}.o"), str(p)] for p in sorted(nat.CSRC.glob("*.cu"))]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        return "".join(p.communicate()[0] for p in procs)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN patterns included)."""
    torch.cuda.synchronize()
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _shadow_segments(scene, gk, lsets, seed: int, rt: int):
    """The DI shadow segments of chip_smoke.py phase 3: from each primary hit
    to its RIS light sample, as (o, d) [N, 3]."""
    rk = RD.initial_candidates(gk, lsets, seed, rt=rt)
    so = (gk[MK.G.POS : MK.G.POS + 3] + 1e-3 * gk[MK.G.NG : MK.G.NG + 3]).T.contiguous()
    return so, (rk[0:3] - gk[MK.G.POS : MK.G.POS + 3]).T.contiguous()


def _inputs(scene, cam, res: int, seed: int):
    """B1-B7's inputs as chip_smoke.py phase 3 builds them."""
    from .ops.pathtracer import PTConfig
    from .ops.restir_gi import secondary_rays
    from .ops.restir_pt import prefix_rays
    from .render.frame import pick_rt

    o, d = cam.generate_rays(res, res, device=scene.device)
    gk = MK.gbuffer(scene, o, d)
    lsets = MK.build_light_sets(scene, seed)
    rt = pick_rt(res * res)
    o2, d2, _, _ = secondary_rays(gk, seed)
    cfg = PTConfig(max_bounces=2, min_emissive_bounce=1)
    st4, sf4 = MK.bounce_trace_plain(scene, MK.initial_state(o2, d2), 0, cfg, True,
                                     cam.pixel_spread_angle(res))
    st5 = MK.bounce_shade_plain(scene, st4, sf4, lsets, 0, seed, cfg, True, rt)
    b6 = (st5, lsets, 1, seed, cfg, False, True, rt)
    b6_last = (MK.bounce_plain(scene, *b6), lsets, 2, seed, cfg, True, True, rt)
    o7, d7 = prefix_rays(gk, seed)
    return dict(b1=(o, d), b2=gk, b3=_shadow_segments(scene, gk, lsets, seed, rt), b6=b6,
                b6_last=b6_last, b7=(o7, d7), b45=(st4, sf4, o2, d2, lsets, cfg, rt))


def _clustered_inputs(scene, cam, res: int, seed: int):
    """B8's ray sets and B9's segments as chip_smoke.py phase 3 builds them
    on the clustered box."""
    from .accel import stream as ST
    from .ops.pathtracer import park
    from .ops.restir_gi import secondary_rays
    from .render.frame import pick_rt

    dev = scene.device
    oc, dc = cam.generate_rays(res, res, device=dev)
    t_cam, _ = ST.stream_closest_plain(scene, oc, dc)
    g = torch.Generator(device=dev).manual_seed(11)
    dg = torch.randn(oc.shape, device=dev, generator=g)
    dg = dg / dg.norm(dim=1, keepdim=True).clamp_min(1e-9)
    og = oc + (t_cam - 1e-3)[:, None] * dc  # a missed primary ray leaves from ~3e38
    gk = MK.gbuffer(scene, oc, dc)
    o2, d2, _, live = secondary_rays(gk, seed)
    return {"camera": (oc, dc), "gi_like": (og, dg),
            "gi_like_parked": park(t_cam < MK.INF, og, dg),
            "gi_bounce0_parked": park(live, o2, d2),
            "b9": _shadow_segments(scene, gk, MK.build_light_sets(scene, seed), seed,
                                   pick_rt(res * res))}


def _ris_runs(p_rd, gk, lsets, seed: int, rt: int) -> dict:
    """B2 of both builds on one G-buffer and its light sets."""
    return {"parent": lambda: p_rd.initial_candidates(gk, lsets, seed, rt=rt),
            "new": lambda: RD.initial_candidates(gk, lsets, seed, rt=rt)}


def _run(out: dict, label: str, runs: dict) -> None:
    """Each entry of runs ({kernel: {build: fn}}): outputs compared bit for
    bit with the first build's, then timed in turns, into out[kernel]."""
    for kname, fns in runs.items():
        got = {v: fn() for v, fn in fns.items()}
        got = {v: g if isinstance(g, tuple) else (g,) for v, g in got.items()}
        ref = next(iter(got.values()))
        rec = out[kname] = {v: {"equal_to_first": all(bits_equal(a, b) for a, b in zip(g, ref))}
                            for v, g in got.items()}
        # in turns: forward then backward, a median of 20 runs each time
        times = {v: [] for v in fns}
        for v in list(fns) + list(reversed(fns)):
            times[v].append(cuda_ms(fns[v], reps=20))
        for v in fns:
            rec[v]["ms"] = times[v]
        print(f"{label} {kname}: " + "; ".join(
            f"{v} {[round(x, 4) for x in r['ms']]} ms equal={r['equal_to_first']}"
            for v, r in rec.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory of the other commit's zetaray_tpu_torch package")
    ap.add_argument("--out", default="kernel_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs the card: CUDA is not available")
    from .scene.camera import Camera
    from .scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
    from .render.frame import pick_rt
    from .scene.scene import upload_scene

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    work = Path(tempfile.mkdtemp(prefix="zetaray_ab_"))
    report = {"card": card, "ptxas": {}, "scenes": {}}
    try:
        name = "zetaray_ab_parent"
        import_package(args.parent.resolve(), work, name)
        p_native, p_mk, p_xi, p_st, p_rd, p_pt, p_proc, p_scene, p_sub, p_sky = (
            importlib.import_module(f"{name}.{m}") for m in (
                "native", "accel.megakernel", "accel.intersect", "accel.stream",
                "ops.restir_di", "ops.pathtracer", "scene.procedural", "scene.scene",
                "scene.subdivide", "ops.sky"))
        for label, nat in (("parent", p_native), ("new", native)):
            text = report["ptxas"][label] = ptxas_report(nat)
            print(f"ptxas, {label}:\n" + "\n".join(
                line for line in text.splitlines()
                if "Compiling" in line or "Used" in line or "spill" in line), flush=True)
        p_native.lib()
        native.lib()

        dev = torch.device("cuda", 0)
        res, seed = 512, 0x2468ACE1
        cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
        for label, subdivide in (("cornell36", None), ("cornell8192", 8192)):
            scene = upload_scene(cornell_box(subdivide_to=subdivide), device=dev)
            scene_p = p_scene.upload_scene(p_proc.cornell_box(subdivide_to=subdivide), device=dev)
            if not (bits_equal(scene.woop, scene_p.woop)
                    and bits_equal(scene.tri_attrs, scene_p.tri_attrs)):
                raise AssertionError(f"{label}: the two commits upload different scenes")
            nt, tp = scene.num_tris, scene.woop.shape[1] // 3
            inp = _inputs(scene, cam, res, seed)
            st4, sf4, o2, d2, lsets, cfg, rt = inp["b45"]
            cfg_p = p_pt.PTConfig(**{f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(p_pt.PTConfig)})
            # the sky (the sun in through the box's opening) and the path options
            opts = dict(path_regularization=True, firefly_clamp=10.0)
            cfg_s = dataclasses.replace(cfg, sky=SkyParams(sun_dir=SUN), **opts)
            cfg_sp = dataclasses.replace(cfg_p, sky=p_sky.SkyParams(sun_dir=SUN), **opts)
            o7, d7 = inp["b7"]
            st0 = MK.initial_state(o2, d2)

            def b6(key):
                st, *rest = inp[key]
                rest_p = [cfg_p if x is cfg else x for x in rest]
                return {"parent": lambda: p_mk.bounce(scene_p, st, *rest_p),
                        "new": lambda: MK.bounce(scene, st, *rest)}

            so, seg = inp["b3"]
            o1, d1 = inp["b1"]
            gk = inp["b2"]
            runs = {
                "gbuffer": {"parent": lambda: p_mk.gbuffer(scene_p, o1, d1),
                            "new": lambda: MK.gbuffer(scene, o1, d1)},
                "ris": _ris_runs(p_rd, gk, lsets, seed, rt),
                "occlusion": {
                    "parent": lambda: p_xi.intersect_occluded(scene_p, so, seg, 1e-3, 1.0 - 1e-3),
                    "new": lambda: XI.intersect_occluded(scene, so, seg, 1e-3, 1.0 - 1e-3)},
                "bounce_trace": {
                    "parent": lambda: p_mk.bounce_trace(scene_p, st0, 0, cfg_p, True),
                    "new": lambda: MK.bounce_trace(scene, st0, 0, cfg, True)},
                "bounce_shade": {
                    "parent": lambda: p_mk.bounce_shade(scene_p, st4, sf4, lsets, 0, seed, cfg_p,
                                                        True, rt),
                    "new": lambda: MK.bounce_shade(scene, st4, sf4, lsets, 0, seed, cfg, True, rt)},
                "bounce": b6("b6"),
                "bounce_last": b6("b6_last"),
                "bounce_shade_sky_sun": {
                    "parent": lambda: p_mk.bounce_shade(scene_p, st4, sf4, lsets, 0, seed,
                                                        cfg_sp, True, rt),
                    "new": lambda: MK.bounce_shade(scene, st4, sf4, lsets, 0, seed, cfg_s, True,
                                                   rt)},
                "bounce_sky_sun": {
                    "parent": lambda: p_mk.bounce(scene_p, inp["b6"][0], lsets, 1, seed, cfg_sp,
                                                  False, True, rt),
                    "new": lambda: MK.bounce(scene, inp["b6"][0], lsets, 1, seed, cfg_s, False,
                                             True, rt)},
                "closest": {"parent": lambda: p_xi.intersect_closest_shaded(scene_p, o7, d7),
                            "new": lambda: XI.intersect_closest_shaded(scene, o7, d7)},
                "control_occlusion": {
                    "this": lambda: XI.intersect_occluded(scene, so, seg, 1e-3, 1.0 - 1e-3)},
            }
            out = report["scenes"][label] = {"nt": nt, "tp": tp, "rays": res * res}
            _run(out, f"{label} (nt {nt}, tp {tp})", runs)
            if subdivide is None:  # B2 at 1920x1080, where it costs most
                cam_hd = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV,
                                        aspect=1920 / 1080)
                g_hd = MK.gbuffer(scene, *cam_hd.generate_rays(1920, 1080, device=dev))
                n_hd = g_hd.shape[1]
                out = report["scenes"]["cornell36_1080p"] = {"nt": nt, "tp": tp, "rays": n_hd}
                _run(out, "cornell36 1920x1080",
                     {"ris": _ris_runs(p_rd, g_hd, lsets, seed, pick_rt(n_hd))})
                del g_hd
            del scene, scene_p, inp, runs
            torch.cuda.empty_cache()

        # B8 and B9 on the clustered box
        from .accel import stream as ST
        from .scene.subdivide import subdivide_scene

        big = upload_scene(subdivide_scene(cornell_box(), 100_000), device=dev)
        big_p = p_scene.upload_scene(p_sub.subdivide_scene(p_proc.cornell_box(), 100_000),
                                     device=dev)
        if not bits_equal(big.woop, big_p.woop):
            raise AssertionError("cornell139k: the two commits upload different scenes")
        inp = _clustered_inputs(big, cam, 256, seed)
        so, seg = inp.pop("b9")

        def b8(o, d):
            return {"parent": lambda: p_st.stream_closest(big_p, o, d),
                    "new": lambda: ST.stream_closest(big, o, d)}

        def raw(o, d):  # bench.py's raw rate: B8 and its Woop epilogue
            return {"parent": lambda: p_st.closest_hit_stream(big_p, o, d),
                    "new": lambda: ST.closest_hit_stream(big, o, d)}

        runs = {f"stream_closest_{k}": b8(*rays) for k, rays in inp.items()}
        runs.update({f"closest_hit_stream_{k}": raw(*inp[k]) for k in ("camera", "gi_like")})
        runs["occlusion_stream"] = {
            "parent": lambda: p_st.occlusion_stream(big_p, so, seg, 1e-3, 1.0 - 1e-3),
            "new": lambda: ST.occlusion_stream(big, so, seg, 1e-3, 1.0 - 1e-3)}
        out = report["scenes"]["cornell139k"] = {"slots": big.woop.shape[1] // 3,
                                                 "rays": 256 * 256}
        _run(out, "cornell139k", runs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
