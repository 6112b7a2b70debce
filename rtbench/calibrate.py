"""The readings the check's limits are set from, on the card.

    python3 rtbench/calibrate.py --workload <cell> --seeds a,b,... [--control a,b,c]
        [--faults a,b,c] [--frames 8] [--out chiprun_out/calibrate_<cell>.json]

In one process (the scene is loaded once): for each seed, the run's
set-up frames and a short window of ``--frames`` frames at the cell's own
size, then the comparison with the reference, as ``run.py`` makes it.
``--control`` seeds also give the control's numbers: the reference with
every pass's float32 outputs rounded to bfloat16, in the port's place.
``--faults`` seeds give the numbers of the port with a fault planted under
its frame function (``rtb/faults.py``): a state left unchanged, half the
image left out, an answer altered where it is produced. It also holds the
reference's ray queries against the port's B8/B9 on a frame's camera and
GI-like rays (they must be equal). Prints one JSON line a reading and
writes them all to ``--out``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def _ray_query_check(cell, gltf, traffic, device):
    """The reference's B8/B9 answers against the port's kernels on frame 0's
    camera rays and on GI-like rays from their hits: rays that differ. An
    animated scene is posed (refit) at its clip's middle first."""
    import torch

    from rtb.loop import PORT, load_port_scene, reference_port
    from rtb.port import Animated, Port

    out = {}
    port, ref = Port(PORT), reference_port()
    ps, cfg = load_port_scene(cell, gltf, port, device)
    rs, _ = load_port_scene(cell, gltf, ref, device)
    if isinstance(ps, Animated):  # the pose at the clip's middle, the farthest from rest
        k = round(0.5 * ps.rig.duration / ps.dt)
        ps, rs = port.pose(ps, k)[0], ref.pose(rs, k)[0]
        out["pose_frame"] = k
    w, h = cfg.render_size()
    o, d = port.camera(traffic, 0).generate_rays(w, h, device=device)
    st_k, st_r = port.module("accel.stream"), ref.module("accel.stream")
    t0 = time.perf_counter()
    t_k, tri_k = st_k.stream_closest(ps, o, d)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    t_r, tri_r = st_r.stream_closest(rs, o, d)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["camera"] = dict(rays=o.shape[0], slots_differ=int((tri_k != tri_r).sum()),
                         t_differ=int((t_k != t_r).sum()), kernel_s=t1 - t0, reference_s=t2 - t1)
    g = torch.Generator(device=device).manual_seed(traffic.seed & 0x7FFFFFFF)
    dg = torch.randn(o.shape, device=device, generator=g)
    dg = dg / dg.norm(dim=1, keepdim=True).clamp_min(1e-9)
    og = o + (t_k.clamp_max(1e3) - 1e-3)[:, None] * d
    t_k, tri_k = st_k.stream_closest(ps, og, dg)
    t_r, tri_r = st_r.stream_closest(rs, og, dg)
    occ_k = st_k.occlusion_stream(ps, og, dg, 1e-3, 2.0)
    t3 = time.perf_counter()
    occ_r = st_r.occlusion_stream(rs, og, dg, 1e-3, 2.0)
    torch.cuda.synchronize()
    out["gi_like"] = dict(slots_differ=int((tri_k != tri_r).sum()), t_differ=int((t_k != t_r).sum()),
                          any_hit_differ=int((occ_k != occ_r).sum()),
                          any_hit_reference_s=time.perf_counter() - t3)
    del ps, rs
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    seeds = lambda s: [int(x) for x in s.split(",") if x]

    import torch

    from rtb import faults, loop, spec
    from rtb.port import Port
    from rtb.traffic import Traffic

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cell = spec.cell(args.workload)
    port = Port(loop.PORT)
    n_start = int(cell["check"]["start_frames"])
    out_path = Path(args.out or f"chiprun_out/calibrate_{args.workload}.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    readings = []

    def emit(rec):
        readings.append(rec)
        print(json.dumps(rec), flush=True)
        out_path.write_text(json.dumps(readings, indent=1))

    with tempfile.TemporaryDirectory(prefix="rtbench_scene_") as tmp:
        scene_cfg = cell["config"]["scene"]
        gltf = spec.scene_generator(scene_cfg["generator"]).write(tmp, scene_cfg)
        first = (seeds(args.seeds) + seeds(args.control) + seeds(args.faults))[0]
        traffic0 = Traffic(cell["traffic"], cell["config"]["camera"], first)
        emit(dict(kind="ray_queries", **_ray_query_check(cell, gltf, traffic0, device)))
        scene, cfg = loop.load_port_scene(cell, gltf, port, device)
        ref_loaded = loop.load_port_scene(cell, gltf, loop.reference_port(), device)
        jobs = ([("port", s, None) for s in seeds(args.seeds)]
                + [("control", s, None) for s in seeds(args.control)]
                + [(f"fault:{name}", s, hook) for s in seeds(args.faults)
                   for name, hook in faults.FAULTS.items()])
        for kind, seed, hook in jobs:
            t = time.perf_counter()
            traffic = Traffic(cell["traffic"], cell["config"]["camera"], seed)
            frame = port.frame if hook is None else hook(port.frame)
            state, start = loop.warm_up(port, scene, cfg, traffic, frame, n_start, device)
            win = loop.window(port, scene, cfg, traffic, frame, state, 0.0, device,
                              max_frames=args.frames, keep=traffic.warm_frames + args.frames // 2)
            t_prog = time.perf_counter() - t
            checked = {"sampled": win.kept, "last": win.last}
            del state, win
            t = time.perf_counter()
            vals = loop.reference_checks(cell, gltf, traffic, device, start, checked,
                                         control=kind == "control", loaded=ref_loaded)
            del start, checked
            torch.cuda.empty_cache()
            emit(dict(kind=kind, seed=seed, values=vals, port_s=t_prog,
                      reference_s=time.perf_counter() - t))
    print(json.dumps({"done": len(readings), "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
