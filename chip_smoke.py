"""Drive the PyTorch port's ReSTIR DI frame once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. needs CUDA; prints the card's name and power limit;
  2. builds the CUDA kernels of zetaray_tpu_torch/csrc with nvcc;
  3. holds each kernel against its plain PyTorch version at the frame's
     shapes (G-buffer and occlusion over 512^2 rays on the procedural
     Cornell box and on its 8192-triangle subdivision, RIS over 512^2 pixels
     with [64, 16, 128] light sets) and times both with CUDA events;
  4. renders the slice (mode restir_gi, indirect off, a-trous, TAA,
     histogram exposure, AgX) for 4 chained frames at 512^2 and 4 at
     1920x1080 (the first frame of a chain has no temporal reuse and no
     TAA, so frame times are medians of frames 2-4), checks that every
     kernel launched and that the images are finite and lit, and compares
     a 64^2 frame on the card with the same frame on the CPU;
  5. prints the kernels' record, the card line, and last a JSON status.

The 512^2 image is written to chiprun_out/zetaray_torch_512.png.
"""

from __future__ import annotations

import json
import os
import statistics
import struct
import subprocess
import sys
import time
import zlib

import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def write_png(path: str, img) -> None:
    """[H, W, 3] uint8 numpy array -> PNG file."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from zetaray_tpu_torch import native
    from zetaray_tpu_torch.accel import intersect as XI
    from zetaray_tpu_torch.accel import megakernel as MK
    from zetaray_tpu_torch.ops import restir_di as RD
    from zetaray_tpu_torch.render.frame import RenderConfig, pick_rt, render_frame_restir
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.procedural import (
        CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box,
    )
    from zetaray_tpu_torch.scene.scene import upload_scene

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = native.build()
    native.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib_path)}", flush=True)

    # -- phase 3: each kernel against its plain version at the slice's shapes
    res = 512
    n = res * res
    seed = 0x2468ACE1
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    o, d = cam.generate_rays(res, res, device=dev)
    record = {}
    for label, subdivide in (("cornell36", None), ("cornell8192", 8192)):
        scene = upload_scene(cornell_box(subdivide_to=subdivide), device=dev)
        tp = scene.woop.shape[1] // 3
        gk = MK.gbuffer(scene, o, d)
        gp = MK.gbuffer_plain(scene, o, d)
        torch.cuda.synchronize()
        for r in (MK.G.VALID, MK.G.MATID, MK.G.INST):
            if not torch.equal(gk[r], gp[r]):
                raise AssertionError(f"gbuffer {label}: row {r} differs from the plain version")
        hit = gp[MK.G.VALID] > 0.5
        err_g = (gk[:, hit] - gp[:, hit]).abs().max().item()
        tol_ok = ((gk[:, hit] - gp[:, hit]).abs() <= 1e-5 * (1 + gp[:, hit].abs())).all().item()
        if not tol_ok:
            raise AssertionError(f"gbuffer {label}: max abs err {err_g} beyond 1e-5*(1+|x|)")
        ms_g = cuda_ms(lambda: MK.gbuffer(scene, o, d), reps=20)
        ms_gp = cuda_ms(lambda: MK.gbuffer_plain(scene, o, d), reps=3, warmup=1)

        lsets = MK.build_light_sets(scene, seed)
        rt = pick_rt(n)
        rk = RD.initial_candidates(gk, lsets, seed, rt=rt)
        rp = RD.initial_candidates_plain(gk, lsets, seed, rt)
        torch.cuda.synchronize()
        same = (rk[0:3] == rp[0:3]).all(0)
        share = same.float().mean().item()
        err_r = (rk[:, same] - rp[:, same]).abs().max().item()
        rel_ok = ((rk[:, same] - rp[:, same]).abs() <= 1e-5 * (1 + rp[:, same].abs())).all().item()
        if share < 0.995 or not rel_ok:
            raise AssertionError(f"ris {label}: same pick on {share:.6f}, max abs err {err_r}")
        ms_r = cuda_ms(lambda: RD.initial_candidates(gk, lsets, seed, rt=rt), reps=20)
        ms_rp = cuda_ms(lambda: RD.initial_candidates_plain(gk, lsets, seed, rt), reps=3, warmup=1)

        so = (gk[MK.G.POS : MK.G.POS + 3] + 1e-3 * gk[MK.G.NG : MK.G.NG + 3]).T.contiguous()
        seg = (rk[0:3] - gk[MK.G.POS : MK.G.POS + 3]).T.contiguous()
        ok = XI.occlusion(scene.woop, so, seg, 1e-3, 1.0 - 1e-3)
        op = XI.occlusion_plain(scene.woop, so, seg, 1e-3, 1.0 - 1e-3)
        torch.cuda.synchronize()
        n_diff = (ok != op).sum().item()
        err_o = (ok.int() - op.int()).abs().max().item()
        if n_diff:
            raise AssertionError(f"occlusion {label}: {n_diff} rays differ from the plain version")
        ms_o = cuda_ms(lambda: XI.occlusion(scene.woop, so, seg, 1e-3, 1.0 - 1e-3), reps=20)
        ms_op = cuda_ms(lambda: XI.occlusion_plain(scene.woop, so, seg, 1e-3, 1.0 - 1e-3),
                        reps=3, warmup=1)
        occ_share = ok.float().mean().item()
        print(f"{label} ({tp} padded triangles, {n} rays): "
              f"gbuffer {ms_g:.4f} ms (plain {ms_gp:.3f}), max abs err {err_g:.3g}; "
              f"ris {ms_r:.4f} ms (plain {ms_rp:.3f}), same pick {share:.6f}, "
              f"max abs err {err_r:.3g}; occlusion {ms_o:.4f} ms (plain {ms_op:.3f}), "
              f"{occ_share:.4f} occluded, 0 differ", flush=True)
        record[label] = {
            "gbuffer": (err_g, ms_g, ms_gp), "ris": (err_r, ms_r, ms_rp),
            "occlusion": (float(err_o), ms_o, ms_op),
        }
        del scene, gk, gp, rk, rp, so, seg
        torch.cuda.empty_cache()

    # -- phase 4: the main path, through the frame entry point
    scene = upload_scene(cornell_box(), device=dev)
    slice_cfg = dict(mode="restir_gi", indirect=False, denoise=True, taa=True)
    cfg = RenderConfig(width=res, height=res, **slice_cfg)
    MK.gbuffer.launches = 0
    RD.initial_candidates.launches = 0
    XI.occlusion.launches = 0

    def chain(cfg_, cam_, frames=4):
        """Render chained frames; returns the last output and each frame's ms."""
        state, times = None, []
        for k in range(frames):
            t = time.perf_counter()
            out_, state = render_frame_restir(scene, cam_.with_jitter(k), seed + k, cfg_, state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return out_, times

    out, times = chain(cfg, cam)
    hdr512, ldr512 = out["hdr"], out["ldr"]
    cfg_hd = RenderConfig(width=1920, height=1080, **slice_cfg)
    cam_hd = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1920 / 1080)
    out_hd, times_hd = chain(cfg_hd, cam_hd)
    launches = {
        "gbuffer": MK.gbuffer.launches, "ris": RD.initial_candidates.launches,
        "occlusion": XI.occlusion.launches,
    }
    print(f"main path: 512^2 frames {[round(x, 3) for x in times]} ms "
          f"(median of frames 2-4 {statistics.median(times[1:]):.3f} ms), "
          f"1920x1080 frames {[round(x, 3) for x in times_hd]} ms "
          f"(median of frames 2-4 {statistics.median(times_hd[1:]):.3f} ms); "
          f"launches {launches}", flush=True)
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    for tag, o_ in (("512", out), ("1080p", out_hd)):
        h_ = o_["hdr"]
        if not torch.isfinite(h_).all():
            raise AssertionError(f"{tag}: non-finite HDR")
        if o_["ldr"].float().mean().item() < 10.0:
            raise AssertionError(f"{tag}: the image is black")
    if tuple(hdr512.shape) != (res, res, 3) or tuple(out_hd["hdr"].shape) != (1080, 1920, 3):
        raise AssertionError("unexpected output shapes")
    os.makedirs("chiprun_out", exist_ok=True)
    write_png(os.path.join("chiprun_out", "zetaray_torch_512.png"), ldr512.cpu().numpy())

    # the same 64^2 frame through the kernels on the card and the plain
    # versions on the CPU
    small = RenderConfig(width=64, height=64, **slice_cfg)
    cpu_scene = upload_scene(cornell_box())
    gpu_hdr = render_frame_restir(scene, cam, seed, small, None)[0]["hdr"].cpu()
    cpu_hdr = render_frame_restir(cpu_scene, cam, seed, small, None)[0]["hdr"]
    close = ((gpu_hdr - cpu_hdr).abs() <= 1e-3 * (1 + cpu_hdr.abs())).all(-1)
    share = close.float().mean().item()
    print(f"64^2 frame, card vs CPU: {share:.4f} of pixels within 1e-3*(1+|x|), "
          f"means {gpu_hdr.mean().item():.6f} / {cpu_hdr.mean().item():.6f}", flush=True)
    if share < 0.99:
        raise AssertionError("the card's frame disagrees with the CPU frame")

    sources = {
        "gbuffer": ("zetaray_tpu_torch/csrc/gbuffer.cu", "zetaray_tpu/accel/megakernel.py:650"),
        "ris": ("zetaray_tpu_torch/csrc/ris.cu", "zetaray_tpu/ops/restir_di.py:141"),
        "occlusion": ("zetaray_tpu_torch/csrc/occlusion.cu",
                      "zetaray_tpu/accel/pallas_kernels.py:148"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        err, ms, plain_ms = record["cornell36"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
