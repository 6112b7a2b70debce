"""Drive the PyTorch port's frames once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. needs CUDA; prints the card's name and power limit;
  2. builds the CUDA kernels of zetaray_tpu_torch/csrc with nvcc;
  3. holds each kernel against its plain PyTorch version at the frame's
     shapes and times both with CUDA events, on the procedural Cornell box
     and on its 8192-triangle subdivision at 512^2: G-buffer (B1), RIS over
     [64, 16, 128] light sets (B2; on the box also on its 1920x1080
     G-buffer), occlusion (B3), the path bounce kernels
     on GI bounce-0 rays built from the G-buffer as the frame's ReSTIR GI
     builds them: trace (B4), shade (B5), fused bounce (B6, at bounce 1
     and, on its trace-only branch of a path's last bounce, at 2), each
     also with the sky (the sun shining in through the box's opening), sun
     NEE, path regularization and the firefly clamp on, and with the sky
     but sun NEE off, each instance's registers (nvcc -Xptxas -v) recorded;
     the WoPS NEE instances of B5 and B6 (PTConfig.nee_mode="wops", a
     per-ray draw from the emissive alias table) on the same rays without
     and with the sky and sun NEE (on the box also B6 with the sky without
     sun NEE) and on the box with three wall lights of unequal power
     (multi_light_box, the share of rays whose pick the alias table
     redirects printed), each bit-equal to its plain version on the rays
     that found a hit (max abs err 0); the material instances of B5 and
     B6 (the transmission and coat lobes) on the materials box (the tall
     block glass, the short one clear-coated) at 512^2 and at 8192
     triangles, on its GI bounce-0 rays, without path options (B4 too:
     its surface rows carry the materials), with the sky, sun NEE and the
     path options, with the sky alone and each with WoPS NEE; and the
     closest hit with attributes
     (B7) on ReSTIR PT prefix rays built as its initial samples build them;
     B7 also on 1024^2 camera rays, as the primary-rays rate of bench.py.
     The a-trous pass (csrc/atrous.cu) on a GI frame of the box at
     1920x1080 with its G-buffer's guides: the four passes bit-equal to the
     plain passes, their ms, bound, launches and registers.
     On the textured box (procedural.textured_box: its PNG maps written
     into TEX_DIR, the bundle after the emissive power round trip) B4 and
     B5 on the GI bounce-0 rays of its textured G-buffer with the
     base-colour fetch between them, as a textured trace splits a bounce,
     and the fetch's and the G-buffer texturing's own times and launches
     (torch.profiler); on the cutout box (procedural.cutout_box, a MASK-mode
     panel) B7 on 512^2 camera rays in each round of the alpha-cutout
     re-trace (a round on the rays still piercing), against its plain
     version.
     B1, B4, B5, B6 and B7 record the real triangle count they sweep (nt)
     and B1, B4, B6 and B7 the ray-triangle pairs they test a second (B5
     the shadow segments it lets through).
     On the box split to 139,266 triangles
     (bench.py's large scene, clustered into 798 clusters of 256 slots) at
     256^2 (its upload time, B8's tree included, printed): the streaming
     closest hit (B8) on camera rays, on bench.py's GI-like rays (origins at
     the primary hits, random unit directions; a missed primary ray's far
     end near 3e38), on those of them whose primary ray hit (the rest
     parked), and on the frame's GI bounce-0 rays, and the streaming any
     hit (B9) on the frame's DI shadow segments (the share of them blocked
     recorded), with bench.py's raw primary and GI-like rates. The box as
     an animated glTF file (procedural.animated_box, written into a
     temporary directory with its buffer as a data: URI: the walls, light
     and short block one node, the tall block a second node with LINEAR
     translation and rotation channels) goes through load_gltf ->
     load_scene -> AnimationRig, is split like the large box and uploaded
     clustered, and is refit to t = 0.5 (refit_scene: the Woop rows, the
     attribute and emissive rows, the cluster boxes and the walk tree's
     boxes on the card; its ms printed for the box and the split box): B8
     on camera and GI-like rays and B9 on DI shadow segments walking the
     refit tree equal their plain versions, and B8 walking the upload's
     boxes over the moved rows does not. The tile offset: B2, B5 and B6 on
     the image's lower half as the second of two row bands (pix0 = 131,072,
     tile0 = 128), each equal to its plain version at that offset (max abs
     err 0) and timed beside the same band at tile0 = 0. The wavefront
     path trace (ops.pathtracer.trace_reference: B8, the vertex kernel of
     csrc/wavefront.cu, B9 a bounce) on the 139,266-triangle box and the
     benchmark's 262,144-triangle hall at 1920x1080 camera rays, in the
     restir_di frame's and GI's configurations, bit-equal to the plain
     wavefront (radiance and first hit), its ms a bounce beside the plain
     one's, the vertex kernel's own ms beside its bound and its registers
     (wavefront_record). Each kernel's
     least time on the card (bound_ms) is reckoned from this run's work and
     the H100's published peaks;
  4. renders chained frames of each path with its launch counters set to 0
     just before it and read just after: the DI-only slice at 512^2
     (indirect off), the main path -- the flagship frame of bench.py
     (ReSTIR DI + GI with PTConfig(max_bounces=3), a-trous, TAA, histogram
     exposure, AgX) at 512^2 --, the 1920x1080 frame of bench.py
     (max_bounces=2), the ReSTIR PT frame of bench.py at 512^2 (ReSTIR DI +
     PT, max_bounces=3, a-trous, TAA) and the plain path-traced frame of
     bench.py at 512^2 (max_bounces=4); the JAX app's default frame
     (mode="restir_di", PTConfig(max_bounces=4), TAA, no a-trous) at 512^2
     with its sun and sky and without them, the flagship frame with the sky,
     path regularization, the firefly clamp and stochastic multi-bounce, and
     the ReSTIR PT frame with the sky; and on the 139,266-triangle box the
     large-scene frame of bench.py (ReSTIR GI, max_bounces=2, a-trous, TAA)
     at 256^2 with its DI-only slice, plain PT and the JAX app's default
     frame with the sky at 256^2 (the vertex kernel launched in the
     clustered chains that path-trace without a sky or cutout, and in no
     dense chain). Chains are 4 frames; the first has no
     temporal reuse and no TAA, so frame times are medians of frames 2-4.
     Then bench.py's features frame (ReSTIR DI with 2 light-voxel-grid
     candidates and pairwise MIS, ReSTIR GI with max_bounces=2, SkyDI with
     pairwise MIS, froxel volumetrics, a-trous, TAA) at 256^2 with its sun
     and at 512^2 with the sun in through the box's opening, there also
     with the GI grid NEE, plain PT with volumetrics at 512^2 and, on the
     139,266-triangle box, ReSTIR PT at 256^2 (B8 and B9, no dense kernel);
     bench.py's upscale_256_to_512 (ReSTIR GI, max_bounces=2, rendered at
     256^2, the temporal upscaler to 512^2, RCAS 0.8) on the box and on
     its 8192-triangle subdivision beside its native 512^2 twin
     (render_scale=1); the flagship and the JAX app's default frame with
     WoPS NEE at 512^2, and with the sky (the flagship with sun NEE and the
     path options, the default frame without sun NEE), each WoPS instance
     of phase 3 taking its launches from the one path that runs it; and
     the flagship, ReSTIR PT and the default frame on the materials box at
     512^2, each also with full_target=True and packed_reuse=False in every
     ReSTIR config, and there, for the launches of the other material
     instances, the flagship with the sky and path options, the default
     frame with the sky and no sun NEE, and those with WoPS NEE; and
     on the textured box the flagship, ReSTIR PT and the default frame, each
     beside its twin without the bundle (over the checker's pixels darker by
     the checker's mean within 10%), and on the cutout box the flagship and
     the default frame (B2 and B7 alone; through the panel's transparent
     half the G-buffer sees the back wall, on its opaque half the panel);
     the default frame at 512^2 with the firefly
     filter at 3 and the weighted-average exposure, with each tonemapper
     but the LUT's, and through a thin lens (f/2.8, 50 mm, focus 3.5);
     phase 3 holds B3 (and B9 on the clustered box) on SkyDI's shade
     segments and the froxel grid's 12,288 sun segments (t_max 1e8; the
     blocked shares printed) and B5 with min_nee_bounce=1 (the GI grid NEE's
     bounce 0) against their plain versions. It
     checks that every kernel of each path launched (and, on the clustered
     box, that no dense kernel did), that the images are finite and lit,
     that the indirect passes add light, that the sky shows behind the
     primary misses above the horizon in every sky frame and not without
     it, and that the sun lights hits the frame without sky leaves darker;
     and compares two chained 64^2 frames on the card with the same frames
     on the CPU: GI, PT, the default frame with the sky and GI with the sky
     and the path options on the box, and GI, the default frame with the
     sky and GI with the sky on the box split to 8706 triangles
     (clustered), and the features frame (on both), the GI grid NEE frame,
     clustered ReSTIR PT, the upscale frame at display 64^2 (render 32^2),
     the default and GI frames with WoPS NEE on the box with wall lights,
     the default frame through the thin lens with the firefly filter,
     the weighted-average exposure and AgX punchy (its LDR held too), and
     the GI (also with the reuse options), PT and default frames on the
     materials box, the GI, PT and default frames on the textured box and
     the GI frame on the cutout box (also on its 8706-triangle split,
     clustered); after the clustered frames, the default frame at 256^2 on
     the cutout box split to 147,458 triangles (B2 and B8 alone); the
     animated box, refit each frame to ANIM_DT more of its clip and
     rendered with the motion from the frame before, beside its static
     twin: the default frame and the flagship at 512^2, the default frame
     on the split box at 256^2 (B2, B8 and B9 alone), and mode="pt" through
     render_frame_restir and mode="restir_gi" through render_frame at 512^2
     (each image differs from its twin's); and two 64^2 animated flagship
     frames on the card against the CPU;
  5. the sharded frames: SHARD_WORLD ranks (parallel.mesh.run_ranks, fresh
     processes after the parent's build; NCCL with a card a rank, else
     gloo with the ranks sharing the card, the choice printed) render row
     bands of 3 chained frames each of the flagship 512^2, ReSTIR PT
     512^2, the default restir_di frame with the sun at 512^2 and
     upscale_256_to_512 (the eye drifting, so reprojections cross the
     bands' edges), with the launch counts set to 0 just before each and
     read just after; the gathered bands are held to the whole frames from
     the same seeds (rtol 3e-3, atol 1e-5), and each rank's ms a frame,
     its exchanges (calls, bytes received, host-staged ms) and peak memory
     are printed;
  6. the host side, each through the entry point a user calls (host_phase):
     (a) the app (python -m zetaray_tpu_torch.app, a subprocess) on the
     animated box written as glTF into IMAGE_DIR/app: 4 frames at 512^2 of
     the default restir_di frame with the sun, --animate, --validate,
     --dump-graph and --outline, the same with --mode restir_gi --bounces 3
     --denoise, and --profile at 256^2, each writing 4 lit PNGs, its ms a
     frame and its last frame's kernel launches (the app's frame stats)
     printed; (c) pick (render.picking) on the 139,266-triangle clustered
     box (B8) and on the cutout box (the re-trace, B7 a round) equal to the
     same picks through the plain versions on a CPU copy of the scene; (d)
     the textured box with its checker as a BC1 and a BC7 DDS file: the
     host decode's ms, a 64^2 textured flagship on the card against the CPU
     (99% of the pixels) and the 512^2 textured flagship's frames; (e) a
     checkpoint of the default frame's 512^2 chain after frame 2, resumed:
     frames 3-4 equal the unbroken chain bit for bit; (b) the viewer
     (gui.Viewer, restir_gi at 256^2, make_server on an ephemeral port):
     GET / and /api/stats, picks at the centre and at a miss equal to the
     plain closest hit on the same ray, camera, material and transform
     (refit) edits, a hot reload (no library rebuilt; the next frame equal
     to the frame without it) and /api/quit, its ms a frame printed; (f)
     python -m zetaray_tpu_torch.warmup and its seconds;
  7. prints the kernels' record (with each kernel's launches on the
     host-side paths, "host_side"), the card line, and last a JSON status.

The 512^2 images are written to IMAGE_DIR: zetaray_torch_512.png (the
flagship frame), zetaray_torch_512_di.png (DI only), zetaray_torch_512_pt.png
(ReSTIR PT), zetaray_torch_512_plain_pt.png (plain PT),
zetaray_torch_512_restir_di_sky.png and _restir_di.png (the JAX app's
default frame with and without the sky), _gi_sky.png, _pt_sky.png,
_features_sun.png, _plain_pt_volumetrics.png, _upscale_256_to_512.png, _wops.png
(the flagship with WoPS NEE), _restir_di_lens.png and _materials.png,
_materials_pt.png and _materials_restir_di.png (the materials box), _textured.png,
_textured_pt.png, _textured_restir_di.png, _cutout.png and _cutout_restir_di.png; the
clustered GI frame to
zetaray_torch_256_clustered.png, the clustered default frame with the sky
to zetaray_torch_256_clustered_restir_di_sky.png, clustered ReSTIR PT to
zetaray_torch_256_clustered_pt.png, the clustered cutout default frame to
zetaray_torch_256_clustered_cutout_restir_di.png, the animated flagship to
zetaray_torch_512_animated.png and the clustered animated default frame to
zetaray_torch_256_clustered_animated_restir_di.png.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import struct
import sys
import tempfile
import time
import zlib

import torch


IMAGE_DIR = "chiprun_out"
ANIM_DT = 0.25  # seconds of the animated box's clip a frame
TEX_DIR = os.path.join(IMAGE_DIR, "textures")  # the texture maps of the textured and cutout boxes

# The least time the card could take (bound_ms): the larger of the work's
# float operations over the H100 SXM's float32 rate outside the tensor cores
# and its bytes (each input read once, each output written once) over the
# HBM3 rate, both NVIDIA's published peaks at a 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PAIR_OPS = 40  # float operations of one Woop ray-triangle test
# float operations of rating one light-set entry in RIS: 3 subtractions, 14
# multiplications, 7 additions, 2 maxima, 3 comparisons, 1 rsqrt, 2 divisions
RIS_ENTRY_OPS = 32
F32 = 4
# float operations of the sky and the sun disk for a live ray that misses (B4,
# B6; csrc/path.cuh sky_env, sun_disk and surface_at), counted by hand from the
# source: 40 for the sky, 7 for the disk past the cosine it shares with the
# sky, 15 to add both, times the throughput, to the radiance; with sun NEE one
# more, the disk's gate on specular rays
SKY_OPS = 62
SUN = (0.2, 0.45, 0.87)  # toward the sun: it shines in through the box's opening at +z
BENCH_FEATURES_SUN = (0.3, 0.8, 0.2)  # bench.py's features frame
FIREFLY_CLAMP = 10.0
# float operations of one a-trous tap (csrc/atrous.cu, a transcendental
# counted as one): the tap's luminance 5; its difference, abs, negation and
# scale 4; expf 1; the normal dot 5; clamp 1; powf 1; the depth difference,
# abs, negation and division 4; expf 1; the weight's 5 products; the colour
# and weight sums 7
ATROUS_TAP_OPS = 34
# a pixel's own: its luminance 5, the depth clamp and scale 2, two compares,
# the weight sum's clamp and three divisions
ATROUS_PIXEL_OPS = 13
# read once a pass: colour, normal, depth, the validity's bool byte; written: colour
ATROUS_PIXEL_BYTES = 12 + 12 + 4 + 1 + 12


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by) of work of ``ops`` float32 operations moving ``nbytes``."""
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bounce_err(name: str, label: str, k, p, found) -> float:
    """Kernel rows k against plain rows p: every row on rays that found a
    hit, radiance and alive on every ray (a ray that missed moves on from a
    zero-attribute surface, whose sampled pdf swings with an ulp of its
    direction). Raises below 99.9% agreement to 1e-5; returns the max abs
    error over the found rays."""
    torch.cuda.synchronize()
    close = torch.isclose(k, p, rtol=1e-5, atol=1e-5)
    share_found = close[:, found].all(0).float().mean().item()
    share_all = close[[9, 10, 11, 13]].all(0).float().mean().item() if k.shape[0] == 16 else 1.0
    if share_found < 0.999 or share_all < 0.999:
        raise AssertionError(f"{name} {label}: {share_found:.6f} of the found rays and "
                             f"{share_all:.6f} of all rays agree with the plain version")
    return (k[:, found] - p[:, found]).abs().max().item()


def lit_segments(after, before, after_no_sun=None) -> int:
    """The shadow segments that let their light through in one shade step:
    rays whose radiance rows (9-11) changed from ``before`` to ``after``; with
    sun NEE, ``after_no_sun`` (the step without it) tells an NEE segment and
    a sun segment of one ray apart."""
    lit = lambda a, b: int((a[9:12] != b[9:12]).any(0).sum().item())
    if after_no_sun is None:
        return lit(after, before)
    return lit(after_no_sun, before) + lit(after, after_no_sun)


def bounce_records(scene, label, opt, cfg, st0, lsets, seed, rt, spread, n_tri, tri_bytes,
                   set_bytes, full=True, textures=None, pix0=0) -> dict:
    """B4 at bounce 0 on the GI bounce-0 state ``st0``, B5 after it and B6 at
    bounce 1 (and on its trace-only last bounce at 2) under ``cfg``, each
    held against its plain version (``bounce_err``) and timed, with its
    bound: {"bounce_trace" | "bounce_shade" | "bounce": record}. A live ray
    that misses costs SKY_OPS (and one more with sun NEE) where ``cfg`` has a
    sky; a shadow segment that lets its light through (NEE or the sun) a test
    of every triangle. ``lsets``: the light sets, or with
    ``cfg.nee_mode="wops"`` the WoPS table (B5's record then holds the share
    of live rays whose pick the alias table redirects). Without ``full``
    B4 runs only as its plain version and B5 without min_nee_bounce=1:
    the record has B5 and B6. With ``textures`` B5 (and B6 after it) take
    the surface rows after the base-colour fetch (``megakernel.fetch_base``),
    as the split bounce of a textured trace does. ``pix0``: the rays are a
    row band from that global ray id on (B5 and B6 take tile0 = pix0 // rt)."""
    from zetaray_tpu_torch.accel import megakernel as MK
    from zetaray_tpu_torch.timing import cuda_ms

    n = st0.shape[1]
    tag = f"{label} {opt}".strip()
    state_bytes = MK.STATE_ROWS * F32
    miss_ops = SKY_OPS + int(cfg.sun_nee) if cfg.sky is not None else 0
    no_sun = dataclasses.replace(cfg, sun_nee=False) if cfg.sky is not None and cfg.sun_nee \
        else None

    def record(err, fn, plain_fn, ops, nbytes, **extra):
        r = dict(max_abs_err=err, ms=cuda_ms(fn, reps=20), plain_ms=cuda_ms(plain_fn, reps=3,
                                                                             warmup=1))
        r["bound_ms"], r["bound_by"] = bound(ops, nbytes)
        return {**r, **extra}

    trace = (scene, st0, 0, cfg, True, spread)
    st4_p, sf4_p = MK.bounce_trace_plain(*trace)
    found = st4_p[13] > 0.5
    out = {}
    if full:
        st4, sf4 = MK.bounce_trace(*trace)
        misses4 = int(((st0[13] > 0.5) & ~found).sum().item())
        err = max(bounce_err("bounce_trace", tag, st4, st4_p, found),
                  bounce_err("bounce_trace surf", tag, sf4, sf4_p, found))
        r4 = out["bounce_trace"] = record(
            err, lambda: MK.bounce_trace(*trace), lambda: MK.bounce_trace_plain(*trace),
            PAIR_OPS * n * n_tri + miss_ops * misses4,
            n * (2 * state_bytes + MK.SURF_ROWS * F32) + tri_bytes,
            nt=n_tri, hit=found.float().mean().item(), live_misses=misses4)
        r4["pairs_per_s"] = n * n_tri / (r4["ms"] * 1e-3)
    if textures:
        sf4_p = MK.fetch_base(textures, st4_p, sf4_p)

    shade = (scene, st4_p, sf4_p, lsets, 0, seed, cfg, True, rt, pix0)
    st5_p = MK.bounce_shade_plain(*shade)
    err = bounce_err("bounce_shade", tag, MK.bounce_shade(*shade), st5_p, found)
    segs5 = lit_segments(st5_p, st4_p, None if no_sun is None else MK.bounce_shade_plain(
        scene, st4_p, sf4_p, lsets, 0, seed, no_sun, True, rt, pix0))
    r5 = out["bounce_shade"] = record(
        err, lambda: MK.bounce_shade(*shade), lambda: MK.bounce_shade_plain(*shade),
        PAIR_OPS * segs5 * n_tri,
        n * (2 * state_bytes + MK.SURF_ROWS * F32) + 12 * n_tri * F32 + set_bytes,
        nt=n_tri, lit_segments=segs5)
    if cfg.nee_mode == "wops":
        u = MK.bounce_uniforms(n, 0, seed, device=st0.device, wops=True)
        taken = MK.wops_pick(lsets, scene.num_emissives, u[0], u[5])[1] & found
        r5["alias_share"] = taken.float().sum().item() / max(1, int(found.sum().item()))
    if full:
        # the instance the ReSTIR_GI_LVG variant launches: no NEE at bounce 0
        # (min_nee_bounce=1; the grid's NEE runs outside), the sun segment stays
        shade1 = (scene, st4_p, sf4_p, lsets, 0, seed,
                  dataclasses.replace(cfg, min_nee_bounce=1), True, rt)
        st5_1p = MK.bounce_shade_plain(*shade1)
        err = bounce_err("bounce_shade min_nee_bounce=1", tag, MK.bounce_shade(*shade1), st5_1p,
                         found)
        segs5_1 = lit_segments(st5_1p, st4_p)
        r5["min_nee_bounce_1"] = record(
            err, lambda: MK.bounce_shade(*shade1), lambda: MK.bounce_shade_plain(*shade1),
            PAIR_OPS * segs5_1 * n_tri,
            n * (2 * state_bytes + MK.SURF_ROWS * F32) + (12 * n_tri * F32 if segs5_1 else 0),
            nt=n_tri, lit_segments=segs5_1)

    st_t1 = MK.bounce_trace_plain(scene, st5_p, 1, cfg, True)[0]
    found_1 = st_t1[13] > 0.5
    misses6 = int(((st5_p[13] > 0.5) & ~found_1).sum().item())
    b6 = (scene, st5_p, lsets, 1, seed, cfg, False, True, rt, pix0)
    st6_p = MK.bounce_plain(*b6)
    err = bounce_err("bounce", tag, MK.bounce(*b6), st6_p, found_1)
    # the frame's final bounce takes the kernel's trace-only branch
    b6_last = (scene, st6_p, lsets, 2, seed, cfg, True, True, rt, pix0)
    st6_last_p = MK.bounce_plain(*b6_last)
    err = max(err, bounce_err("bounce last", tag, MK.bounce(*b6_last), st6_last_p,
                              st6_last_p[13] > 0.5))
    segs6 = lit_segments(st6_p, st_t1, None if no_sun is None else MK.bounce_plain(
        scene, st5_p, lsets, 1, seed, no_sun, False, True, rt, pix0))
    r6 = out["bounce"] = record(
        err, lambda: MK.bounce(*b6), lambda: MK.bounce_plain(*b6),
        PAIR_OPS * (int(found_1.sum().item()) + segs6) * n_tri + miss_ops * misses6,
        n * 2 * state_bytes + tri_bytes + set_bytes,
        nt=n_tri, hit=found_1.float().mean().item(), lit_segments=segs6, live_misses=misses6)
    r6["pairs_per_s"] = (n + segs6) * n_tri / (r6["ms"] * 1e-3)
    return out


def wops_bounce_records(scene, label, opt, cfg, st0, seed, rt, spread, n_tri, tri_bytes,
                        rec, kernels=("bounce_shade", "bounce")) -> None:
    """The WoPS instances of B5 and B6 under ``cfg`` (nee_mode="wops") on
    the GI bounce-0 state ``st0`` (``bounce_records`` without B4's kernel),
    each bit-equal to its plain version on the rays that found a hit (max
    abs err 0, as the other instances); those of ``kernels`` are stored as
    rec[kernel][opt]."""
    from zetaray_tpu_torch.accel import megakernel as MK

    table = MK.wops_table(scene)
    recs = bounce_records(scene, label, opt, cfg, st0, table, seed, rt, spread, n_tri,
                          tri_bytes, table.numel() * F32, full=False)
    alias_share = recs["bounce_shade"]["alias_share"]
    recs = {k: r for k, r in recs.items() if k in kernels}
    for name, r in recs.items():
        if r["max_abs_err"] != 0.0:
            raise AssertionError(f"{name} {label} {opt}: max abs err {r['max_abs_err']} on "
                                 "the found rays, not 0")
        rec.setdefault(name, {})[opt] = r
    print(f"{label} ({st0.shape[1]} GI bounce-0 rays, {opt}, {scene.num_emissives} emissives, "
          f"alias taken by {alias_share:.4f} of the live rays): "
          + "; ".join(f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
                      f"{r['bound_ms']:.4f} by {r['bound_by']}), max abs err "
                      f"{r['max_abs_err']:.3g}, shadow segments let through "
                      f"{r['lit_segments']}" for k, r in recs.items()), flush=True)


def device_launches(fn, top: int = 4):
    """Kernel launches on the card of one call of fn, counted by
    ``torch.profiler`` (copies and fills left out), after one warm-up call,
    and its ``top`` kernels by device time: (launches, [(name, launches,
    ms)])."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA
           and not ev.key.startswith(("Memcpy", "Memset"))]
    evs.sort(key=lambda ev: -ev.self_device_time_total)
    return (sum(ev.count for ev in evs),
            [(ev.key[:60], ev.count, ev.self_device_time_total / 1e3) for ev in evs[:top]])


def ptxas_registers(report: str) -> dict:
    """{mangled kernel name: "<n> registers, <spill stores> B spill stores,
    <loads> B loads"} from what ``nvcc -Xptxas -v`` reports (``report``:
    ``kernel_ab.ptxas_report``)."""
    out, key, spill = {}, None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            key, spill = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and key:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            out[key] = f"{m.group(1)} registers, {spill}"
            key = None
    return out


def bounce_registers(report: str) -> dict:
    """``ptxas_registers(report)`` of each instance of B4-B6:
    {"bounce_trace" | "bounce_shade" | "bounce": {instance: text}}, the
    instances named by their compile-time branches (B4 sky, B5 sun_nee,
    wops and mat, B6 sky, sun_nee, wops and mat, joined by "_"; "" for
    none)."""
    names = {"bounce_trace_kernel": ("bounce_trace", ("sky",)),
             "bounce_shade_kernel": ("bounce_shade", ("sun_nee", "wops", "mat")),
             "bounce_kernel": ("bounce", ("sky", "sun_nee", "wops", "mat"))}
    out = {v[0]: {} for v in names.values()}
    for entry, text in ptxas_registers(report).items():
        m = re.search(r"\d+(bounce\w*_kernel)I((?:Lb[01]E)+)E", entry)
        if m:
            kernel, branches = names[m.group(1)]
            flags = re.findall(r"Lb([01])E", m.group(2))
            out[kernel]["_".join(b for b, f in zip(branches, flags) if f == "1")] = text
    return out


def atrous_record(dev, report: str, seed: int = 0x2468ACE1) -> dict:
    """Phase 3's a-trous row: the four passes of ``ops.denoise.atrous_denoise_p``
    (``csrc/atrous.cu``, a launch each) on a GI frame of the box at 1920x1080
    (denoise and TAA off) with its G-buffer's normals, depth and validity
    as guides, against the plain passes on the card, bit for bit or it
    raises. Returns the four passes' ms and the plain ones' (CUDA events),
    their bound, the launches of each on the card as the profiler counts
    them (``device_launches``: the plain chain against the kernel's) and
    the kernel's registers (``report``: ``kernel_ab.ptxas_report``). The
    launches of the main path are counted by its chains."""
    from zetaray_tpu_torch.accel import megakernel as MK
    from zetaray_tpu_torch.kernel_ab import bits_equal
    from zetaray_tpu_torch.ops import denoise as DN
    from zetaray_tpu_torch.ops.pathtracer import PTConfig
    from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.procedural import (
        CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box,
    )
    from zetaray_tpu_torch.scene.scene import upload_scene
    from zetaray_tpu_torch.timing import cuda_ms

    w, h = 1920, 1080
    scene = upload_scene(cornell_box(), device=dev)
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=w / h)
    frame, _ = render_frame_restir(scene, cam, seed, RenderConfig(
        width=w, height=h, mode="restir_gi", pt=PTConfig(max_bounces=3), denoise=False,
        taa=False), None)
    gb = MK.gbuffer(scene, *cam.generate_rays(w, h, device=dev))
    img = frame["hdr"].permute(2, 0, 1).contiguous()
    nrm = gb[MK.G.NS : MK.G.NS + 3].reshape(3, h, w)
    depth, valid = gb[MK.G.DEPTH].reshape(h, w), (gb[MK.G.VALID] > 0.5).reshape(h, w)
    cfg = DN.ATrousConfig()

    def kernel():
        return DN.atrous_denoise_p(img, nrm, depth, valid, cfg)

    def plain():
        return DN.atrous_denoise_plain(img, nrm, depth, valid, cfg)

    got, want = kernel(), plain()
    if not bits_equal(got, want):
        diff = (got - want).abs().nan_to_num(nan=float("inf")).max().item()
        raise AssertionError(f"atrous 1920x1080: max abs err {diff} against the plain passes")
    n = w * h
    b_ms, b_by = bound(cfg.iterations * n * (25 * ATROUS_TAP_OPS + ATROUS_PIXEL_OPS),
                       cfg.iterations * n * ATROUS_PIXEL_BYTES)
    rec = dict(max_abs_err=0.0, ms=cuda_ms(kernel, reps=20),
               plain_ms=cuda_ms(plain, reps=3, warmup=1), bound_ms=b_ms, bound_by=b_by,
               profiled_launches=device_launches(kernel)[0],
               plain_launches=device_launches(plain)[0],
               registers=next(t for e, t in ptxas_registers(report).items()
                              if "atrous_pass_kernel" in e),
               valid_share=valid.float().mean().item())
    print(f"atrous (1920x1080, {cfg.iterations} passes, {rec['valid_share']:.4f} valid): "
          f"{rec['ms']:.4f} ms, {rec['ms'] / cfg.iterations:.4f} a pass (plain "
          f"{rec['plain_ms']:.3f}, bound {b_ms:.4f} by {b_by}), profiled launches "
          f"{rec['profiled_launches']} "
          f"(plain {rec['plain_launches']}), registers {rec['registers']}, bit-equal to the "
          f"plain passes", flush=True)
    return rec


# the vertex kernel's bytes (csrc/wavefront.cu) at a bounce that reads no
# path state: each ray's o, d and B8 slot in; its path state, radiance, next
# ray and shadow segment out; each distinct hit triangle's v0/e1/e2 and the
# 26 attribute columns a vertex reads; each emissive's alias entry and the
# 17 floats of its row
WAVEFRONT_RAY_BYTES = (6 + 1) * F32 + (9 + 3 + 6 + 6) * F32
WAVEFRONT_TRI_BYTES = (9 + 26) * F32
WAVEFRONT_LIGHT_BYTES = (2 + 17) * F32


def lamp_hall(directory):
    """The benchmark's many-light hall (``rtbench/scenes/lamp_hall.py``,
    262,144 triangles) written into ``directory`` and loaded: (CpuScene,
    its camera at 16:9)."""
    import importlib.util

    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.scene import load_scene

    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rtbench")
    if bench not in sys.path:
        sys.path.append(bench)  # the generator reads the harness's spec (``rtb``)
    spec = importlib.util.spec_from_file_location(
        "lamp_hall", os.path.join(bench, "scenes", "lamp_hall.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    cpu = load_scene(str(gen.write(directory, {"split_rounds": 5})))
    return cpu, Camera.look_at((-13.0, 1.7, 0.0), (0.0, 3.0, 0.0), vfov_deg=60.0,
                               aspect=1920 / 1080)


def wavefront_record(dev, report: str, seed: int = 0x2468ACE1) -> dict:
    """Phase 3's wavefront row: ``ops.pathtracer.trace_reference``'s kernel
    path (B8, the vertex kernel of ``csrc/wavefront.cu``, B9 a bounce) on
    the 139,266-triangle box and the benchmark's 262,144-triangle hall at
    1920x1080 camera rays, in the restir_di frame's configuration and in
    GI's (the first hit returned, every seventh ray parked), against the
    plain wavefront on the card, radiance and first hit bit for bit or it
    raises. Returns each case's ms a bounce of both (CUDA events, B8 and B9
    included) and their launches a trace (``device_launches``), the vertex
    kernel's own ms at bounce 0 with every branch on (emission, NEE, the
    BSDF sample, Russian roulette) beside its bound (bytes: path state,
    attribute columns and emissive rows), and the registers of its two
    instances (``report``: ``kernel_ab.ptxas_report``)."""
    from zetaray_tpu_torch.accel import stream as ST
    from zetaray_tpu_torch.kernel_ab import bits_equal
    from zetaray_tpu_torch.ops import pathtracer as PT
    from zetaray_tpu_torch.ops.pathtracer import PTConfig
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.procedural import (
        CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box,
    )
    from zetaray_tpu_torch.scene.scene import upload_scene
    from zetaray_tpu_torch.scene.subdivide import subdivide_scene
    from zetaray_tpu_torch.timing import cuda_ms

    w, h = 1920, 1080
    n = w * h
    hall_cpu, hall_cam = lamp_hall(tempfile.mkdtemp(prefix="zetaray_hall_"))
    scenes = {
        "box139k": (subdivide_scene(cornell_box(), 100_000),
                    Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=w / h)),
        "hall262k": (hall_cpu, hall_cam),
    }
    configs = {"di": (PTConfig(max_bounces=4, min_emissive_bounce=2, min_nee_bounce=1), False),
               "gi": (PTConfig(max_bounces=1, min_emissive_bounce=1), True)}
    regs = {("mat" if "ILb1E" in e else "opaque"): t for e, t in ptxas_registers(report).items()
            if "wavefront_vertex_kernel" in e}
    rec = {"registers": regs}
    for name, (cpu, cam) in scenes.items():
        sc = upload_scene(cpu, device=dev)
        o, d = cam.generate_rays(w, h, device=dev)
        for cname, (cfg, first) in configs.items():
            oo, dd = (PT.park(torch.arange(n, device=dev) % 7 != 3, o, d) if first else (o, d))

            def kernel():
                return PT.trace_reference(sc, oo, dd, seed, cfg, return_first_hit=first)

            def plain():
                return PT.trace_reference_plain(sc, oo, dd, seed, cfg, return_first_hit=first)

            got, want = kernel(), plain()
            pairs = list(zip((got[0], *got[1]), (want[0], *want[1]))) if first else [(got, want)]
            for a, b in pairs:
                if not bits_equal(a, b):
                    raise AssertionError(f"wavefront {name} {cname}: the kernel path differs from "
                                         f"the plain wavefront in {(a != b).sum().item()} values")
            bounces = cfg.max_bounces + 1
            case = dict(max_abs_err=0.0, ms=cuda_ms(kernel, reps=10) / bounces,
                        plain_ms=cuda_ms(plain, reps=3, warmup=1) / bounces,
                        launches=device_launches(kernel)[0], plain_launches=device_launches(plain)[0],
                        lit=((got[0] if first else got).sum(1) > 0).float().mean().item())
            rec[f"{name}_{cname}"] = case
            print(f"wavefront {name} {cname} (1920x1080, {bounces} bounces, {case['lit']:.4f} of "
                  f"the rays lit): {case['ms']:.4f} ms a bounce (plain {case['plain_ms']:.3f}), "
                  f"{case['launches']} launches a trace (plain {case['plain_launches']}), bit-equal "
                  f"to the plain wavefront", flush=True)
        # the vertex kernel alone at bounce 0, every branch on
        cfg = PTConfig(max_bounces=4, rr_start=0)
        _, tri = ST.stream_closest(sc, o, d, cfg.t_min)
        f32 = dict(dtype=torch.float32, device=dev)
        state = torch.empty((PT.WF_ROWS, n), **f32)
        rows = [torch.empty((n, 3), **f32) for _ in range(5)]
        ms = cuda_ms(lambda: PT.wavefront_vertex(sc, o, d, tri, None, None, state, *rows, None, 0,
                                                 seed, cfg), reps=20)
        n_tri = tri[tri >= 0].unique().numel()
        b_ms, b_by = bound(0, n * WAVEFRONT_RAY_BYTES + n_tri * WAVEFRONT_TRI_BYTES
                           + sc.num_emissives * WAVEFRONT_LIGHT_BYTES)
        rec[f"{name}_vertex"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, hit_triangles=n_tri)
        print(f"wavefront {name}: the vertex kernel at bounce 0 with every branch "
              f"{ms:.4f} ms (bound {b_ms:.4f} by {b_by}, {n_tri} distinct triangles hit, "
              f"{sc.num_emissives} emissives); registers {regs}", flush=True)
        del sc, o, d, tri, state, rows
        torch.cuda.empty_cache()
    return rec


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


SHARD_WORLD = 2  # ranks of the sharded phase


def shard_camera(k: int, aspect: float = 1.0):
    """Frame k's camera in the sharded phase: the box's framing with the eye
    drifting right and up, so that reprojections cross the bands' edges."""
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV

    eye = (CAMERA_EYE[0] + 0.03 * k, CAMERA_EYE[1] + 0.02 * k, CAMERA_EYE[2])
    return Camera.look_at(eye, CAMERA_TARGET, vfov_deg=CAMERA_VFOV,
                          aspect=aspect).with_jitter(k)


def sharded_rank(rank: int, world: int, init_method: str, backend: str, specs, seed: int):
    """One rank of the sharded phase (``parallel.mesh.run_ranks`` in a fresh
    process; the parent built the kernels): its band of each spec's chained
    frames on the box through ``render_frame_restir_sharded``, each path
    with the kernels' launch counts set to 0 just before it and read just
    after. Returns, by spec, each frame's ms, the bytes and host seconds of
    the exchanges, the peak memory, the counts and (the gathered image, on
    every rank) each frame's HDR."""
    from zetaray_tpu_torch import native
    from zetaray_tpu_torch.parallel import halo as HX
    from zetaray_tpu_torch.parallel import mesh as PM
    from zetaray_tpu_torch.scene.procedural import cornell_box
    from zetaray_tpu_torch.scene.scene import upload_scene

    tiles = PM.init_tiles(world, rank, init_method, backend, timeout=300.0)
    dev = tiles.device
    native.lib()
    scene = upload_scene(cornell_box(), device=dev)
    kernels_of = {"gbuffer": "zr_gbuffer", "ris": "zr_ris", "occlusion": "zr_occlusion",
                  "bounce_trace": "zr_bounce_trace", "bounce_shade": "zr_bounce_shade",
                  "bounce": "zr_bounce", "closest": "zr_closest", "atrous": "zr_atrous"}
    out = {}
    for tag, cfg, frames in specs:
        for entry in kernels_of.values():
            native.launches[entry] = 0
        HX.stats.update(bytes=0, calls=0, seconds=0.0)
        torch.cuda.reset_peak_memory_stats(dev)
        state, times, hdrs, stats = None, [], [], []
        for k in range(frames):
            before = dict(HX.stats)
            t = time.perf_counter()
            res, state = PM.render_frame_restir_sharded(tiles, scene, shard_camera(k), seed + k,
                                                        cfg, state)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t) * 1e3)
            stats.append({key: HX.stats[key] - before[key] for key in before})
            hdrs.append(PM.gather_rows(res["hdr"], tiles))
        out[tag] = dict(times=times, exchange=stats, peak_mb=torch.cuda.max_memory_allocated(dev)
                        / 2**20, counts={n: native.launches[e] for n, e in kernels_of.items()},
                        hdr=hdrs if rank == 0 else None, device=str(dev))
    return out


def _http(port: int, path: str, obj=None):
    """GET (obj None) or POST obj as JSON to the viewer's server; the JSON
    reply, or the raw bytes of a page."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if obj is None else json.dumps(obj).encode(),
                                 method="GET" if obj is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        body = r.read()
    return body if path == "/" else json.loads(body)


def _scene_on_cpu(sc):
    """A CUDA scene's tables copied to the CPU, where every wrapper takes
    its plain version: the same slots, trees and rows."""
    return dataclasses.replace(sc, **{f.name: getattr(sc, f.name).cpu()
                                      for f in dataclasses.fields(sc)
                                      if f.init and isinstance(getattr(sc, f.name), torch.Tensor)})


def _app_chain(path, opts, dev, frames=4):
    """The LDR of frame ``frames - 1`` of an app run with ``opts`` (size,
    sun, ``--animate``, ``--outline``, mode, bounces, denoise), rendered
    in this process by ``render_frame_restir`` on ``dev``."""
    from zetaray_tpu_torch import app
    from zetaray_tpu_torch.ops import post
    from zetaray_tpu_torch.ops.gbuffer_pack import TG
    from zetaray_tpu_torch.ops.pathtracer import PTConfig
    from zetaray_tpu_torch.ops.sky import SkyParams
    from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
    from zetaray_tpu_torch.scene.animation import AnimationRig, transform_deltas
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.gltf import load_gltf
    from zetaray_tpu_torch.scene.refit import refit_scene
    from zetaray_tpu_torch.scene.scene import load_scene, upload_scene

    arg = lambda flag, default: opts[opts.index(flag) + 1] if flag in opts else default
    w, h = (int(v) for v in arg("--size", "512x512").split("x"))
    sun = tuple(float(v) for v in arg("--sun", "").split(",")) if "--sun" in opts else None
    cfg_ = RenderConfig(width=w, height=h, mode=arg("--mode", "restir_di"),
                        pt=PTConfig(max_bounces=int(arg("--bounces", 4)),
                                    sky=SkyParams(sun_dir=sun) if sun else None),
                        denoise="--denoise" in opts)
    fps = float(arg("--animate", 0))
    doc = load_gltf(path)
    cpu_ = load_scene(doc)
    sc = upload_scene(cpu_, device=dev)
    if app.scene_textures(cpu_, dev) is not None:
        raise AssertionError("_app_chain: the animated box has no textures")
    rig = AnimationRig(doc)
    cam0 = Camera.look_at((0.0, 1.0, 3.5), (0.0, 1.0, 0.0), vfov_deg=45.0, aspect=w / h)
    state = None
    for i in range(frames):
        t = i / fps
        motion, _ = transform_deltas(rig.instance_worlds(t),
                                     rig.instance_worlds(max(t - 1.0 / fps, 0.0)))
        out, state = render_frame_restir(refit_scene(sc, *rig.deltas(t)),
                                         cam0.with_jitter(i), app.frame_seed(i), cfg_,
                                         state, None, motion=motion)
    ldr = out["ldr"]
    pid = [k for k, n in enumerate(cpu_.inst_names) if arg("--outline", None) in n][0]
    inst = state.gbuf[TG.INST].reshape(h, w)
    return (post.picked_outline_p(ldr.float().permute(2, 0, 1) / 255.0, inst, pid)
            * 255.0).permute(1, 2, 0).to(torch.uint8).cpu().numpy()


def host_phase(dev, chain, show, kernels_of, big_cpu, seed: int, res: int) -> dict:
    """Phase 6, the host side: the app, picking, DDS textures, a checkpoint,
    the viewer and the warm-up, each through the entry point a user calls.
    Returns {kernel name: {path: launches}} of the paths run in this
    process and, for the app's runs (subprocesses), their last frame's
    launches from the app's frame stats."""
    import subprocess
    import threading

    import numpy as np

    from zetaray_tpu_torch import native
    from zetaray_tpu_torch.accel import intersect as XI
    from zetaray_tpu_torch.gui import Viewer, make_server
    from zetaray_tpu_torch.profile import LAUNCHERS
    from zetaray_tpu_torch.ops import prelighting as PL
    from zetaray_tpu_torch.ops.pathtracer import PTConfig
    from zetaray_tpu_torch.ops.sky import SkyParams
    from zetaray_tpu_torch.render.frame import RenderConfig, render_frame_restir
    from zetaray_tpu_torch.render.picking import pick
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.procedural import (
        CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, TEX_CHECKER, animated_box, cornell_box,
        cutout_box, textured_box,
    )
    from zetaray_tpu_torch.scene.scene import upload_scene
    from zetaray_tpu_torch.scene.textures import load_dds, load_scene_textures
    from zetaray_tpu_torch.utils.checkpoint import load_frame_state, save_frame_state
    from zetaray_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    host = {}  # kernel name -> {path: launches}
    # the kernels' names by the tags of the frame stats
    entry_names = {e: name for name, e in kernels_of.items()}
    tag_names = {tag: entry_names[e] for tag, e in LAUNCHERS.items()}

    def note(path, counts):
        for name, n in counts.items():
            if n:
                host.setdefault(name, {})[path] = n

    # (a) the app as a user runs it, on the animated box written as glTF
    app_dir = os.path.join(IMAGE_DIR, "app")
    os.makedirs(app_dir, exist_ok=True)
    gltf = str(animated_box(os.path.join(app_dir, "box.gltf")))
    common = [sys.executable, "-m", "zetaray_tpu_torch.app", gltf, "--frames", "4"]
    frame_opts = ["--size", "512x512", "--sun", ",".join(map(str, SUN)), "--animate", "30",
                  "--validate", "--dump-graph", "--outline", "tall"]
    runs = {
        "app restir_di 512^2": (frame_opts, ("B1", "B2", "B3", "B6")),
        "app restir_gi 512^2": (frame_opts + ["--mode", "restir_gi", "--bounces", "3",
                                              "--denoise"], ("B1", "B2", "B3", "B4", "B5", "B6")),
        "app --profile 256^2": (["--size", "256x256", "--profile"], ("B1", "B2", "B3", "B6")),
    }
    for k, (tag, (opts, expect)) in enumerate(runs.items()):
        out_dir = os.path.join(app_dir, f"run{k}")
        t0 = time.perf_counter()
        p = subprocess.run(common + opts + ["--out", out_dir], capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"{tag} exited {p.returncode}:\n{p.stderr[-4000:]}")
        frame_ms = [float(x) for x in re.findall(r"\] frame \d+: ([0-9.]+) ms", p.stderr)]
        launches = {tag_names[t]: int(n) for t, n in re.findall(r"launches/(B\d): (\d+)",
                                                                 p.stdout)}
        means = [float(read_png(os.path.join(out_dir, f"frame_{i:04d}.png")).mean())
                 for i in range(4)]
        if len(frame_ms) != 4 or min(means) < 10.0:
            raise AssertionError(f"{tag}: frames {frame_ms} ms, PNG means {means}")
        for t in expect:
            if launches.get(tag_names[t], 0) <= 0:
                raise AssertionError(f"{tag}: kernel {tag_names[t]} was not launched: {launches}")
        if "--dump-graph" in opts and "digraph frame {" not in p.stdout:
            raise AssertionError(f"{tag}: no frame graph printed")
        passes = re.findall(r"^  (.+): ([0-9.]+) ms$", p.stdout, re.M)
        if "--profile" in opts and len(passes) < 10:
            raise AssertionError(f"{tag}: --profile printed {len(passes)} passes")
        note(f"{tag}, a frame", launches)
        same = ""
        if "--animate" in opts:
            # the same frames rendered here through the frame function, with the
            # app's frame seeds, refit, motion and outline: the app's last PNG
            # must equal this chain's last LDR bit for bit
            want = _app_chain(gltf, opts, dev)
            got = read_png(os.path.join(out_dir, "frame_0003.png"))
            if not np.array_equal(got, want):
                raise AssertionError(f"{tag}: frame_0003.png differs from the direct chain in "
                                     f"{int((got != want).any(-1).sum())} pixels")
            same = "; frame_0003.png equal to a direct render_frame_restir chain bit for bit"
        print(f"(a) {tag}: frames {frame_ms} ms (median of frames 2-4 "
              f"{statistics.median(frame_ms[1:]):.3f} ms), the run {wall:.1f} s wall; last "
              f"frame's launches {launches}; PNG means {[round(x, 1) for x in means]}"
              + (f"; passes {dict((n, float(v)) for n, v in passes[:6])} ms ..."
                 if "--profile" in opts else "") + same, flush=True)

    # (c) pick on the 139,266-triangle clustered box (B8 and its epilogue)
    # and on the cutout box (the re-trace, B7 a round), each against the same
    # pick through the plain versions on a CPU copy of the scene
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    pixels = [(256, 256), (40, 300), (470, 60), (200, 180), (330, 180), (100, 420), (0, 0)]
    cut_cpu = cutout_box(TEX_DIR)
    for tag, sc, cpu_, kernel in (
            ("clustered 139k", upload_scene(big_cpu, device=dev), big_cpu, "stream_closest"),
            ("cutout", upload_scene(cut_cpu, device=dev), cut_cpu, "closest")):
        plain_sc = _scene_on_cpu(sc)
        for entry in kernels_of.values():
            native.launches[entry] = 0
        ms, hits = [], 0
        for px, py in pixels:
            t0 = time.perf_counter()
            got = pick(sc, cpu_, cam, px, py, res, res)
            ms.append((time.perf_counter() - t0) * 1e3)
            want = pick(plain_sc, cpu_, cam, px, py, res, res)
            if (got.hit, got.tri, got.instance, got.material) != (
                    want.hit, want.tri, want.instance, want.material) or (
                    got.hit and abs(got.t - want.t) > 1e-6 * abs(want.t)):
                raise AssertionError(f"pick {tag} ({px}, {py}): {got} against plain {want}")
            hits += got.hit
        counts = {name: native.launches[e] for name, e in kernels_of.items()}
        if counts[kernel] < len(pixels) or hits < 5:
            raise AssertionError(f"pick {tag}: launches {counts}, {hits} hits")
        note(f"pick {tag}, {len(pixels)} picks", counts)
        print(f"(c) pick on the {tag} box at {res}^2 pixels {pixels}: equal to the plain "
              f"versions ({hits} hits, t to 1e-6); ms a pick {[round(x, 3) for x in ms]}; "
              f"launches {counts}", flush=True)
        del sc, plain_sc
    torch.cuda.empty_cache()

    # (d) the textured box with its checker as BC1 and BC7 DDS files
    flag = dict(mode="restir_gi", pt=PTConfig(max_bounces=3), denoise=True, taa=True)
    dds_dir = os.path.join(TEX_DIR, "dds")
    os.makedirs(dds_dir, exist_ok=True)
    t0 = time.perf_counter()
    native.bcn_lib()
    print(f"(d) BCn library: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(native.bcn_library_path())}", flush=True)
    for fmt in ("bc1", "bc7"):
        tcpu = textured_box(dds_dir, base_format=fmt)
        path = tcpu.texture_paths[TEX_CHECKER]
        dec = []
        for _ in range(5):
            t0 = time.perf_counter()
            load_dds(path)
            dec.append((time.perf_counter() - t0) * 1e3)
        outs = {}
        for dv, where in (("cpu", "cpu"), (dev, "card")):
            sc = upload_scene(tcpu, device=dv)
            tex = load_scene_textures(tcpu, device=dv)
            sc = PL.apply_tri_powers(sc, *PL.estimate_tri_power(sc, tex))
            if where == "cpu":
                state = None
                for k in range(2):
                    o_, state = render_frame_restir(sc, cam.with_jitter(k), seed + k,
                                                    RenderConfig(width=64, height=64, **flag),
                                                    state, textures=tex)
                outs["cpu"] = o_["hdr"]
            else:
                o_, _, _ = chain(RenderConfig(width=64, height=64, **flag), cam, (), frames=2,
                                 sc=sc, textures=tex)
                outs["card"] = o_["hdr"].cpu()
                _, times, counts = chain(RenderConfig(width=res, height=res, **flag), cam,
                                         ("gbuffer", "ris", "occlusion", "bounce_trace",
                                          "bounce_shade", "bounce"), sc=sc, textures=tex)
        close = ((outs["card"] - outs["cpu"]).abs() <= 1e-3 * (1 + outs["cpu"].abs())).all(-1)
        share = close.float().mean().item()
        if not share >= 0.99:
            raise AssertionError(f"DDS {fmt} textured 64^2 flagship: {share} of the pixels "
                                 "agree with the CPU")
        note(f"DDS {fmt} flagship {res}^2, a chain of 4", counts)
        print(f"(d) DDS {fmt.upper()} checker {os.path.basename(path)}: host decode (load_dds) "
              f"{[round(x, 3) for x in dec]} ms; 64^2 textured flagship on the card against "
              f"the CPU: {share:.4f} of the pixels within 1e-3", flush=True)
        show(f"(d) DDS {fmt.upper()} textured flagship {res}^2", times, counts)

    # (e) a checkpoint after frame 2 of the default frame's chain, resumed
    app_cfg = RenderConfig(width=res, height=res, mode="restir_di", taa=True,
                           pt=PTConfig(max_bounces=4, sky=SkyParams(sun_dir=SUN)))
    box = upload_scene(cornell_box(), device=dev)
    ckpt = os.path.join(app_dir, "state.npz")
    state, whole = None, []
    for k in range(4):
        o_, state = render_frame_restir(box, cam.with_jitter(k), seed + k, app_cfg, state)
        whole.append(o_)
        if k == 1:
            t0 = time.perf_counter()
            save_frame_state(ckpt, state, params_snapshot={"seed": seed})
            save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state, params = load_frame_state(ckpt)
    load_ms = (time.perf_counter() - t0) * 1e3
    if params != {"seed": seed} or state.history.device.type != "cuda":
        raise AssertionError(f"checkpoint: params {params}, history on {state.history.device}")
    for k in (2, 3):
        o_, state = render_frame_restir(box, cam.with_jitter(k), seed + k, app_cfg, state)
        for key in ("hdr", "ldr"):
            if not torch.equal(o_[key], whole[k][key]):
                raise AssertionError(f"checkpoint: resumed frame {k + 1} {key} differs from the "
                                     f"unbroken chain")
    print(f"(e) checkpoint of the default frame {res}^2 after frame 2 "
          f"({os.path.getsize(ckpt)} bytes, save {save_ms:.1f} ms, load {load_ms:.1f} ms): "
          "frames 3-4 resumed equal the unbroken chain bit for bit", flush=True)

    # (b) the viewer on the card at 256^2 (restir_gi) behind its HTTP server;
    # last of the in-process steps, since its hot reload re-imports the op
    # modules (the kernels' wrappers and their counts with them)
    vres = 256
    from zetaray_tpu_torch.utils import params as PRM

    PRM.registry._params.clear()
    viewer = Viewer(gltf, RenderConfig(width=vres, height=vres, **flag), device=dev)
    server = make_server(viewer, 0)
    port = server.server_address[1]
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    try:
        vms = []

        def frame(i):
            t0 = time.perf_counter()
            img = viewer.render_one(i)  # ends in a copy to the host
            vms.append((time.perf_counter() - t0) * 1e3)
            return img

        for i in range(3):
            frame(i)
        if b"zetaray_tpu_torch" not in _http(port, "/"):
            raise AssertionError("viewer: GET / did not serve the page")
        st = _http(port, "/api/stats")
        if st["width"] != vres or st["device"] != str(dev):
            raise AssertionError(f"viewer: stats {st}")
        native.launches["zr_closest"] = 0
        for px, py, hit in ((vres // 2, vres // 2, True), (0, 0, False)):
            _http(port, "/api/pick", {"x": px, "y": py})
            frame(3)
            res_ = _http(port, "/api/pick")
            o, d = viewer._camera(3).generate_rays(vres, vres, device=dev, rows=(py, 1))
            sh = XI.closest_hit_plain_shaded(viewer.scene.woop, viewer.scene.tri_attrs,
                                             o[px : px + 1], d[px : px + 1])
            tri, t = int(sh.tri[0]), float(sh.t[0])
            if res_["hit"] != hit or res_["tri"] != tri or (
                    hit and abs(res_["t"] - t) > 1e-6 * t):
                raise AssertionError(f"viewer pick ({px}, {py}): {res_} against the plain "
                                     f"closest hit tri {tri}, t {t}")
        pick_launches = native.launches["zr_closest"]
        if pick_launches != 2:
            raise AssertionError(f"viewer picks launched B7 {pick_launches} times")
        note("viewer, 2 picks", {"closest": pick_launches})
        _http(port, "/api/camera", {"dyaw": 0.2, "ddolly": 0.1})
        _http(port, "/api/material", {"index": 0, "field": "roughness", "value": 0.4})
        _http(port, "/api/transform", {"instance": 1, "translate": [0.1, 0.0, 0.0]})
        sel = viewer.scene.inst_id == 1
        x0 = viewer.scene.v0[sel, 0].mean().item()
        frame(4)
        moved = viewer.scene.v0[sel, 0].mean().item() - x0
        if abs(moved - 0.1) > 1e-5 or abs(viewer.scene.mat_roughness[0].item() - 0.4) > 1e-6:
            raise AssertionError(f"viewer edits: moved {moved}, roughness "
                                 f"{viewer.scene.mat_roughness[0].item()}")
        lib_before, path_before = native._lib, native.library_path()
        viewer._frame_state = None
        plain_next = frame(5)
        _http(port, "/api/reload", {})
        reloaded_next = frame(5)
        reloaded = _http(port, "/api/reload_result")["reloaded"]
        if (native._lib is not lib_before or native.library_path() != path_before
                or "zetaray_tpu_torch.native" in reloaded
                or "zetaray_tpu_torch.render.frame" not in reloaded):
            raise AssertionError(f"viewer reload: {reloaded}")
        if not (plain_next == reloaded_next).all():
            raise AssertionError("viewer: the frame after the reload differs from the frame "
                                 "without it")
        _http(port, "/api/quit", {})
        srv.join(timeout=60)
        if srv.is_alive() or viewer.state.running:
            raise AssertionError("viewer: /api/quit did not stop the server and the loop")
        print(f"(b) viewer {vres}^2 restir_gi on {dev}: ms a viewer frame "
              f"{[round(x, 3) for x in vms]} (median {statistics.median(vms[1:]):.3f}); picks "
              f"equal the plain closest hit (B7 launched {pick_launches} times); camera, "
              f"material and transform (refit) edits applied; reload of {len(reloaded)} "
              "modules, no library rebuilt, the next frame equal to the frame without it; "
              "quit stopped the server", flush=True)
    finally:
        viewer.stop()
        server.shutdown()
        server.server_close()
        PRM.registry._params.clear()

    # (f) the warm-up as a user runs it
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "zetaray_tpu_torch.warmup"], capture_output=True,
                       text=True, timeout=600)
    if p.returncode != 0 or "warmup complete" not in p.stdout:
        raise AssertionError(f"warmup exited {p.returncode}:\n{p.stdout[-2000:]}\n"
                             f"{p.stderr[-3000:]}")
    print(f"(f) python -m zetaray_tpu_torch.warmup: {time.perf_counter() - t0:.1f} s wall; "
          + "; ".join(p.stdout.strip().splitlines()), flush=True)
    print(f"host-side phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return host


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from zetaray_tpu_torch import native
    from zetaray_tpu_torch.accel import intersect as XI
    from zetaray_tpu_torch.accel import megakernel as MK
    from zetaray_tpu_torch.accel import stream as ST
    from zetaray_tpu_torch.accel.bvh import LEAF_SIZE
    from zetaray_tpu_torch.ops import prelighting as PL
    from zetaray_tpu_torch.ops import restir_di as RD
    from zetaray_tpu_torch.ops import skydi as SD
    from zetaray_tpu_torch.ops import volumetrics as VL
    from zetaray_tpu_torch.ops.pathtracer import PTConfig, park
    from zetaray_tpu_torch.ops.restir_di import ReSTIRConfig
    from zetaray_tpu_torch.ops.restir_gi import ReSTIRGIConfig
    from zetaray_tpu_torch.ops.restir_pt import ReSTIRPTConfig
    from zetaray_tpu_torch.ops.skydi import SkyDIConfig
    from zetaray_tpu_torch.ops.volumetrics import VolumetricsConfig
    from zetaray_tpu_torch.ops.restir_gi import secondary_rays
    from zetaray_tpu_torch.ops.restir_pt import prefix_rays
    from zetaray_tpu_torch.ops.sky import SkyParams
    from zetaray_tpu_torch.render.frame import (
        RenderConfig, pick_rt, render_frame, render_frame_restir,
    )
    from zetaray_tpu_torch.scene.animation import AnimationRig, transform_deltas
    from zetaray_tpu_torch.scene.camera import Camera
    from zetaray_tpu_torch.scene.gltf import load_gltf
    from zetaray_tpu_torch.ops.upscale import UpscaleConfig
    from zetaray_tpu_torch.scene.procedural import (
        CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, CHECKER, PANEL, PANEL_RECT, PANEL_Z, ROOM,
        TEX_CHECKER, animated_box, cornell_box, cutout_box, materials_box, multi_light_box,
        textured_box,
    )
    from zetaray_tpu_torch.scene.refit import refit_scene
    from zetaray_tpu_torch.scene.scene import A, load_scene, upload_scene
    from zetaray_tpu_torch.scene.textures import apply_textures_to_gbuffer, load_scene_textures
    from zetaray_tpu_torch.scene.subdivide import subdivide_scene
    from zetaray_tpu_torch.timing import card_line, cuda_ms

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = native.build()
    native.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib_path)}", flush=True)
    from zetaray_tpu_torch import kernel_ab

    report = kernel_ab.ptxas_report(native)
    registers = bounce_registers(report)
    print(f"registers of B4-B6 by their compile-time branches: {registers}", flush=True)

    # -- phase 3: each kernel against its plain version at the frame's shapes
    res = 512
    n = res * res
    seed = 0x2468ACE1
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    o, d = cam.generate_rays(res, res, device=dev)
    cam_hd = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1920 / 1080)

    def check_ris(label, gk, lsets, pix0=0):
        """B2 on G-buffer gk against its plain version: at least 99.5% of the
        pixels pick the same entry and those agree to 1e-5 * (1 + |x|).
        Returns its reservoirs and a record of its times and bound. ``pix0``:
        gk is a row band from that global pixel on (tile0 = pix0 // rt)."""
        n_px = gk.shape[1]
        n_sets, _, ps = lsets.shape
        rt = pick_rt(n_px)
        rk = RD.initial_candidates(gk, lsets, seed, rt=rt, pix0=pix0)
        rp = RD.initial_candidates_plain(gk, lsets, seed, rt, pix0)
        torch.cuda.synchronize()
        same = (rk[0:3] == rp[0:3]).all(0)
        share = same.float().mean().item()
        err = (rk[:, same] - rp[:, same]).abs().max().item()
        rel_ok = ((rk[:, same] - rp[:, same]).abs() <= 1e-5 * (1 + rp[:, same].abs())).all().item()
        if share < 0.995 or not rel_ok:
            raise AssertionError(f"ris {label}: same pick on {share:.6f}, max abs err {err}")
        del rp
        # a valid pixel rates every entry, an invalid one only the last (its
        # weights are 0, its target is row 13); RIS reads 10 G-buffer rows
        # (position, normal, base color, valid)
        n_valid = int((gk[MK.G.VALID] > 0.5).sum().item())
        b_ms, b_by = bound(RIS_ENTRY_OPS * (n_valid * ps + n_px - n_valid),
                           n_px * (10 + RD.R_ROWS) * F32 + n_sets * MK.LSET_STAGED * ps * F32)
        return rk, dict(max_abs_err=err,
                        ms=cuda_ms(lambda: RD.initial_candidates(gk, lsets, seed, rt=rt,
                                                                 pix0=pix0), reps=20),
                        plain_ms=cuda_ms(lambda: RD.initial_candidates_plain(gk, lsets, seed, rt,
                                                                             pix0),
                                         reps=3, warmup=1),
                        bound_ms=b_ms, bound_by=b_by, valid_share=n_valid / n_px)

    sky = SkyParams(sun_dir=SUN)
    vol_cfg = VolumetricsConfig()

    def direction_segments(gk, dev_):
        """The frame's segments along unit directions, tested in (1e-3, 1e8):
        SkyDI's shade segments toward the winning sky directions of the
        G-buffer gk (candidates and a pairwise spatial pass, as the features
        frame draws them) and the default froxel grid's 12,288 sun segments
        ({name: (origins [M, 3], directions [M, 3])})."""
        sd_cfg = SkyDIConfig(spatial_mis="pairwise")
        side = int(round(gk.shape[1] ** 0.5))
        sky_res = SD.spatial_reuse(SD.initial_candidates(gk, sky, seed, sd_cfg), gk, side, side,
                                   seed, sd_cfg)
        pos, _, _ = VL.froxel_points(cam, vol_cfg, dev_)
        return {"skydi_segments": SD.shade_segments(sky_res, gk),
                "froxel_sun_segments": VL.sun_segments(pos, sky)}

    def check_any_hit(tag, kernel, plain, so_s, sd_s, pair_tests, scene_bytes):
        """An any-hit kernel on segments so_s, sd_s against its plain version:
        every flag equal. A blocked segment needs at least one test, a free
        one ``pair_tests``. Returns its record."""
        ok_k, ok_p = kernel(so_s, sd_s), plain(so_s, sd_s)
        torch.cuda.synchronize()
        n_diff = int((ok_k != ok_p).sum().item())
        if n_diff:
            raise AssertionError(f"{tag}: {n_diff} segments differ from the plain version")
        m = so_s.shape[0]
        n_blk = int(ok_p.sum().item())
        b_ms, b_by = bound(PAIR_OPS * ((m - n_blk) * pair_tests + n_blk),
                           m * (6 + 1) * F32 + scene_bytes)
        r = dict(max_abs_err=0.0, ms=cuda_ms(lambda: kernel(so_s, sd_s), reps=20),
                 plain_ms=cuda_ms(lambda: plain(so_s, sd_s), reps=2, warmup=1),
                 bound_ms=b_ms, bound_by=b_by, segments=m, blocked=n_blk / m)
        print(f"{tag} ({m} segments, {n_blk / m:.4f} blocked): {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.3f}, bound {b_ms:.4f} by {b_by}), equal on every segment",
              flush=True)
        return r

    record = {}
    for label, subdivide in (("cornell36", None), ("cornell8192", 8192)):
        scene = upload_scene(cornell_box(subdivide_to=subdivide), device=dev)
        tp = scene.woop.shape[1] // 3
        n_tri = scene.num_tris
        tri_bytes = n_tri * (12 + A.WIDTH) * F32  # Woop rows and attribute rows
        rec = record[label] = {}

        def put(name, err, ms, plain_ms, ops, nbytes):
            rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            rec[name]["bound_ms"], rec[name]["bound_by"] = bound(ops, nbytes)

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
        put("gbuffer", err_g, cuda_ms(lambda: MK.gbuffer(scene, o, d), reps=20),
            cuda_ms(lambda: MK.gbuffer_plain(scene, o, d), reps=3, warmup=1),
            PAIR_OPS * n * n_tri, n * (6 + MK.G.ROWS) * F32 + tri_bytes)
        r1 = rec["gbuffer"]
        r1.update(nt=n_tri, pairs_per_s=n * n_tri / (r1["ms"] * 1e-3))

        lsets = MK.build_light_sets(scene, seed)
        n_sets, _, ps = lsets.shape
        set_bytes = n_sets * MK.LSET_STAGED * ps * F32
        rt = pick_rt(n)
        rk, rec["ris"] = check_ris(label, gk, lsets)
        if label == "cornell36":  # B2 also at 1920x1080, where it costs most
            o_hd, d_hd = cam_hd.generate_rays(1920, 1080, device=dev)
            g_hd = MK.gbuffer(scene, o_hd, d_hd)
            r_hd = rec["ris"]["at_1920x1080"] = check_ris("cornell36 1920x1080", g_hd, lsets)[1]
            print(f"cornell36 (1920x1080 pixels, {r_hd['valid_share']:.4f} valid): ris "
                  f"{r_hd['ms']:.4f} ms (plain {r_hd['plain_ms']:.3f}, bound "
                  f"{r_hd['bound_ms']:.4f} by {r_hd['bound_by']}), max abs err "
                  f"{r_hd['max_abs_err']:.3g}", flush=True)
            del o_hd, d_hd, g_hd
            torch.cuda.empty_cache()

        so = (gk[MK.G.POS : MK.G.POS + 3] + 1e-3 * gk[MK.G.NG : MK.G.NG + 3]).T.contiguous()
        seg = (rk[0:3] - gk[MK.G.POS : MK.G.POS + 3]).T.contiguous()
        ok = XI.occlusion(scene, so, seg, 1e-3, 1.0 - 1e-3)
        op = XI.occlusion_plain(scene.woop, so, seg, 1e-3, 1.0 - 1e-3)
        torch.cuda.synchronize()
        n_diff = (ok != op).sum().item()
        if n_diff:
            raise AssertionError(f"occlusion {label}: {n_diff} rays differ from the plain version")
        n_occ = ok.sum().item()
        # an occluded ray needs at least one test, a free one all of them
        put("occlusion", float((ok.int() - op.int()).abs().max().item()),
            cuda_ms(lambda: XI.occlusion(scene, so, seg, 1e-3, 1.0 - 1e-3), reps=20),
            cuda_ms(lambda: XI.occlusion_plain(scene.woop, so, seg, 1e-3, 1.0 - 1e-3),
                    reps=3, warmup=1),
            PAIR_OPS * ((n - n_occ) * n_tri + n_occ), n * (6 + 1) * F32 + 12 * n_tri * F32)
        print(f"{label} ({tp} padded triangles, {n} rays): " + "; ".join(
            f"{k} {rec[k]['ms']:.4f} ms (plain {rec[k]['plain_ms']:.3f}, bound "
            f"{rec[k]['bound_ms']:.4f} by {rec[k]['bound_by']}), max abs err "
            f"{rec[k]['max_abs_err']:.3g}" for k in ("gbuffer", "ris", "occlusion"))
            + f"; {n_occ / n:.4f} occluded; gbuffer {r1['pairs_per_s']:.4g} pairs/s", flush=True)
        # B3 on direction segments in (1e-3, 1e8): SkyDI's shade toward each
        # pixel's winning sky direction and the froxel grid's sun segments
        for seg_name, (so_s, sd_s) in direction_segments(gk, dev).items():
            rec["occlusion"][seg_name] = check_any_hit(
                f"occlusion {label} {seg_name}", lambda a, b: XI.occlusion(scene, a, b, 1e-3, 1e8),
                lambda a, b: XI.occlusion_plain(scene.woop, a, b, 1e-3, 1e8), so_s, sd_s,
                n_tri, 12 * n_tri * F32)

        # B4-B6 on the GI trace's bounce-0 rays (the flagship's GI trace:
        # 2 bounces after x2, x2's own emission excluded), without path
        # options, then with the sky (the sun shining in through the box's
        # opening), sun NEE, path regularization and the firefly clamp, and
        # with the sky but no sun NEE
        o2, d2, _, _ = secondary_rays(gk, seed)
        st0 = MK.initial_state(o2, d2)
        gi_cfg = PTConfig(max_bounces=2, min_emissive_bounce=1)
        opt_cfg = dataclasses.replace(gi_cfg, sky=SkyParams(sun_dir=SUN), path_regularization=True,
                                      firefly_clamp=FIREFLY_CLAMP)
        spread = cam.pixel_spread_angle(res)
        for opt, cfg_ in (("", gi_cfg), ("sky_sun", opt_cfg),
                          ("sky_no_sun_nee", dataclasses.replace(opt_cfg, sun_nee=False))):
            recs = bounce_records(scene, label, opt, cfg_, st0, lsets, seed, rt, spread, n_tri,
                                  tri_bytes, set_bytes)
            for name, r in recs.items():
                if opt:
                    rec[name][opt] = r
                else:
                    rec[name] = r
            print(f"{label} ({n} GI bounce-0 rays{', ' + opt if opt else ''}, "
                  f"{recs['bounce_trace']['hit']:.4f} hit, {recs['bounce']['hit']:.4f} hit at "
                  f"bounce 1): " + "; ".join(
                      f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
                      f"{r['bound_ms']:.4f} by {r['bound_by']}), max abs err "
                      f"{r['max_abs_err']:.3g}" for k, r in recs.items())
                  + f"; bounce_shade min_nee_bounce=1 "
                  f"{recs['bounce_shade']['min_nee_bounce_1']['ms']:.4f} ms (plain "
                  f"{recs['bounce_shade']['min_nee_bounce_1']['plain_ms']:.3f}, bound "
                  f"{recs['bounce_shade']['min_nee_bounce_1']['bound_ms']:.4f}), max abs err "
                  f"{recs['bounce_shade']['min_nee_bounce_1']['max_abs_err']:.3g}"
                  + f"; bounce_trace {recs['bounce_trace']['pairs_per_s']:.4g}, bounce "
                  f"{recs['bounce']['pairs_per_s']:.4g} pairs/s; shadow segments let through: "
                  f"bounce_shade {recs['bounce_shade']['lit_segments']}, bounce "
                  f"{recs['bounce']['lit_segments']}" + (
                      f"; live misses: bounce_trace {recs['bounce_trace']['live_misses']}, "
                      f"bounce {recs['bounce']['live_misses']}; bounds with the sky, ms: "
                      f"bounce_trace {recs['bounce_trace']['bound_ms']!r}, bounce "
                      f"{recs['bounce']['bound_ms']!r}" if opt else ""), flush=True)

        if label == "cornell36":
            # the tile offset: B2, B5 and B6 on the image's lower half as the
            # second of two row bands (rank 1 of the sharded frames), from
            # global pixel pix0 = n / 2 (tile0 = pix0 // rt), against their
            # plain versions at that offset: max abs err 0; each also timed on
            # the same band at tile0 = 0 (ms_tile0_0)
            half = n // 2
            rt_b = pick_rt(half)
            tile0 = half // rt_b
            key = f"tile0_{tile0}"
            gk_b, st0_b = gk[:, half:].contiguous(), st0[:, half:].contiguous()
            r_b = check_ris(f"{label} band {key}", gk_b, lsets, pix0=half)[1]
            r_b["ms_tile0_0"] = cuda_ms(lambda: RD.initial_candidates(gk_b, lsets, seed, rt=rt_b),
                                        reps=20)
            recs = bounce_records(scene, label, key, gi_cfg, st0_b, lsets, seed, rt_b, spread,
                                  n_tri, tri_bytes, set_bytes, full=False, pix0=half)
            recs0 = bounce_records(scene, label, "tile0_0", gi_cfg, st0_b, lsets, seed, rt_b,
                                   spread, n_tri, tri_bytes, set_bytes, full=False)
            for name, r in recs.items():
                r["ms_tile0_0"] = recs0[name]["ms"]
            for name, r in (("ris", r_b), *recs.items()):
                if r["max_abs_err"] != 0.0:
                    raise AssertionError(f"{name} {key}: max abs err {r['max_abs_err']}")
                rec[name][key] = {**r, "tile0": tile0, "pix0": half}
            print(f"{label} (the lower band of {half} pixels, pix0 {half}, tile0 {tile0}): "
                  + "; ".join(f"{k} {r['ms']:.4f} ms (at tile0 0 {r['ms_tile0_0']:.4f}, plain "
                              f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} by "
                              f"{r['bound_by']}), max abs err {r['max_abs_err']:.3g}"
                              for k, r in (("ris", r_b), *recs.items())), flush=True)

        # the WoPS instances of B5 and B6 (nee_mode="wops": a per-ray draw
        # from the emissive alias table) on the same rays, bit-equal to
        # their plain versions; without sun NEE B5 runs the instance of
        # "wops" (it has no sky branch), so there only B6 is kept
        opts_wops = [("wops", gi_cfg, ("bounce_shade", "bounce")),
                     ("wops_sky_sun", opt_cfg, ("bounce_shade", "bounce"))]
        if label == "cornell36":
            opts_wops.append(("wops_sky_no_sun_nee", dataclasses.replace(opt_cfg, sun_nee=False),
                              ("bounce",)))
        for opt, cfg_, kept in opts_wops:
            wops_bounce_records(scene, label, opt, dataclasses.replace(cfg_, nee_mode="wops"), st0,
                                seed, rt, spread, n_tri, tri_bytes, rec, kept)

        # B7 on ReSTIR PT prefix rays: every output equal to the plain version
        o7, d7 = prefix_rays(gk, seed)
        sh = XI.closest_hit(scene, o7, d7)
        sh_p = XI.closest_hit_plain_shaded(scene.woop, scene.tri_attrs, o7, d7)
        torch.cuda.synchronize()
        for field, a, b in zip(sh._fields, sh, sh_p):
            if not torch.equal(a, b):
                raise AssertionError(f"closest {label}: {field} differs from the plain version")
        hit7 = sh_p.tri >= 0
        err_7 = max((a.float() - b.float())[..., hit7].abs().max().item() for a, b in zip(sh, sh_p))
        put("closest", err_7,
            cuda_ms(lambda: XI.closest_hit(scene, o7, d7), reps=20),
            cuda_ms(lambda: XI.closest_hit_plain_shaded(scene.woop, scene.tri_attrs, o7, d7),
                    reps=3, warmup=1),
            PAIR_OPS * n * n_tri, n * (6 + 4 + A.WIDTH) * F32 + tri_bytes)
        r7 = rec["closest"]
        r7.update(nt=n_tri, pairs_per_s=n * n_tri / (r7["ms"] * 1e-3))
        # bench.py's primary-rays rate: B7 on 1024^2 camera rays
        oc, dc = cam.generate_rays(1024, 1024, device=dev)
        ms_c = cuda_ms(lambda: XI.closest_hit(scene, oc, dc), reps=10)
        print(f"{label} ({n} PT prefix rays, {hit7.float().mean().item():.4f} hit, tie chunk "
              f"{XI.tie_chunk(tp)}): closest {r7['ms']:.4f} ms (plain {r7['plain_ms']:.3f}, bound "
              f"{r7['bound_ms']:.4f} by {r7['bound_by']}), tri/t/u/v/attrs equal, max abs err "
              f"{err_7:.3g}, {r7['pairs_per_s']:.4g} pairs/s; 1024^2 camera rays {ms_c:.4f} ms = "
              f"{oc.shape[0] / ms_c / 1e3:.1f} Mrays/s", flush=True)
        del scene, gk, gp, rk, so, seg, st0, o7, d7, sh, sh_p, oc, dc
        torch.cuda.empty_cache()

    # the WoPS instances on the box with three wall lights of unequal power,
    # where the alias table redirects picks
    ml = upload_scene(multi_light_box(), device=dev)
    o2m, d2m, _, _ = secondary_rays(MK.gbuffer(ml, o, d), seed)
    record["multi_light"] = {}
    wops_bounce_records(ml, "multi_light", "wops",
                        PTConfig(max_bounces=2, min_emissive_bounce=1, nee_mode="wops"),
                        MK.initial_state(o2m, d2m), seed, pick_rt(n), cam.pixel_spread_angle(res),
                        ml.num_tris, ml.num_tris * (12 + A.WIDTH) * F32, record["multi_light"])
    if not record["multi_light"]["bounce_shade"]["wops"]["alias_share"] > 0.01:
        raise AssertionError("the alias table redirects no pick on the multi-light box")
    del ml, o2m, d2m

    # the material instances of B5 and B6 (their transmission and coat
    # lobes) on the materials box (the tall block glass, the short one under
    # a clear coat) and its 8192-triangle subdivision, on the GI bounce-0
    # rays as the frame's ReSTIR GI draws them (through the glass too), each
    # held against its plain version: without path options (with B4, whose
    # surface rows 15-18 carry the materials, and B5 with min_nee_bounce=1),
    # with the sky, sun NEE and the path options, with the sky alone, and
    # each with WoPS NEE; the box covers every material instance, the
    # subdivision the two that the materials frames below spend most in
    mat_cfgs = {
        "": (gi_cfg, ("bounce_trace", "bounce_shade", "bounce")),
        "sky_sun": (opt_cfg, ("bounce_shade", "bounce")),
        "sky_no_sun_nee": (dataclasses.replace(opt_cfg, sun_nee=False), ("bounce",)),
        "wops": (dataclasses.replace(gi_cfg, nee_mode="wops"), ("bounce_shade", "bounce")),
        "wops_sky_sun": (dataclasses.replace(opt_cfg, nee_mode="wops"),
                         ("bounce_shade", "bounce")),
        "wops_sky_no_sun_nee": (dataclasses.replace(opt_cfg, sun_nee=False, nee_mode="wops"),
                                ("bounce",)),
    }
    for label, subdivide, opts in (("materials36", None, list(mat_cfgs)),
                                   ("materials8192", 8192, ["", "wops_sky_sun"])):
        ms = upload_scene(materials_box(subdivide_to=subdivide), device=dev)
        if not (ms.has_transmission and ms.has_coat):
            raise AssertionError(f"{label}: the materials box has no glass or no coat")
        gk_m = MK.gbuffer(ms, o, d)
        o2m, d2m, _, _ = secondary_rays(gk_m, seed, trans=True, coat=True)
        st0m = MK.initial_state(o2m, d2m)
        rec = record[label] = {}
        tri_bytes_m = ms.num_tris * (12 + A.WIDTH) * F32
        for opt in opts:
            cfg_, kept = mat_cfgs[opt]
            lights = MK.wops_table(ms) if cfg_.nee_mode == "wops" else MK.build_light_sets(ms, seed)
            recs = bounce_records(ms, label, opt, cfg_, st0m, lights, seed, rt, spread, ms.num_tris,
                                  tri_bytes_m, lights.numel() * F32, full=opt == "")
            for name in kept:
                rec.setdefault(name, {})[opt] = recs[name]
            print(f"{label} ({n} GI bounce-0 rays, materials{', ' + opt if opt else ''}): "
                  + "; ".join(f"{k} {recs[k]['ms']:.4f} ms (plain {recs[k]['plain_ms']:.3f}, "
                              f"bound {recs[k]['bound_ms']:.4f} by {recs[k]['bound_by']}), max "
                              f"abs err {recs[k]['max_abs_err']:.3g}" for k in kept)
                  + (f"; bounce_shade min_nee_bounce=1 "
                     f"{recs['bounce_shade']['min_nee_bounce_1']['ms']:.4f} ms, max abs err "
                     f"{recs['bounce_shade']['min_nee_bounce_1']['max_abs_err']:.3g}"
                     if opt == "" else ""), flush=True)
        del ms, gk_m, o2m, d2m, st0m
        torch.cuda.empty_cache()

    # a-trous at 1920x1080, the size both benchmark cells denoise
    record["atrous1080p"] = atrous_record(dev, report, seed)
    torch.cuda.empty_cache()
    # the wavefront path trace at 1920x1080 on the benchmark's clustered scenes
    record["wavefront1080p"] = wavefront_record(dev, report, seed)
    torch.cuda.empty_cache()

    # -- phase 3 on the textured box (after the emissive power round trip, as
    # the JAX app does it): B4 and B5 on the GI bounce-0 rays of its textured
    # G-buffer with the base-colour fetch between them, each held against its
    # plain version, and the fetch's own time and launches (and those of the
    # G-buffer texturing)
    os.makedirs(TEX_DIR, exist_ok=True)

    def textured_scene(cpu_, dev_):
        """(scene, bundle) on dev_; the emissive power round trip where the
        bundle has an emissive map."""
        sc_ = upload_scene(cpu_, device=dev_)
        tex_ = load_scene_textures(cpu_, device=dev_)
        if tex_["emissive"]:
            sc_ = PL.apply_tri_powers(sc_, *PL.estimate_tri_power(sc_, tex_))
        return sc_, tex_

    tscene, ttex = textured_scene(textured_box(TEX_DIR), dev)
    gk_raw = MK.gbuffer(tscene, o, d)
    gk_t = apply_textures_to_gbuffer(gk_raw, ttex, spread)
    o2t, d2t, _, _ = secondary_rays(gk_t, seed)
    st0t = MK.initial_state(o2t, d2t)
    lsets_t = MK.build_light_sets(tscene, seed)
    tri_bytes_t = tscene.num_tris * (12 + A.WIDTH) * F32
    recs = bounce_records(tscene, "textured36", "textures", gi_cfg, st0t, lsets_t, seed, rt,
                          spread, tscene.num_tris, tri_bytes_t, lsets_t.numel() * F32,
                          textures=ttex)
    rec = record["textured36"] = {k: recs[k] for k in ("bounce_trace", "bounce_shade")}
    st4t, sf4t = MK.bounce_trace(tscene, st0t, 0, gi_cfg, True, spread)
    texels = sum(m.numel() for m in ttex["base"][TEX_CHECKER]) * F32
    fetch = dict(ms=cuda_ms(lambda: MK.fetch_base(ttex, st4t, sf4t), reps=20))
    fetch["launches"], fetch["top_kernels"] = device_launches(
        lambda: MK.fetch_base(ttex, st4t, sf4t))
    # the least a fetch moves: 8 rows of each ray in (uv, texture, density,
    # cone, base colour) and 3 rows out, and the checker chain read once (its
    # taps repeat across rays and stay in L2)
    fetch["bound_ms"], fetch["bound_by"] = bound(0, n * (8 + 3) * F32 + texels)
    gtex = dict(ms=cuda_ms(lambda: apply_textures_to_gbuffer(gk_raw, ttex, spread), reps=10))
    gtex["launches"], gtex["top_kernels"] = device_launches(
        lambda: apply_textures_to_gbuffer(gk_raw, ttex, spread))
    rec["bounce_shade"]["fetch"] = fetch
    rec["bounce_shade"]["gbuffer_textures"] = gtex
    print(f"textured36 ({n} GI bounce-0 rays of the textured G-buffer, fetch between B4 and B5): "
          + "; ".join(f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
                      f"{r['bound_ms']:.4f} by {r['bound_by']}), max abs err "
                      f"{r['max_abs_err']:.3g}" for k, r in rec.items())
          + f"; the fetch {fetch['ms']:.4f} ms in {fetch['launches']} launches (bound "
          f"{fetch['bound_ms']:.4f} by bytes; its checker chain {texels} bytes; longest kernels "
          f"{fetch['top_kernels']}); the G-buffer's four maps {gtex['ms']:.4f} ms in "
          f"{gtex['launches']} launches (longest {gtex['top_kernels']})", flush=True)
    del gk_raw, gk_t, o2t, d2t, st0t, st4t, sf4t

    # B7 on the cutout box's camera rays in each round of the alpha-cutout
    # re-trace, against its plain version on the same rays (the plain
    # version's hits carry the re-trace on), then the re-trace through the
    # kernel alone equal to it
    csc, ctex = textured_scene(cutout_box(TEX_DIR), dev)
    uncut = dataclasses.replace(csc, has_cutout=False, alpha_tex=None)
    tri_bytes_c = csc.num_tris * (12 + A.WIDTH) * F32
    rounds = []

    def b7_round(_sc, o_, d_, t_min, t_max):
        kern = lambda: XI.closest_hit(uncut, o_, d_, t_min, t_max)
        plain = lambda: XI.closest_hit_plain_shaded(uncut.woop, uncut.tri_attrs, o_, d_, t_min,
                                                    t_max)
        k_, p_ = kern(), plain()
        torch.cuda.synchronize()
        for field, a_, b_ in zip(k_._fields, k_, p_):
            if not torch.equal(a_, b_):
                raise AssertionError(f"closest in cutout round {len(rounds)}: {field} differs "
                                     "from the plain version")
        m = o_.shape[0]  # a round traces the rays still piercing
        b_ms, b_by = bound(PAIR_OPS * m * csc.num_tris, m * (6 + 4 + A.WIDTH) * F32 + tri_bytes_c)
        rounds.append(dict(max_abs_err=0.0, ms=cuda_ms(kern, reps=10),
                           plain_ms=cuda_ms(plain, reps=2, warmup=1), bound_ms=b_ms,
                           bound_by=b_by, rays=m, hit=(p_.tri >= 0).float().mean().item()))
        return p_

    closest_raw, XI._closest_raw = XI._closest_raw, b7_round  # each round through b7_round
    try:
        sh_r = XI._closest_cutout(csc, o.contiguous(), d.contiguous(), 1e-4, MK.INF)
    finally:
        XI._closest_raw = closest_raw
    sh_k = XI.intersect_closest_shaded(csc, o, d)
    torch.cuda.synchronize()
    for field, a_, b_ in zip(sh_k._fields, sh_k, sh_r):
        if not torch.equal(a_, b_):
            raise AssertionError(f"the cutout re-trace: {field} differs from the plain rounds'")
    record["cutout36"] = {"closest": dict(rounds[0], rounds=rounds)}
    print(f"cutout36 ({n} camera rays, {len(rounds)} of at most {XI.CUTOUT_ROUNDS} rounds of the "
          f"re-trace): closest " + "; ".join(
              f"round {i} on {r['rays']} rays {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}, {r['hit']:.4f} hit)"
              for i, r in enumerate(rounds))
          + "; every round equal to the plain version, the re-trace too", flush=True)
    del uncut, sh_r, sh_k

    # -- phase 3 on the clustered box: B8 and B9 against their plain versions
    big_cpu = subdivide_scene(cornell_box(), 100_000)
    t_up = time.perf_counter()
    big = upload_scene(big_cpu, device=dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t_up
    if big.cluster_aabb is None:
        raise AssertionError(f"{big_cpu.num_tris} triangles: the large box did not cluster")
    res_c = 256
    n_c = res_c * res_c
    oc, dc = cam.generate_rays(res_c, res_c, device=dev)
    tp_c = big.woop.shape[1] // 3
    n_cl = big.cluster_aabb.shape[0]
    n_leaves = int((big.walk_nodes[:, 12:14] < 0).sum().item())
    print(f"cornell139k: {big_cpu.num_tris} triangles in {n_cl} clusters of "
          f"{big.cluster_size} slots; B8's tree {big.walk_nodes.shape[0]} nodes, {n_leaves} "
          f"leaves of at most {LEAF_SIZE} triangles, stack {big.walk_stack}; upload "
          f"{t_up:.3f} s", flush=True)
    # the floor of any walk: a query reads the rays and writes its outputs;
    # B8 reads the Woop rows of the distinct slots it returns, and a ray that
    # hits (B8) or is blocked (B9) needs one Woop test. What else a walk
    # reads (nodes, rows of triangles it misses, for B9 which blocker)
    # depends on its tree, so it is not counted
    n_real = int((big.woop.reshape(4, 3, -1) != 0).any(0).any(0).sum().item())
    if n_real != big_cpu.num_tris or big.leaf_slot.shape[0] != n_real:
        raise AssertionError(f"{n_real} non-zero Woop slots and {big.leaf_slot.shape[0]} "
                             f"leaf rows for {big_cpu.num_tris} triangles")
    rec_c = record["cornell139k"] = {}

    def check_b8(label, o_, d_, sc_=None):
        sc_ = big if sc_ is None else sc_
        t_k, tri_k = ST.stream_closest(sc_, o_, d_)
        t_p, tri_p = ST.stream_closest_plain(sc_, o_, d_)
        torch.cuda.synchronize()
        if not (torch.equal(tri_k, tri_p) and torch.equal(t_k, t_p)):
            raise AssertionError(
                f"stream_closest {label}: {(tri_k != tri_p).sum().item()} slots and "
                f"{(t_k != t_p).sum().item()} t differ from the plain version")
        hit = tri_p >= 0
        err = max((t_k[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0,
                  (tri_k - tri_p).abs().max().item())
        ms = cuda_ms(lambda: ST.stream_closest(sc_, o_, d_), reps=10)
        plain = cuda_ms(lambda: ST.stream_closest_plain(sc_, o_, d_), reps=1, warmup=0)
        b_ms, b_by = bound(PAIR_OPS * int(hit.sum().item()),
                           o_.shape[0] * (6 + 2) * F32 + tri_p[hit].unique().numel() * 12 * F32)
        print(f"cornell139k ({tp_c} slots in {n_cl} clusters, {o_.shape[0]} {label}, "
              f"{hit.float().mean().item():.4f} hit): stream_closest {ms:.4f} ms (plain "
              f"{plain:.3f}, bound {b_ms:.4f} by {b_by}), t and slot equal", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by), t_p

    def raw_rate(o_, d_):
        """bench.py's raw rate: B8 and its Woop epilogue, Mrays/s."""
        return o_.shape[0] / cuda_ms(lambda: ST.closest_hit_stream(big, o_, d_), reps=5) / 1e3

    rec_c["stream_closest"], t_cam = check_b8("camera rays", oc, dc)
    g = torch.Generator(device=dev).manual_seed(11)
    dg = torch.randn(oc.shape, device=dev, generator=g)
    dg = dg / dg.norm(dim=1, keepdim=True).clamp_min(1e-9)
    og = oc + (t_cam - 1e-3)[:, None] * dc  # a missed primary ray leaves from ~3e38
    check_b8("GI-like rays", og, dg)
    cam_hit = t_cam < MK.INF
    check_b8("GI-like rays of primary hits (the rest parked)", *park(cam_hit, og, dg))
    mrays = {"primary": raw_rate(oc, dc), "gi": raw_rate(og, dg)}
    print(f"cornell139k raw stream rates (bench.py): primary {mrays['primary']:.3f} Mrays/s, "
          f"GI-like {mrays['gi']:.3f} Mrays/s", flush=True)
    gk_c = MK.gbuffer(big, oc, dc)
    o2c, d2c, _, live_c = secondary_rays(gk_c, seed)
    check_b8("GI bounce-0 rays (dead parked)", *park(live_c, o2c, d2c))
    rk_c = RD.initial_candidates(gk_c, MK.build_light_sets(big, seed), seed, rt=pick_rt(n_c))
    so_c = (gk_c[MK.G.POS : MK.G.POS + 3] + 1e-3 * gk_c[MK.G.NG : MK.G.NG + 3]).T.contiguous()
    seg_c = (rk_c[0:3] - gk_c[MK.G.POS : MK.G.POS + 3]).T.contiguous()
    occ_k = ST.occlusion_stream(big, so_c, seg_c, 1e-3, 1.0 - 1e-3)
    occ_p = ST.occlusion_stream_plain(big, so_c, seg_c, 1e-3, 1.0 - 1e-3)
    torch.cuda.synchronize()
    if not torch.equal(occ_k, occ_p):
        raise AssertionError(f"occlusion_stream: {(occ_k != occ_p).sum().item()} segments "
                             "differ from the plain version")
    n_occ_c = int(occ_p.sum().item())
    b_ms, b_by = bound(PAIR_OPS * n_occ_c, n_c * (6 + 1) * F32)
    rec_c["occlusion_stream"] = dict(
        max_abs_err=float((occ_k.int() - occ_p.int()).abs().max().item()),
        ms=cuda_ms(lambda: ST.occlusion_stream(big, so_c, seg_c, 1e-3, 1.0 - 1e-3), reps=10),
        plain_ms=cuda_ms(lambda: ST.occlusion_stream_plain(big, so_c, seg_c, 1e-3, 1.0 - 1e-3),
                         reps=1, warmup=0),
        bound_ms=b_ms, bound_by=b_by, blocked=n_occ_c / n_c)
    r9 = rec_c["occlusion_stream"]
    print(f"cornell139k ({n_c} DI shadow segments, {n_occ_c / n_c:.4f} blocked): "
          f"occlusion_stream {r9['ms']:.4f} ms (plain {r9['plain_ms']:.3f}, bound "
          f"{r9['bound_ms']:.4f} by {r9['bound_by']}), equal on every segment", flush=True)
    for seg_name, (so_s, sd_s) in direction_segments(gk_c, dev).items():
        r9[seg_name] = check_any_hit(
            f"occlusion_stream cornell139k {seg_name}",
            lambda a, b: ST.occlusion_stream(big, a, b, 1e-3, 1e8),
            lambda a, b: ST.occlusion_stream_plain(big, a, b, 1e-3, 1e8), so_s, sd_s, 0, 0)
    del og, dg, gk_c, o2c, d2c, rk_c, so_c, seg_c, occ_k, occ_p
    torch.cuda.empty_cache()

    # -- phase 3 on the animated box: the box written as a glTF file (walls,
    # light and short block one node, the tall block a second node with
    # LINEAR translation and rotation channels) into a temporary directory,
    # loaded (load_gltf -> load_scene -> AnimationRig), split like the large
    # box and uploaded clustered, refit to t = 0.5: B8 and B9 walking the
    # refit tree against their plain versions, and the refit's time (host
    # clock after a synchronise, median of 10) on the box and split
    anim_dir = tempfile.mkdtemp(prefix="zetaray_anim_")
    try:
        doc = load_gltf(animated_box(os.path.join(anim_dir, "box.gltf")))
    finally:
        shutil.rmtree(anim_dir)
    anim_cpu, rig = load_scene(doc), AnimationRig(doc)
    anim_box = upload_scene(anim_cpu, device=dev)
    anim_big_cpu = subdivide_scene(anim_cpu, 100_000)
    t_up = time.perf_counter()
    anim_big = upload_scene(anim_big_cpu, device=dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t_up
    if anim_big.cluster_aabb is None or anim_big_cpu.num_tris != big_cpu.num_tris:
        raise AssertionError("the split animated box is not the clustered large box")

    def refit_ms(sc_, t_anim, reps=10):
        times_ = []
        for _ in range(reps + 1):
            t_ = time.perf_counter()
            refit_scene(sc_, *rig.deltas(t_anim))
            torch.cuda.synchronize()
            times_.append((time.perf_counter() - t_) * 1e3)
        return statistics.median(times_[1:])

    refit_times = {"box36": refit_ms(anim_box, 0.5), "box139k": refit_ms(anim_big, 0.5)}
    posed = refit_scene(anim_big, *rig.deltas(0.5))
    print(f"animated box: {anim_cpu.num_tris} triangles, {len(doc.instances)} instances, clip "
          f"{rig.duration} s; split to {anim_big_cpu.num_tris} and uploaded in {t_up:.3f} s; "
          f"refit to t = 0.5 {refit_times['box36']:.3f} ms (box), {refit_times['box139k']:.3f} "
          f"ms ({anim_big_cpu.num_tris} triangles, walk tree of {posed.walk_nodes.shape[0]} "
          f"nodes included)", flush=True)
    rec_r = record["refit139k"] = {}
    rec_r["stream_closest"], t_pc = check_b8("camera rays, refit to t = 0.5", oc, dc, posed)
    og = oc + (t_pc - 1e-3)[:, None] * dc
    dg = torch.randn(oc.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(11))
    dg = dg / dg.norm(dim=1, keepdim=True).clamp_min(1e-9)
    check_b8("GI-like rays, refit to t = 0.5", og, dg, posed)
    _, tri_pc = ST.stream_closest(posed, oc, dc)  # equal to the plain version (check_b8)
    on_block = int((posed.inst_id[tri_pc[tri_pc >= 0].long()] == 1).sum().item())
    _, tri_stale = ST.stream_closest(dataclasses.replace(posed, walk_nodes=anim_big.walk_nodes),
                                     oc, dc)
    stale = int((tri_stale != tri_pc).sum().item())
    if on_block < 1000 or stale == 0:
        raise AssertionError(f"refit: {on_block} camera rays find the moved block, {stale} "
                             "differ when B8 walks the upload's boxes")
    gk_r = MK.gbuffer(posed, oc, dc)
    rk_r = RD.initial_candidates(gk_r, MK.build_light_sets(posed, seed), seed, rt=pick_rt(n_c))
    so_r = (gk_r[MK.G.POS : MK.G.POS + 3] + 1e-3 * gk_r[MK.G.NG : MK.G.NG + 3]).T.contiguous()
    seg_r = (rk_r[0:3] - gk_r[MK.G.POS : MK.G.POS + 3]).T.contiguous()
    occ_k = ST.occlusion_stream(posed, so_r, seg_r, 1e-3, 1.0 - 1e-3)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    occ_p = ST.occlusion_stream_plain(posed, so_r, seg_r, 1e-3, 1.0 - 1e-3)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])  # one run: the plain walk takes seconds
    if not torch.equal(occ_k, occ_p):
        raise AssertionError(f"occlusion_stream refit139k: {(occ_k != occ_p).sum().item()} "
                             "segments differ from the plain version")
    n_occ_r = int(occ_p.sum().item())
    b_ms, b_by = bound(PAIR_OPS * n_occ_r, n_c * (6 + 1) * F32)
    rec_r["occlusion_stream"] = dict(
        max_abs_err=0.0, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, blocked=n_occ_r / n_c,
        ms=cuda_ms(lambda: ST.occlusion_stream(posed, so_r, seg_r, 1e-3, 1.0 - 1e-3), reps=10))
    print(f"refit139k ({n_c} DI shadow segments, {n_occ_r / n_c:.4f} blocked): occlusion_stream "
          f"{rec_r['occlusion_stream']['ms']:.4f} ms (plain {plain_ms:.3f}, bound {b_ms:.4f} by "
          f"{b_by}), equal on every segment", flush=True)
    print(f"refit139k: {on_block} camera rays hit the moved block; B8 walking the upload's "
          f"boxes over the moved rows differs on {stale} of them", flush=True)
    del og, dg, gk_r, rk_r, so_r, seg_r, posed, tri_stale, occ_k, occ_p
    torch.cuda.empty_cache()

    # -- phase 4: each path through the frame entry point, counts read per path
    scene = upload_scene(cornell_box(), device=dev)
    kernels_of = {
        "gbuffer": "zr_gbuffer", "ris": "zr_ris", "occlusion": "zr_occlusion",
        "bounce_trace": "zr_bounce_trace", "bounce_shade": "zr_bounce_shade",
        "bounce": "zr_bounce", "closest": "zr_closest", "stream_closest": "zr_stream_closest",
        "occlusion_stream": "zr_stream_occlusion", "atrous": "zr_atrous",
        "wavefront": "zr_wavefront_vertex",
    }
    di_kernels = ("gbuffer", "ris", "occlusion")
    dense_kernels = ("gbuffer", "occlusion", "bounce_trace", "bounce_shade", "bounce", "closest")

    def chain(cfg_, cam_, expect, frames=4, restir=True, sc=None, absent=(), textures=None,
              animate=False):
        """Render chained frames on ``sc`` (default: the box), with the
        texture bundle ``textures``, the launch counts set to 0 just before
        and read just after; the kernels of ``expect`` must have launched,
        those of ``absent`` not, a-trous exactly when the frames denoise,
        and the wavefront's vertex kernel never on a dense scene.
        ``animate``: ``sc`` is the animated box's
        upload, refit each frame to the rig's time ANIM_DT * k and rendered
        with the motion from the frame before (the refit inside the frame's
        time). Returns (last output, each frame's ms, counts)."""
        sc = scene if sc is None else sc
        if sc.cluster_aabb is None:
            absent = (*absent, "wavefront")
        if restir and cfg_.denoise:
            expect = (*expect, "atrous")
        else:
            absent = (*absent, "atrous")
        for entry in kernels_of.values():
            native.launches[entry] = 0
        state, times, sc_k, motion = None, [], sc, None
        w_prev = rig.instance_worlds(0.0) if animate else None
        for k in range(frames):
            t = time.perf_counter()
            if animate:
                sc_k = refit_scene(sc, *rig.deltas(ANIM_DT * k))
                w = rig.instance_worlds(ANIM_DT * k)
                motion, w_prev = transform_deltas(w, w_prev)[0], w
            if restir:
                out_, state = render_frame_restir(sc_k, cam_.with_jitter(k), seed + k, cfg_,
                                                  state, textures=textures, motion=motion)
            else:
                out_ = render_frame(sc_k, cam_.with_jitter(k), seed + k, cfg_)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        counts = {name: native.launches[e] for name, e in kernels_of.items()}
        for name in expect:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by its path: {counts}")
        for name in absent:
            if counts[name] != 0:
                raise AssertionError(f"kernel {name} ran on a path that must not launch it: "
                                     f"{counts}")
        h_ = out_["hdr"]
        if tuple(h_.shape) != (cfg_.height, cfg_.width, 3) or not torch.isfinite(h_).all():
            raise AssertionError(f"{cfg_.width}x{cfg_.height}: bad or non-finite HDR")
        if out_["ldr"].float().mean().item() < 10.0:
            raise AssertionError(f"{cfg_.width}x{cfg_.height}: the image is black")
        return out_, times, counts

    def show(tag, times, counts):
        print(f"{tag}: frames {[round(x, 3) for x in times]} ms (median of frames 2-4 "
              f"{statistics.median(times[1:]):.3f} ms); launches {counts}", flush=True)

    flagship = dict(mode="restir_gi", pt=PTConfig(max_bounces=3), denoise=True, taa=True)
    pt_frame = dict(mode="restir_pt", pt=PTConfig(max_bounces=3), denoise=True, taa=True)
    out_di, times_di, counts_di = chain(
        RenderConfig(width=res, height=res, mode="restir_gi", indirect=False, denoise=True,
                     taa=True), cam, di_kernels)
    show("DI-only slice 512^2", times_di, counts_di)
    gi_kernels = ("gbuffer", "ris", "occlusion", "bounce_trace", "bounce_shade", "bounce")
    out, times, launches = chain(RenderConfig(width=res, height=res, **flagship), cam,
                                 gi_kernels)
    show("main path, flagship 512^2", times, launches)
    cfg_hd = RenderConfig(width=1920, height=1080, mode="restir_gi", pt=PTConfig(max_bounces=2),
                          denoise=True, taa=True)
    out_hd, times_hd, counts_hd = chain(cfg_hd, cam_hd, gi_kernels)
    show("flagship 1920x1080, max_bounces=2", times_hd, counts_hd)
    out_pt, times_pt, launches_pt = chain(
        RenderConfig(width=res, height=res, **pt_frame), cam,
        ("gbuffer", "ris", "occlusion", "bounce", "closest"))
    show("ReSTIR PT 512^2, max_bounces=3", times_pt, launches_pt)
    out_ppt, times_ppt, counts_ppt = chain(
        RenderConfig(width=res, height=res, mode="pt", pt=PTConfig(max_bounces=4)), cam,
        ("bounce",), restir=False)
    show("plain PT 512^2, max_bounces=4", times_ppt, counts_ppt)
    means = {k: v["hdr"].mean().item() for k, v in
             (("flagship", out), ("pt", out_pt), ("di", out_di), ("plain_pt", out_ppt))}
    print(f"mean HDR at 512^2: {means}", flush=True)
    for k in ("flagship", "pt"):
        if not means[k] > 1.05 * means["di"]:
            raise AssertionError(f"the {k} frame adds no light to the DI-only frame")

    # the JAX app's default frame (restir_di, max_bounces=4, TAA, no a-trous)
    # with its sun and sky and without them, the flagship GI frame with the
    # sky and the path options, and ReSTIR PT with the sky
    app = dict(width=res, height=res, mode="restir_di", taa=True)
    app_kernels = ("gbuffer", "ris", "occlusion", "bounce")
    out_app, times_app, counts_app = chain(
        RenderConfig(**app, pt=PTConfig(max_bounces=4, sky=sky)), cam, app_kernels)
    show("JAX app default frame 512^2 (restir_di, max_bounces=4) with sun and sky", times_app,
         counts_app)
    out_app0, times_app0, counts_app0 = chain(RenderConfig(**app, pt=PTConfig(max_bounces=4)),
                                              cam, app_kernels)
    show("JAX app default frame 512^2 without sky", times_app0, counts_app0)
    gi_sky = dict(mode="restir_gi", denoise=True, taa=True, pt=PTConfig(
        max_bounces=3, sky=sky, path_regularization=True, firefly_clamp=FIREFLY_CLAMP,
        stochastic_multi_bounce=True))
    out_gs, times_gs, counts_gs = chain(RenderConfig(width=res, height=res, **gi_sky), cam,
                                        gi_kernels)
    show("flagship 512^2 with sky, regularization, firefly clamp, stochastic multi-bounce",
         times_gs, counts_gs)
    pt_sky = {**pt_frame, "pt": PTConfig(max_bounces=3, sky=sky)}
    out_ps, times_ps, counts_ps = chain(RenderConfig(width=res, height=res, **pt_sky), cam,
                                        ("gbuffer", "ris", "occlusion", "bounce", "closest"))
    show("ReSTIR PT 512^2 with sky", times_ps, counts_ps)
    # the last frame's primary misses that look above the horizon show the
    # sky in every sky frame, and none of the frame without it; the sun
    # lights hits the frame without sky leaves darker
    o_l, d_l = cam.with_jitter(3).generate_rays(res, res, device=dev)
    valid_l = (MK.gbuffer(scene, o_l, d_l)[MK.G.VALID] > 0.5).reshape(res, res)
    miss_up = ~valid_l & (d_l[:, 1] > 0.0).reshape(res, res)
    lum = {k: v["hdr"].sum(-1) for k, v in
           (("app", out_app), ("app_no_sky", out_app0), ("gi", out_gs), ("pt", out_ps))}
    sky_shares = {k: (lum[k][miss_up] > 0).float().mean().item() for k in ("app", "gi", "pt")}
    dark_share = (lum["app_no_sky"][miss_up] == 0).float().mean().item()
    differs = (out_app["hdr"] != out_app0["hdr"]).any(-1).float().mean().item()
    sunlit = ((lum["app"] > 1.5 * lum["app_no_sky"] + 1e-3) & valid_l).float().mean().item()
    print(f"sky at 512^2: {int(miss_up.sum().item())} primary misses above the horizon, lit in "
          f"{sky_shares} of them, black without sky in {dark_share:.4f}; the default frame "
          f"with sky differs on {differs:.4f} of pixels and is over 1.5x brighter on "
          f"{sunlit:.4f} of them (hits); mean HDR app {out_app['hdr'].mean().item():.6f}, "
          f"without sky {out_app0['hdr'].mean().item():.6f}, GI sky "
          f"{out_gs['hdr'].mean().item():.6f}, PT sky {out_ps['hdr'].mean().item():.6f}",
          flush=True)
    if (min(sky_shares.values()) < 0.99 or dark_share < 0.95 or differs < 0.5 or sunlit < 0.05
            or miss_up.sum().item() < 1000):
        raise AssertionError("the sky and the sun do not show as they should")
    os.makedirs(IMAGE_DIR, exist_ok=True)
    for name, o_ in (("", out), ("_di", out_di), ("_pt", out_pt), ("_plain_pt", out_ppt),
                     ("_restir_di_sky", out_app), ("_restir_di", out_app0), ("_gi_sky", out_gs),
                     ("_pt_sky", out_ps)):
        write_png(os.path.join(IMAGE_DIR, f"zetaray_torch_512{name}.png"), o_["ldr"].cpu().numpy())

    # bench.py's upscale_256_to_512 (bench.py:178-183: render 256^2, TAAU to
    # 512^2, RCAS) on the box and on its 8192-triangle subdivision, and its
    # native 512^2 twin (render_scale=1) on the box
    upscale = RenderConfig(width=res, height=res, mode="restir_gi", pt=PTConfig(max_bounces=2),
                           render_scale=0.5, taa=True,
                           upscale_cfg=UpscaleConfig(rcas_sharpness=0.8))
    scene_8k = upload_scene(cornell_box(subdivide_to=8192), device=dev)
    up_paths = {}
    for tag, cfg_, sc in (("upscale_256_to_512", upscale, scene),
                          ("upscale_256_to_512 at 8192 triangles", upscale, scene_8k),
                          ("native 512^2 twin (render_scale=1)",
                           dataclasses.replace(upscale, render_scale=1.0), scene)):
        up_paths[tag] = chain(cfg_, cam, gi_kernels, sc=sc)
        show(tag, *up_paths[tag][1:])
    del scene_8k
    out_up = up_paths["upscale_256_to_512"][0]
    # the WoPS flagship (B5 and B6 on their WoPS branch) and the JAX app's
    # default frame with WoPS (B6 alone); then, for the launches of phase
    # 3's other WoPS instances, the flagship with the sky, sun NEE and the
    # path options (B5 and B6 with sun NEE) and the default frame with the
    # sky but no sun NEE (B6 with the sky alone). A wrapper counts its
    # launches whatever the instance, so each record takes the counts of
    # the one path that runs its instance
    no_b45 = ("bounce_trace", "bounce_shade")
    wops_paths = {}
    for tag, opt, cfg_, kern, absent in (
            ("flagship 512^2 with WoPS NEE", "wops", RenderConfig(
                width=res, height=res, **{**flagship, "pt": PTConfig(max_bounces=3,
                                                                     nee_mode="wops")}),
             gi_kernels, ()),
            ("JAX app default frame 512^2 with WoPS NEE", None, RenderConfig(
                **app, pt=PTConfig(max_bounces=4, nee_mode="wops")), app_kernels, no_b45),
            ("flagship 512^2 with sky, path options and WoPS NEE", "wops_sky_sun", RenderConfig(
                width=res, height=res, **{**gi_sky, "pt": dataclasses.replace(
                    gi_sky["pt"], nee_mode="wops")}), gi_kernels, ()),
            ("JAX app default frame 512^2 with sky, no sun NEE, WoPS NEE", "wops_sky_no_sun_nee",
             RenderConfig(**app, pt=PTConfig(max_bounces=4, sky=sky, sun_nee=False,
                                             nee_mode="wops")), app_kernels, no_b45)):
        wops_paths[tag] = chain(cfg_, cam, kern, absent=absent)
        show(tag, *wops_paths[tag][1:])
        for name in ("bounce_shade", "bounce"):
            if opt in record["cornell36"][name]:
                record["cornell36"][name][opt]["launches"] = wops_paths[tag][2][name]
    # the three frames on the materials box (a glass block, a coated block):
    # the flagship, ReSTIR PT and the JAX app's default frame, each also
    # with full_target=True and packed_reuse=False in every ReSTIR config;
    # then, for the launches of phase 3's other material instances, the
    # flagship with the sky, sun NEE and the path options, the default frame
    # with the sky but no sun NEE, and those with WoPS NEE. A wrapper counts
    # its launches whatever the instance, so each record takes the counts of
    # the one path that runs its instance
    mscene = upload_scene(materials_box(), device=dev)
    reuse_opts = dict(restir=ReSTIRConfig(full_target=True, packed_reuse=False),
                      restir_gi=ReSTIRGIConfig(full_target=True, packed_reuse=False),
                      restir_pt=ReSTIRPTConfig(full_target=True, packed_reuse=False))
    pt_kernels = ("gbuffer", "ris", "occlusion", "bounce", "closest")
    wops_pt = lambda base: dataclasses.replace(base, nee_mode="wops")
    mat_paths = {}
    for tag, opt, cfg_, kern, absent in (
            ("flagship", "", RenderConfig(width=res, height=res, **flagship), gi_kernels, ()),
            ("ReSTIR PT", None, RenderConfig(width=res, height=res, **pt_frame), pt_kernels,
             ("bounce_trace", "bounce_shade")),
            ("default restir_di", None, RenderConfig(**app, pt=PTConfig(max_bounces=4)),
             app_kernels, no_b45),
            ("flagship, full_target + packed_reuse=False", None,
             RenderConfig(width=res, height=res, **flagship, **reuse_opts), gi_kernels, ()),
            ("ReSTIR PT, full_target + packed_reuse=False", None,
             RenderConfig(width=res, height=res, **pt_frame, **reuse_opts), pt_kernels,
             ("bounce_trace", "bounce_shade")),
            ("default restir_di, full_target + packed_reuse=False", None,
             RenderConfig(**app, pt=PTConfig(max_bounces=4), **reuse_opts), app_kernels, no_b45),
            ("flagship with sky and path options", "sky_sun",
             RenderConfig(width=res, height=res, **gi_sky), gi_kernels, ()),
            ("default restir_di with sky, no sun NEE", "sky_no_sun_nee",
             RenderConfig(**app, pt=PTConfig(max_bounces=4, sky=sky, sun_nee=False)),
             app_kernels, no_b45),
            ("flagship with WoPS NEE", "wops", RenderConfig(
                width=res, height=res, **{**flagship, "pt": PTConfig(max_bounces=3,
                                                                     nee_mode="wops")}),
             gi_kernels, ()),
            ("flagship with sky, path options and WoPS NEE", "wops_sky_sun", RenderConfig(
                width=res, height=res, **{**gi_sky, "pt": wops_pt(gi_sky["pt"])}), gi_kernels,
             ()),
            ("default restir_di with sky, no sun NEE, WoPS NEE", "wops_sky_no_sun_nee",
             RenderConfig(**app, pt=PTConfig(max_bounces=4, sky=sky, sun_nee=False,
                                             nee_mode="wops")), app_kernels, no_b45)):
        mat_paths[tag] = chain(cfg_, cam, kern, sc=mscene, absent=absent)
        show(f"materials box 512^2: {tag}", *mat_paths[tag][1:])
        for name in ("bounce_trace", "bounce_shade", "bounce"):
            if opt is not None and opt in record["materials36"].get(name, {}):
                record["materials36"][name][opt]["launches"] = mat_paths[tag][2][name]
    m_means = {tag: p_[0]["hdr"].mean().item() for tag, p_ in mat_paths.items()}
    opaque_gi = ((mat_paths["flagship"][0]["hdr"] - out["hdr"]).abs()
                 > 1e-3 * (1 + out["hdr"].abs())).any(-1).float().mean().item()
    print(f"materials box mean HDR at 512^2: {m_means}; the flagship differs from the opaque "
          f"box's on {opaque_gi:.4f} of pixels", flush=True)
    if opaque_gi < 0.05:
        raise AssertionError("the glass and the coat do not show in the flagship frame")
    for name, tag in (("_materials", "flagship"), ("_materials_pt", "ReSTIR PT"),
                      ("_materials_restir_di", "default restir_di")):
        write_png(os.path.join(IMAGE_DIR, f"zetaray_torch_512{name}.png"),
                  mat_paths[tag][0]["ldr"].cpu().numpy())
    del mscene

    # the textured box after the emissive power round trip: the flagship,
    # ReSTIR PT and the default frame, each beside its twin without the
    # bundle. Textured, the default frame's path trace splits every bounce
    # (B4, the fetch, B5: no B6) and ReSTIR PT's suffix trace (no bounce
    # past x3 at max_bounces=3) is B4 alone. Over the pixels of the checker
    # (the floor and the back wall) each is darker than its twin by the
    # checker's mean
    tex_kernels = {
        "flagship": (gi_kernels, ()),
        "ReSTIR PT": (("gbuffer", "ris", "occlusion", "bounce_trace", "closest"),
                      ("bounce_shade", "bounce")),
        "default restir_di": (("gbuffer", "ris", "occlusion", "bounce_trace", "bounce_shade"),
                              ("bounce",)),
    }
    tex_cfgs = {"flagship": RenderConfig(width=res, height=res, **flagship),
                "ReSTIR PT": RenderConfig(width=res, height=res, **pt_frame),
                "default restir_di": RenderConfig(**app, pt=PTConfig(max_bounces=4))}
    checker_px = (MK.gbuffer(tscene, o_l, d_l)[MK.G.MATID] == CHECKER).reshape(res, res)
    checker_mean = ttex["base"][TEX_CHECKER][0][..., :3].mean().item()
    tex_paths, darker = {}, {}
    for tag, cfg_ in tex_cfgs.items():
        tex_paths[tag] = chain(cfg_, cam, tex_kernels[tag][0], sc=tscene,
                               absent=tex_kernels[tag][1], textures=ttex)
        show(f"textured box 512^2: {tag}", *tex_paths[tag][1:])
        twin = chain(cfg_, cam, (), sc=tscene)
        show(f"textured box 512^2: {tag}, its twin without the bundle", *twin[1:])
        lum_t, lum_0 = (p_[0]["hdr"].sum(-1)[checker_px].mean().item() for p_ in (tex_paths[tag],
                                                                                   twin))
        darker[tag] = lum_t / lum_0
    print(f"textured box at 512^2: over the {int(checker_px.sum().item())} checker pixels each "
          f"textured frame over its twin {darker}; the checker's mean {checker_mean:.6f}",
          flush=True)
    for tag, ratio in darker.items():
        if abs(ratio / checker_mean - 1.0) > 0.1:
            raise AssertionError(f"the textured {tag} frame is not darker by the checker's mean")
    for name, tag in (("_textured", "flagship"), ("_textured_pt", "ReSTIR PT"),
                      ("_textured_restir_di", "default restir_di")):
        write_png(os.path.join(IMAGE_DIR, f"zetaray_torch_512{name}.png"),
                  tex_paths[tag][0]["ldr"].cpu().numpy())
    for name in ("bounce_trace", "bounce_shade"):
        record["textured36"][name]["launches"] = tex_paths["flagship"][2][name]

    # the cutout box: the flagship and the default frame, every ray query the
    # re-trace (B7 a round) and every path trace the wavefront: B2 and B7
    # alone of the kernels. Through the panel's transparent half the
    # G-buffer sees the back wall, on its opaque half the panel
    cut_kernels = ("gbuffer", "occlusion", "bounce_trace", "bounce_shade", "bounce")
    cut_paths = {}
    for tag, cfg_ in (("flagship", tex_cfgs["flagship"]),
                      ("default restir_di", tex_cfgs["default restir_di"])):
        cut_paths[tag] = chain(cfg_, cam, ("ris", "closest"), sc=csc, absent=cut_kernels,
                               textures=ctex)
        show(f"cutout box 512^2: {tag}", *cut_paths[tag][1:])
    record["cutout36"]["closest"]["launches"] = cut_paths["flagship"][2]["closest"]
    gk_c = MK.gbuffer(csc, o, d)
    t_pl = (PANEL_Z - o[:, 2]) / d[:, 2]
    px, py = o[:, 0] + t_pl * d[:, 0], o[:, 1] + t_pl * d[:, 1]
    x0, x1, y0, y1 = PANEL_RECT
    m_ = 0.05  # off the panel's edges and its seam at x = 0
    inside = (px > x0 + m_) & (px < x1 - m_) & (py > y0 + m_) & (py < y1 - m_)
    unblocked = inside & (gk_c[MK.G.DEPTH] > t_pl * (1.0 - 1e-4))  # no block in front
    clear, opaque = unblocked & (px < -m_), unblocked & (px > m_)
    wall_err = (gk_c[MK.G.POS + 2][clear] - ROOM[3]).abs().max().item()
    panel_err = ((gk_c[MK.G.DEPTH][opaque] - t_pl[opaque]).abs() / t_pl[opaque]).max().item()
    on_panel = (gk_c[MK.G.MATID][opaque] == PANEL).float().mean().item()
    print(f"cutout box G-buffer at 512^2: {int(clear.sum().item())} pixels through the panel's "
          f"transparent half see the back wall (z error {wall_err:.3g}), "
          f"{int(opaque.sum().item())} on its opaque half the panel (relative depth error "
          f"{panel_err:.3g}, {on_panel:.4f} of them on its material)", flush=True)
    if (clear.sum().item() < 1000 or opaque.sum().item() < 1000 or wall_err > 1e-3
            or panel_err > 1e-4 or on_panel < 1.0):
        raise AssertionError("the cutout panel does not show as it should")
    for name, tag in (("_cutout", "flagship"), ("_cutout_restir_di", "default restir_di")):
        write_png(os.path.join(IMAGE_DIR, f"zetaray_torch_512{name}.png"),
                  cut_paths[tag][0]["ldr"].cpu().numpy())
    del gk_c

    # the JAX app's default frame with the display options: the firefly
    # filter at 3 with the weighted-average exposure, each tonemapper but
    # the LUT's (AgX is the default frame above), and a thin lens
    lens = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0,
                          f_stop=2.8, focal_length_mm=50.0, focus_dist=3.5)
    display = {}
    for tag, extra, cam_ in (
            ("firefly 3 + weighted-average exposure",
             dict(firefly_factor=3.0, exposure_mode="weighted_avg"), cam),
            ("tonemapper none", dict(tonemapper="none"), cam),
            ("tonemapper neutral", dict(tonemapper="neutral"), cam),
            ("tonemapper agx_golden", dict(tonemapper="agx_golden"), cam),
            ("tonemapper agx_punchy", dict(tonemapper="agx_punchy"), cam),
            ("thin lens f/2.8 50 mm focus 3.5", {}, lens)):
        display[tag] = chain(RenderConfig(**app, pt=PTConfig(max_bounces=4), **extra), cam_,
                             app_kernels)
        show(f"JAX app default frame 512^2, {tag}", *display[tag][1:])
    base_hdr, base_ldr = out_app0["hdr"], out_app0["ldr"]
    shares = {}
    for tag, (o_, _, _) in display.items():
        same_hdr = ((o_["hdr"] - base_hdr).abs() <= 1e-3 * (1 + base_hdr.abs())).all(-1)
        shares[tag] = (same_hdr.float().mean().item(),
                       (o_["ldr"] != base_ldr).any(-1).float().mean().item())
    print(f"display options against the default frame (share of pixels with the same HDR, "
          f"share with another LDR): {shares}", flush=True)
    for tag, (same, other) in shares.items():
        # a tonemapper leaves the HDR as it is, the filter darkens a few
        # pixels, the lens blurs most; each changes the displayed image
        lo, hi = ((0.99, 1.0) if tag.startswith("tonemapper") else
                  (0.0, 0.999) if tag.startswith("firefly") else (0.0, 0.9))
        if other < 0.1 or not lo <= same <= hi:
            raise AssertionError(f"the display option {tag} does not act as it should")
    for name, o_ in (("_upscale_256_to_512", out_up),
                     ("_wops", wops_paths["flagship 512^2 with WoPS NEE"][0]),
                     ("_restir_di_lens", display["thin lens f/2.8 50 mm focus 3.5"][0])):
        write_png(os.path.join(IMAGE_DIR, f"zetaray_torch_512{name}.png"), o_["ldr"].cpu().numpy())

    # bench.py's features frame (ReSTIR DI with 2 light-voxel-grid
    # candidates and pairwise MIS, ReSTIR GI with max_bounces=2, stochastic
    # multi-bounce and path regularization, SkyDI with pairwise MIS,
    # froxel volumetrics, a-trous and TAA) at 256^2 as it stands, then at
    # 512^2 with the sun in through the box's opening, there also with the
    # GI grid NEE (restir_gi.lvg: B5 with min_nee_bounce=1), and plain PT
    # with volumetrics at 512^2
    def features(sun_dir):
        return dict(mode="restir_gi", pt=PTConfig(
            max_bounces=2, sky=SkyParams(sun_dir=sun_dir), stochastic_multi_bounce=True,
            path_regularization=True),
            restir=ReSTIRConfig(lvg_samples=2, spatial_mis="pairwise"),
            restir_gi=ReSTIRGIConfig(boiling_suppression=True), skydi=True,
            skydi_cfg=SkyDIConfig(spatial_mis="pairwise"), volumetrics=vol_cfg, denoise=True,
            taa=True)

    feat_paths = {}
    for tag, w_, cfg_kw in (
            ("features 256^2 (bench.py)", 256, features(BENCH_FEATURES_SUN)),
            ("features 512^2 with SUN", res, features(SUN)),
            ("features 512^2 with SUN and the GI grid NEE", res,
             {**features(SUN), "restir_gi": ReSTIRGIConfig(boiling_suppression=True, lvg=True)})):
        out_f, times_f, counts_f = chain(RenderConfig(width=w_, height=w_, **cfg_kw), cam,
                                         gi_kernels)
        show(tag, times_f, counts_f)
        feat_paths[tag] = (out_f, times_f, counts_f)
    out_fv, times_fv, counts_fv = chain(
        RenderConfig(width=res, height=res, mode="pt", pt=PTConfig(max_bounces=4, sky=sky),
                     volumetrics=vol_cfg), cam, ("gbuffer", "occlusion", "bounce"), restir=False)
    show("plain PT 512^2 with SUN and volumetrics", times_fv, counts_fv)
    out_f512 = feat_paths["features 512^2 with SUN"][0]
    # B3 a frame: the flagship's three (DI visibility, DI shade, GI shade),
    # plus SkyDI's shade and the froxels' sun segments, plus the GI grid NEE
    occ_per_frame = [c["occlusion"] / 4 for _, _, c in feat_paths.values()]
    if occ_per_frame != [launches["occlusion"] / 4 + 2] * 2 + [launches["occlusion"] / 4 + 3]:
        raise AssertionError(f"B3 launches a frame {occ_per_frame}: SkyDI, the froxels or the "
                             f"GI grid NEE did not run as they should")
    print(f"mean HDR: features 256^2 "
          f"{feat_paths['features 256^2 (bench.py)'][0]['hdr'].mean().item():.6f}, 512^2 with SUN "
          f"{out_f512['hdr'].mean().item():.6f}, with the GI grid NEE "
          f"{feat_paths['features 512^2 with SUN and the GI grid NEE'][0]['hdr'].mean().item():.6f}"
          f", plain PT with volumetrics {out_fv['hdr'].mean().item():.6f}", flush=True)
    for name, o_ in (("_features_sun", out_f512), ("_plain_pt_volumetrics", out_fv)):
        write_png(os.path.join(IMAGE_DIR, f"zetaray_torch_512{name}.png"), o_["ldr"].cpu().numpy())

    # bench.py's large-scene frame on the clustered box: every ray query
    # through B8 and B9, none through the dense kernels
    large = dict(mode="restir_gi", pt=PTConfig(max_bounces=2), denoise=True, taa=True)
    stream_kernels = ("stream_closest", "occlusion_stream")
    out_cl, times_cl, launches_cl = chain(
        RenderConfig(width=res_c, height=res_c, **large), cam,
        ("ris", "wavefront") + stream_kernels, sc=big, absent=dense_kernels)
    show("clustered GI 256^2 (139,266 triangles), max_bounces=2", times_cl, launches_cl)
    out_cl_di, times_cl_di, counts_cl_di = chain(
        RenderConfig(width=res_c, height=res_c, **{**large, "indirect": False}), cam,
        ("ris",) + stream_kernels, sc=big, absent=dense_kernels + ("wavefront",))
    show("clustered DI-only slice 256^2", times_cl_di, counts_cl_di)
    out_cl_pt, times_cl_pt, counts_cl_pt = chain(
        RenderConfig(width=res_c, height=res_c, mode="pt", pt=PTConfig(max_bounces=4)), cam,
        ("wavefront",) + stream_kernels, restir=False, sc=big, absent=dense_kernels)
    show("clustered plain PT 256^2, max_bounces=4", times_cl_pt, counts_cl_pt)
    means_cl = {k: v["hdr"].mean().item() for k, v in
                (("gi", out_cl), ("di", out_cl_di), ("plain_pt", out_cl_pt))}
    print(f"mean HDR at 256^2 on the clustered box: {means_cl}", flush=True)
    if not means_cl["gi"] > 1.05 * means_cl["di"]:
        raise AssertionError("the clustered GI frame adds no light to its DI-only frame")
    write_png(os.path.join(IMAGE_DIR, "zetaray_torch_256_clustered.png"),
              out_cl["ldr"].cpu().numpy())
    out_cl_app, times_cl_app, counts_cl_app = chain(
        RenderConfig(width=res_c, height=res_c, mode="restir_di", taa=True,
                     pt=PTConfig(max_bounces=4, sky=sky)), cam, ("ris",) + stream_kernels,
        sc=big, absent=dense_kernels + ("wavefront",))  # a sky: the plain wavefront
    show("clustered JAX app default frame 256^2 with sun and sky", times_cl_app, counts_cl_app)
    write_png(os.path.join(IMAGE_DIR, "zetaray_torch_256_clustered_restir_di_sky.png"),
              out_cl_app["ldr"].cpu().numpy())
    out_cl_rpt, times_cl_rpt, counts_cl_rpt = chain(
        RenderConfig(width=res_c, height=res_c, **pt_frame), cam,
        ("ris", "wavefront") + stream_kernels, sc=big, absent=dense_kernels)
    show("clustered ReSTIR PT 256^2, max_bounces=3", times_cl_rpt, counts_cl_rpt)
    if not out_cl_rpt["hdr"].mean().item() > 1.05 * means_cl["di"]:
        raise AssertionError("the clustered ReSTIR PT frame adds no light to its DI-only frame")
    write_png(os.path.join(IMAGE_DIR, "zetaray_torch_256_clustered_pt.png"),
              out_cl_rpt["ldr"].cpu().numpy())
    del big
    torch.cuda.empty_cache()

    # the animated box (its tall block sliding and turning, ANIM_DT of the
    # clip a frame, refit and motion each frame) beside its static twin (the
    # same upload at rest, no motion): the JAX app's default frame and the
    # flagship at 512^2, the default frame on the split box at 256^2 (B8 and
    # B9 on the refit walk tree, no dense kernel), and mode="pt" through
    # both frame functions (render_frame_restir takes restir_di's branches,
    # render_frame path-traces whatever the mode)
    anim_paths = {}
    for tag, cfg_, sc_, expect, absent, restir in (
            ("default 512^2", RenderConfig(**app, pt=PTConfig(max_bounces=4)), anim_box,
             app_kernels, (), True),
            ("flagship 512^2", RenderConfig(width=res, height=res, **flagship), anim_box,
             gi_kernels, (), True),
            ("clustered default 256^2", RenderConfig(width=res_c, height=res_c, mode="restir_di",
                                                     taa=True, pt=PTConfig(max_bounces=4)),
             anim_big, ("ris", "wavefront") + stream_kernels, dense_kernels, True),
            ("mode=pt, render_frame_restir 512^2", RenderConfig(
                width=res, height=res, mode="pt", taa=True, pt=PTConfig(max_bounces=4)),
             anim_box, app_kernels, (), True),
            ("mode=restir_gi, render_frame 512^2", RenderConfig(
                width=res, height=res, mode="restir_gi", pt=PTConfig(max_bounces=4)),
             anim_box, ("bounce",), ("ris", "occlusion"), False)):
        out_a, times_a, counts_a = chain(cfg_, cam, expect, sc=sc_, absent=absent, restir=restir,
                                         animate=True)
        show(f"animated {tag}", times_a, counts_a)
        out_s, times_s, counts_s = chain(cfg_, cam, expect, sc=sc_, absent=absent, restir=restir)
        show(f"static twin of the animated {tag}", times_s, counts_s)
        moved = (out_a["hdr"] != out_s["hdr"]).any(-1).float().mean().item()
        if moved < 0.01:
            raise AssertionError(f"animated {tag}: the image does not change with the motion")
        anim_paths[tag] = dict(ms=statistics.median(times_a[1:]),
                               static_ms=statistics.median(times_s[1:]), counts=counts_a,
                               moved=moved, out=out_a)
    print("animated frames (median of frames 2-4, refit included) against their static twins: "
          + "; ".join(f"{k} {v['ms']:.3f} / {v['static_ms']:.3f} ms, {v['moved']:.4f} of the "
                      f"pixels differ" for k, v in anim_paths.items()), flush=True)
    write_png(os.path.join(IMAGE_DIR, "zetaray_torch_512_animated.png"),
              anim_paths["flagship 512^2"]["out"]["ldr"].cpu().numpy())
    write_png(os.path.join(IMAGE_DIR, "zetaray_torch_256_clustered_animated_restir_di.png"),
              anim_paths["clustered default 256^2"]["out"]["ldr"].cpu().numpy())
    del anim_big
    torch.cuda.empty_cache()
    # the box with the masked panel split like the large box (clustered):
    # the default frame at 256^2, every query the re-trace through B8, so no
    # B9 and no dense kernel
    cut_big_cpu = subdivide_scene(cutout_box(TEX_DIR), 100_000)
    big_cut = upload_scene(cut_big_cpu, device=dev)
    if big_cut.cluster_aabb is None or not big_cut.has_cutout:
        raise AssertionError("the large cutout box is not a clustered cutout scene")
    out_cc, times_cc, counts_cc = chain(
        RenderConfig(width=res_c, height=res_c, mode="restir_di", taa=True,
                     pt=PTConfig(max_bounces=4)), cam, ("ris", "stream_closest"), sc=big_cut,
        absent=dense_kernels + ("occlusion_stream", "wavefront"), textures=ctex)
    show(f"clustered cutout default frame 256^2 ({cut_big_cpu.num_tris} triangles)", times_cc,
         counts_cc)
    write_png(os.path.join(IMAGE_DIR, "zetaray_torch_256_clustered_cutout_restir_di.png"),
              out_cc["ldr"].cpu().numpy())
    del big_cut
    torch.cuda.empty_cache()

    # two chained 64^2 frames, GI and PT on the box and GI on the box split to
    # 8706 triangles (clustered), then the JAX app's default frame with its
    # sun and sky and the GI frame with the sky and the path options on both,
    # through the kernels on the card and through the plain versions on the
    # CPU
    box_8706 = subdivide_scene(cornell_box(), 8193)
    app_64 = dict(mode="restir_di", taa=True, pt=PTConfig(max_bounces=4, sky=sky))
    feat_64 = features(SUN)
    gi_lvg_64 = {**feat_64, "restir_gi": ReSTIRGIConfig(boiling_suppression=True, lvg=True)}
    up_64 = dict(mode="restir_gi", pt=PTConfig(max_bounces=2), render_scale=0.5, taa=True,
                 upscale_cfg=UpscaleConfig(rcas_sharpness=0.8))
    wops_app_64 = {**app_64, "pt": PTConfig(max_bounces=4, nee_mode="wops")}
    wops_gi_64 = {**flagship, "pt": PTConfig(max_bounces=3, nee_mode="wops")}
    display_64 = {**app_64, "firefly_factor": 3.0, "exposure_mode": "weighted_avg",
                  "tonemapper": "agx_punchy"}
    # the display options act after the HDR: that frame is also held on
    # its LDR, each channel within one level of the CPU's
    cams_64 = {"restir_di lens + display options": lens}
    tex_box, cut_box = textured_box(TEX_DIR), cutout_box(TEX_DIR)
    app_64_plain = dict(mode="restir_di", taa=True, pt=PTConfig(max_bounces=4))
    for tag, base, cpu_scene in (("GI", flagship, cornell_box()), ("PT", pt_frame, cornell_box()),
                                 ("clustered GI", large, box_8706),
                                 ("restir_di sky", app_64, cornell_box()),
                                 ("GI sky", gi_sky, cornell_box()),
                                 ("clustered restir_di sky", app_64, box_8706),
                                 ("clustered GI sky", gi_sky, box_8706),
                                 ("features", feat_64, cornell_box()),
                                 ("clustered features", feat_64, box_8706),
                                 ("GI grid NEE", gi_lvg_64, cornell_box()),
                                 ("clustered ReSTIR PT", pt_frame, box_8706),
                                 ("upscale 32^2 to 64^2", up_64, cornell_box()),
                                 ("restir_di WoPS, wall lights", wops_app_64, multi_light_box()),
                                 ("GI WoPS, wall lights", wops_gi_64, multi_light_box()),
                                 ("restir_di lens + display options", display_64, cornell_box()),
                                 ("GI materials", flagship, materials_box()),
                                 ("GI materials, full_target + packed_reuse=False",
                                  {**flagship, **reuse_opts}, materials_box()),
                                 ("PT materials", pt_frame, materials_box()),
                                 ("restir_di materials", app_64, materials_box()),
                                 ("GI textured", flagship, tex_box),
                                 ("PT textured", pt_frame, tex_box),
                                 ("restir_di textured", app_64_plain, tex_box),
                                 ("GI cutout", flagship, cut_box),
                                 ("clustered GI cutout", large, subdivide_scene(cut_box, 8193))):
        small = RenderConfig(width=64, height=64, **base)
        cam_ = cams_64.get(tag, cam)
        outs = {}
        for dv in ("cuda", "cpu"):
            if cpu_scene.texture_paths:
                sc, tex = textured_scene(cpu_scene, dv)
            else:
                sc, tex = upload_scene(cpu_scene, device=dv), None
            if (sc.cluster_aabb is not None) != tag.startswith("clustered"):
                raise AssertionError(f"64^2 {tag}: the scene is not uploaded as expected")
            state = None
            for k in range(2):
                out_s, state = render_frame_restir(sc, cam_.with_jitter(k), seed + k, small, state,
                                                   textures=tex)
            outs[dv] = out_s
        gpu_hdr, cpu_hdr = outs["cuda"]["hdr"].cpu(), outs["cpu"]["hdr"]
        close = ((gpu_hdr - cpu_hdr).abs() <= 1e-3 * (1 + cpu_hdr.abs())).all(-1)
        shares = [close.float().mean().item()]
        text = f"{shares[0]:.4f} of pixels within 1e-3*(1+|x|)"
        if tag in cams_64:
            ldr_diff = (outs["cuda"]["ldr"].cpu().int() - outs["cpu"]["ldr"].int()).abs()
            shares.append((ldr_diff <= 1).all(-1).float().mean().item())
            text += f", {shares[1]:.4f} with an LDR within one level"
        print(f"64^2 {tag} frames, card vs CPU: {text}, means {gpu_hdr.mean().item():.6f} / "
              f"{cpu_hdr.mean().item():.6f}", flush=True)
        if min(shares) < 0.99:
            raise AssertionError(f"the card's {tag} frame disagrees with the CPU frame")
    # the animated flagship: two 64^2 frames, the box refit to ANIM_DT and
    # rendered with its motion, on the card and on the CPU
    outs = {}
    for dv in ("cuda", "cpu"):
        rest_ = upload_scene(anim_cpu, device=dv)
        state, w_prev = None, rig.instance_worlds(0.0)
        for k in range(2):
            w = rig.instance_worlds(ANIM_DT * (k + 1))
            out_s, state = render_frame_restir(
                refit_scene(rest_, *rig.deltas(ANIM_DT * (k + 1))), cam.with_jitter(k), seed + k,
                RenderConfig(width=64, height=64, **flagship), state,
                motion=transform_deltas(w, w_prev)[0])
            w_prev = w
        outs[dv] = out_s["hdr"].cpu()
    close = ((outs["cuda"] - outs["cpu"]).abs() <= 1e-3 * (1 + outs["cpu"].abs())).all(-1)
    share = close.float().mean().item()
    print(f"64^2 animated GI frames, card vs CPU: {share:.4f} of pixels within 1e-3*(1+|x|), "
          f"means {outs['cuda'].mean().item():.6f} / {outs['cpu'].mean().item():.6f}", flush=True)
    if share < 0.99:
        raise AssertionError("the card's animated GI frame disagrees with the CPU frame")

    # -- the sharded frames: SHARD_WORLD ranks render row bands of chained
    # 512^2 frames; the gathered bands are held to the whole frames
    from zetaray_tpu_torch.parallel import mesh as PM

    backend = PM.pick_backend(SHARD_WORLD)
    n_cards = torch.cuda.device_count()
    why = ("NCCL, one card a rank" if backend == "nccl" else
           "gloo: the ranks share the cards, each exchange staged through the host")
    print(f"sharded frames: backend {backend}, world {SHARD_WORLD}, {n_cards} card(s), rank r "
          f"on cuda:(r % {n_cards}); {why}", flush=True)
    shard_specs = [
        ("flagship 512^2", RenderConfig(width=res, height=res, **flagship), 3),
        ("ReSTIR PT 512^2", RenderConfig(width=res, height=res, **pt_frame), 3),
        ("default restir_di 512^2 with the sun",
         RenderConfig(**app, pt=PTConfig(max_bounces=4, sky=sky)), 3),
        ("upscale_256_to_512", upscale, 3),
    ]
    shard_expect = {"flagship 512^2": gi_kernels, "upscale_256_to_512": gi_kernels,
                    "ReSTIR PT 512^2": ("gbuffer", "ris", "occlusion", "closest", "bounce"),
                    "default restir_di 512^2 with the sun": app_kernels}
    twins = {}
    for tag, cfg_, frames in shard_specs:
        state, times = None, []
        for k in range(frames):
            t = time.perf_counter()
            out_t, state = render_frame_restir(scene, shard_camera(k), seed + k, cfg_, state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            twins[tag, k] = out_t["hdr"].cpu()
        twins[tag, "ms"] = times
    torch.cuda.empty_cache()
    t_sh = time.perf_counter()
    ranks = PM.run_ranks("chip_smoke:sharded_rank", SHARD_WORLD, (backend, shard_specs, seed),
                         timeout=900)
    print(f"sharded phase: {SHARD_WORLD} ranks started, rendered and joined in "
          f"{time.perf_counter() - t_sh:.1f} s", flush=True)
    shard_launches = {}
    for tag, cfg_, frames in shard_specs:
        for k in range(frames):
            got, want = torch.from_numpy(ranks[0][tag]["hdr"][k]), twins[tag, k]
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"sharded {tag}: bad gathered HDR")
            err = (got - want).abs()
            if not (err <= 1e-5 + 3e-3 * want.abs()).all():
                raise AssertionError(f"sharded {tag} frame {k}: max abs err "
                                     f"{err.max().item()} beyond rtol 3e-3, atol 1e-5")
        for name in shard_expect[tag] + (("atrous",) if cfg_.denoise else ()):
            if min(r[tag]["counts"][name] for r in ranks) <= 0:
                raise AssertionError(f"sharded {tag}: a rank did not launch {name}")
        for name in kernels_of:
            total = sum(r[tag]["counts"].get(name, 0) for r in ranks)
            if total:
                shard_launches.setdefault(name, {})[tag] = total
        per_rank = "; ".join(
            f"rank {i} ({r[tag]['device']}): frames {[round(x, 3) for x in r[tag]['times']]} ms, "
            f"exchanges {[e['calls'] for e in r[tag]['exchange']]} calls "
            f"{[e['bytes'] for e in r[tag]['exchange']]} B received "
            f"{[round(e['seconds'] * 1e3, 3) for e in r[tag]['exchange']]} ms host-staged, "
            f"peak {r[tag]['peak_mb']:.1f} MiB" for i, r in enumerate(ranks))
        err = max((torch.from_numpy(ranks[0][tag]["hdr"][k]) - twins[tag, k]).abs().max().item()
                  for k in range(frames))
        print(f"sharded {tag}, {frames} chained frames: max abs err against the whole frame "
              f"{err} (rtol 3e-3, atol 1e-5); whole frame "
              f"{[round(x, 3) for x in twins[tag, 'ms']]} ms; {per_rank}", flush=True)
    del ranks, twins

    # -- the host side: the app, picking, DDS textures, a checkpoint, the
    # viewer and the warm-up
    host = host_phase(dev, chain, show, kernels_of, big_cpu, seed, res)

    bounce_src = "zetaray_tpu_torch/csrc/bounce.cu"
    sources = {
        "gbuffer": ("zetaray_tpu_torch/csrc/gbuffer.cu", "zetaray_tpu/accel/megakernel.py:650"),
        "ris": ("zetaray_tpu_torch/csrc/ris.cu", "zetaray_tpu/ops/restir_di.py:141"),
        "occlusion": ("zetaray_tpu_torch/csrc/occlusion.cu",
                      "zetaray_tpu/accel/pallas_kernels.py:148"),
        "bounce_trace": (bounce_src, "zetaray_tpu/accel/megakernel.py:830"),
        "bounce_shade": (bounce_src, "zetaray_tpu/accel/megakernel.py:944"),
        "bounce": (bounce_src, "zetaray_tpu/accel/megakernel.py:360"),
        "closest": ("zetaray_tpu_torch/csrc/closest.cu",
                    "zetaray_tpu/accel/pallas_kernels.py:66"),
        "stream_closest": ("zetaray_tpu_torch/csrc/stream.cu", "zetaray_tpu/accel/stream.py:382"),
        "occlusion_stream": ("zetaray_tpu_torch/csrc/stream.cu",
                             "zetaray_tpu/accel/stream.py:420"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        # no single PyTorch call computes a ray-triangle closest hit, an
        # any-hit query, RIS over a light set or a path bounce
        if name in stream_kernels:  # on the clustered box, launches of its GI frame
            launches_of, rec_of = launches_cl, record["cornell139k"]
        else:
            launches_of, rec_of = launches_pt if name == "closest" else launches, record["cornell36"]
        mats = {k: record[k][name] for k in ("materials36", "materials8192")
                if name in record[k]}
        # the textured box's split bounce (B4, B5) and the cutout re-trace
        # (B7 its rounds on the box, B8 on the large cutout box's frame)
        paths = {k: record[k][name] for k in ("textured36", "cutout36") if name in record[k]}
        if name == "stream_closest":
            paths["cutout147k"] = {"launches": counts_cc[name]}
        if name in record["refit139k"]:  # B8 and B9 on the refit walk tree, t = 0.5
            paths["refit139k"] = record["refit139k"][name]
        animated = {k: v["counts"][name] for k, v in anim_paths.items() if v["counts"][name]}
        if animated:  # launches of the animated frames, a chain of 4
            paths["animated"] = {"launches": animated}
        if name in shard_launches:  # the ranks' launches of the sharded frames, 3 a chain
            paths["sharded"] = {"launches": shard_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches_of[name], **rec_of[name], "library_ms": None,
            **({"registers": registers[name]} if name in registers else {}),
            **({"materials": mats} if mats else {}), **paths,
            **({"host_side": host[name]} if name in host else {}),
        })
    # a-trous replaces no TPU kernel: the JAX package's a-trous is XLA-side.
    # Its launches are the flagship chain's; the denoised 1920x1080, ReSTIR
    # PT and sharded chains', and the host side's, beside them
    kernels.append({"name": "atrous", "route": "cuda",
                    "source": "zetaray_tpu_torch/csrc/atrous.cu", "replaces": None,
                    "launches": launches["atrous"], **record["atrous1080p"],
                    "library_ms": None, "flagship1080p": {"launches": counts_hd["atrous"]},
                    "restir_pt": {"launches": launches_pt["atrous"]},
                    **({"sharded": {"launches": shard_launches["atrous"]}}
                       if "atrous" in shard_launches else {}),
                    **({"host_side": host["atrous"]} if "atrous" in host else {})})
    # the wavefront's vertex kernel replaces no TPU kernel: the JAX wavefront
    # is XLA-side. Its launches are the clustered GI chain's; the clustered
    # plain PT, ReSTIR PT and animated default chains' beside them
    kernels.append({"name": "wavefront", "route": "cuda",
                    "source": "zetaray_tpu_torch/csrc/wavefront.cu", "replaces": None,
                    "launches": launches_cl["wavefront"], **record["wavefront1080p"],
                    "library_ms": None, "plain_pt": {"launches": counts_cl_pt["wavefront"]},
                    "restir_pt": {"launches": counts_cl_rpt["wavefront"]},
                    "animated": {"launches": anim_paths["clustered default 256^2"]["counts"][
                        "wavefront"]}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
