"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import nothing
of JAX, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from zetaray_tpu_torch import native
from zetaray_tpu_torch.accel import bvh as TB
from zetaray_tpu_torch.accel import intersect as XI
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.accel import stream as ST
from zetaray_tpu_torch.kernel_ab import bits_equal
from zetaray_tpu_torch.ops import denoise as DN
from zetaray_tpu_torch.ops import restir_di as RD
from zetaray_tpu_torch.ops import pathtracer as PT
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.restir_gi import secondary_rays
from zetaray_tpu_torch.ops.sky import SkyParams
from zetaray_tpu_torch.parallel.mesh import run_ranks
from zetaray_tpu_torch.render.frame import RenderConfig, pick_rt, render_frame, render_frame_restir
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import (
    CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box, repeated_box,
)
from zetaray_tpu_torch.scene.scene import upload_scene, with_cluster_tree
from zetaray_tpu_torch.scene.subdivide import subdivide_scene

torch.set_num_threads(1)

SEED = 0x1234567


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(dev, res=128):
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    return cam, *cam.generate_rays(res, res, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("subdivide", [None, 2000])
def test_gbuffer_kernel_matches_plain(cuda, subdivide):
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device=cuda)
    _, o, d = _rays(cuda)
    before = native.launches["zr_gbuffer"]
    gk = MK.gbuffer(scene, o, d)
    gp = MK.gbuffer_plain(scene, o, d)
    torch.cuda.synchronize()
    assert native.launches["zr_gbuffer"] == before + 1
    for r in (MK.G.VALID, MK.G.MATID, MK.G.INST):
        assert torch.equal(gk[r], gp[r])
    hit = gp[MK.G.VALID] > 0.5
    torch.testing.assert_close(gk[:, hit], gp[:, hit], rtol=1e-5, atol=1e-5)


# The frame seed of B2's cases: pcg4d gives pixel RIS_U0_PIXEL a uniform of
# exactly 0, so its target u * w_sum is 0 and equals every checkpoint of
# running sum 0 before its first entry of positive weight.
RIS_SEED = 34907
RIS_U0_PIXEL = 522
RIS_RT = 128  # the narrowest tile width: the 1000 pixels draw from all 8 sets


def _ris_sets(lsets, name):
    """B2's light sets of case ``name`` (edited in place): the sampled sets;
    every third entry of pdf 0; entries 32-63 of pdf 0 (a whole chunk of
    zero weight, so checkpoints repeat); weight only in entries 0-7 (every
    pick in the first chunk) or in 120-127 (every pick in the last); no
    weight at all (every pick the last entry); every odd entry two-sided
    and facing away, every fourth of pdf 0, the last entry among them."""
    pdf, two, ng = lsets[:, 9], lsets[:, 10], lsets[:, 3:6]
    if name == "pdf0":
        pdf[:, ::3] = 0.0
    elif name == "zero_chunk":
        pdf[:, 32:64] = 0.0
    elif name == "first_chunk":
        pdf[:, 8:] = 0.0
    elif name == "last_chunk":
        pdf[:, :120] = 0.0
    elif name == "no_weight":
        pdf[:] = 0.0
    elif name == "two_sided":
        two[:, 1::2] = 1.0
        ng[:, :, 1::2] *= -1.0
        pdf[:, 3::4] = 0.0
    else:
        assert name == "sampled"
    return lsets


RIS_CASES = ("sampled", "pdf0", "zero_chunk", "first_chunk", "last_chunk", "no_weight",
             "two_sided")


def ris_case(name, dev):
    """(G-buffer, light sets) of B2's case ``name`` on ``dev``: the box's
    32^2 camera G-buffer cut to 1000 pixels (the last block ragged) with
    every fifth pixel's VALID row cleared and its other rows kept (its
    row-13 target is that of the last entry, mostly not 0), and 8 light sets
    of 128 entries (_ris_sets)."""
    scene = upload_scene(cornell_box(), device=dev)
    _, o, d = _rays(dev, 32)
    gb = MK.gbuffer(scene, o, d)[:, :1000].contiguous()
    gb[MK.G.VALID, ::5] = 0.0
    return gb, _ris_sets(MK.build_light_sets(scene, SEED, 8), name).contiguous()


def ris_pick(res, lsets, rt):
    """The light-set entry each pixel of reservoirs ``res`` picked: the
    first of its set with the same position."""
    n, n_sets = res.shape[1], lsets.shape[0]
    set_of = (torch.arange(n, device=res.device) // rt) * 31 % n_sets
    same = (lsets[set_of, 0:3, :] == res[0:3].T[:, :, None]).all(1)
    assert same.any(1).all()
    return same.int().argmax(1)


@pytest.mark.cuda
def test_ris_and_occlusion_kernels_match_plain(cuda):
    """B2 and B3 against their plain versions on 128^2 camera rays of the box
    split to 1000 triangles, and B2 also on the cases of the host test
    (test_torch_rehearsal.py::test_ris_on_host): at least 99.5% of the
    pixels pick the same entry (the card's rsqrtf is not the CPU's 1/sqrt),
    and those agree to 1e-5."""
    scene = upload_scene(cornell_box(subdivide_to=1000), device=cuda)
    _, o, d = _rays(cuda)
    gb = MK.gbuffer(scene, o, d)
    lsets = MK.build_light_sets(scene, SEED)
    rt = pick_rt(gb.shape[1])
    cases = [(gb, lsets, SEED, rt)] + [(*ris_case(c, cuda), RIS_SEED, RIS_RT) for c in RIS_CASES]
    before = native.launches["zr_ris"]
    for g, ls, seed, rt_ in cases:
        rk = RD.initial_candidates(g, ls, seed, rt=rt_)
        rp = RD.initial_candidates_plain(g, ls, seed, rt_)
        same = (rk[0:3] == rp[0:3]).all(0)
        assert same.float().mean() >= 0.995
        torch.testing.assert_close(rk[:, same], rp[:, same], rtol=1e-5, atol=1e-6)
    assert native.launches["zr_ris"] == before + len(cases)
    rk = RD.initial_candidates(gb, lsets, SEED, rt=rt)
    so = (gb[MK.G.POS : MK.G.POS + 3] + 1e-3 * gb[MK.G.NG : MK.G.NG + 3]).T.contiguous()
    seg = (rk[0:3] - gb[MK.G.POS : MK.G.POS + 3]).T.contiguous()
    ok = XI.occlusion(scene, so, seg, 1e-3, 1.0 - 1e-3)
    assert torch.equal(ok, XI.occlusion_plain(scene.woop, so, seg, 1e-3, 1.0 - 1e-3))
    assert 0 < ok.sum() < ok.numel()


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    scene = upload_scene(cornell_box(), device=cuda)
    _, o, d = _rays(cuda, 8)
    with pytest.raises(ValueError):
        MK.gbuffer(scene, o.T.contiguous().T, d)  # not contiguous
    with pytest.raises(TypeError):
        XI.occlusion(scene, o.double(), d.double())


def _close_rays(k, p, rows=slice(None)):
    """Share of rays whose rows agree to 1e-5 (relative and absolute)."""
    return torch.isclose(k[rows], p[rows], rtol=1e-5, atol=1e-5).all(0).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("subdivide", [None, 2000])
def test_bounce_kernels_match_plain(cuda, subdivide):
    """B4, B5 and B6 against their plain versions on GI bounce-0 rays. All
    rows on rays that found a hit, radiance and alive on every ray (rays
    that missed move on from a zero-attribute surface, where one ulp of the
    sampled direction moves the pdf row by percents)."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device=cuda)
    _, o, d = _rays(cuda)
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene, o, d), SEED)
    lsets = MK.build_light_sets(scene, SEED)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1)
    rt = pick_rt(o.shape[0])
    kernels = ("zr_bounce_trace", "zr_bounce_shade", "zr_bounce")
    counts = [native.launches[k] for k in kernels]
    st, surf = MK.bounce_trace(scene, MK.initial_state(o2, d2), 0, cfg, True, 0.004)
    st_p, surf_p = MK.bounce_trace_plain(scene, MK.initial_state(o2, d2), 0, cfg, True, 0.004)
    found = st_p[13] > 0.5
    assert 0.3 < found.float().mean() < 1.0
    assert _close_rays(st, st_p) == 1.0 and _close_rays(surf, surf_p) == 1.0
    st5 = MK.bounce_shade(scene, st_p, surf_p, lsets, 0, SEED, cfg, True, rt)
    st5_p = MK.bounce_shade_plain(scene, st_p, surf_p, lsets, 0, SEED, cfg, True, rt)
    assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
    assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
    for b, last in ((1, False), (2, True)):
        f6 = MK.bounce_trace_plain(scene, st5_p, b, cfg, True)[0][13] > 0.5
        st6 = MK.bounce(scene, st5_p, lsets, b, SEED, cfg, last, True, rt)
        st6_p = MK.bounce_plain(scene, st5_p, lsets, b, SEED, cfg, last, True, rt)
        assert _close_rays(st6[:, f6], st6_p[:, f6]) >= 0.999
        assert _close_rays(st6, st6_p, [9, 10, 11, 13]) >= 0.999
    torch.cuda.synchronize()
    assert [native.launches[k] for k in kernels] == [counts[0] + 1, counts[1] + 1, counts[2] + 2]


SUN = (0.2, 0.45, 0.87)  # shines in through the box's opening at +z
PATH_OPTIONS = {
    "sky": dict(sky=SkyParams(sun_dir=SUN)),
    "sky_no_sun_nee": dict(sky=SkyParams(sun_dir=SUN), sun_nee=False),
    "regularized_clamped": dict(path_regularization=True, firefly_clamp=0.05),
}


@pytest.mark.cuda
@pytest.mark.parametrize("subdivide", [None, 300, 2000])
@pytest.mark.parametrize("opts", sorted(PATH_OPTIONS))
def test_bounce_options_match_plain(cuda, subdivide, opts):
    """The sky, sun NEE, path regularization and firefly branches of B4, B5
    and B6 against the plain versions, as test_bounce_kernels_match_plain
    holds them, on GI bounce-0 rays at the narrowest tile width (rt = 128),
    on the box, on 300 triangles (3 chunks of the sweep's ring, swept three
    times by B5 and B6 with sun NEE) and on 2000: B4 at bounce 0, B5 at
    bounce 0 and 1 (where regularization acts), B6 at bounce 1 and on its
    trace-only last bounce at 2. Rays that escape
    through the opening gather the sky; every ray gains light (NEE or the
    sun) in the kernel exactly where it does in the plain version."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device=cuda)
    _, o, d = _rays(cuda)
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene, o, d), SEED)
    lsets = MK.build_light_sets(scene, SEED)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1, **PATH_OPTIONS[opts])
    st0 = MK.initial_state(o2, d2)
    st, surf = MK.bounce_trace(scene, st0, 0, cfg, True, 0.004)
    st_p, surf_p = MK.bounce_trace_plain(scene, st0, 0, cfg, True, 0.004)
    found = st_p[13] > 0.5
    assert 0.3 < found.float().mean() < 1.0
    assert _close_rays(st, st_p) == 1.0 and _close_rays(surf, surf_p) == 1.0
    escaped = ((st_p[9:12] != st0[9:12]).any(0) & ~found).sum().item()
    assert escaped > 50 if cfg.sky is not None else escaped == 0
    for b in (1, 0):
        st5 = MK.bounce_shade(scene, st_p, surf_p, lsets, b, SEED, cfg, True, 128)
        st5_p = MK.bounce_shade_plain(scene, st_p, surf_p, lsets, b, SEED, cfg, True, 128)
        assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
        assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
        assert torch.equal(*((x[9:12] != st_p[9:12]).any(0) for x in (st5, st5_p)))
    for b, last in ((1, False), (2, True)):
        f6 = MK.bounce_trace_plain(scene, st5_p, b, cfg, True)[0][13] > 0.5
        st6 = MK.bounce(scene, st5_p, lsets, b, SEED, cfg, last, True, 128)
        st6_p = MK.bounce_plain(scene, st5_p, lsets, b, SEED, cfg, last, True, 128)
        assert _close_rays(st6[:, f6], st6_p[:, f6]) >= 0.999
        assert _close_rays(st6, st6_p, [9, 10, 11, 13]) >= 0.999
        assert torch.equal(*((x[9:12] != st5_p[9:12]).any(0) for x in (st6, st6_p)))


@pytest.mark.cuda
@pytest.mark.parametrize("subdivide", [None, 2000])
def test_closest_kernel_matches_plain(cuda, subdivide):
    """B7 against its plain version on ReSTIR PT prefix rays (a BSDF
    direction at each primary hit): every output equal."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device=cuda)
    _, o, d = _rays(cuda)
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene, o, d), SEED)
    before = native.launches["zr_closest"]
    got = XI.closest_hit(scene, o2, d2)
    want = XI.closest_hit_plain_shaded(scene.woop, scene.tri_attrs, o2, d2)
    torch.cuda.synchronize()
    assert native.launches["zr_closest"] == before + 1
    assert 0.3 < (want.tri >= 0).float().mean() < 1.0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("subdivide", [None, 200, 300, 1000])
def test_sweep_kernels_on_ragged_shapes(cuda, subdivide):
    """B1 and B3-B7 where their sweep has ragged edges: 36, 200, 300 or
    1000 real triangles (1, 2, 3 and 8 chunks of the 128-triangle staging
    ring, none full; with an odd count of at least 3 B6's shadow sweep
    starts in the ring stage that holds the closest-hit sweep's last chunk),
    1000 rays (not a multiple of a block's 128) and B5 and B6 with the
    narrowest tile width, rt = 128. B1 on 1000 camera rays as in
    test_gbuffer_kernel_matches_plain. B3 equal to its plain version on
    shadow segments and on rays of unbounded length, B7 in every output. B4,
    B5 and B6 as in test_bounce_kernels_match_plain, and on every ray that
    found a hit B4's surface position and B6's next origin (the hit point
    moved off the surface) equal bit for bit. B1, B3, B4, B6 and B7 refuse
    a negative t_min."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device=cuda)
    assert scene.num_tris % 128
    _, o, d = _rays(cuda, 32)
    o1, d1 = o[:1000].contiguous(), d[:1000].contiguous()
    g1, g1_p = MK.gbuffer(scene, o1, d1), MK.gbuffer_plain(scene, o1, d1)
    torch.cuda.synchronize()
    for r in (MK.G.VALID, MK.G.MATID, MK.G.INST):
        assert torch.equal(g1[r], g1_p[r])
    hit = g1_p[MK.G.VALID] > 0.5
    assert hit.float().mean() > 0.5
    torch.testing.assert_close(g1[:, hit], g1_p[:, hit], rtol=1e-5, atol=1e-5)
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene, o, d), SEED)
    o2, d2 = o2[:1000].contiguous(), d2[:1000].contiguous()
    got = XI.closest_hit(scene, o2, d2)
    want = XI.closest_hit_plain_shaded(scene.woop, scene.tri_attrs, o2, d2)
    torch.cuda.synchronize()
    assert 0.3 < (want.tri >= 0).float().mean() < 1.0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    lsets = MK.build_light_sets(scene, SEED)
    seg = (MK.build_light_sets(scene, SEED + 1)[0, 0:3, :1].T - o2).contiguous()
    for dirs, t_min, t_max in ((seg, 1e-3, 1.0 - 1e-3), (d2, 1e-4, MK.INF)):
        occ = XI.occlusion(scene, o2, dirs, t_min, t_max)
        assert torch.equal(occ, XI.occlusion_plain(scene.woop, o2, dirs, t_min, t_max))
        assert 0 < occ.sum() < occ.numel()
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1)
    st0 = MK.initial_state(o2, d2)
    st4, surf4 = MK.bounce_trace(scene, st0, 0, cfg, True, 0.004)
    st, surf = MK.bounce_trace_plain(scene, st0, 0, cfg, True, 0.004)
    found = st[13] > 0.5
    assert 0.3 < found.float().mean() < 1.0
    assert _close_rays(st4, st) == 1.0 and _close_rays(surf4, surf) == 1.0
    assert torch.equal(st4[13], st[13]) and torch.equal(surf4[0:3, found], surf[0:3, found])
    st5 = MK.bounce_shade_plain(scene, st, surf, lsets, 0, SEED, cfg, True, 128)
    st5_k = MK.bounce_shade(scene, st, surf, lsets, 0, SEED, cfg, True, 128)
    assert _close_rays(st5_k[:, found], st5[:, found]) >= 0.999
    assert _close_rays(st5_k, st5, [9, 10, 11, 13]) >= 0.999
    for b, last in ((1, False), (2, True)):
        f6 = MK.bounce_trace_plain(scene, st5, b, cfg, True)[0][13] > 0.5
        st6 = MK.bounce(scene, st5, lsets, b, SEED, cfg, last, True, 128)
        st6_p = MK.bounce_plain(scene, st5, lsets, b, SEED, cfg, last, True, 128)
        assert _close_rays(st6[:, f6], st6_p[:, f6]) >= 0.999
        assert _close_rays(st6, st6_p, [9, 10, 11, 13]) >= 0.999
        if not last:
            assert f6.float().mean() > 0.3
            assert torch.equal(st6[0:3, f6], st6_p[0:3, f6])
    with pytest.raises(ValueError, match="t_min"):
        MK.gbuffer(scene, o1, d1, t_min=-1.0)
    with pytest.raises(ValueError, match="t_min"):
        XI.closest_hit(scene, o2, d2, t_min=-1.0)
    with pytest.raises(ValueError, match="t_min"):
        XI.occlusion(scene, o2, d2, t_min=-1.0)
    with pytest.raises(ValueError, match="t_min"):
        MK.bounce(scene, st5, lsets, 1, SEED, PTConfig(t_min=-1.0), False, True, 128)
    with pytest.raises(ValueError, match="t_min"):
        MK.bounce_trace(scene, st0, 0, PTConfig(t_min=-1.0), True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,indirect", [("restir_gi", False), ("restir_gi", True),
                                           ("restir_pt", True)])
def test_card_frame_matches_cpu_frame(cuda, mode, indirect):
    """Two chained 32^2 frames through the kernels on the card and through
    the plain versions on the CPU: DI only, with ReSTIR GI, with ReSTIR PT."""
    cfg = RenderConfig(width=32, height=32, mode=mode, indirect=indirect,
                       pt=PTConfig(max_bounces=3), denoise=True, taa=True)
    cam, _, _ = _rays(cuda)
    outs = {}
    for dev in ("cpu", cuda):
        scene = upload_scene(cornell_box(), device=dev)
        state = None
        for k in range(2):
            out, state = render_frame_restir(scene, cam.with_jitter(k), SEED + k, cfg, state)
        outs[str(dev)] = out["hdr"].cpu()
    got, want = outs[str(cuda)], outs["cpu"]
    close = ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(-1)
    assert close.float().mean() >= 0.99


@pytest.mark.cuda
def test_card_plain_pt_frame_matches_cpu_frame(cuda):
    cfg = RenderConfig(width=32, height=32, mode="pt", pt=PTConfig(max_bounces=4))
    cam, _, _ = _rays(cuda)
    outs = {str(dev): render_frame(upload_scene(cornell_box(), device=dev), cam, SEED,
                                   cfg)["hdr"].cpu() for dev in ("cpu", cuda)}
    got, want = outs[str(cuda)], outs["cpu"]
    close = ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(-1)
    assert close.float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("name,cluster_size", [("box8706", None), ("box546", 128),
                                               ("ties", 128), ("deep", 128)])
def test_stream_kernels_match_plain(cuda, name, cluster_size):
    """B8 and B9 against their plain versions on the box split to 8706
    triangles (34 clusters of 256), on the box split to 546 triangles in
    clusters of 128, on the box with each triangle repeated 160 times
    (clusters of 128), where the tie rule (t, cluster, -slot) decides every
    hit, and on the box bisected to 56 triangles, each repeated 100 times,
    with its 56 clusters in a chain (the cluster tree 55 deep, the walks'
    stack 61 entries, 61 KiB of B8's shared memory a block): camera rays,
    rays leaving each primary hit (or, where the primary ray missed, from
    its far end, as bench.py builds them) in random directions, and shadow
    segments; t and slot equal. B8 and B9 refuse a negative t_min."""
    cpu = {"box8706": lambda: subdivide_scene(cornell_box(), 8193),
           "box546": lambda: subdivide_scene(cornell_box(), 500),
           "ties": lambda: repeated_box(160),
           "deep": lambda: repeated_box(100, 56)}[name]()
    scene = upload_scene(cpu, device=cuda, cluster_size=cluster_size)
    assert scene.cluster_aabb is not None
    if name == "deep":
        scene = with_cluster_tree(scene, TB.chain_tree(scene.cluster_aabb.cpu().numpy()))
        assert scene.walk_stack == 61
    _, o, d = _rays(cuda)
    g = torch.Generator(device=cuda).manual_seed(SEED)
    before = (native.launches["zr_stream_closest"], native.launches["zr_stream_occlusion"])
    t, tri = ST.stream_closest(scene, o, d)
    t_p, tri_p = ST.stream_closest_plain(scene, o, d)
    assert torch.equal(tri, tri_p) and torch.equal(t, t_p)
    dg = torch.randn(o.shape, device=cuda, generator=g)
    og = o + (t_p - 1e-3)[:, None] * d
    dg = dg / dg.norm(dim=1, keepdim=True)
    t2, tri2 = ST.stream_closest(scene, og, dg)
    t2_p, tri2_p = ST.stream_closest_plain(scene, og, dg)
    assert torch.equal(tri2, tri2_p) and torch.equal(t2, t2_p)
    assert 0.3 < (tri2_p >= 0).float().mean() < 1.0
    gb = MK.gbuffer(scene, o, d)
    rk = RD.initial_candidates(gb, MK.build_light_sets(scene, SEED), SEED, rt=pick_rt(o.shape[0]))
    so = (gb[MK.G.POS : MK.G.POS + 3] + 1e-3 * gb[MK.G.NG : MK.G.NG + 3]).T.contiguous()
    seg = (rk[0:3] - gb[MK.G.POS : MK.G.POS + 3]).T.contiguous()
    occ = ST.occlusion_stream(scene, so, seg, 1e-3, 1.0 - 1e-3)
    assert torch.equal(occ, ST.occlusion_stream_plain(scene, so, seg, 1e-3, 1.0 - 1e-3))
    assert 0 < occ.sum() < occ.numel()
    torch.cuda.synchronize()
    # the G-buffer took B8 too
    assert (native.launches["zr_stream_closest"], native.launches["zr_stream_occlusion"]) == (
        before[0] + 3, before[1] + 1)
    with pytest.raises(ValueError, match="t_min"):
        ST.stream_closest(scene, o, d, t_min=-1.0)
    with pytest.raises(ValueError, match="t_min"):
        ST.occlusion_stream(scene, so, seg, t_min=-1.0)


@pytest.mark.cuda
def test_card_clustered_gi_frame_matches_cpu_frame(cuda):
    """Two chained 32^2 GI frames on the 546-triangle box in clusters of 128:
    through B8/B9 on the card and their plain versions on the CPU."""
    cfg = RenderConfig(width=32, height=32, mode="restir_gi", pt=PTConfig(max_bounces=2),
                       denoise=True, taa=True)
    cam, _, _ = _rays(cuda)
    box = subdivide_scene(cornell_box(), 500)
    outs = {}
    for dev in ("cpu", cuda):
        scene = upload_scene(box, device=dev, cluster_size=128)
        state = None
        for k in range(2):
            out, state = render_frame_restir(scene, cam.with_jitter(k), SEED + k, cfg, state)
        outs[str(dev)] = out["hdr"].cpu()
    got, want = outs[str(cuda)], outs["cpu"]
    close = ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(-1)
    assert close.float().mean() >= 0.99


def _direction_segments(gb, cam, res):
    """SkyDI's shade segments toward each pixel's winning sky direction and
    the default froxel grid's 12,288 sun segments (unit directions, tested
    in (1e-3, 1e8)), as the features frame sends them."""
    from zetaray_tpu_torch.ops import skydi as SD
    from zetaray_tpu_torch.ops import volumetrics as VL

    sky = SkyParams(sun_dir=SUN)
    cfg = SD.SkyDIConfig(spatial_mis="pairwise")
    res_sd = SD.spatial_reuse(SD.initial_candidates(gb, sky, SEED, cfg), gb, res, res, SEED, cfg)
    pos, _, _ = VL.froxel_points(cam, VL.VolumetricsConfig(), gb.device)
    return {"skydi": SD.shade_segments(res_sd, gb), "froxels": VL.sun_segments(pos, sky)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "box2000", "box546_clustered"])
def test_any_hit_on_direction_segments_matches_plain(cuda, name):
    """B3 (dense) and B9 (clustered) on the segments along unit directions
    that SkyDI's shade and the froxel grid send, with t_max = 1e8: every
    flag equal to the plain version's, some blocked and some free."""
    cpu = {"box": cornell_box, "box2000": lambda: cornell_box(subdivide_to=2000),
           "box546_clustered": lambda: subdivide_scene(cornell_box(), 500)}[name]()
    scene = upload_scene(cpu, device=cuda, cluster_size=128 if "clustered" in name else None)
    cam, o, d = _rays(cuda)
    for key, (so, sd) in _direction_segments(MK.gbuffer(scene, o, d), cam, 128).items():
        if scene.cluster_aabb is None:
            got = XI.occlusion(scene, so, sd, 1e-3, 1e8)
            want = XI.occlusion_plain(scene.woop, so, sd, 1e-3, 1e8)
        else:
            got = ST.occlusion_stream(scene, so, sd, 1e-3, 1e8)
            want = ST.occlusion_stream_plain(scene, so, sd, 1e-3, 1e8)
        assert torch.equal(got, want), key
        assert 0 < want.sum() < want.numel(), key


@pytest.mark.cuda
@pytest.mark.parametrize("subdivide", [None, 300, 2000])
@pytest.mark.parametrize("opts", ["", "sky"])
def test_bounce_shade_without_bounce0_nee_matches_plain(cuda, subdivide, opts):
    """B5 as the ReSTIR_GI_LVG variant launches it, min_nee_bounce = 1 (no
    NEE at bounce 0; with the sky its sun segment stays), against the plain
    version as test_bounce_kernels_match_plain holds B5; no ray gains NEE
    light."""
    scene = upload_scene(cornell_box(subdivide_to=subdivide), device=cuda)
    _, o, d = _rays(cuda)
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene, o, d), SEED)
    lsets = MK.build_light_sets(scene, SEED)
    cfg = PTConfig(max_bounces=1, min_emissive_bounce=1, min_nee_bounce=1,
                   **(PATH_OPTIONS[opts] if opts else {}))
    st_p, surf_p = MK.bounce_trace_plain(scene, MK.initial_state(o2, d2), 0, cfg, True, 0.004)
    found = st_p[13] > 0.5
    st5 = MK.bounce_shade(scene, st_p, surf_p, lsets, 0, SEED, cfg, True, pick_rt(o.shape[0]))
    st5_p = MK.bounce_shade_plain(scene, st_p, surf_p, lsets, 0, SEED, cfg, True,
                                  pick_rt(o.shape[0]))
    assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
    assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
    lit = (st5_p[9:12] != st_p[9:12]).any(0)
    if opts:
        assert lit.any()  # the sun lights some rays
    else:
        assert not lit.any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["features", "features_gi_lvg", "clustered_pt"])
def test_card_features_and_clustered_pt_frames_match_cpu_frames(cuda, name):
    """Two chained 32^2 frames on the card and on the CPU: bench.py's
    features frame (grid candidates, pairwise MIS, SkyDI, volumetrics) with
    the sun in through the box's opening, also with the GI grid NEE, and
    ReSTIR PT on the 546-triangle box in clusters of 128."""
    from zetaray_tpu_torch.ops.restir_di import ReSTIRConfig
    from zetaray_tpu_torch.ops.restir_gi import ReSTIRGIConfig
    from zetaray_tpu_torch.ops.skydi import SkyDIConfig
    from zetaray_tpu_torch.ops.volumetrics import VolumetricsConfig

    if name == "clustered_pt":
        cfg = RenderConfig(width=32, height=32, mode="restir_pt", pt=PTConfig(max_bounces=3),
                           denoise=True, taa=True)
        cpu, cluster = subdivide_scene(cornell_box(), 500), 128
    else:
        cfg = RenderConfig(
            width=32, height=32, mode="restir_gi",
            pt=PTConfig(max_bounces=2, sky=SkyParams(sun_dir=SUN),
                        stochastic_multi_bounce=True, path_regularization=True),
            restir=ReSTIRConfig(lvg_samples=2, spatial_mis="pairwise"),
            restir_gi=ReSTIRGIConfig(lvg=name == "features_gi_lvg"), skydi=True,
            skydi_cfg=SkyDIConfig(spatial_mis="pairwise"), volumetrics=VolumetricsConfig(),
            denoise=True, taa=True)
        cpu, cluster = cornell_box(), None
    cam, _, _ = _rays(cuda)
    outs = {}
    for dev in ("cpu", cuda):
        scene = upload_scene(cpu, device=dev, cluster_size=cluster)
        state = None
        for k in range(2):
            out, state = render_frame_restir(scene, cam.with_jitter(k), SEED + k, cfg, state)
        outs[str(dev)] = out["hdr"].cpu()
    got, want = outs[str(cuda)], outs["cpu"]
    close = ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(-1)
    assert close.float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("subdivide", [None, 300, 2000])
@pytest.mark.parametrize("sun", [False, True], ids=["no_sky", "sun_nee"])
def test_wops_kernels_match_plain(cuda, subdivide, sun):
    """The WoPS NEE instances of B5 (bounce 0 and 1) and B6 (bounce 1)
    against their plain versions on 128^2 GI bounce-0 rays of the box with
    three wall lights of unequal power (multi_light_box; 300 triangles: 3
    chunks of the sweep's ring), with and without sun NEE, held as
    test_bounce_options_match_plain holds the others; the alias table
    redirects a share of the picks."""
    from zetaray_tpu_torch.scene.procedural import multi_light_box
    from zetaray_tpu_torch.core.rng import bounce_uniforms

    scene = upload_scene(multi_light_box(subdivide_to=subdivide), device=cuda)
    _, o, d = _rays(cuda)
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene, o, d), SEED)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1, nee_mode="wops",
                   sky=SkyParams(sun_dir=SUN) if sun else None)
    table = MK.wops_table(scene)
    st_p, surf_p = MK.bounce_trace_plain(scene, MK.initial_state(o2, d2), 0, cfg, True)
    found = st_p[13] > 0.5
    u = bounce_uniforms(o2.shape[0], 0, SEED, device=cuda, wops=True)
    redirected = MK.wops_pick(table, scene.num_emissives, u[0], u[5])[1]
    assert (redirected & found).float().mean() > 0.01
    for b in (0, 1):
        before = native.launches["zr_bounce_shade"]
        st5 = MK.bounce_shade(scene, st_p, surf_p, table, b, SEED, cfg, True, 128)
        assert native.launches["zr_bounce_shade"] == before + 1
        st5_p = MK.bounce_shade_plain(scene, st_p, surf_p, table, b, SEED, cfg, True, 128)
        assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
        assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
        assert torch.equal(*((x[9:12] != st_p[9:12]).any(0) for x in (st5, st5_p)))
    f6 = MK.bounce_trace_plain(scene, st5_p, 1, cfg, True)[0][13] > 0.5
    st6 = MK.bounce(scene, st5_p, table, 1, SEED, cfg, False, True, 128)
    st6_p = MK.bounce_plain(scene, st5_p, table, 1, SEED, cfg, False, True, 128)
    assert _close_rays(st6[:, f6], st6_p[:, f6]) >= 0.999
    assert _close_rays(st6, st6_p, [9, 10, 11, 13]) >= 0.999
    assert torch.equal(*((x[9:12] != st5_p[9:12]).any(0) for x in (st6, st6_p)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["upscale", "wops_restir_di", "lens_display"])
def test_card_upscale_wops_and_display_frames_match_cpu_frames(cuda, name):
    """Two chained frames on the card and on the CPU: bench.py's
    upscale_256_to_512 config at display 64^2 (render 32^2), the JAX app's
    default frame with WoPS NEE on the box with wall lights, and that frame
    through a thin lens with the firefly filter, the weighted-average
    exposure and the punchy AgX look, at 32^2."""
    from zetaray_tpu_torch.ops.upscale import UpscaleConfig
    from zetaray_tpu_torch.scene.procedural import multi_light_box

    cam, _, _ = _rays(cuda)
    cpu = cornell_box()
    if name == "upscale":
        cfg = RenderConfig(width=64, height=64, mode="restir_gi", pt=PTConfig(max_bounces=2),
                           render_scale=0.5, taa=True,
                           upscale_cfg=UpscaleConfig(rcas_sharpness=0.8))
    elif name == "wops_restir_di":
        cfg = RenderConfig(width=32, height=32, mode="restir_di", taa=True,
                           pt=PTConfig(max_bounces=4, nee_mode="wops"))
        cpu = multi_light_box()
    else:
        cfg = RenderConfig(width=32, height=32, mode="restir_di", taa=True,
                           pt=PTConfig(max_bounces=4), firefly_factor=3.0,
                           exposure_mode="weighted_avg", tonemapper="agx_punchy")
        cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0,
                             f_stop=2.8, focal_length_mm=50.0, focus_dist=3.5)
    outs = {}
    for dev in ("cpu", cuda):
        scene = upload_scene(cpu, device=dev)
        state = None
        for k in range(2):
            out, state = render_frame_restir(scene, cam.with_jitter(k), SEED + k, cfg, state)
        outs[str(dev)] = out["hdr"].cpu()
    got, want = outs[str(cuda)], outs["cpu"]
    assert got.shape == (cfg.height, cfg.width, 3)
    close = ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(-1)
    assert close.float().mean() >= 0.99


def lobes_box(lobes: str, subdivide_to=None):
    """``materials_box`` with the lobes ``lobes`` names: "glass" (the tall
    block's transmission, the coat taken off), "coat" (the short block's
    coat, the glass made opaque), "glass_coat" (both) or "coated_glass"
    (both, and the glass under a coat of weight 0.5, roughness 0.2, so that
    the coat attenuates transmitted light)."""
    import dataclasses

    import numpy as np

    from zetaray_tpu_torch.scene.procedural import materials_box

    cpu = materials_box(subdivide_to)
    m = cpu.materials
    if lobes == "coat":
        m = dataclasses.replace(m, transmission=np.zeros_like(m.transmission))
    elif lobes == "glass":
        m = dataclasses.replace(m, coat_weight=np.zeros_like(m.coat_weight))
    elif lobes == "coated_glass":
        from zetaray_tpu_torch.scene.procedural import GLOSSY

        m = dataclasses.replace(m, coat_weight=m.coat_weight.copy(),
                                coat_roughness=m.coat_roughness.copy())
        m.coat_weight[GLOSSY], m.coat_roughness[GLOSSY] = 0.5, 0.2
    return dataclasses.replace(cpu, materials=m)


MATERIAL_CASES = {
    "glass": ("glass", None, {}),
    "coat": ("coat", None, {}),
    "glass_coat": ("glass_coat", None, {}),
    "coated_glass": ("coated_glass", None, {}),
    "glass_coat_300_sky_sun": ("glass_coat", 300, dict(
        sky=SkyParams(sun_dir=SUN), path_regularization=True, firefly_clamp=0.05)),
    "glass_coat_300_wops": ("glass_coat", 300, dict(nee_mode="wops")),
    "glass_coat_2000_sky": ("glass_coat", 2000, dict(sky=SkyParams(sun_dir=SUN),
                                                     sun_nee=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MATERIAL_CASES))
def test_material_kernels_match_plain(cuda, case):
    """The material instances of B5 (bounce 0) and B6 (bounce 1, and its
    trace-only last bounce at 2) against their plain versions on 128^2 GI
    bounce-0 rays of the box with a glass block and a coated block (each
    lobe alone and both, with the path options, WoPS NEE and the sky), at
    rt = 128, as test_bounce_kernels_match_plain holds the opaque ones;
    the same rays gain the NEE light, and some samples are transmitted."""
    lobes, subdivide, opts = MATERIAL_CASES[case]
    scene = upload_scene(lobes_box(lobes, subdivide), device=cuda)
    _, o, d = _rays(cuda)
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene, o, d), SEED)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1, rr_start=1, **opts)
    lsets = MK.wops_table(scene) if cfg.nee_mode == "wops" else MK.build_light_sets(scene, SEED)
    st_p, surf_p = MK.bounce_trace_plain(scene, MK.initial_state(o2, d2), 0, cfg, True)
    found = st_p[13] > 0.5
    before = (native.launches["zr_bounce_shade"], native.launches["zr_bounce"])
    st5 = MK.bounce_shade(scene, st_p, surf_p, lsets, 0, SEED, cfg, True, 128)
    st5_p = MK.bounce_shade_plain(scene, st_p, surf_p, lsets, 0, SEED, cfg, True, 128)
    assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
    assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
    assert torch.equal(*((x[9:12] != st_p[9:12]).any(0) for x in (st5, st5_p)))
    below = found & (st5_p[13] > 0.5) & ((st5_p[3:6] * surf_p[6:9]).sum(0) < 0.0)
    assert (below.sum() > 10) == scene.has_transmission
    for b, last in ((1, False), (2, True)):
        f6 = MK.bounce_trace_plain(scene, st5_p, b, cfg, True)[0][13] > 0.5
        st6 = MK.bounce(scene, st5_p, lsets, b, SEED, cfg, last, True, 128)
        st6_p = MK.bounce_plain(scene, st5_p, lsets, b, SEED, cfg, last, True, 128)
        assert _close_rays(st6[:, f6], st6_p[:, f6]) >= 0.999
        assert _close_rays(st6, st6_p, [9, 10, 11, 13]) >= 0.999
    torch.cuda.synchronize()
    assert (native.launches["zr_bounce_shade"], native.launches["zr_bounce"]) == (
        before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["restir_gi", "restir_gi_options", "restir_pt", "restir_di"])
def test_card_materials_frames_match_cpu_frames(cuda, name):
    """Two chained 32^2 frames on the materials box on the card and on the
    CPU: the flagship GI frame (also with full_target and packed_reuse=False
    in every ReSTIR config), ReSTIR PT and the default restir_di frame."""
    from zetaray_tpu_torch.ops import restir_gi as RG
    from zetaray_tpu_torch.ops import restir_pt as RP
    from zetaray_tpu_torch.scene.procedural import materials_box

    opt = dict(full_target=True, packed_reuse=False)
    mode = name.replace("_options", "")
    extra = dict(restir=RD.ReSTIRConfig(**opt), restir_gi=RG.ReSTIRGIConfig(**opt),
                 restir_pt=RP.ReSTIRPTConfig(**opt)) if name.endswith("_options") else {}
    cfg = RenderConfig(width=32, height=32, mode=mode, denoise=mode != "restir_di", taa=True,
                       pt=PTConfig(max_bounces=4 if mode == "restir_di" else 3), **extra)
    cam, _, _ = _rays(cuda)
    outs = {}
    for dev in ("cpu", cuda):
        scene = upload_scene(materials_box(), device=dev)
        state = None
        for k in range(2):
            out, state = render_frame_restir(scene, cam.with_jitter(k), SEED + k, cfg, state)
        outs[str(dev)] = out["hdr"].cpu()
    got, want = outs[str(cuda)], outs["cpu"]
    assert torch.isfinite(got).all() and got.mean() > 0
    close = ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(-1)
    assert close.float().mean() >= 0.99
    assert abs(got.mean() - want.mean()) <= 0.02 * want.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("subdivide", [None, 2000])
def test_split_textured_bounce_matches_cpu(cuda, tmp_path, subdivide):
    """The split bounce of a textured trace, B4, the base-colour fetch and
    B5, on the card against their plain versions on the CPU, on the textured
    box's GI bounce-0 rays (made on the CPU, so both sides take the same
    inputs); then the whole textured trace."""
    from zetaray_tpu_torch.scene.procedural import textured_box
    from zetaray_tpu_torch.scene.textures import load_scene_textures

    cpu_scene = textured_box(tmp_path, subdivide_to=subdivide)
    cfg = PTConfig(max_bounces=3, min_emissive_bounce=1)
    spread = 0.004
    cpu = torch.device("cpu")
    scene_p, scene_k = (upload_scene(cpu_scene, device=x) for x in (cpu, cuda))
    tex_p, tex_k = (load_scene_textures(cpu_scene, device=x) for x in (cpu, cuda))
    _, o, d = _rays(cpu)
    o2, d2, _, _ = secondary_rays(MK.gbuffer(scene_p, o, d), SEED)
    lsets = MK.build_light_sets(scene_p, SEED)
    rt = pick_rt(o.shape[0])
    k = lambda x: x.to(cuda)
    st0 = MK.initial_state(o2, d2)
    st, surf = MK.bounce_trace(scene_k, k(st0), 0, cfg, True, spread)
    st_p, surf_p = MK.bounce_trace_plain(scene_p, st0, 0, cfg, True, spread)
    found = st_p[13] > 0.5
    assert _close_rays(st.cpu(), st_p) == 1.0 and _close_rays(surf.cpu(), surf_p) == 1.0
    surf_t = MK.fetch_base(tex_k, k(st_p), k(surf_p)).cpu()
    surf_tp = MK.fetch_base(tex_p, st_p, surf_p)
    assert _close_rays(surf_t, surf_tp) == 1.0
    assert (surf_tp[9:12, found] != surf_p[9:12, found]).any(0).float().mean() > 0.1
    st5 = MK.bounce_shade(scene_k, k(st_p), k(surf_tp), k(lsets), 0, SEED, cfg, True, rt).cpu()
    st5_p = MK.bounce_shade_plain(scene_p, st_p, surf_tp, lsets, 0, SEED, cfg, True, rt)
    assert _close_rays(st5[:, found], st5_p[:, found]) >= 0.999
    assert _close_rays(st5, st5_p, [9, 10, 11, 13]) >= 0.999
    rad = MK.trace_megakernel(scene_k, k(o2), k(d2), SEED, cfg, rt=rt, rows_out=True,
                              light_sets=k(lsets), textures=tex_k, spread_angle=spread).cpu()
    rad_p = MK.trace_megakernel(scene_p, o2, d2, SEED, cfg, rt=rt, rows_out=True,
                                light_sets=lsets, textures=tex_p, spread_angle=spread)
    close = ((rad - rad_p).abs() <= 1e-3 * (1 + rad_p.abs())).all(0)
    assert close.float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size", [0, 128])
def test_cutout_retrace_matches_plain(cuda, tmp_path, monkeypatch, cluster_size):
    """The alpha-cutout re-trace on the card (B7 each round on the dense
    cutout box, B8 on its 546-triangle split clustered by 128) against the
    same on the CPU (the plain versions) on the same camera rays: every hit
    and occlusion flag equal; B7 launches once a round, as many rounds as
    the CPU's re-trace runs (two: through the panel's transparent half to
    the back wall)."""
    from zetaray_tpu_torch.scene.procedural import cutout_box

    cpu_scene = cutout_box(tmp_path)
    if cluster_size:
        cpu_scene = subdivide_scene(cpu_scene, 500)
    _, o, d = _rays(torch.device("cpu"))
    seg = torch.tensor([0.0, -0.2, -6.0]).expand_as(d).contiguous()
    rounds = []

    closest_raw = XI._closest_raw

    def counted(*args):
        rounds.append(args[1].shape[0])
        return closest_raw(*args)

    with monkeypatch.context() as patch:
        patch.setattr(XI, "_closest_raw", counted)
        XI._closest_cutout(upload_scene(cpu_scene, device="cpu", cluster_size=cluster_size), o,
                           d, 1e-4, MK.INF)
    assert len(rounds) == 2 and rounds[1] < rounds[0] // 4
    got = {}
    for dev in (cuda, torch.device("cpu")):
        scene = upload_scene(cpu_scene, device=dev, cluster_size=cluster_size)
        assert scene.has_cutout
        o_, d_, seg_ = (x.to(dev) for x in (o, d, seg))
        before = native.launches["zr_closest"]
        sh = XI.intersect_closest_shaded(scene, o_, d_)
        launched = native.launches["zr_closest"] - before
        occ = XI.intersect_occluded(scene, o_, seg_, 1e-3, 1.0)
        gb = MK.gbuffer(scene, o_, d_)
        got[dev.type] = ([x.cpu() for x in sh] + [occ.cpu(), gb.cpu()], launched)
    (k, launched), (p, _) = got["cuda"], got["cpu"]
    assert launched == (0 if cluster_size else len(rounds))
    for a, b in zip(k[:-1], p[:-1]):
        assert torch.equal(a, b)
    torch.testing.assert_close(k[-1], p[-1], rtol=1e-5, atol=1e-5)  # the G-buffer rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["textured_gi", "textured_pt", "textured_di", "cutout_gi",
                                  "cutout_di", "cutout_clustered_gi"])
def test_card_textured_and_cutout_frames_match_cpu_frames(cuda, tmp_path, name):
    """Two chained 32^2 frames on the card and on the CPU: the textured box
    with its bundle after the emissive round trip (GI, ReSTIR PT, the
    default restir_di frame) and the cutout box (GI and the default frame;
    GI also on its 8706-triangle split, clustered)."""
    from zetaray_tpu_torch.ops import prelighting as PL
    from zetaray_tpu_torch.scene.procedural import cutout_box, textured_box
    from zetaray_tpu_torch.scene.textures import load_scene_textures

    kind, mode = name.split("_", 1)
    mode = "restir_" + mode.rsplit("_", 1)[-1]
    cpu_scene = (textured_box if kind == "textured" else cutout_box)(tmp_path)
    if "clustered" in name:
        cpu_scene = subdivide_scene(cpu_scene, 8193)
    cfg = RenderConfig(width=32, height=32, mode=mode, denoise=mode != "restir_di", taa=True,
                       pt=PTConfig(max_bounces=4 if mode == "restir_di" else 3))
    cam, _, _ = _rays(cuda)
    outs = {}
    for dev in ("cpu", cuda):
        scene = upload_scene(cpu_scene, device=dev)
        assert (scene.cluster_aabb is not None) == ("clustered" in name)
        tex = load_scene_textures(cpu_scene, device=dev)
        if kind == "textured":
            scene = PL.apply_tri_powers(scene, *PL.estimate_tri_power(scene, tex))
        state = None
        for k in range(2):
            out, state = render_frame_restir(scene, cam.with_jitter(k), SEED + k, cfg, state,
                                             textures=tex)
        outs[str(dev)] = out["hdr"].cpu()
    got, want = outs[str(cuda)], outs["cpu"]
    assert torch.isfinite(got).all() and got.mean() > 0
    close = ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(-1)
    assert close.float().mean() >= 0.99


def _animated_box(tmp_path, subdivide_to):
    """The animated box (procedural.animated_box) split to ``subdivide_to``
    triangles, and its rig."""
    from zetaray_tpu_torch.scene.animation import AnimationRig
    from zetaray_tpu_torch.scene.gltf import load_gltf
    from zetaray_tpu_torch.scene.procedural import animated_box
    from zetaray_tpu_torch.scene.scene import load_scene

    doc = load_gltf(animated_box(tmp_path / "box.gltf"))
    return subdivide_scene(load_scene(doc), subdivide_to), AnimationRig(doc)


def _stream_hits(scene, o, d):
    """B8 on camera rays and on rays leaving their hits in random
    directions, each held against its plain version; B9 on DI shadow
    segments, held too. Returns B8's (t, slot) on the camera rays."""
    t, tri = ST.stream_closest(scene, o, d)
    t_p, tri_p = ST.stream_closest_plain(scene, o, d)
    assert torch.equal(tri, tri_p) and torch.equal(t, t_p)
    g = torch.Generator(device=o.device).manual_seed(SEED)
    dg = torch.randn(o.shape, device=o.device, generator=g)
    dg = dg / dg.norm(dim=1, keepdim=True)
    og = o + (t_p - 1e-3)[:, None] * d
    t2, tri2 = ST.stream_closest(scene, og, dg)
    t2_p, tri2_p = ST.stream_closest_plain(scene, og, dg)
    assert torch.equal(tri2, tri2_p) and torch.equal(t2, t2_p)
    gb = MK.gbuffer(scene, o, d)
    rk = RD.initial_candidates(gb, MK.build_light_sets(scene, SEED), SEED, rt=pick_rt(o.shape[0]))
    so = (gb[MK.G.POS : MK.G.POS + 3] + 1e-3 * gb[MK.G.NG : MK.G.NG + 3]).T.contiguous()
    seg = (rk[0:3] - gb[MK.G.POS : MK.G.POS + 3]).T.contiguous()
    occ = ST.occlusion_stream(scene, so, seg, 1e-3, 1.0 - 1e-3)
    assert torch.equal(occ, ST.occlusion_stream_plain(scene, so, seg, 1e-3, 1.0 - 1e-3))
    assert 0 < occ.sum() < occ.numel()
    return t, tri


@pytest.mark.cuda
@pytest.mark.parametrize("split", [(500, 128), (8193, None)], ids=["box546", "box8706"])
@pytest.mark.parametrize("t", [0.5, 1.0])
def test_stream_kernels_on_a_refit_scene_match_plain(cuda, tmp_path, split, t):
    """B8 and B9 walking the refit walk tree of the animated box (its tall
    block moved) equal their plain versions (max abs err 0), and find the
    block where it moved to; walking the upload's boxes instead loses hits."""
    from dataclasses import replace

    from zetaray_tpu_torch.scene.refit import refit_scene

    cpu, rig = _animated_box(tmp_path, split[0])
    rest = upload_scene(cpu, device=cuda, cluster_size=split[1])
    assert rest.cluster_aabb is not None
    posed = refit_scene(rest, *rig.deltas(t))
    _, o, d = _rays(cuda)
    _, tri = _stream_hits(posed, o, d)
    assert (posed.inst_id[tri[tri >= 0].long()] == 1).sum() > 100
    _, tri_stale = ST.stream_closest(replace(posed, walk_nodes=rest.walk_nodes), o, d)
    assert not torch.equal(tri_stale, tri)


@pytest.mark.cuda
def test_refit_to_a_pose_and_back_gives_the_rest_hits(cuda, tmp_path):
    """The rig back at its rest time after a pose: B8's hits and the walk
    tree equal those of the rest time's refit taken before the pose, bit for
    bit (nothing of the pose stays behind), and B8's hits on the upload on
    99.9% of the rays, t to 1e-5 (the refit's float32 Woop rows against the
    upload's float64 ones; the clip's keys, float32, put the rest time's
    block an ulp off the node's rest translation)."""
    from zetaray_tpu_torch.scene.refit import refit_scene

    cpu, rig = _animated_box(tmp_path, 8193)
    rest = upload_scene(cpu, device=cuda)
    _, o, d = _rays(cuda)
    at_rest = refit_scene(rest, *rig.deltas(0.0))
    first = _stream_hits(at_rest, o, d)
    _stream_hits(refit_scene(rest, *rig.deltas(1.0)), o, d)
    back = refit_scene(rest, *rig.deltas(rig.duration))  # the loop wraps to 0
    again = _stream_hits(back, o, d)
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    assert torch.equal(back.walk_nodes, at_rest.walk_nodes)
    t_r, tri_r = _stream_hits(rest, o, d)
    assert (again[1] == tri_r).float().mean() >= 0.999
    same = (again[1] == tri_r) & (tri_r >= 0)
    torch.testing.assert_close(again[0][same], t_r[same], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "clustered", "cutout"])
def test_card_pick_matches_cpu(cuda, tmp_path, kind):
    """``render.picking.pick`` on the card (B7 on the box, B8 on its split
    to 8193 triangles, the cutout re-trace on the cutout box) against the
    same picks on the CPU: triangle, instance and material exact, t to
    1e-5."""
    from zetaray_tpu_torch.render.picking import pick
    from zetaray_tpu_torch.scene.procedural import cutout_box

    cpu_scene = cutout_box(tmp_path) if kind == "cutout" else cornell_box(
        subdivide_to=8193 if kind == "clustered" else None)
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    scenes = {dev: upload_scene(cpu_scene, device=dev) for dev in ("cpu", cuda)}
    assert (scenes[cuda].cluster_aabb is not None) == (kind == "clustered")
    counter = "zr_closest" if kind != "clustered" else "zr_stream_closest"
    hits = 0
    for px, py in [(32, 32), (5, 40), (60, 3), (20, 22), (40, 22), (12, 50), (0, 0)]:
        before = native.launches[counter]
        got = pick(scenes[cuda], cpu_scene, cam, px, py, 64, 64)
        assert native.launches[counter] > before
        want = pick(scenes["cpu"], cpu_scene, cam, px, py, 64, 64)
        assert (got.hit, got.tri, got.instance, got.material) == (
            want.hit, want.tri, want.instance, want.material)
        if got.hit:
            hits += 1
            assert got.t == pytest.approx(want.t, rel=1e-5)
    assert hits >= 5


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bc1", "bc7"])
def test_card_dds_textured_frame_matches_cpu(cuda, tmp_path, fmt):
    """The flagship on the textured box with its checker as a BC1 or BC7
    DDS file (decoded on the host by the BCn library), two chained 64^2
    frames on the card against the CPU (99% of pixels)."""
    from zetaray_tpu_torch.ops import prelighting as PL
    from zetaray_tpu_torch.scene.procedural import textured_box
    from zetaray_tpu_torch.scene.textures import load_scene_textures

    cpu_scene = textured_box(tmp_path, base_format=fmt)
    cfg = RenderConfig(width=64, height=64, mode="restir_gi", denoise=True, taa=True,
                       pt=PTConfig(max_bounces=3))
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    outs = {}
    for dev in ("cpu", cuda):
        scene = upload_scene(cpu_scene, device=dev)
        tex = load_scene_textures(cpu_scene, device=dev)
        scene = PL.apply_tri_powers(scene, *PL.estimate_tri_power(scene, tex))
        state = None
        for k in range(2):
            out, state = render_frame_restir(scene, cam.with_jitter(k), SEED + k, cfg, state,
                                             textures=tex)
        outs[str(dev)] = out["hdr"].cpu()
    got, want = outs[str(cuda)], outs["cpu"]
    assert torch.isfinite(got).all() and got.mean() > 0
    close = ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(-1)
    assert close.float().mean() >= 0.99


# -- a-trous (csrc/atrous.cu) ---------------------------------------------------

# shapes where the taps' shifts (up to 16) exceed the image, and where the
# 32 x 8 blocks are ragged
ATROUS_SHAPES = [(7, 5), (1, 33), (33, 1), (17, 1000)]


def atrous_case(h: int, w: int, seed: int, device="cpu"):
    """An a-trous input, seeded: a lognormal colour [3, H, W], unit normals
    that mostly agree, depth in [2, 4] and about a tenth of the pixels not
    valid (bool [H, W])."""
    g = torch.Generator().manual_seed(seed)
    img = torch.exp(1.5 * torch.randn((3, h, w), generator=g) - 1.0)
    nrm = torch.randn((3, h, w), generator=g)
    nrm[2] = nrm[2].abs() + 2.0
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=0, keepdim=True)
    depth = 2.0 + 2.0 * torch.rand((h, w), generator=g)
    valid = torch.rand((h, w), generator=g) > 0.1
    return tuple(t.to(device) for t in (img, nrm, depth, valid))


@pytest.fixture(scope="module")
def gi_guides_1080p():
    """A GI frame of the box at 1920x1080 before a-trous (denoise and TAA
    off), [3, H, W], and its guides: the G-buffer's shading normals, depth
    and validity (the box's outside misses: invalid pixels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    w, h = 1920, 1080
    scene = upload_scene(cornell_box(), device=dev)
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=w / h)
    cfg = RenderConfig(width=w, height=h, mode="restir_gi", pt=PTConfig(max_bounces=3),
                       denoise=False, taa=False)
    out, _ = render_frame_restir(scene, cam, SEED, cfg, None)
    gb = MK.gbuffer(scene, *cam.generate_rays(w, h, device=dev))
    return (out["hdr"].permute(2, 0, 1).contiguous(), gb[MK.G.NS : MK.G.NS + 3].reshape(3, h, w),
            gb[MK.G.DEPTH].reshape(h, w), (gb[MK.G.VALID] > 0.5).reshape(h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 2, 4, 8, "chain"])
def test_atrous_kernel_matches_plain_at_1080p(gi_guides_1080p, step):
    """Each a-trous pass (one launch) and the 4-pass chain (4 launches) on a
    rendered GI frame at 1920x1080, bit for bit against the plain pass on
    the card."""
    hdr, nrm, depth, valid = gi_guides_1080p
    assert valid.any() and not valid.all()
    before = native.launches["zr_atrous"]
    if step == "chain":
        got, want = DN.atrous_denoise_p(hdr, nrm, depth, valid), DN.atrous_denoise_plain(
            hdr, nrm, depth, valid)
    else:
        got = DN.atrous_iteration_p(hdr, nrm, depth, valid, step)
        want = DN.atrous_iteration_plain(hdr, nrm, depth, valid.to(torch.float32), step)
    assert bits_equal(got, want)
    assert native.launches["zr_atrous"] == before + (4 if step == "chain" else 1)
    assert not torch.equal(got, hdr)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATROUS_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_atrous_kernel_on_ragged_shapes(cuda, shape):
    """Steps 1-8 and the chain on images smaller than the taps' shifts and
    on ragged blocks, bit for bit against the plain pass."""
    img, nrm, depth, valid = atrous_case(*shape, seed=sum(shape), device=cuda)
    for step in (1, 2, 4, 8):
        want = DN.atrous_iteration_plain(img, nrm, depth, valid.to(torch.float32), step)
        assert bits_equal(DN.atrous_iteration_p(img, nrm, depth, valid, step), want), step
    assert bits_equal(DN.atrous_denoise_p(img, nrm, depth, valid),
                      DN.atrous_denoise_plain(img, nrm, depth, valid))


@pytest.mark.cuda
def test_atrous_kernel_reads_strided_planes(cuda):
    """Row and column slices of larger planes, as the row-band path slices
    its halo-extended guides: the kernel reads them through their strides,
    bit-equal to the plain pass on contiguous copies."""
    h, w = 40, 70
    big = atrous_case(h + 9, w + 6, seed=21, device=cuda)
    img, nrm, depth, valid = (t[..., 4 : 4 + h, 2 : 2 + w] for t in big)
    assert not any(t.is_contiguous() for t in (img, nrm, depth, valid))
    dense = [t.contiguous() for t in (img, nrm, depth, valid)]
    for step in (1, 2, 4, 8):
        want = DN.atrous_iteration_plain(*dense[:3], dense[3].to(torch.float32), step)
        assert bits_equal(DN.atrous_iteration_p(img, nrm, depth, valid, step), want), step


def atrous_bands(rank, world, init_method, cases):
    """A rank of ``test_atrous_bands_match_the_whole_image`` (``run_ranks``
    imports it from this module, which pytest puts on the path): each case
    {name: (img, nrm, depth, valid)} (numpy, the whole image) -> this
    rank's band of ``render.frame._atrous_band`` on the card (gloo)."""
    from zetaray_tpu_torch.parallel import mesh
    from zetaray_tpu_torch.render.frame import _Band, _atrous_band

    tiles = mesh.init_tiles(world, rank, init_method, "gloo", timeout=120.0)
    out = {}
    for name, arrays in cases.items():
        img, nrm, depth, valid = (torch.from_numpy(x).to(tiles.device) for x in arrays)
        h, w = depth.shape
        ctx = tiles.shard(h)
        rows = slice(ctx.row0, ctx.row0 + ctx.h_local)
        out[name] = _atrous_band(_Band(ctx, w, h, tiles.device), img[:, rows], nrm[:, rows],
                                 depth[rows], valid[rows]).cpu()
    return out


@pytest.mark.cuda
def test_atrous_bands_match_the_whole_image(cuda):
    """``render.frame._atrous_band`` over 2 row bands (2 gloo ranks on the
    card; bands of 40 rows, and of 6, under the widest pass's halo of 16)
    equals the whole image's a-trous bit for bit."""
    native.build()  # the ranks load this build
    cases = {f"{h}x37": [t.numpy() for t in atrous_case(h, 37, seed=h)] for h in (80, 12)}
    bands = run_ranks(f"{__name__}:atrous_bands", 2, (cases,), timeout=300, blocked=("jax",))
    for name, arrays in cases.items():
        whole = DN.atrous_denoise_p(*(torch.from_numpy(x).to(cuda) for x in arrays))
        got = torch.cat([torch.from_numpy(b[name]) for b in bands], 1).to(cuda)
        assert bits_equal(got, whole), name


@pytest.mark.cuda
def test_atrous_wrapper_rejects_bad_inputs(cuda):
    img, nrm, depth, valid = atrous_case(9, 11, seed=5, device=cuda)
    it = DN.atrous_iteration_p
    before = native.launches["zr_atrous"]
    with pytest.raises(TypeError):
        it(img.double(), nrm, depth, valid, 1)
    with pytest.raises(TypeError):
        it(img, nrm, depth, valid.to(torch.float32), 1)
    with pytest.raises(ValueError):
        it(img[0], nrm, depth, valid, 1)
    with pytest.raises(ValueError):
        it(img, nrm[:2], depth, valid, 1)
    with pytest.raises(ValueError):
        it(img, nrm, depth[:8], valid, 1)
    with pytest.raises(ValueError):
        it(img, nrm, depth.cpu(), valid, 1)
    with pytest.raises(ValueError):  # a column stride of 9
        it(img, nrm.transpose(1, 2).contiguous().transpose(1, 2), depth, valid, 1)
    assert native.launches["zr_atrous"] == before


# The path traces of the frames: the restir_di frame's (render.frame) and
# GI's initial samples (ops.restir_gi l2_cfg, with the first hit and every
# seventh ray parked, as GI parks its dead rays).
WAVEFRONT_CONFIGS = {
    "di": (PTConfig(max_bounces=4, min_emissive_bounce=2, min_nee_bounce=1), False),
    "gi": (PTConfig(max_bounces=1, min_emissive_bounce=1), True),
}


@pytest.fixture(scope="module")
def wavefront_scenes_1080p(tmp_path_factory):
    """The 139,266-triangle box and the 262,144-triangle hall on the card
    with their 1920x1080 camera rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    box_cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1920 / 1080)
    from chip_smoke import lamp_hall

    hall, hall_cam = lamp_hall(tmp_path_factory.mktemp("hall"))
    out = {}
    for name, cpu, cam in (("box139k", subdivide_scene(cornell_box(), 100_000), box_cam),
                           ("hall262k", hall, hall_cam)):
        scene = upload_scene(cpu, device=dev)
        assert scene.cluster_aabb is not None and not scene.has_cutout
        out[name] = (scene, *cam.generate_rays(1920, 1080, device=dev))
    return out


def _wavefront_both(scene, o, d, cfg, first_hit, pix0=0):
    """(kernel path, plain wavefront) of the same rays; GI's parks every
    seventh ray first."""
    if first_hit:
        o, d = PT.park(torch.arange(o.shape[0], device=o.device) % 7 != 3, o, d)
    got = PT.trace_reference(scene, o, d, SEED, cfg, return_first_hit=first_hit, pix0=pix0)
    want = PT.trace_reference_plain(scene, o, d, SEED, cfg, return_first_hit=first_hit,
                                    pix0=pix0)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["box139k", "hall262k"])
@pytest.mark.parametrize("config", sorted(WAVEFRONT_CONFIGS))
def test_wavefront_kernel_matches_plain_at_1080p(wavefront_scenes_1080p, scene_name, config):
    """trace_reference's kernel path (B8, the vertex kernel, B9 a bounce)
    against the plain wavefront on 1920x1080 camera rays: the radiance and
    the bounce-0 ShadedHit bit for bit; one vertex launch a bounce."""
    scene, o, d = wavefront_scenes_1080p[scene_name]
    cfg, first_hit = WAVEFRONT_CONFIGS[config]
    before = native.launches["zr_wavefront_vertex"]
    got, want = _wavefront_both(scene, o, d, cfg, first_hit)
    assert native.launches["zr_wavefront_vertex"] == before + cfg.max_bounces + 1
    if first_hit:
        (got, sh_got), (want, sh_want) = got, want
        for a, b in zip(sh_got, sh_want):
            assert a.dtype == b.dtype and bits_equal(a, b)
    assert bits_equal(got, want)
    assert (want.sum(1) > 0).float().mean().item() > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 1920 * 1080 - 37])
def test_wavefront_kernel_on_ragged_shapes(wavefront_scenes_1080p, n):
    """Ray counts that fill no whole block, and a row band's pixel offset:
    bit for bit against the plain wavefront (the DI configuration)."""
    scene, o, d = wavefront_scenes_1080p["box139k"]
    cfg, _ = WAVEFRONT_CONFIGS["di"]
    pix0 = 1920 * 1080 - n
    got, want = _wavefront_both(scene, o[pix0:].contiguous(), d[pix0:].contiguous(), cfg, False,
                                pix0=pix0)
    assert bits_equal(got, want)


@pytest.mark.cuda
def test_wavefront_wrapper_rejects_bad_inputs(wavefront_scenes_1080p):
    scene, o, d = wavefront_scenes_1080p["box139k"]
    o, d = o[:256].contiguous(), d[:256].contiguous()
    cfg = PTConfig(max_bounces=1)
    n, dev = o.shape[0], o.device
    state = torch.empty((PT.WF_ROWS, n), device=dev)
    rows = [torch.empty((n, 3), device=dev) for _ in range(5)]
    tri = torch.zeros((n,), dtype=torch.int32, device=dev)
    before = native.launches["zr_wavefront_vertex"]
    bad = [
        dict(tri=tri.long()), dict(tri=tri[:-1]), dict(o=o.cpu()), dict(state=state[:-1]),
        dict(occluded=torch.zeros((n,), dtype=torch.int32, device=dev)),
        dict(o=o.T.contiguous().T),
    ]
    for change in bad:
        args = dict(o=o, d=d, tri=tri, occluded=None, smb_kill=None, state=state, rad=rows[0],
                    o_next=rows[1], d_next=rows[2], seg_o=rows[3], seg_d=rows[4],
                    first_hit=None)
        args.update(change)
        with pytest.raises((TypeError, ValueError)):
            PT.wavefront_vertex(scene, bounce=0, seed=SEED, cfg=cfg, **args)
    with pytest.raises(RuntimeError):  # a first hit past bounce 0: the entry point refuses
        PT.wavefront_vertex(scene, o, d, tri, None, None, state, *rows,
                            (torch.empty((n,), device=dev),) * 3
                            + (torch.empty((PT.A.WIDTH, n), device=dev),), 1, SEED, cfg)
    assert native.launches["zr_wavefront_vertex"] == before
