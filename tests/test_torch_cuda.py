"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import nothing
of JAX, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from zetaray_tpu_torch.accel import intersect as XI
from zetaray_tpu_torch.accel import megakernel as MK
from zetaray_tpu_torch.ops import restir_di as RD
from zetaray_tpu_torch.render.frame import RenderConfig, pick_rt, render_frame_restir
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from zetaray_tpu_torch.scene.scene import upload_scene

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
    before = MK.gbuffer.launches
    gk = MK.gbuffer(scene, o, d)
    gp = MK.gbuffer_plain(scene, o, d)
    torch.cuda.synchronize()
    assert MK.gbuffer.launches == before + 1
    for r in (MK.G.VALID, MK.G.MATID, MK.G.INST):
        assert torch.equal(gk[r], gp[r])
    hit = gp[MK.G.VALID] > 0.5
    torch.testing.assert_close(gk[:, hit], gp[:, hit], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ris_and_occlusion_kernels_match_plain(cuda):
    scene = upload_scene(cornell_box(subdivide_to=1000), device=cuda)
    _, o, d = _rays(cuda)
    gb = MK.gbuffer(scene, o, d)
    lsets = MK.build_light_sets(scene, SEED)
    rt = pick_rt(gb.shape[1])
    rk = RD.initial_candidates(gb, lsets, SEED, rt=rt)
    rp = RD.initial_candidates_plain(gb, lsets, SEED, rt)
    same = (rk[0:3] == rp[0:3]).all(0)
    assert same.float().mean() >= 0.995
    torch.testing.assert_close(rk[:, same], rp[:, same], rtol=1e-5, atol=1e-6)
    so = (gb[MK.G.POS : MK.G.POS + 3] + 1e-3 * gb[MK.G.NG : MK.G.NG + 3]).T.contiguous()
    seg = (rk[0:3] - gb[MK.G.POS : MK.G.POS + 3]).T.contiguous()
    ok = XI.occlusion(scene.woop, so, seg, 1e-3, 1.0 - 1e-3)
    assert torch.equal(ok, XI.occlusion_plain(scene.woop, so, seg, 1e-3, 1.0 - 1e-3))
    assert 0 < ok.sum() < ok.numel()


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    scene = upload_scene(cornell_box(), device=cuda)
    _, o, d = _rays(cuda, 8)
    with pytest.raises(ValueError):
        MK.gbuffer(scene, o.T.contiguous().T, d)  # not contiguous
    with pytest.raises(TypeError):
        XI.occlusion(scene.woop, o.double(), d.double())


@pytest.mark.cuda
def test_card_frame_matches_cpu_frame(cuda):
    """Two chained 32^2 frames through the kernels on the card and through
    the plain versions on the CPU."""
    cfg = RenderConfig(width=32, height=32, mode="restir_gi", indirect=False, denoise=True,
                       taa=True)
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
