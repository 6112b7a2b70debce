"""Textures of the PyTorch port against the JAX package's
``scene/textures.py`` and the emissive-texture power round trip of
``ops/prelighting.py``.

The host side (mips, PNG decode, the scene bundle and its carry-over from
JAX) is held bit for bit. The fetches compute the same float operations in
another order of launches (the port gathers the two levels a ray blends
from one packed table), so they are held to 1e-5 relative; the powers too.
Inputs come from numpy with a seed; PNG files are written to ``tmp_path``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.ops import prelighting as JPL
from zetaray_tpu.scene import textures as JT
from zetaray_tpu.utils.png import write_png as jax_write_png
from zetaray_tpu_torch.accel.megakernel import G
from zetaray_tpu_torch.interop import scene_from_arrays
from zetaray_tpu_torch.ops import prelighting as TPL
from zetaray_tpu_torch.scene import textures as TT
from zetaray_tpu_torch.scene.procedural import CHECKER, TEX_CHECKER, textured_box
from zetaray_tpu_torch.scene.scene import EA, upload_scene
from zetaray_tpu_torch.utils.png import read_png, write_png
from tests.test_prelighting import _textured_light_scene
from tests.test_torch_scene import jax_scene_arrays, to_jax_cpu_scene, to_port_cpu_scene

torch.set_num_threads(1)

RTOL = 1e-5


def _jax_bundle_numpy(bundle):
    """A JAX bundle with its mips as numpy arrays."""
    out = {"ids": {k: np.asarray(v) for k, v in bundle["ids"].items()}}
    for slot, _, _ in TT.SLOTS:
        out[slot] = {i: [np.asarray(m) for m in mips] for i, mips in bundle[slot].items()}
    return out


def _assert_bundles_equal(port, jax_np):
    assert sorted(port["ids"]) == sorted(jax_np["ids"])
    for slot, ids in jax_np["ids"].items():
        np.testing.assert_array_equal(port["ids"][slot].numpy(), ids)
    for slot, _, _ in TT.SLOTS:
        assert sorted(port[slot]) == sorted(jax_np[slot]), slot
        for i, mips in jax_np[slot].items():
            assert len(port[slot][i]) == len(mips)
            for a, b in zip(port[slot][i], mips):
                np.testing.assert_array_equal(a.numpy(), b)


def test_png_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for c in (3, 4):
        img = rng.integers(0, 256, (13, 21, c), dtype=np.uint8)
        write_png(str(tmp_path / f"p{c}.png"), img)
        jax_write_png(str(tmp_path / f"j{c}.png"), img)
        assert (tmp_path / f"p{c}.png").read_bytes() == (tmp_path / f"j{c}.png").read_bytes()
        np.testing.assert_array_equal(read_png(str(tmp_path / f"j{c}.png")), img)


@pytest.mark.parametrize("shape", [(37, 20, 4), (64, 64, 4), (1, 9, 4)])
def test_build_mips_bit_exact(shape):
    img = np.random.default_rng(5).random(shape).astype(np.float32)
    want, got = JT.build_mips(img), TT.build_mips(img)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("srgb", [True, False])
def test_load_texture_bit_exact(tmp_path, srgb, channels):
    img = np.random.default_rng(channels).integers(0, 256, (40, 40, channels), dtype=np.uint8)
    path = tmp_path / "t.png"
    write_png(str(path), img)
    want, got = JT.load_texture(path, srgb=srgb), TT.load_texture(path, srgb=srgb)
    assert len(got) == len(want) == 6  # 40, 20, 10, 5, 2, 1
    for a, b in zip(got, want):
        assert a.shape[-1] == 4
        np.testing.assert_array_equal(a, b)


def test_missing_texture_is_none_and_dds_raises(tmp_path):
    assert TT.load_texture(tmp_path / "absent.png") is None
    # a DDS file whose header names no BC format (the decoder reads them
    # since the BCn port; tests/test_torch_bcn.py holds it to JAX's)
    (tmp_path / "t.dds").write_bytes(b"DDS " + bytes(144))
    with pytest.raises(NotImplementedError, match="fourcc"):
        TT.load_texture(tmp_path / "t.dds")


def _shared_box(tmp_path):
    """textured_box with the checker also the short block's emissive map
    (the same path and colour space in two slots: one decode)."""
    cpu = textured_box(tmp_path)
    cpu.materials.emissive_tex[CHECKER] = TEX_CHECKER
    return cpu


def test_load_scene_textures_bit_exact(tmp_path):
    cpu = _shared_box(tmp_path)
    want = _jax_bundle_numpy(JT.load_scene_textures(to_jax_cpu_scene(cpu)))
    got = TT.load_scene_textures(cpu, device="cpu")
    _assert_bundles_equal(got, want)
    assert all(len(got[s]) == 1 for s in ("base", "normal", "mr"))
    assert sorted(got["emissive"]) == [0, 3]
    assert got["emissive"][0] is got["base"][0]  # one decode per (path, colour space)
    assert isinstance(got["base"][0], TT.MipChain)


def test_textures_from_arrays_bit_exact(tmp_path):
    cpu = _shared_box(tmp_path)
    want = _jax_bundle_numpy(JT.load_scene_textures(to_jax_cpu_scene(cpu)))
    _assert_bundles_equal(TT.textures_from_arrays(want, device="cpu"), want)
    flat = TT.textures_from_arrays({2: want["base"][0][0], 5: want["base"][0]}, device="cpu")
    assert len(flat[2]) == 1 and len(flat[5]) == len(want["base"][0])
    np.testing.assert_array_equal(flat[2][0].numpy(), want["base"][0][0])


def _chains():
    rng = np.random.default_rng(11)
    return {"square": TT.build_mips(rng.random((64, 64, 4)).astype(np.float32)),
            "npot": TT.build_mips(rng.random((24, 24, 4)).astype(np.float32)),
            "single": [rng.random((5, 7, 4)).astype(np.float32)]}


@pytest.mark.parametrize("name", ["square", "npot", "single"])
def test_sampling_matches_jax(name):
    """Bilinear at every level and trilinear at random uv (wrapping) and
    levels, below 0 and above the last level too: 1e-5."""
    mips = _chains()[name]
    rng = np.random.default_rng(len(mips))
    n = 4096
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lam = rng.uniform(-2.0, len(mips) + 1.0, n).astype(np.float32)
    lam[:64] = np.arange(64) % len(mips)  # whole levels
    for m in mips:
        want = np.asarray(JT.sample_bilinear(jnp.asarray(m), jnp.asarray(uv)))
        got = TT.sample_bilinear(torch.from_numpy(m), torch.from_numpy(uv)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    want = np.asarray(JT.sample_trilinear([jnp.asarray(m) for m in mips], jnp.asarray(uv),
                                          jnp.asarray(lam)))
    chain = TT.MipChain(torch.from_numpy(m) for m in mips)
    for arg in (chain, list(chain)):  # packed once, or packed per call
        got = TT.sample_trilinear(arg, torch.from_numpy(uv), torch.from_numpy(lam)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_empty_mip_levels_raise():
    """build_mips of an image that is not square ends in empty levels (as
    in JAX, whose fetch then fails): the port's fetch refuses the chain."""
    mips = TT.build_mips(np.ones((12, 40, 4), np.float32))
    assert min(m.size for m in mips) == 0
    assert [m.shape for m in mips] == [m.shape for m in JT.build_mips(np.ones((12, 40, 4),
                                                                              np.float32))]
    with pytest.raises(ValueError, match="empty level"):
        TT.sample_trilinear([torch.from_numpy(m) for m in mips], torch.zeros((4, 2)),
                            torch.zeros(4))


def _random_gbuffer(n, n_mats, seed=2):
    """A G-buffer with random rows: unit normals and tangents drawn
    independently (so a normal-map tilt falls below the geometric normal
    on some pixels), random uv, depth, uv density, material and validity."""
    rng = np.random.default_rng(seed)
    gb = np.zeros((G.ROWS, n), np.float32)

    def unit():
        v = rng.normal(size=(3, n))
        return v / np.linalg.norm(v, axis=0)

    gb[G.NS : G.NS + 3] = unit()
    gb[G.NG : G.NG + 3] = unit()
    gb[G.TANG : G.TANG + 3] = unit()
    gb[G.BASE : G.BASE + 3] = rng.random((3, n))
    gb[G.METAL] = rng.random(n)
    gb[G.ROUGH] = rng.random(n)
    gb[G.EMISS : G.EMISS + 3] = rng.random((3, n)) * 4.0
    gb[G.UV : G.UV + 2] = rng.uniform(-0.5, 1.5, (2, n))
    gb[G.DEPTH] = rng.uniform(0.0, 8.0, n)
    gb[G.UVDENS] = rng.uniform(0.0, 3.0, n)
    gb[G.MATID] = rng.integers(-1, n_mats, n)
    gb[G.TEXID] = rng.integers(-1, 3, n)
    gb[G.VALID] = rng.random(n) < 0.9
    return gb


def test_apply_texture_maps_matches_jax(tmp_path):
    """All four slots on a random G-buffer at a 512^2 pixel spread: 1e-5.
    Some pixels take the normal map's fallback (the tilted normal below the
    geometric one keeps the shading normal)."""
    cpu = textured_box(tmp_path)
    jtex = JT.load_scene_textures(to_jax_cpu_scene(cpu))
    ttex = TT.load_scene_textures(cpu, device="cpu")
    gb = _random_gbuffer(8192, len(cpu.materials.metallic))
    spread = 0.0015
    want = np.asarray(JT.apply_texture_maps(jnp.asarray(gb), jtex, spread))
    got = TT.apply_textures_to_gbuffer(torch.from_numpy(gb), ttex, spread).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    matid = np.maximum(gb[G.MATID].astype(np.int32), 0)
    normal_px = (gb[G.VALID] > 0.5) & (cpu.materials.normal_tex[matid] >= 0)
    kept = np.all(got[G.NS : G.NS + 3] == gb[G.NS : G.NS + 3], 0)
    assert (normal_px & kept).sum() > 50 and (normal_px & ~kept).sum() > 50
    for rows in (slice(G.BASE, G.BASE + 3), slice(G.METAL, G.ROUGH + 1),
                 slice(G.EMISS, G.EMISS + 3)):
        assert (got[rows] != gb[rows]).any()


def test_flat_base_dict_and_base_color_at_match_jax(tmp_path):
    """The flat {index: mips} form picked by G.TEXID, and the path-vertex
    fetch base_color_at (bundle and flat forms), at random cones: 1e-5."""
    cpu = textured_box(tmp_path)
    jtex = JT.load_scene_textures(to_jax_cpu_scene(cpu))
    ttex = TT.load_scene_textures(cpu, device="cpu")
    chains = _chains()
    flat_np = {0: chains["square"], 2: chains["single"][0]}
    flat_j = {0: [jnp.asarray(m) for m in chains["square"]], 2: jnp.asarray(chains["single"][0])}
    flat_t = TT.textures_from_arrays(flat_np, device="cpu")
    gb = _random_gbuffer(4096, 4, seed=9)
    want = np.asarray(JT.apply_textures_to_gbuffer(jnp.asarray(gb), flat_j, 0.003))
    got = TT.apply_textures_to_gbuffer(torch.from_numpy(gb), flat_t, 0.003).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)

    rng = np.random.default_rng(4)
    n = 4096
    uv = rng.uniform(-1.0, 2.0, (n, 2)).astype(np.float32)
    texid = rng.integers(-1, 3, n).astype(np.float32)
    cone = rng.uniform(0.0, 0.05, n).astype(np.float32)
    dens = rng.uniform(0.0, 2.0, n).astype(np.float32)
    for j_arg, t_arg in ((jtex, ttex), (flat_j, flat_t)):
        want = np.asarray(JT.base_color_at(j_arg, jnp.asarray(uv), jnp.asarray(texid),
                                           jnp.asarray(cone), jnp.asarray(dens)))
        got = TT.base_color_at(t_arg, *(torch.from_numpy(x) for x in (uv, texid, cone, dens)))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
        assert (got.numpy() != 1.0).any() and (got.numpy() == 1.0).any()
    assert TT.base_color_at({}, *(torch.from_numpy(x) for x in (uv, texid, cone, dens))) is None


def _round_trip_pair(jcpu, jdev, jtex, n_samples):
    """The power round trip on both sides of one scene: (JAX scene after it,
    port scene after it, JAX powers and means, port powers and means)."""
    tdev = upload_scene(to_port_cpu_scene(jcpu), device="cpu")
    ttex = TT.textures_from_arrays(_jax_bundle_numpy(jtex), device="cpu")
    pj, mj = JPL.estimate_tri_power(jdev, jtex, n_samples=n_samples)
    pt, mt = TPL.estimate_tri_power(tdev, ttex, n_samples=n_samples)
    return (JPL.apply_tri_powers(jdev, pj, mj), TPL.apply_tri_powers(tdev, pt, mt),
            (np.asarray(pj), np.asarray(mj)), (pt.numpy(), mt.numpy()))


@pytest.mark.parametrize("n_samples", [64, 256])
def test_power_round_trip_matches_jax(n_samples):
    """tests/test_prelighting.py's textured light scene: the powers and the
    mean texture to 1e-5, the rebuilt alias tables exactly, the pdf rows
    and the scaled radiance to 1e-5."""
    jcpu, jdev, jtex = _textured_light_scene()
    jtex = dict(jtex, emissive={0: [jnp.asarray(np.asarray(m)) for m in jtex["emissive"][0]]})
    js, ts, (pj, mj), (pt, mt) = _round_trip_pair(jcpu, jdev, jtex, n_samples)
    np.testing.assert_allclose(pt, pj, rtol=RTOL)
    np.testing.assert_allclose(mt, mj, rtol=RTOL)
    assert 0.4 < mt.mean() < 0.6
    # rebuilt from the same powers the tables agree exactly
    js2 = JPL.apply_tri_powers(jdev, pj, mj)
    ts2 = TPL.apply_tri_powers(upload_scene(to_port_cpu_scene(jcpu), device="cpu"), pj, mj)
    for k in ("em_prob", "em_alias", "em_pdf", "em_attrs", "tri_attrs", "em_power"):
        np.testing.assert_array_equal(getattr(ts2, k).numpy(), np.asarray(getattr(js2, k)), k)
    for k in ("em_prob", "em_pdf", "em_power"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=RTOL)
    np.testing.assert_array_equal(ts.em_alias.numpy(), np.asarray(js.em_alias))
    e = ts.num_emissives
    np.testing.assert_allclose(ts.em_attrs[:e, EA.LE : EA.LE + 3].numpy(),
                               np.asarray(js.em_attrs[:e, EA.LE : EA.LE + 3]), rtol=RTOL)


def test_textured_box_power_round_trip_matches_jax(tmp_path):
    """The textured box's striped light: its power drops to the stripes'
    mean on both sides (1e-5), the untextured estimate is the upload's."""
    cpu = textured_box(tmp_path)
    jcpu = to_jax_cpu_scene(cpu)
    from zetaray_tpu.scene.scene import upload_scene as jax_upload

    jdev = jax_upload(jcpu)
    jtex = JT.load_scene_textures(jcpu)
    js, ts, (pj, mj), (pt, mt) = _round_trip_pair(jcpu, jdev, jtex, 64)
    np.testing.assert_allclose(pt, pj, rtol=RTOL)
    np.testing.assert_allclose(mt, mj, rtol=RTOL)
    p0, m0 = TPL.estimate_tri_power(upload_scene(cpu, device="cpu"))
    np.testing.assert_allclose(m0.numpy(), 1.0)
    assert (pt < 0.8 * p0.numpy()).all()
    port_of_jax = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    for k in ("em_prob", "em_alias", "em_attrs", "tri_attrs"):
        np.testing.assert_array_equal(getattr(port_of_jax, k).numpy(), np.asarray(getattr(js, k)))
    assert dataclasses.is_dataclass(ts) and ts.num_emissives == 2


def test_kernel_cone_spread_is_whole_microradians():
    """B4 widens the ray cone by the spread as the JAX kernels carry it,
    whole micro-radians (``megakernel.cone_spread``); ``trace_reference``
    and ReSTIR PT's cones take the spread as given (ROADMAP.md section C)."""
    from zetaray_tpu_torch.accel import megakernel as MK
    from zetaray_tpu_torch.ops.pathtracer import PTConfig
    from zetaray_tpu_torch.scene.procedural import cornell_box

    spread = 0.0015339808  # a 512^2 camera's pixel spread
    assert MK.cone_spread(spread) == float(np.float32(1533) * np.float32(1e-6)) != spread
    scene = upload_scene(cornell_box(), device="cpu")
    o = torch.tensor([[0.0, 1.0, 3.5]]).expand(64, 3).contiguous()
    g = torch.Generator().manual_seed(1)
    d = torch.nn.functional.normalize(torch.randn(64, 3, generator=g) * 0.2
                                      - torch.tensor([0.0, 0.0, 1.0]), dim=1)
    st, _ = MK.bounce_trace(scene, MK.initial_state(o, d), 0, PTConfig(), True, spread)
    t = MK.closest_hit_plain(scene.woop, o, d)[0]
    found = st[13] > 0.5
    assert found.float().mean() > 0.8
    torch.testing.assert_close(st[15], torch.where(found, t * MK.cone_spread(spread), 0.0),
                               rtol=0, atol=0)
