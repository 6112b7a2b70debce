"""The sun and sky of the PyTorch port (``ops/sky.py``) against the JAX
package's ``ops/sky.py``, on the same directions (unit vectors from a
seeded numpy generator).

What must agree, and how closely:

- ``sky_radiance`` and ``sun_irradiance``: to rtol 1e-5 (the closed form
  goes through sqrt and one division, which XLA and PyTorch round alike;
  XLA may fuse a multiply-add);
- ``sun_disk``, and ``sky_radiance`` with its disk: exactly 0 outside the
  disk and to rtol 1e-5 inside it, on directions off its rim. On the rim
  the edge ramp multiplies the cosine by about 3.7e5, so one float32 ulp of
  the cosine moves the radiance by about 1e3: the rim is left out;
- the sky-view LUT (32x16 texels, 8 steps): to rtol 3e-3 and atol 1e-5.
  The march's altitude is r - 6360 km, with r the square root of a sum
  near 4e7 km^2, whose float32 ulp (4 km^2) moves the altitude by 3e-4 km;
  XLA fuses that sum's multiply-adds and PyTorch does not, and exp, sin and
  cos round differently by an ulp, as do the two linspaces. Rays that reach the ground within a few
  hundred metres feel it most (0.24% at one row of texels);
  ``sample_sky_lut`` reads the same texel on at least 99.9% of the
  directions and agrees there to rtol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.core.vec3 import V3 as JV3
from zetaray_tpu.ops import sky as JSK
from zetaray_tpu_torch.core.vec3 import V3 as TV3
from zetaray_tpu_torch.ops import sky as TSK

torch.set_num_threads(1)

SUNS = [(0.32, 0.92, 0.22), (0.2, 0.45, 0.87), (0.0, 1.0, 0.0), (-0.5, 0.1, -0.3)]


def _dirs(seed, n=4096):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _disk_dirs(sun, params, seed):
    """Directions inside the sun disk's core (edge 1), just outside it
    (edge 0), and random ones: none on the rim."""
    s = np.asarray(sun, np.float64)
    s /= np.linalg.norm(s)
    r = np.random.default_rng(seed)
    t = np.cross(s, [0.3, 0.5, 0.81])
    t /= np.linalg.norm(t)
    b = np.cross(s, t)
    rad = params.sun_angular_radius
    out = []
    for ang in (0.0, 0.3 * rad, 0.6 * rad, 1.5 * rad, 3.0 * rad):
        phi = r.uniform(0, 2 * np.pi, 64)
        dd = (np.cos(ang) * s[None] + np.sin(ang) * (np.cos(phi)[:, None] * t
                                                      + np.sin(phi)[:, None] * b))
        out.append(dd)
    out.append(_dirs(seed))
    return np.concatenate(out).astype(np.float32)


def _params(sun):
    return JSK.SkyParams(sun_dir=sun), TSK.SkyParams(sun_dir=sun)


def test_sky_params_match():
    assert TSK.SkyParams() == TSK.SkyParams(**vars(JSK.SkyParams()))
    assert TSK.SUN_RADIANCE_SCALE == JSK.SUN_RADIANCE_SCALE
    assert TSK.SUN_COLOR == JSK.SUN_COLOR


@pytest.mark.parametrize("sun", SUNS)
@pytest.mark.parametrize("with_disk", [False, True])
def test_sky_radiance_matches_jax(sun, with_disk):
    jp, tp = _params(sun)
    d = _disk_dirs(sun, jp, 3)
    want = JSK.sky_radiance(JV3(*map(jnp.asarray, d.T)), jp, with_disk=with_disk)
    got = TSK.sky_radiance(TV3(*map(torch.from_numpy, d.T.copy())), tp, with_disk=with_disk)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    if with_disk:  # the disk's core is 50000 * SUN_COLOR above the sky
        assert float(got.x[:128].min()) > 4e4


@pytest.mark.parametrize("sun", SUNS)
def test_sun_disk_and_irradiance_match_jax(sun):
    jp, tp = _params(sun)
    d = _disk_dirs(sun, jp, 4)
    want = np.asarray(JSK.sun_disk(jnp.asarray(d), jp))
    got = TSK.sun_disk(torch.from_numpy(d), tp).numpy()
    assert got.shape == want.shape == (d.shape[0], 3)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (want[:192] > 0).all() and (want[192:] == 0).all()
    np.testing.assert_array_equal(TSK.sun_irradiance(tp), JSK.sun_irradiance(jp))
    np.testing.assert_array_equal(TSK.sun_direction(tp),
                                  (np.asarray(sun) / np.linalg.norm(sun)).astype(np.float32))


@pytest.mark.parametrize("sun", SUNS[:2])
def test_sky_view_lut_and_sampling_match_jax(sun):
    jp, tp = _params(sun)
    want = np.array(JSK.build_sky_view_lut(jp, width=32, height=16, steps=8))
    got = TSK.build_sky_view_lut(tp, width=32, height=16, steps=8).numpy()
    assert got.shape == want.shape == (16, 32, 3)
    assert want.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=1e-5)
    d = _disk_dirs(sun, jp, 5)
    s_want = np.asarray(JSK.sample_sky_lut(jnp.asarray(want), jnp.asarray(d), jp))
    s_got = TSK.sample_sky_lut(torch.from_numpy(want), torch.from_numpy(d), tp).numpy()
    same = np.isclose(s_got, s_want, rtol=1e-5, atol=1e-7).all(-1)
    assert same.mean() >= 0.999
    assert (s_want[:192] > 4e4).all()  # the disk on top of the LUT
