"""The animation rig of the PyTorch port against the JAX package: channel
sampling (STEP, LINEAR with slerp, CUBICSPLINE), the node hierarchy's
instance worlds, the rest -> t deltas and ``transform_deltas``, on the glTF
files of tests/test_torch_gltf.py and on random channels.

Tolerance: 1e-12 in float64 (the deltas, float32 in both, are equal).
"""

import numpy as np
import pytest

from zetaray_tpu.scene import animation as JA
from zetaray_tpu.scene import gltf as JG
from zetaray_tpu_torch.scene import animation as TA
from zetaray_tpu_torch.scene import gltf as TG
from tests.test_torch_gltf import FILES

TOL = 1e-12
TIMES = [-0.5, 0.0, 0.1, 0.5, 0.999, 1.0, 1.3, 2.0, 2.49, 2.5, 3.7, 7.25]


def _channels(r):
    """Random channels of each path and interpolation, in both packages."""
    out = []
    for path, width in (("translation", 3), ("rotation", 4), ("scale", 3)):
        for interp in ("STEP", "LINEAR", "CUBICSPLINE"):
            k = 4
            times = np.sort(r.uniform(0, 3, k)).astype(np.float32)
            shape = (k, 3, width) if interp == "CUBICSPLINE" else (k, width)
            vals = r.normal(size=shape).astype(np.float32)
            if path == "rotation":
                vals /= np.linalg.norm(vals, axis=-1, keepdims=True)
            out.append(tuple(mod.GltfChannel(node=0, path=path, times=times, values=vals,
                                             interpolation=interp) for mod in (TG, JG)))
    # near-parallel keys take slerp's lerp branch; opposite ones its shortest arc
    q = np.array([[0, 0, 0, 1], [0, 1e-3, 0, 1], [0, 0, 0, -1]], np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.array([0, 1, 2], np.float32)
    out.append(tuple(mod.GltfChannel(node=0, path="rotation", times=t, values=q,
                                     interpolation="LINEAR") for mod in (TG, JG)))
    return out


def test_sample_channel_matches_jax():
    r = np.random.default_rng(12)
    for ch_t, ch_j in _channels(r):
        for t in TIMES + list(ch_t.times) + list(r.uniform(-1, 4, 16)):
            got, want = TA.sample_channel(ch_t, t), JA.sample_channel(ch_j, t)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                       err_msg=f"{ch_t.path} {ch_t.interpolation} t={t}")
    one = TG.GltfChannel(node=0, path="scale", times=np.zeros(1, np.float32),
                         values=np.ones((1, 3), np.float32), interpolation="LINEAR")
    np.testing.assert_array_equal(TA.sample_channel(one, 5.0), np.ones(3))
    with pytest.raises(ValueError):
        TA.sample_channel(TG.GltfChannel(0, "scale", np.zeros(0, np.float32),
                                         np.zeros((0, 3), np.float32), "LINEAR"), 0.0)


@pytest.mark.parametrize("name", sorted(FILES))
def test_rig_matches_jax(tmp_path, name):
    """instance_worlds and deltas (looped and not) at each time, and the
    rig's duration and animated flag."""
    path = FILES[name](tmp_path)
    rig_t, rig_j = TA.AnimationRig(TG.load_gltf(path)), JA.AnimationRig(JG.load_gltf(path))
    assert rig_t.animated and rig_t.animated == rig_j.animated
    assert rig_t.duration == rig_j.duration > 0
    np.testing.assert_array_equal(rig_t.rest_worlds, rig_j.rest_worlds)
    for t in TIMES:
        for loop in (True, False):
            np.testing.assert_allclose(rig_t.instance_worlds(t, loop),
                                       rig_j.instance_worlds(t, loop), rtol=0, atol=TOL)
            for got, want in zip(rig_t.deltas(t, loop), rig_j.deltas(t, loop)):
                assert got.dtype == want.dtype == np.float32
                assert got.shape[0] == rig_t.rest_worlds.shape[0] + 1
                np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the rest pose's deltas are the identity; a clip's end differs from its start
    dp, dn = rig_t.deltas(0.0)
    np.testing.assert_allclose(dp[:, :, :3], np.tile(np.eye(3), (dp.shape[0], 1, 1)), atol=1e-6)
    assert not np.allclose(rig_t.instance_worlds(1.0), rig_t.instance_worlds(0.0))
    assert not TA.AnimationRig(TG.load_gltf(path), animation=5).animated


def test_transform_deltas_matches_jax():
    """D_i = to_i @ from_i^-1 and its normal matrix, identity row
    appended, on random affine worlds; applied to from_i's points it gives
    to_i's."""
    from zetaray_tpu_torch.core import transforms as TT

    r = np.random.default_rng(5)
    def worlds(n):
        return np.stack([TT.trs_to_mat4(r.normal(size=3), r.normal(size=4),
                                        r.uniform(0.5, 2, 3)) for _ in range(n)])
    a, b = worlds(6), worlds(6)
    for got, want in zip(TA.transform_deltas(a, b), JA.transform_deltas(a, b)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    dp, dn = TA.transform_deltas(a, b)
    p = r.normal(size=(5, 3))
    for i in range(6):
        moved = TT.transform_points(a[i], p) @ dp[i, :, :3].T + dp[i, :, 3]
        np.testing.assert_allclose(moved, TT.transform_points(b[i], p), atol=1e-4)
        np.testing.assert_allclose(dn[i], np.linalg.inv(dp[i, :, :3]).T, atol=1e-4)
    np.testing.assert_array_equal(dp[6, :, :3], np.eye(3))
    np.testing.assert_array_equal(dp[6, :, 3], np.zeros(3))
    empty = TA.transform_deltas(np.zeros((0, 4, 4)), np.zeros((0, 4, 4)))
    assert empty[0].shape == (1, 3, 4) and empty[1].shape == (1, 3, 3)
