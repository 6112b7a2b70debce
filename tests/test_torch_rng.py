"""pcg4d and uniform4 of the PyTorch port against the JAX package, bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zetaray_tpu.core import rng as jrng
from zetaray_tpu_torch.core import rng as trng

torch.set_num_threads(1)

# every salt the DI slice draws with: RIS pick, light sets, temporal, spatial
SALTS = [0, 0x51E5, 0xBEEF, 0x7E17, 0x5A71]


def test_pcg4d_lanes_bit_exact():
    r = np.random.default_rng(3)
    lanes = [r.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32) for _ in range(4)]
    lanes[2][:8] = np.arange(2**32 - 8, 2**32, dtype=np.uint64).astype(np.uint32)
    want = jrng.pcg4d_lanes(*(jnp.asarray(x) for x in lanes))
    got = trng.pcg4d_lanes(*(torch.from_numpy(x.astype(np.int64)) for x in lanes))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("bounce", [0, 1, 15])
def test_uniform4_bit_exact(salt, bounce):
    r = np.random.default_rng(salt + bounce)
    pix = r.integers(0, 2**31 - 1, 2048).astype(np.int32)
    pix[:4] = [0, 1, 2**31 - 1, 262143]
    for seed in (0, 12345, 2**32 - 1, 2**32 - 77,
                 int(jrng.seed_from_key(jax.random.PRNGKey(7)))):
        want = jrng.uniform4(jnp.asarray(pix), bounce, jnp.uint32(seed), salt)
        got = trng.uniform4(torch.from_numpy(pix), bounce, seed, salt)
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_uniform4_tensor_seed_bit_exact(dtype):
    """Per-pixel seeds, as ReSTIR PT's replay draws them from the SRCSEED
    row: u32 values in int64, or their bits in int32 (the row viewed as
    int32), including seeds whose bits form a float NaN."""
    r = np.random.default_rng(11)
    pix = r.integers(0, 2**24, 4096).astype(np.int32)
    seeds = r.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    seeds[:6] = [0, 1, 2**31, 2**32 - 1, 0x7FC00001, 0xFF800001]
    want = jrng.uniform4(jnp.asarray(pix), 201, jnp.asarray(seeds), 0x9717)
    t_seeds = torch.from_numpy(seeds.view(np.int32).copy() if dtype == torch.int32
                               else seeds.astype(np.int64))
    got = trng.uniform4(torch.from_numpy(pix), 201, t_seeds, 0x9717)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
