"""The port's row-halo exchange (``parallel/halo.py``) against the JAX
package's, on gloo ranks on the CPU.

Each world (2 and 4 ranks) runs every case once in fresh processes
(``parallel.mesh.run_ranks``, a file store, JAX unimportable there:
``tests/torch_ranks.py``); the JAX functions run under ``jax.shard_map``
on the conftest's 8-device CPU mesh. A band holds 4 rows; the cases cover
row axes 0 and 1, halos no taller and taller than a band (up to 16 rows,
a-trous's widest pass: 4 hops, past the whole image at world 2), the
flat SoA form and the edge-clamped form. The exchange moves data only, so
every band must equal JAX's exactly.
"""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from zetaray_tpu.parallel import halo as JH
from zetaray_tpu_torch.parallel.mesh import run_ranks
from tests.torch_ranks import BLOCKED

ROWS = 4  # rows a band
WORLDS = (2, 4)
# name: (halo, row axis, kind, shape of the whole image with H at the row axis)
CASES = {
    "rows_axis0_halo2": (2, 0, "rows", lambda h: (h, 5)),
    "rows_axis0_halo6": (6, 0, "rows", lambda h: (h, 5)),
    "rows_axis0_halo16": (16, 0, "rows", lambda h: (h, 3)),
    "rows_axis1_halo1": (1, 1, "rows", lambda h: (3, h, 6)),
    "rows_axis1_halo5": (5, 1, "rows", lambda h: (3, h, 6)),
    "clamped_axis1_halo1": (1, 1, "clamped", lambda h: (3, h, 6)),
    "clamped_axis1_halo7": (7, 1, "clamped", lambda h: (3, h, 6)),
    "clamped_axis0_halo2": (2, 0, "clamped", lambda h: (h, 6)),
    "flat_halo2": (2, 1, "flat", lambda h: (5, h * 6)),
    "flat_halo9": (9, 1, "flat", lambda h: (5, h * 6)),
}


def _data(name, world):
    halo, axis, kind, shape = CASES[name]
    r = np.random.default_rng(sorted(CASES).index(name) * 10 + world)
    return r.standard_normal(shape(ROWS * world)).astype(np.float32)


def _jax_bands(world, data):
    """The JAX exchange of each case, as lists of the shards' bands: every
    case in one ``shard_map``."""
    names = sorted(CASES)
    mesh = Mesh(np.array(jax.devices()[:world]), ("tiles",))

    def spec(name):
        halo, axis, kind, _ = CASES[name]
        s = [None] * data[name].ndim
        s[axis] = "tiles"
        return P(*s)

    def body(*xs):
        out = []
        for name, a in zip(names, xs):
            halo, axis, kind, _ = CASES[name]
            if kind == "flat":
                out.append(JH.halo_exchange_flat(a, 6, halo, "tiles", world))
            elif kind == "clamped":
                out.append(JH.halo_exchange_rows_clamped(a, halo, "tiles", world, axis))
            else:
                out.append(JH.halo_exchange_rows(a, halo, "tiles", world, axis))
        return tuple(out)

    specs = tuple(spec(name) for name in names)
    outs = jax.shard_map(body, mesh=mesh, in_specs=specs, out_specs=specs,
                         check_vma=False)(*(data[name] for name in names))
    return {name: np.split(np.asarray(o), world, axis=CASES[name][1])
            for name, o in zip(names, outs)}


@pytest.fixture(scope="module", params=WORLDS)
def world_run(request):
    world = request.param
    data = {name: _data(name, world) for name in CASES}
    cases = [(name, data[name], *CASES[name][:3]) for name in CASES]
    bands = run_ranks("tests.torch_ranks:halo_cases", world, (cases,), timeout=300,
                      blocked=BLOCKED)
    return world, _jax_bands(world, data), bands


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_exchange_matches_jax(world_run, name):
    world, jax_bands, bands = world_run
    want = jax_bands[name]
    halo, axis, kind, _ = CASES[name]
    for rank in range(world):
        got = bands[rank][name]
        assert got.shape == want[rank].shape
        assert got.shape[axis] == (ROWS + 2 * halo) * (6 if kind == "flat" else 1)
        np.testing.assert_array_equal(got, want[rank])
