"""The ReSTIR PT frame and the JAX app's default ``restir_di`` frame on the
materials box, PyTorch port against ``render_frame_restir``, as
tests/test_torch_frame_materials.py holds the GI frames (its module
docstring says how, and with which shares).
"""

import pytest
import torch

from tests.test_torch_frame_materials import check_frame, run_jax, scenes  # noqa: F401

torch.set_num_threads(1)

NAMES = ("pt", "di")


@pytest.fixture(scope="module")
def jax_runs(scenes):  # noqa: F811
    return run_jax(scenes["dense"][0], NAMES)


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_materials_frame_from_jax_state(scenes, jax_runs, name, k):  # noqa: F811
    """``check_frame`` of the ReSTIR PT frame and the default frame."""
    check_frame(scenes, jax_runs, name, k)
