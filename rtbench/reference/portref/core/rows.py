"""Row-matrix (SoA) construction, as the JAX package's ``core/rows.py``."""

from __future__ import annotations

import torch


def stack_rows(num_rows: int, vals: dict, n=None, like=None) -> torch.Tensor:
    """Build a (num_rows, n) float32 row matrix from {row: [n] tensor}.

    Rows not in ``vals`` are zero, or taken from ``like`` when given.
    """
    if like is not None:
        return torch.stack([vals.get(i, like[i]) for i in range(num_rows)], 0)
    first = next(iter(vals.values()))
    if n is None:
        n = first.shape[0]
    zero = torch.zeros((n,), dtype=torch.float32, device=first.device)
    return torch.stack([vals.get(i, zero) for i in range(num_rows)], 0)


def set3(vals: dict, row: int, v) -> None:
    """vals[row..row+2] = the V3's components."""
    vals[row] = v.x
    vals[row + 1] = v.y
    vals[row + 2] = v.z
