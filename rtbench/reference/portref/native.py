"""The reference's stand-in for the port's ``native``: the device choice of
the loaders, and no kernel library (the copied modules reach the library
only in the kernel branches that the frozen copy never takes)."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` where one is named, else the card; raises without CUDA."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: name device='cpu'")
    return torch.device("cuda")


def __getattr__(name: str):
    raise AttributeError(f"native.{name}: the reference launches no hand-written kernel")
