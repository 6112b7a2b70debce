"""The comparison that decides ``correct``.

The reference is ``reference.portref``, the frozen plain copy of the port,
run on the same glTF file with the same seeds and cameras. It takes
nothing the port made except, for the window's frames, the state the port
carried into them: a reference chain as long as the window would take
longer than the window. So three checks run once the window has closed:

- ``start``: the reference renders the first ``start_frames`` frames from
  nothing, as the port did in its set-up, and its last frame's outputs and
  state are held against the port's;
- ``sampled``: a window frame drawn from the seed (``Traffic.sampled_frame``),
  rendered by the reference from the state the port carried into it
  (``FrameState`` of the frame before), outputs and state held against the
  port's;
- ``last``: the same for the window's last frame.

Each check gives these numbers, each a share (0 to 1) or a ratio:

- ``di_res``, ``ind_res``: the share of pixels whose DI or indirect (GI or
  PT) reservoir, as the state carries it to the next frame, differs from
  the reference's by more than ``REL`` (relative to 1 + |reference|);
- ``hdr_l1``: sum |port - reference| / sum |reference| over the HDR image
  (a NaN or an infinity counts as 3e38);
- ``ldr``: the share of display pixels with a channel more than one level
  of 255 from the reference's.

No share of HDR pixels is compared: a-trous spreads a change of one pixel
over a 61 x 61 neighbourhood, so it could not tell one pick that rounds
differently from a fault.

A workload file's ``check.limits`` names the numbers compared and their
limits; ``correct`` is true where each is at or below its limit.
"""

from __future__ import annotations

import dataclasses

import torch

REL = 1e-4  # a float32 value's tolerance, relative to 1 + |reference|


def _col_mismatch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N] bool: the pixels whose column of rows [R, N] differs."""
    a, b = a.float(), b.float()
    close = (a - b).abs() <= REL * (1.0 + b.abs())
    close |= a.isnan() & b.isnan()
    close |= (a == b)  # equal infinities
    return ~close.all(0)


def numbers(port_out, port_state, ref_out, ref_state) -> dict:
    """The comparison's numbers for one frame (see the module docstring)."""
    share = lambda m: float(m.float().mean())
    hp, hr = port_out["hdr"].float(), ref_out["hdr"].float()
    lp, lr = port_out["ldr"].int(), ref_out["ldr"].int()
    return {
        "di_res": share(_col_mismatch(port_state.reservoirs, ref_state.reservoirs)),
        "ind_res": share(_col_mismatch(port_state.gi_reservoirs, ref_state.gi_reservoirs)),
        "hdr_l1": float((hp - hr).abs().nan_to_num(3e38).sum() / hr.abs().sum().clamp_min(1e-30)),
        "ldr": share(((lp - lr).abs() > 1).any(-1)),
    }


def verdict(values: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [[name, value, limit]] of the numbers compared)."""
    rows = [[name, values.get(name, float("nan")), lim] for name, lim in limits.items()]
    ok = all(v <= lim for _, v, lim in rows)  # a NaN fails
    return ok, rows


def round_bf16(x):
    """``x`` with every float32 tensor in it rounded to bfloat16 and back."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(torch.float32) if x.dtype == torch.float32 else x
    if isinstance(x, tuple) and hasattr(x, "_make"):
        return x._make(round_bf16(v) for v in x)
    if isinstance(x, (tuple, list)):
        return type(x)(round_bf16(v) for v in x)
    if isinstance(x, dict):
        return {k: round_bf16(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: round_bf16(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x
