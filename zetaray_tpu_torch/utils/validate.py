"""Frame validation: the debug-layer / Check-macro analog.

The reference's safety net is the D3D12 debug layer plus Check/Assert
macros that message-box and abort (Utility/Error.h:1-92). As the JAX
package's ``utils/validate.py``: one reduction on the plane's device counts
its NaN, Inf and negative values, the host reads the three counts in one
small copy, and raises or logs with the plane's name. It costs one pass a
validated plane: turn it on for a frame loop (``app --validate``) or
around a suspect pass while debugging.
"""

from __future__ import annotations

import torch

from . import log


class ValidationError(RuntimeError):
    pass


def _counts(x: torch.Tensor) -> list[int]:
    """(n_nan, n_inf, n_neg) of ``x``: one sum over a [3, N] mask on its
    device, read in one host copy; zeros for a tensor that is not floating
    point. A -Inf counts as Inf and as negative, as in JAX."""
    if not x.is_floating_point():
        return [0, 0, 0]
    x = x.reshape(-1)
    return torch.stack([torch.isnan(x), torch.isinf(x), x < 0.0]).sum(1).tolist()


def check_finite(name: str, x: torch.Tensor, allow_negative: bool = True,
                 raise_on_error: bool = True) -> bool:
    """Validate one tensor. Returns True when clean; logs (and raises by
    default) naming the plane otherwise -- the Check(expr, msg) analog."""
    n_nan, n_inf, n_neg = _counts(x)
    bad = n_nan + n_inf + (0 if allow_negative else n_neg)
    if bad == 0:
        return True
    msg = (
        f"validate: '{name}' has {n_nan} NaN, {n_inf} Inf"
        + ("" if allow_negative else f", {n_neg} negative")
        + f" of {x.numel()} values"
    )
    log.error(msg)
    if raise_on_error:
        raise ValidationError(msg)
    return False


def check_frame(out, state=None, raise_on_error: bool = True) -> bool:
    """Validate a ``render_frame(_restir)`` result dict and, where given,
    the temporal ``FrameState``: the HDR must be finite and non-negative,
    the LDR is uint8 (skipped), the DI, indirect and SkyDI reservoirs and
    the TAA history finite. The planes and verdicts of the JAX
    ``check_frame``."""
    ok = check_finite("hdr", out["hdr"], allow_negative=False, raise_on_error=raise_on_error)
    if state is not None:
        for fname in ("reservoirs", "gi_reservoirs", "history", "sky_reservoirs"):
            leaf = getattr(state, fname, None)
            if leaf is not None:
                ok = check_finite(f"state.{fname}", leaf, raise_on_error=raise_on_error) and ok
    return ok
