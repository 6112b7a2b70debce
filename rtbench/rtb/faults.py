"""Faults planted under the port's frame function, each of which the
comparison has to catch (``calibrate.py`` reads their numbers on the card;
``tests/test_rtbench_check.py`` sees ``correct`` come out false on the CPU).
Each wraps ``Port.frame`` (scene, traffic, k, cfg, state) -> (outputs, state).
The cells run on one card, so no exchange between cards can be left out."""

from __future__ import annotations

import dataclasses


def stale_state(frame):
    """A step that returns its state unchanged: every frame after the first
    hands the next one the state it was given."""
    def run(scene, traffic, k, cfg, state):
        out, new = frame(scene, traffic, k, cfg, state)
        return out, (new if state is None else state)
    return run


def half_image(frame):
    """Half of the batch left out: the lower half of the image's rows and of
    the state's pixels never rendered (zeros)."""
    def run(scene, traffic, k, cfg, state):
        out, new = frame(scene, traffic, k, cfg, state)
        h = out["hdr"].shape[0]
        out = {key: v.clone() for key, v in out.items()}
        for v in out.values():
            v[h // 2 :] = 0
        cut = lambda x: x if x is None else x.clone().index_fill_(
            1, _lower_half(x.shape[1], x.device), 0)
        new = dataclasses.replace(new, reservoirs=cut(new.reservoirs),
                                  gi_reservoirs=cut(new.gi_reservoirs))
        return out, new
    return run


def _lower_half(n, device):
    import torch

    return torch.arange(n // 2, n, device=device)


def altered_answer(frame):
    """An answer altered where it is produced: the frame's HDR image (the
    TAA history too) scaled by 1 + 2^-7."""
    def run(scene, traffic, k, cfg, state):
        out, new = frame(scene, traffic, k, cfg, state)
        out = dict(out, hdr=out["hdr"] * (1.0 + 2.0 ** -7))
        return out, dataclasses.replace(new, history=new.history * (1.0 + 2.0 ** -7))
    return run


FAULTS = {"stale_state": stale_state, "half_image": half_image, "altered_answer": altered_answer}
