"""B8 (``stream_closest_kernel``, ``accel.stream.stream_closest``): the
closest hit on a clustered scene.

One Woop ray-triangle test (40 float operations) for each ray that hits;
it reads each ray (6 floats) and writes t and the slot (2 words), and reads
the Woop rows (12 floats) of the distinct slots hit. What else a walk reads
(tree nodes, rows of triangles it misses) depends on its tree and is not
counted.
"""

import torch

PAIR_OPS = 40
F32 = 4


def counts(args, kwargs, result):
    """Device counts of one launch (no read-back: the frame keeps flowing)."""
    scene, o = args[0], args[1]
    tri = result[1].long()
    seen = torch.zeros(scene.woop.shape[1] // 3 + 1, dtype=torch.bool, device=tri.device)
    seen[tri + 1] = True  # a miss (-1) marks the first entry
    return {"rays": o.shape[0], "hits": (tri >= 0).sum(), "slots": seen[1:].sum()}


def work(c):
    return PAIR_OPS * c["hits"], c["rays"] * (6 + 2) * F32 + c["slots"] * 12 * F32
