"""B9 (``stream_any_hit_kernel``, ``accel.stream.occlusion_stream``): the
any hit of rays or segments on a clustered scene.

One Woop test (40 float operations) for each ray that is blocked; it reads
each ray (6 floats) and writes one word. The rows a walk reads depend on
its tree and are not counted.
"""

PAIR_OPS = 40
F32 = 4


def counts(args, kwargs, result):
    return {"rays": args[1].shape[0], "blocked": result.sum()}


def work(c):
    return PAIR_OPS * c["blocked"], c["rays"] * (6 + 1) * F32
