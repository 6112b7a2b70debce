"""B2 (``ris_kernel``, ``ops.restir_di.initial_candidates``): full-set RIS
over each pixel's presampled light set.

A valid pixel rates every entry of its set, an invalid one only the last;
a rating is 32 float operations (3 subtractions, 14 multiplications, 7
additions, 2 maxima, 3 comparisons, 1 rsqrt, 2 divisions). It reads 10
G-buffer rows (position, normal, base colour, valid) a pixel and the 11
staged rows of every set entry once, and writes 16 reservoir rows a pixel.
"""

ENTRY_OPS = 32
GBUF_ROWS_READ = 10
R_ROWS = 16
LSET_STAGED = 11
G_VALID = 15  # the G-buffer's valid row
F32 = 4


def counts(args, kwargs, result):
    gbuf, light_sets = args[0], args[1]
    n_sets, _, ps = light_sets.shape
    return {"pixels": gbuf.shape[1], "valid": (gbuf[G_VALID] > 0.5).sum(), "sets": n_sets,
            "set_size": ps}


def work(c):
    ops = ENTRY_OPS * (c["valid"] * c["set_size"] + c["pixels"] - c["valid"])
    nbytes = (c["pixels"] * (GBUF_ROWS_READ + R_ROWS) * F32
              + c["sets"] * LSET_STAGED * c["set_size"] * F32)
    return ops, nbytes
