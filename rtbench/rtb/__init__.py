"""The benchmark harness of ``zetaray_tpu_torch``: spec files, traffic, the
frame loop, trace reduction and the comparison with the plain reference."""
