"""A frozen copy of the port's plain PyTorch paths: the benchmark's reference.

These modules are the port's (``render/frame.py`` and everything it and the
scene loader import) as they stood when the benchmark was written, with
three mechanical edits and nothing else:

- every wrapper that launched a hand-written kernel for a CUDA tensor takes
  its plain PyTorch version on every device (the nine ``if True:  # frozen
  reference`` lines), so the copy launches no kernel of the port;
- ``native`` is a stub that holds the device and tensor checks and builds
  no library;
- on a clustered scene the closest-hit and any-hit queries (B8, B9) go
  through ``accel.stream_fast``, which gives the answer of their dense
  plain versions, tie rule included, at a fraction of their time.

The copy imports nothing outside itself, PyTorch and numpy. It is frozen:
when the port changes, the benchmark still compares with what the frame
computed when the benchmark was defined.
"""
