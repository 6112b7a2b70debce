"""ZetaRay in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The PyTorch counterpart of the JAX package: the same row layouts at every
public function (G-buffer ``G``, scene tables ``A``/``EA``, presampled
light sets, DI reservoirs and their packed form, the packed temporal
G-buffer ``TG``), so each module can be held against its JAX counterpart.

What runs on the card as a kernel written by hand (``csrc/``):

- ``accel.megakernel.gbuffer``    primary closest hit -> 40-row G-buffer
- ``ops.restir_di.initial_candidates``  full-set RIS over a light set
- ``accel.intersect.occlusion``   any-hit shadow rays
- ``accel.megakernel.bounce_trace``, ``bounce_shade``, ``bounce``  one path
  bounce (trace half, shade half, both fused) of the ReSTIR GI trace, the
  ReSTIR PT suffix and plain PT
- ``accel.intersect.closest_hit``  closest hit with the winner's attribute
  row: every ray query of ReSTIR PT
- ``accel.stream.stream_closest``, ``occlusion_stream``  closest (B8) and
  any hit (B9) on a clustered scene: a walk over the cluster tree and on
  down to leaves of a few triangles
- ``ops.denoise.atrous_iteration_p``  one pass of the a-trous denoiser
  (no TPU kernel: the JAX package's a-trous is XLA-side)
- ``ops.pathtracer.wavefront_vertex``  one vertex of the clustered
  scenes' wavefront path trace, between B8 and B9 (no TPU kernel)

Each wrapper takes its plain PyTorch version for a CPU tensor; for a CUDA
tensor it allocates its outputs and calls its launch function
(``launch_gbuffer``, ``launch_ris``, ...; ``wavefront_vertex`` is one),
which validates every tensor with ``native.require`` and calls
``native.launch``: the one seam to ``csrc/``, which counts each launch in
``native.launches``. Everything between the kernels is plain PyTorch on
the same device. The loaders put scenes and rays on the card
unless told otherwise (``native.default_device``).

Package layout mirrors the JAX package:
  core/    pcg4d, SoA vectors, packing, sampling, transforms, SH
  scene/   host scene arrays, glTF loading and the packed vertex format,
           upload (with the alpha atlas of cutout materials), the animation
           rig, the device refit (B8/B9's walk tree included), instance
           edits, procedural Cornell boxes (one as an animated glTF file),
           camera, textures (PNG and BC-compressed DDS), material packing
  accel/   G-buffer, occlusion, closest-hit and path bounce kernels, the
           alpha-cutout re-trace around the closest hits
  ops/     lights, shading, the path tracer, ReSTIR DI, GI and PT,
           packing, denoise, TAA, post
  render/  the frames, picking, the frame graph
  utils/   the PNG reader and writer, the log ring, params, frame stats and spans,
           validation, checkpoints
  csrc/host/  the host's BCn texture decoder (g++, ``native.decode_bcn``)
  gui/     the interactive viewer and its HTTP server
  app      ``python -m zetaray_tpu_torch.app``: the JAX app's entry point
  warmup   builds both libraries and renders each mode once
  profile  ``time_passes`` (host ms per span), ``trace_frame``, ``launch_counts``
  kernel_ab  B1 and B3-B9 against another commit's kernels on the card
  timing   CUDA-event medians and the card's name and power limit
"""

__version__ = "0.1.0"
