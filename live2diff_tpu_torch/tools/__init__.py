"""Measuring tools of the port: the counterparts of the JAX package's
``tools/``. Each runs as ``python -m live2diff_tpu_torch.tools.<name>``,
takes ``--device`` where it runs a pipeline (the card by default;
``--device cpu --tiny`` runs it on the CPU at a tiny width, where it times
CPU ops, not a device) and exposes its work as a function that
``chip_smoke.py`` and the tests call:

* ``psnr``: PSNR between two videos or frame folders (``psnr``, ``score``),
  on the host.
* ``parity``: build from a style config and its weights, stream a video as
  the CLI does and score the output against reference frames (``run``).
* ``profile_stages``: the codec, the depth branch and the stream-batch UNet
  each timed alone, beside the captured step (``profile_stages``).
* ``trace_step``: a profile of replays of the captured step: kernels by
  device time, families, coarse buckets and the idle and host gaps around
  the device work, each kernel in the frame that launched it (``trace``,
  ``aggregate``).
* ``aot_probe``: the start-up split of a cold and a warm start from a
  primed engine directory (``prime``, ``load``).
* ``kernel_check``: every CUDA kernel against its plain version on the
  card, at the JAX file's shapes and tolerances (``run_all``); the port
  bench's ``kernel_selftest`` row.

The JAX tools without a counterpart here:

* ``dump_hlo.py`` and ``compile_probe.py`` read XLA programs; the port has
  none.
* ``op_trace.py`` is ``scripts/kernel_ab.py --device`` and
  ``microbench.py`` is ``scripts/kernel_ab.py``; ``chip_smoke.py``'s
  phase 2 checks every kernel at every shape the stream steps give it,
  beyond ``kernel_check``'s.
"""
