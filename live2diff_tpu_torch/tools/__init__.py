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
* ``aot_probe``: the start-up split of a cold and a warm start from a
  primed engine directory (``prime``, ``load``).
* ``kernel_check``: every CUDA kernel against its plain version on the
  card, at the JAX file's shapes and tolerances (``run_all``), which
  ``chip_smoke.py`` runs.

The JAX tools without a counterpart here:

* ``profile_stages.py`` and ``trace_step.py`` (and the root ``bench.py``):
  the port's speed is measured by ``benchmark/run.py`` alone, whose traced
  run (``--trace 1``) gives each step's stages and its kernels by family.
* ``dump_hlo.py`` and ``compile_probe.py`` read XLA programs; the port has
  none.
* ``op_trace.py`` is ``scripts/kernel_ab.py --device`` and
  ``microbench.py`` is ``scripts/kernel_ab.py``; ``chip_smoke.py``'s
  phase 2 checks every kernel at every shape the stream steps give it,
  beyond ``kernel_check``'s.
"""
