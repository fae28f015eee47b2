"""live2diff_tpu_torch: the PyTorch/CUDA port of live2diff_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is tested
against. It imports torch only, never jax or the JAX package. Its entry
points run on the card unless the caller passes ``device="cpu"``; there the
hand-written kernels' plain torch versions run instead.
"""

__version__ = "0.1.0"
