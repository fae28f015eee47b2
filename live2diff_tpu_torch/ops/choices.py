"""Per-pipeline choice of the opt-in kernels.

The JAX package picks three of its kernels through process-wide
environment variables read at trace time (``live2diff_tpu/ops/attention.py``
and ``live2diff_tpu/ops/norm.py``):

* ``LIVE2DIFF_FLASH`` = ``dmajor`` (default) | ``smajor`` | ``int8``: which
  flash kernel serves the large spatial self-attentions;
* ``LIVE2DIFF_GN_TAGS`` (default ``none``): the GroupNorm call sites that
  launch the GroupNorm kernel, or ``all``;
* ``LIVE2DIFF_LN_TAGS`` (default ``vit``): the same for LayerNorm.

The port reads no environment variable. The same three choices are one
``KernelChoices`` value, handed to the model constructors, which give each
attention and norm module its choice when it is built. Two pipelines in one
process can therefore run different kernels.

The port's flash default is the JAX package's; its norm defaults are not:
both norm kernels may run at every site. A norm call still takes its
kernel only where it can (``ops/norm.py:gn_route``, ``ln_route``: a bf16
CUDA input, no gradient through the call, the kernel's shape conditions),
so fp32 pipelines, training and CPU runs take the plain versions whatever
the choice. On an H100 (80GB HBM3, 700 W) the plain norms' launches made up
most of the 40-46 % of a stream call's device time that PyTorch's
elementwise, reduction and small cuBLAS kernels took; with both kernels at
every site a 512x512 step's UNet took 17.0 ms of device time where it took
33.8, its kernels a frame fell from 6,293 to 3,072, and a camera stream
returned 1.67x the frames. ``"none"`` or a collection of sites still
chooses otherwise, for A/B runs.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable, Union

FLASH_VARIANTS = ("dmajor", "smajor", "int8")
GN_SITES = frozenset({"resnet", "attn_in", "motion_in", "midas", "vae"})
LN_SITES = frozenset({"spatial", "temporal", "vit"})

Sites = Union[str, Iterable[str]]


def _site_set(value: Sites, known: FrozenSet[str], what: str) -> Union[str, FrozenSet[str]]:
    """``"all"``, or the frozenset of the named sites (``"none"`` is empty)."""
    if value == "all":
        return "all"
    if value == "none":
        return frozenset()
    if isinstance(value, str):
        raise TypeError(f"{what}: expected 'all', 'none' or a collection of site names, got {value!r}")
    sites = frozenset(value)
    unknown = sites - known
    if unknown:
        raise ValueError(f"{what}: unknown site(s) {sorted(unknown)}; known: {sorted(known)}")
    return sites


@dataclasses.dataclass(frozen=True)
class KernelChoices:
    """Which kernels the modules of one pipeline launch on the card.

    ``flash_variant``: the flash kernel of the self-attentions that pass the
    JAX package's flash gate (``ops/attention.py:dot_product_attention``).
    ``gn_kernel_sites`` / ``ln_kernel_sites``: ``"all"``, ``"none"`` or a
    collection of call-site names; ``"all"`` by default (the module's
    docstring says why the port departs from the JAX defaults here).
    """

    flash_variant: str = "dmajor"
    gn_kernel_sites: Sites = "all"
    ln_kernel_sites: Sites = "all"

    def __post_init__(self):
        if self.flash_variant not in FLASH_VARIANTS:
            raise ValueError(
                f"flash_variant {self.flash_variant!r}: expected one of {FLASH_VARIANTS}")
        object.__setattr__(self, "gn_kernel_sites",
                           _site_set(self.gn_kernel_sites, GN_SITES, "gn_kernel_sites"))
        object.__setattr__(self, "ln_kernel_sites",
                           _site_set(self.ln_kernel_sites, LN_SITES, "ln_kernel_sites"))

    def gn_kernel_at(self, site: str) -> bool:
        return self.gn_kernel_sites == "all" or site in self.gn_kernel_sites

    def ln_kernel_at(self, site: str) -> bool:
        return self.ln_kernel_sites == "all" or site in self.ln_kernel_sites


DEFAULT_KERNELS = KernelChoices()
