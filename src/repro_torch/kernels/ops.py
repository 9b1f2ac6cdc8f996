"""Public entry points of the kernels, under the reference's names.

Where ``repro.kernels.ops`` chooses between ``tpu`` / ``interpret`` /
``ref`` backends, the port has no choice to make: a tensor on a CUDA
device goes to the hand-written kernel, a tensor on the CPU to the plain
PyTorch version, and the wrappers themselves decide that from the tensor
they are given. ``ssd_scan`` takes any sequence length on both: the
reference's padding to a chunk multiple happens in its plain version and is
a mask in the kernel.
"""
from __future__ import annotations

from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import (DEFAULT_PAGE_SIZE,
                                                 paged_attention)
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["DEFAULT_PAGE_SIZE", "flash_prefill", "paged_attention", "ssd_scan"]
