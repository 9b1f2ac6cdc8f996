"""The kernels' plain PyTorch versions under the reference's names
(``repro.kernels.ref``): what the CPU tests and the on-card comparison
hold the kernels against."""
from __future__ import annotations

from repro_torch.kernels.flash_prefill import \
    flash_prefill_plain as flash_prefill_ref
from repro_torch.kernels.paged_attention import \
    paged_attention_plain as paged_attention_ref

__all__ = ["flash_prefill_ref", "paged_attention_ref"]
