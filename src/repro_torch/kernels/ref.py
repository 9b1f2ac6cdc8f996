"""The kernels' plain PyTorch versions under the reference's names
(``repro.kernels.ref``): what the CPU tests and the on-card comparison
hold the kernels against."""
from __future__ import annotations

from repro_torch.kernels.flash_prefill import \
    flash_prefill_plain as flash_prefill_ref
from repro_torch.kernels.paged_attention import \
    paged_attention_plain as paged_attention_ref
from repro_torch.kernels.ssd_scan import ssd_scan_backward_plain, ssd_scan_plain
from repro_torch.kernels.ssd_scan import \
    ssd_sequential_plain as ssd_sequential_ref


def ssd_scan_ref(x, dt, A, B, C, h0=None, *, chunk: int = 256):
    """The chunked SSD with ``ops.ssd_scan``'s signature."""
    return ssd_scan_plain(x, dt, A, B, C, chunk, h0=h0)


__all__ = ["flash_prefill_ref", "paged_attention_ref", "ssd_scan_backward_plain",
           "ssd_scan_ref", "ssd_sequential_ref"]
