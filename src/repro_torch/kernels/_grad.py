"""Which kernel launches a gradient would have to pass through.

The wrappers hand their outputs to the caller as plain tensors (a ``ctypes``
launch leaves no autograd record), so a launch on inputs that require a
gradient would cut the gradient off without a word. ``flash_prefill`` and
``ssd_scan`` route such a call through their autograd functions (each with
a hand-written backward kernel). ``paged_attention``, a decode kernel that
no trainer reaches, has no backward and refuses it (``refuse_grad``)."""
from __future__ import annotations

import torch


def wants_grad(*tensors) -> bool:
    """Whether autograd records the call: grad mode is on and some input
    (``None`` entries skipped) requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``NotImplementedError`` where ``wants_grad(*tensors)``: the
    launch of ``kernel`` would return a tensor without a gradient."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{kernel}: no backward pass on a CUDA device (a decode kernel, which "
            "no trainer reaches): call it under torch.no_grad() or on inputs that "
            "do not require a gradient")
