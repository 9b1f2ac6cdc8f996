"""Flash attention for prefill: wrapper, plain PyTorch version, launch counter.

The kernel is ``csrc/flash_prefill.cu`` (CUDA C++ for sm_90a). It replaces
the TPU kernel ``repro/kernels/flash_prefill.py::flash_prefill`` (body
``_kernel``): causal or full GQA attention with an online softmax in
float32. It is extended only as far as the serving path feeds it: the keys
and values may hold ``q_offset`` already-cached positions in front
(``T = q_offset + S``; query row ``i`` sits at position ``q_offset + i``),
``S`` and ``T`` are arbitrary, and the batch, head and sequence axes may be
strided (``D`` contiguous), so ``(B, S, H, D)`` tensors are passed as
transposed views without a copy. It also takes the two masks that the
reference's ``layers.attention_forward`` adds to the causal one in ``jnp``:
a sliding ``window`` and a bidirectional prefix of ``prefix_len`` keys (the
VLM's vision tokens), and head_dim 80 and 96 besides 64 and 128.

Bound on the H100: ``2 * (S + T) * D`` elements per head moved against
``4 * S * T * D`` operations (half of it when causal with ``q_offset == 0``);
in bf16 at the serving shape both are a few microseconds. The source holds
two kernels, chosen here by dtype and nothing else, both on the tensor
cores: bf16 runs ``wgmma`` (K/V tiles by TMA into a two-stage ring, tensor
maps encoded per call over the strided views), float32 runs 3xTF32
``mma.sync`` (each operand split into a TF32 head and tail, three products,
which keeps float32's precision; K and V staged by ``cp.async``). Their
designs and what holds them back are described at the top of the ``.cu``
source.

``flash_prefill`` runs the plain version only for tensors on the CPU (and
on the meta device, which computes nothing). On CUDA tensors it launches the kernel for their dtype or raises; a bf16 launch
that fails is not retried on the other kernel.

Gradients. A call whose inputs require a gradient (with grad mode on) goes
through ``FlashPrefill``, an autograd function: its forward is the call
above, which also returns each row's log-sum-exp, and saves q, k, v, the
output and the log-sum-exp; its backward is ``flash_prefill_backward``,
which launches ``csrc/flash_prefill_bwd.cu`` on CUDA tensors and runs
``flash_prefill_backward_plain`` (the explicit formulas, no autograd) on CPU
tensors, so that training takes the same route on both. The TPU package has
no Pallas backward; it trains through ``jax.grad`` of plain attention, which
the backward kernels stand in for.
Training has no cached rows: a gradient through a call with ``q_offset > 0``
is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import wants_grad

_NEG_INF = -1e30
_HEAD_DIMS = (64, 80, 96, 128)


def attention_mask(S: int, T: int, *, q_offset: int = 0, window: int = 0,
                   prefix_len: int = 0, device=None) -> torch.Tensor:
    """The causal mask (S, T) of query rows at positions ``q_offset ..``, in
    the reference's order: causal, ``&=`` the window (0 = none), ``|=`` the
    bidirectional prefix (0 = none)."""
    qi = q_offset + torch.arange(S, device=device)[:, None]
    ki = torch.arange(T, device=device)[None, :]
    mask = ki <= qi
    if window > 0:
        mask &= ki > qi - window
    if prefix_len > 0:
        mask |= ki < prefix_len
    return mask


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0, window: int = 0,
                        prefix_len: int = 0, return_lse: bool = False):
    """Plain PyTorch version, any device: materialises the (S, T) scores.

    q (B,H,S,D); k/v (B,Hkv,T,D); returns (B,H,S,D). Softmax in float32
    (float64 for float64 inputs).
    ``window`` and ``prefix_len`` act only when causal (``attention_mask``).
    With ``return_lse``, returns ``(o, lse)``: lse (B,H,S) in that dtype, each
    row's log-sum-exp of its scaled, masked scores, as the kernel writes it
    for the backward.
    """
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = H // Hkv
    wide = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Hkv, group, S, D).to(wide)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(wide)) / math.sqrt(D)
    if causal:
        mask = attention_mask(S, T, q_offset=q_offset, window=window,
                              prefix_len=prefix_len, device=q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.to(wide)).reshape(B, H, S, D).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, S)
    return o


def _check(q, k, v, causal, q_offset, window, prefix_len):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_prefill: q (B,H,S,D) and k, v (B,Hkv,T,D) "
                         "expected")
    B, H, S, D = q.shape
    Bk, Hkv, T, Dk = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_prefill kernel: dtype {q.dtype} not taken "
                        "(float32 and bfloat16 are)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_prefill kernel: q, k and v must share one dtype")
    if D not in _HEAD_DIMS or Dk != D:
        raise ValueError(f"flash_prefill kernel: head_dim {D} not taken "
                         f"(one of {_HEAD_DIMS} is)")
    if Bk != B or Hkv < 1 or H % Hkv:
        raise ValueError("flash_prefill kernel: batch or head counts of q and "
                         "k do not match")
    if S < 1 or T < 1:
        raise ValueError("flash_prefill kernel: empty sequence")
    if q_offset < 0 or (causal and T != q_offset + S):
        raise ValueError(f"flash_prefill kernel: causal attention needs "
                         f"T == q_offset + S, got T={T}, q_offset={q_offset}, "
                         f"S={S}")
    if window < 0 or prefix_len < 0:
        raise ValueError("flash_prefill kernel: window and prefix_len must be "
                         ">= 0")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_prefill kernel: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_prefill kernel: {name} needs a contiguous head_dim "
                f"axis and 16-byte aligned rows, got strides {t.stride()}")


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_prefill")
    fn = lib.flash_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + \
            [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0, window: int = 0,
                  prefix_len: int = 0) -> torch.Tensor:
    """Flash attention. q (B,H,S,D); k/v (B,Hkv,T,D); returns (B,H,S,D) with
    q's strides. When causal, ``T == q_offset + S`` and query row ``i`` sees
    KV rows ``0 .. q_offset + i`` inside the last ``window`` of them (0 =
    all), and every query sees the first ``prefix_len`` rows (0 = none). A
    prefix with cached rows in front (``q_offset > 0``) is refused, as the
    reference refuses a vision prefix after the first chunk.

    Tensors on the CPU (and on the meta device, which computes nothing)
    go through ``flash_prefill_plain``; tensors on a CUDA
    device launch the kernel (and count the launch in
    ``flash_prefill.launches``, a bf16 launch of the wgmma kernel also in
    ``flash_prefill.tensor_core_launches``, a float32 launch of the 3xTF32
    kernel in ``flash_prefill.tf32_launches``, one with ``q_offset > 0``
    also in ``flash_prefill.offset_launches``, one with a window or a prefix
    in ``window_launches`` or ``prefix_launches``, one without the causal
    mask in ``full_launches``) or raise. Inputs that
    require a gradient go through ``FlashPrefill`` (see the module
    docstring).
    """
    if causal and prefix_len > 0 and q_offset > 0:
        raise ValueError("flash_prefill: a bidirectional prefix must be in the "
                         "first chunk (q_offset == 0)")
    if wants_grad(q, k, v):
        if q_offset:
            raise ValueError("flash_prefill: no gradient through cached rows "
                             "(q_offset > 0); training has none")
        return FlashPrefill.apply(q, k, v, causal, window, prefix_len)
    return _forward(q, k, v, causal=causal, q_offset=q_offset, window=window,
                    prefix_len=prefix_len)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
             q_offset: int, window: int, prefix_len: int, with_lse: bool = False):
    """``flash_prefill`` without autograd: the plain version on the CPU (and
    on the meta device), the kernel on a CUDA device. ``with_lse``: returns
    ``(o, lse)``, lse (B,H,S) float32 as ``flash_prefill_plain(return_lse=True)`` gives it; on the card
    the kernel's LSE instance writes it (``flash_prefill.lse_launches``)."""
    if q.device.type in ("cpu", "meta"):
        return flash_prefill_plain(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, prefix_len=prefix_len,
                                   return_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: device {q.device} not supported")
    _check(q, k, v, causal, q_offset, window, prefix_len)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)        # keeps q's strides: no transposed copy
    if out.stride(3) != 1:
        raise ValueError("flash_prefill kernel: q is not dense")
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse \
        else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    # bf16 on the wgmma kernel; float32 on the 3xTF32 kernel, whose three
    # products a pair of operands keep float32's precision
    is_bf16 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        err = _library().flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, Hkv, S, T, D, q_offset, int(causal), window, prefix_len,
            int(is_bf16),
            strides, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_prefill: cuTensorMapEncodeTiled failed: "
                           f"CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error {err}")
    flash_prefill.launches += 1
    flash_prefill.tensor_core_launches += int(is_bf16)
    flash_prefill.tf32_launches += int(not is_bf16)
    flash_prefill.offset_launches += int(q_offset > 0)
    flash_prefill.window_launches += int(causal and window > 0)
    flash_prefill.prefix_launches += int(causal and prefix_len > 0)
    flash_prefill.full_launches += int(not causal)
    flash_prefill.lse_launches += int(with_lse)
    return (out, lse) if with_lse else out


flash_prefill.launches = 0   # launches of either CUDA kernel by this wrapper
flash_prefill.tensor_core_launches = 0   # of those, the bf16 wgmma kernel's
flash_prefill.tf32_launches = 0   # of those, the float32 3xTF32 kernel's
flash_prefill.offset_launches = 0   # of those, the ones with cached rows in front
flash_prefill.window_launches = 0   # of those, the ones with a sliding window
flash_prefill.prefix_launches = 0   # of those, the ones with a bidirectional prefix
flash_prefill.full_launches = 0   # of those, the ones without the causal mask
flash_prefill.lse_launches = 0   # of those, the ones that wrote the log-sum-exp


class FlashPrefill(torch.autograd.Function):
    """``flash_prefill`` with a gradient: the forward launches the kernel's
    LSE instance (the plain version on the CPU) and saves q, k, v, the output
    and each row's log-sum-exp (B,H,S) float32, 4 bytes a query row and head;
    the backward is ``flash_prefill_backward`` given that log-sum-exp, so it
    repeats no forward pass. q (B,H,S,D), k/v (B,Hkv,T,D); no cached rows
    (``q_offset == 0``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, prefix_len: int):
        o, lse = _forward(q, k, v, causal=causal, q_offset=0, window=window,
                          prefix_len=prefix_len, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = (causal, window, prefix_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, prefix_len = ctx.masks
        dq, dk, dv = flash_prefill_backward(q, k, v, o, do, causal=causal,
                                            window=window, prefix_len=prefix_len,
                                            lse=lse)
        return dq, dk, dv, None, None, None


def flash_prefill_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 o: torch.Tensor, do: torch.Tensor, *,
                                 causal: bool = True, window: int = 0,
                                 prefix_len: int = 0, lse: torch.Tensor | None = None):
    """The gradients of ``flash_prefill_plain`` (no cached rows) by the
    explicit formulas, in float32 (in float64 for float64 inputs, the
    yardstick of the kernels' precision), without autograd: P = softmax(Q
    K^T scale + mask), dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO
    O)), dQ = dS K scale, dK = dS^T Q scale, dK and dV summed over each KV
    head's group.
    Given the forward's log-sum-exp ``lse`` (B,H,S), P = exp(Q K^T scale -
    lse) where the mask lets a key through, as the kernels form it.
    q, o, do (B,H,S,D); k, v (B,Hkv,T,D). Returns (dq, dk, dv) in the
    inputs' dtype."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(D)
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Hkv, group, S, D).to(ct)
    dog = do.reshape(B, Hkv, group, S, D).to(ct)
    og = o.reshape(B, Hkv, group, S, D).to(ct)
    kf, vf = k.to(ct), v.to(ct)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    if causal:
        mask = attention_mask(S, T, window=window, prefix_len=prefix_len,
                              device=q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    if lse is None:
        p = torch.softmax(s, dim=-1)
    else:   # a masked score's exp(-1e30 - lse) is 0
        p = torch.exp(s - lse.to(ct).reshape(B, Hkv, group, S, 1))
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _backward_library() -> ctypes.CDLL:
    lib = _build.library("flash_prefill_bwd")
    fn = lib.flash_prefill_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + \
            [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_prefill_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                           window: int = 0, prefix_len: int = 0,
                           lse: torch.Tensor | None = None):
    """The gradients (dq, dk, dv) of ``flash_prefill(q, k, v, causal=,
    window=, prefix_len=)`` whose output was ``o``, for the output's
    gradient ``do``; no cached rows. Causal or full (S != T), with a window
    or a prefix; each gradient in its input's dtype and shape. ``lse``: that
    forward's log-sum-exp (B,H,S) float32, as ``FlashPrefill`` saves it.

    Tensors on the CPU (and on the meta device, which computes nothing)
    go through ``flash_prefill_backward_plain`` without
    ``lse``: P is the softmax of its own scores, the rounding that the CPU's
    training parity against the reference's jitted AdamW steps holds (an
    update divides a near-zero gradient by its own magnitude, so a one-ulp
    change in P moves a parameter by a share of ``lr``). Tensors on a CUDA
    device launch
    ``csrc/flash_prefill_bwd.cu`` (counted in
    ``flash_prefill_backward.launches``: one a call, whose two kernels run
    in turn, dQ then dK/dV; bf16 on ``wgmma``, float32 on 3xTF32
    ``mma.sync``, counted in ``flash_prefill_backward.tf32_launches`` too)
    or raise. On the card, a call without ``lse`` first launches the forward
    kernel's LSE instance to get it (counted as a ``flash_prefill`` launch).
    """
    if q.device.type in ("cpu", "meta"):
        return flash_prefill_backward_plain(q, k, v, o, do, causal=causal,
                                            window=window, prefix_len=prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_backward: device {q.device} not supported")
    _check(q, k, v, causal, 0, window, prefix_len)
    vec = 16 // q.element_size()
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_prefill_backward: {name} must have q's shape, "
                             "dtype and device")
    if do.stride(3) != 1 or any(st % vec for st in do.stride()[:3]) or \
            do.data_ptr() % 16:
        do = do.contiguous()
    if o.stride(3) != 1 or any(st % vec for st in o.stride()[:3]) or o.data_ptr() % 16:
        raise ValueError("flash_prefill_backward: o needs a contiguous head_dim "
                         "axis and 16-byte aligned rows")
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if lse is None:
        _, lse = _forward(q, k, v, causal=causal, q_offset=0, window=window,
                          prefix_len=prefix_len, with_lse=True)
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_prefill_backward: lse must be float32 {(B, H, S)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    if any(t.stride(3) != 1 for t in (dq, dk, dv)):
        raise ValueError("flash_prefill_backward: q, k and v must be dense")
    strides = (ctypes.c_longlong * 24)(*[st for t in tensors for st in t.stride()[:3]])
    with torch.cuda.device(q.device):
        err = _backward_library().flash_prefill_bwd_launch(
            *[t.data_ptr() for t in tensors], lse.data_ptr(), delta.data_ptr(),
            B, H, Hkv, S, T, D, int(causal), window, prefix_len,
            int(q.dtype == torch.bfloat16), strides, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_prefill_backward: cuTensorMapEncodeTiled failed: "
                           f"CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_prefill_backward kernel launch failed: CUDA "
                           f"error {err}")
    flash_prefill_backward.launches += 1
    flash_prefill_backward.tf32_launches += int(q.dtype == torch.float32)
    return dq, dk, dv


flash_prefill_backward.launches = 0   # calls that launched the CUDA kernels
flash_prefill_backward.tf32_launches = 0   # of those, the float32 3xTF32 kernels'
