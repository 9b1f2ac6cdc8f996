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
two kernels, chosen here by dtype and nothing else: bf16 runs both products
on the tensor cores (``wgmma``, K/V tiles by TMA into a two-stage ring,
tensor maps encoded per call over the strided views), float32 runs them as
FMAs (tensor cores would round it to TF32). Their designs and what holds
them back are described at the top of the ``.cu`` source.

``flash_prefill`` runs the plain version only for tensors on the CPU. On
CUDA tensors it launches the kernel for their dtype or raises; a bf16 launch
that fails is not retried on the FMA kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

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
                        prefix_len: int = 0) -> torch.Tensor:
    """Plain PyTorch version, any device: materialises the (S, T) scores.

    q (B,H,S,D); k/v (B,Hkv,T,D); returns (B,H,S,D). Softmax in float32.
    ``window`` and ``prefix_len`` act only when causal (``attention_mask``).
    """
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, S, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(D)
    if causal:
        mask = attention_mask(S, T, q_offset=q_offset, window=window,
                              prefix_len=prefix_len, device=q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + \
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

    Tensors on the CPU go through ``flash_prefill_plain``; tensors on a CUDA
    device launch the kernel (and count the launch in
    ``flash_prefill.launches``, a bf16 launch of the tensor-core kernel also
    in ``flash_prefill.tensor_core_launches``, one with ``q_offset > 0`` also
    in ``flash_prefill.offset_launches``, one with a window or a prefix in
    ``window_launches`` or ``prefix_launches``) or raise.
    """
    if causal and prefix_len > 0 and q_offset > 0:
        raise ValueError("flash_prefill: a bidirectional prefix must be in the "
                         "first chunk (q_offset == 0)")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, prefix_len=prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: device {q.device} not supported")
    _check(q, k, v, causal, q_offset, window, prefix_len)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)        # keeps q's strides: no transposed copy
    if out.stride(3) != 1:
        raise ValueError("flash_prefill kernel: q is not dense")
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    # bf16 on the tensor cores; float32 on the FMA kernel, which keeps it
    # exact (the tensor cores would round it to TF32)
    tensor_cores = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        err = _library().flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Hkv, S, T, D, q_offset, int(causal), window, prefix_len,
            int(tensor_cores),
            strides, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_prefill: cuTensorMapEncodeTiled failed: "
                           f"CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error {err}")
    flash_prefill.launches += 1
    flash_prefill.tensor_core_launches += int(tensor_cores)
    flash_prefill.offset_launches += int(q_offset > 0)
    flash_prefill.window_launches += int(causal and window > 0)
    flash_prefill.prefix_launches += int(causal and prefix_len > 0)
    return out


flash_prefill.launches = 0   # launches of either CUDA kernel by this wrapper
flash_prefill.tensor_core_launches = 0   # of those, the bf16 wgmma kernel's
flash_prefill.offset_launches = 0   # of those, the ones with cached rows in front
flash_prefill.window_launches = 0   # of those, the ones with a sliding window
flash_prefill.prefix_launches = 0   # of those, the ones with a bidirectional prefix
