"""Paged-attention decode: wrapper, plain PyTorch version, launch counter.

The kernel is ``csrc/paged_attention.cu`` (CUDA C++ for sm_90a). It replaces
the TPU kernel ``repro/kernels/paged_attention.py::paged_attention`` (body
``_kernel``) and computes the same function: one query token per sequence
attends over a KV pool ``(num_pages, page, n_kv, D)`` addressed through a
per-sequence block table, with tokens at or past ``lengths[b]`` masked; a
sequence of length 0 gives zeros.

Bound on the H100: bytes. Each K/V element is read once and used for
``group`` (1..8) multiply-adds, so the least time is that of streaming
``2 * length * n_kv * D`` elements per sequence from device memory. The
kernel's design (one block per (sequence, KV head), warps striding over the
pages, 16-byte loads, all query rows of a group sharing each loaded row)
and what still holds it back (a grid of ``B * n_kv`` blocks is smaller than
the card) are described at the top of the ``.cu`` source.

``paged_attention`` runs the plain version only for tensors on the CPU. On
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

DEFAULT_PAGE_SIZE = 16
_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, any device, any page size.

    q (B, n_kv, group, D); pools (P, page, n_kv, D); block_tables
    (B, max_pages); lengths (B,). Returns (B, n_kv, group, D). Softmax in
    float32; a row with every position masked gives zeros, as the kernel's
    ``acc / max(l, 1e-30)`` does.
    """
    B, n_kv, group, D = q.shape
    page = k_pool.shape[1]
    S = block_tables.shape[1] * page
    bt = block_tables.long()
    k = k_pool[bt].reshape(B, S, n_kv, D).float()
    v = v_pool[bt].reshape(B, S, n_kv, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k) / math.sqrt(D)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1) * valid      # length 0: uniform -> zeros
    o = torch.einsum("bkgs,bskd->bkgd", w, v)
    return o.to(q.dtype)


def _check(q, k_pool, v_pool, block_tables, lengths, page_size):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("paged_attention: q (B, n_kv, group, D) and pools "
                         "(num_pages, page, n_kv, D) expected")
    B, n_kv, group, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention kernel: dtype {q.dtype} not taken "
                        "(float32 and bfloat16 are)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_attention kernel: q and the pools must share "
                        "one dtype")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {D} not taken "
                         f"(one of {_HEAD_DIMS} is)")
    if not 1 <= group <= _MAX_GROUP:
        raise ValueError(f"paged_attention kernel: group {group} not taken "
                         f"(1..{_MAX_GROUP} is)")
    if page_size != DEFAULT_PAGE_SIZE or k_pool.shape[1] != page_size:
        raise ValueError(f"paged_attention kernel: page size must be "
                         f"{DEFAULT_PAGE_SIZE}, got {k_pool.shape[1]}")
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (n_kv, D):
        raise ValueError("paged_attention kernel: pool shape does not match q")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel: block_tables and lengths "
                        "must be int32")
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_attention kernel: block_tables (B, max_pages) "
                         "and lengths (B,) expected")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_attention kernel: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention kernel: {name} must be "
                             "16-byte aligned")


def _library() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    page_size: int = DEFAULT_PAGE_SIZE) -> torch.Tensor:
    """Decode attention over paged KV.

    q            (B, n_kv, group, D)   one query token per sequence
    k_pool/v_pool(num_pages, page_size, n_kv, D)
    block_tables (B, max_pages) int32  page ids per sequence
    lengths      (B,) int32            tokens in each sequence's KV
    returns      (B, n_kv, group, D)

    Tensors on the CPU go through ``paged_attention_plain``; tensors on a
    CUDA device launch the kernel (and count the launch in
    ``paged_attention.launches``) or raise.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: device {q.device} not supported")
    _check(q, k_pool, v_pool, block_tables, lengths, page_size)
    B, n_kv, group, D = q.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        err = _library().paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, n_kv, group, D, block_tables.shape[1],
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0   # launches of the CUDA kernel by this wrapper
