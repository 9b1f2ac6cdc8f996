"""Paged-attention decode: wrapper, plain PyTorch version, launch counter.

The kernel is ``csrc/paged_attention.cu`` (CUDA C++ for sm_90a). It replaces
the TPU kernel ``repro/kernels/paged_attention.py::paged_attention`` (body
``_kernel``) and computes the same function: one query token per sequence
attends over a KV pool ``(num_pages, page, n_kv, D)`` addressed through a
per-sequence block table, with tokens at or past ``lengths[b]`` masked; a
sequence of length 0 gives zeros. Beyond the TPU kernel it takes an optional
per-sequence lower bound ``starts[b]``: tokens below it are masked too. That
is the reference's sliding window (``layers.attention_decode`` masks
``slot_pos > pos - window``): the port's pool keeps every position of a
sequence and applies the window as ``starts = max(0, pos + 1 - window)``,
where the reference keeps a ring of the last ``window`` slots; both attend
over the same positions. head_dim is 64, 80, 96 or 128.

Bound on the H100: bytes. Each K/V element is read once and used for
``group`` (1..8) multiply-adds, so the least time is that of streaming
``2 * length * n_kv * D`` elements per sequence from device memory. The
kernel splits the pages of a sequence over blocks (flash-decoding): a grid
of ``(B, n_kv, n_splits)`` blocks, each walking ``PAGES_PER_SPLIT`` pages
with its K/V loads double-buffered; the last split of a sequence to finish
merges the splits' partial softmaxes in the same launch. ``split_plan``
fixes ``n_splits`` from the block table's shape alone, so a launch makes no
host sync and allocates nothing that depends on ``lengths``. The design and
what still holds it back are described at the top of the ``.cu`` source;
``paged_attention_split_plain`` computes the same partials and merge in
plain PyTorch.

``paged_attention`` runs the plain version only for tensors on the CPU
(and on the meta device, which computes nothing). On CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import refuse_grad

DEFAULT_PAGE_SIZE = 16
PAGES_PER_SPLIT = 16     # 256 tokens of one sequence per block, as in the kernel
_NEG_INF = -1e30
_HEAD_DIMS = (64, 80, 96, 128)
_MAX_GROUP = 8


class SplitPlan(NamedTuple):
    """Grid and scratch of one launch, from shapes only."""
    n_splits: int
    grid: Tuple[int, int, int]              # (B, n_kv, n_splits)
    stats_shape: Tuple[int, int, int, int]  # m and l: (B, n_kv, n_splits, group)
    acc_shape: Tuple[int, int, int, int, int]   # (B, n_kv, n_splits, group, D)


def split_plan(B: int, n_kv: int, group: int, D: int, max_pages: int) -> SplitPlan:
    """The split of a block table of ``max_pages`` pages: ``ceil(max_pages /
    PAGES_PER_SPLIT)`` splits, at least one."""
    n_splits = max(1, -(-max_pages // PAGES_PER_SPLIT))
    return SplitPlan(n_splits, (B, n_kv, n_splits), (B, n_kv, n_splits, group),
                     (B, n_kv, n_splits, group, D))


def _starts(starts: Optional[torch.Tensor], lengths: torch.Tensor) -> torch.Tensor:
    """Each sequence's first position, clipped to ``[0, length]`` as the
    kernel clips it (``None``: 0)."""
    if starts is None:
        return torch.zeros_like(lengths, dtype=torch.long)
    return torch.minimum(starts.long().clamp_min(0), lengths.long())


def paged_attention_partials_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   lengths: torch.Tensor,
                                   starts: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain PyTorch version of the kernel's splits: each split's partial
    softmax ``(m, l, acc)`` over its ``PAGES_PER_SPLIT`` pages, float32,
    shaped as ``split_plan`` says. A split with no token in ``[start,
    length)`` has ``m = -1e30, l = 0, acc = 0`` (the kernel writes no partial
    for it). Table entries outside a sequence's pages in that range are never
    dereferenced."""
    B, n_kv, group, D = q.shape
    page = k_pool.shape[1]
    pps = PAGES_PER_SPLIT
    plan = split_plan(B, n_kv, group, D, block_tables.shape[1])
    m = torch.full(plan.stats_shape, _NEG_INF, device=q.device)
    l = torch.zeros(plan.stats_shape, device=q.device)
    acc = torch.zeros(plan.acc_shape, device=q.device)
    n_pages = (lengths.long() + page - 1) // page
    lo = _starts(starts, lengths)
    qf = q.float()
    for s in range(plan.n_splits):
        pages = torch.arange(s * pps, min((s + 1) * pps, block_tables.shape[1]),
                             device=q.device)
        used = (pages[None, :] < n_pages[:, None]) & \
            (pages[None, :] >= (lo // page)[:, None])           # (B, P)
        bt = torch.where(used, block_tables[:, pages].long(), 0)
        k = k_pool[bt].reshape(B, -1, n_kv, D).float()
        v = v_pool[bt].reshape(B, -1, n_kv, D).float()
        tok = pages[0] * page + torch.arange(k.shape[1], device=q.device)
        valid = ((tok[None, :] < lengths[:, None]) &
                 (tok[None, :] >= lo[:, None]))[:, None, None, :]
        sc = torch.einsum("bkgd,bskd->bkgs", qf, k) / math.sqrt(D)
        sc = torch.where(valid, sc, torch.full_like(sc, _NEG_INF))
        ms = sc.amax(-1)
        p = torch.exp(sc - ms[..., None]) * valid
        m[:, :, s] = ms
        l[:, :, s] = p.sum(-1)
        acc[:, :, s] = torch.einsum("bkgs,bskd->bkgd", p, v)
    return m, l, acc


def paged_attention_merge_plain(m: torch.Tensor, l: torch.Tensor,
                                acc: torch.Tensor, dtype: torch.dtype
                                ) -> torch.Tensor:
    """Plain PyTorch version of the kernel's merge: the splits' partials
    (B, n_kv, n_splits, group[, D]) -> (B, n_kv, group, D) in ``dtype``.
    Splits with ``l == 0`` contribute nothing; with none left the row is 0.
    (The kernel merges only the splits that hold pages of the sequence, and
    those have ``l >= 1``.)"""
    full = l > 0
    m_all = torch.where(full, m, torch.full_like(m, _NEG_INF)).amax(2, keepdim=True)
    w = torch.where(full, torch.exp(m - m_all), torch.zeros_like(m))
    # an empty split's acc is never read: the kernel does not write it
    num = (w[..., None] * torch.where(full[..., None], acc, 0.0)).sum(2)
    den = (w * l).sum(2)
    return (num / den.clamp_min(1e-30)[..., None]).to(dtype)


def paged_attention_split_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, block_tables: torch.Tensor,
                                lengths: torch.Tensor,
                                starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: partials per split, then
    the merge. Same function as ``paged_attention_plain``."""
    m, l, acc = paged_attention_partials_plain(q, k_pool, v_pool, block_tables,
                                               lengths, starts)
    return paged_attention_merge_plain(m, l, acc, q.dtype)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor,
                          starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, any device, any page size.

    q (B, n_kv, group, D); pools (P, page, n_kv, D); block_tables
    (B, max_pages); lengths (B,); starts (B,) or None: positions
    ``[starts[b], lengths[b])`` are attended to. Returns (B, n_kv, group, D).
    Softmax in float32; a row with every position masked gives zeros, as the
    kernel's ``acc / max(l, 1e-30)`` does.
    """
    B, n_kv, group, D = q.shape
    page = k_pool.shape[1]
    S = block_tables.shape[1] * page
    bt = block_tables.long()
    k = k_pool[bt].reshape(B, S, n_kv, D).float()
    v = v_pool[bt].reshape(B, S, n_kv, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k) / math.sqrt(D)
    tok = torch.arange(S, device=q.device)[None, :]
    valid = (tok < lengths[:, None]) & (tok >= _starts(starts, lengths)[:, None])
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1) * valid      # length 0: uniform -> zeros
    o = torch.einsum("bkgs,bskd->bkgd", w, v)
    return o.to(q.dtype)


def _check(q, k_pool, v_pool, block_tables, lengths, starts, page_size):
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
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("block_tables", block_tables), ("lengths", lengths)]
    if starts is not None:
        if starts.dtype != torch.int32 or starts.shape != (B,):
            raise ValueError("paged_attention kernel: starts (B,) int32 expected")
        tensors.append(("starts", starts))
    for name, t in tensors:
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
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 counters on ``device`` that are 0 between launches: one
    buffer per device and size, allocated zeroed at its first use and never
    freed or replaced, so that every launch of that size (a CUDA graph
    captured over one included) finds it at the same address. The kernel's
    merging split sets the counters back to 0, so a launch neither clears
    nor moves them. Launches on one device must not run concurrently on two
    streams; graphs replayed on one stream never overlap."""
    device = torch.device(device)
    t = _tickets.get((device, n))
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            # a capture would record the zero fill, not run it
            raise RuntimeError(
                f"paged_attention: no ticket counters of size {n} before a "
                "CUDA graph capture; launch once eagerly first")
        t = _tickets[(device, n)] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    page_size: int = DEFAULT_PAGE_SIZE,
                    starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over paged KV.

    q            (B, n_kv, group, D)   one query token per sequence
    k_pool/v_pool(num_pages, page_size, n_kv, D)
    block_tables (B, max_pages) int32  page ids per sequence
    lengths      (B,) int32            tokens in each sequence's KV
    starts       (B,) int32 or None    first position attended to (a
                                       sliding window's lower bound)
    returns      (B, n_kv, group, D)

    Tensors on the CPU (and on the meta device, which computes nothing)
    go through ``paged_attention_plain``; tensors on a
    CUDA device launch the kernel (counted in ``paged_attention.launches``)
    or raise. The kernel has no backward (it serves the decode step, which
    no training path runs): on a CUDA device, inputs that require a gradient
    (with grad mode on) raise ``NotImplementedError`` instead of losing it.
    """
    if q.device.type in ("cpu", "meta"):
        return paged_attention_plain(q, k_pool, v_pool, block_tables, lengths,
                                     starts)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: device {q.device} not supported")
    refuse_grad("paged_attention", q, k_pool, v_pool)
    _check(q, k_pool, v_pool, block_tables, lengths, starts, page_size)
    B, n_kv, group, D = q.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    plan = split_plan(B, n_kv, group, D, block_tables.shape[1])
    scratch = [0, 0, 0, 0]    # no partials and no tickets with a single split
    if plan.n_splits > 1:
        # one float32 allocation holds m, l and acc, in that order
        n_stats = math.prod(plan.stats_shape)
        part = torch.empty(n_stats * (2 + D), dtype=torch.float32, device=q.device)
        base = part.data_ptr()
        tickets = _ticket_counters(q.device, B * n_kv)
        scratch = [base, base + 4 * n_stats, base + 8 * n_stats, tickets.data_ptr()]
    with torch.cuda.device(q.device):
        err = _library().paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(),
            None if starts is None else starts.data_ptr(), out.data_ptr(),
            *scratch, B, n_kv, group, D, block_tables.shape[1], plan.n_splits,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0   # launches of the CUDA kernel
