"""Mamba2 SSD chunked scan: wrapper, plain PyTorch versions, launch counters.

The kernels are in ``csrc/ssd_scan.cu`` (CUDA C++ for sm_90a). They replace
the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan`` (body ``_kernel``) and
compute the same function: per (batch, head), chunks in order with the
(P, N) state carried across them, an intra-chunk term
``((C B^T) o L o dt_j) x`` and an inter-chunk term ``exp(dA_cum) (C h^T)``.
Unlike the TPU kernel they take any sequence length: the steps past ``s`` of
the last chunk are masked in the kernel (no input, no decay, no store),
which is what ``repro.kernels.ops.ssd_scan``'s padding to a chunk multiple
computes, so the wrapper makes no padded copies. x, B and C may be strided
views (their last axis contiguous), as ``mamba_forward`` slices them out of
one projection.

Bound on the H100 at the serving path's shape (1 x 341 steps, 64 heads,
P = 64, N = 128, bf16): bytes, 7.9 MB (x, dt, B, C and h0 read once, y and
the fp32 state written once), 2.37 us at 3.35 TB/s; the 0.76 GFLOP the data
needs take a third of that on the bf16 tensor cores. The source holds two
kernels, chosen here by dtype and nothing else. bf16 runs every product on
the tensor cores (``wgmma``): one block per (batch, head, 32 columns of P)
walks the chunks with the state in registers, a producer warp loads the C,
B and x tiles by TMA (tensor maps encoded per call over the strided views)
and scans ``dt * A``, and two consumer warpgroups run the products. The
operands it forms itself (the weights ``W``, ``fin o B`` of the state update
and the copy of the state that ``C h^T`` reads) go to the tensor cores as a
bf16 head and tail, which keeps them to 16 bits. float32 runs on the FMA
kernel (tensor cores would round it to TF32). Their designs and what holds
them back are described at the top of the ``.cu`` source.

``ssd_scan`` runs the plain version only for tensors on the CPU. On CUDA
tensors it launches the kernel for their dtype or raises; a bf16 launch
that fails is not retried on the FMA kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._grad import refuse_grad

_CHUNKS = (32, 64, 128, 256)
_HEAD_DIMS = (32, 64)          # P
_STATE_DIMS = (16, 64, 128)    # N


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, any device: the chunked SSD of
    ``repro.models.ssm.ssd_chunked`` (Mamba2 Listing 1), with its signature.

    x (b,s,h,p); dt (b,s,h); A (h,); B/C (b,s,n); h0 optional (b,h,p,n).
    Returns (y (b,s,h,p) in x's dtype, final state (b,h,p,n) float32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        # pad to a chunk multiple: dt = 0 makes padded steps the identity
        # (decay exp(0) = 1, zero input), so the final state is unaffected
        pad = chunk - s % chunk
        y, h_final = ssd_scan_plain(F.pad(x, (0, 0, 0, 0, 0, pad)),
                                    F.pad(dt, (0, 0, 0, pad)), A,
                                    F.pad(B, (0, 0, 0, pad)),
                                    F.pad(C, (0, 0, 0, pad)), chunk, h0=h0)
        return y[:, :s], h_final
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    dA = dtc * A                                      # (b,nc,cs,h), negative
    dA_cum = torch.cumsum(dA, dim=2)

    # intra-chunk: L[i,j] = exp(dA_cum[i] - dA_cum[j]) for i >= j, else 0.
    # The exponent is masked, not the result: for i < j it is positive and
    # exp overflows to inf, and inf * 0 is NaN.
    li = dA_cum[:, :, :, None, :]
    lj = dA_cum[:, :, None, :, :]
    idx = torch.arange(chunk, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    Lmat = torch.exp(torch.where(mask, li - lj, -torch.inf))
    scores = torch.einsum("bzin,bzjn->bzij", Cc, Bc)
    w = scores[..., None] * Lmat * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", w, xc)

    # per-chunk final states
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (b,nc,cs,h)
    states = torch.einsum("bzjn,bzjh,bzjhp->bzhpn", Bc,
                          (decay_to_end * dtc).float(), xc)     # (b,nc,h,p,n)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    entering = []
    for z in range(nc):
        entering.append(state)
        state = chunk_decay[:, z, :, None, None] * state + states[:, z]
    h_entering = torch.stack(entering, dim=1)                   # (b,nc,h,p,n)

    # inter-chunk output: the decayed state entering each chunk
    y_off = torch.einsum("bzin,bzih,bzhpn->bzihp", Cc, torch.exp(dA_cum),
                         h_entering)
    y = (y_diag + y_off).reshape(b, s, h, p).to(x.dtype)
    return y, state


def ssd_sequential_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fully sequential recurrence (``repro.kernels.ref.ssd_sequential_ref``):
    the ground truth for the chunked form. Shapes as ``ssd_scan_plain``;
    the initial state is zero."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        Bt, Ct = B[:, t].float(), C[:, t].float()
        dA = torch.exp(dtt * A)                                   # (b,h)
        upd = (dtt[:, :, None] * xt)[..., None] * Bt[:, None, None, :]
        state = dA[:, :, None, None] * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Ct))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _check(x, dt, A, B, C, h0, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3:
        raise ValueError("ssd_scan: x (b,s,h,p), dt (b,s,h), A (h,), B and C "
                         "(b,s,n) expected")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) \
            or C.shape != B.shape:
        raise ValueError("ssd_scan: shapes of x, dt, A, B and C do not match")
    if h0 is not None and h0.shape != (b, h, p, n):
        raise ValueError(f"ssd_scan: h0 must be {(b, h, p, n)}, got "
                         f"{tuple(h0.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan kernel: dtype {x.dtype} not taken "
                        "(float32 and bfloat16 are)")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_scan kernel: x, B and C must share one dtype")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or \
            (h0 is not None and h0.dtype != torch.float32):
        raise TypeError("ssd_scan kernel: dt, A and h0 must be float32")
    if chunk not in _CHUNKS or p not in _HEAD_DIMS or n not in _STATE_DIMS:
        raise ValueError(f"ssd_scan kernel: chunk {chunk}, P {p}, N {n} not "
                         f"taken (chunk in {_CHUNKS}, P in {_HEAD_DIMS}, N in "
                         f"{_STATE_DIMS} are)")
    if b < 1 or s < 1 or h < 1:
        raise ValueError("ssd_scan kernel: empty batch, sequence or heads")
    vec = 16 // x.element_size()
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("h0", h0)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"ssd_scan kernel: {name} on {t.device}, x on "
                             f"{x.device}")
        if name in ("x", "B", "C") and (
                t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"ssd_scan kernel: {name} needs a contiguous last "
                             f"axis and 16-byte aligned rows, got strides "
                             f"{t.stride()}")
        if name in ("A", "h0") and not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel: {name} must be contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.library("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
            [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, h0: Optional[torch.Tensor] = None,
             *, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the reference's ``ops.ssd_scan`` layout.

    x (b,s,h,p); dt (b,s,h) f32; A (h,) f32; B/C (b,s,n); h0 optional
    (b,h,p,n) f32 -> (y (b,s,h,p) in x's dtype, final state (b,h,p,n) f32).
    Any ``s``: a ragged last chunk is masked, not padded.

    Tensors on the CPU go through ``ssd_scan_plain``; tensors on a CUDA
    device launch the kernel (and count the launch in ``ssd_scan.launches``,
    a bf16 launch of the tensor-core kernel also in
    ``ssd_scan.tensor_core_launches``) or raise. The kernel has no backward:
    on a CUDA device, inputs that require a gradient (with grad mode on)
    raise ``NotImplementedError`` instead of losing it.
    """
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: device {x.device} not supported")
    refuse_grad("ssd_scan", x, dt, A, B, C, h0)
    _check(x, dt, A, B, C, h0, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        *y.stride()[:3])
    # bf16 on the tensor cores; float32 on the FMA kernel, which keeps it
    # exact (the tensor cores would round it to TF32)
    tensor_cores = x.dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        err = _library().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), state.data_ptr(),
            b, s, h, p, n, chunk, int(tensor_cores), strides,
            torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"ssd_scan: cuTensorMapEncodeTiled failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    ssd_scan.tensor_core_launches += int(tensor_cores)
    return y, state


ssd_scan.launches = 0   # launches of either CUDA kernel by this wrapper
ssd_scan.tensor_core_launches = 0   # of those, the bf16 wgmma kernel's
