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
needs take a third of that on the bf16 tensor cores. The source holds three
kernels, chosen by ``forward_route`` on the dtype and the shape alone. bf16
runs every product on the tensor cores (``wgmma``): one block per (batch,
head, 32 columns of P) walks the chunks with the state in registers, a
producer warp loads the C, B and x tiles by TMA (tensor maps encoded per
call over the strided views) and scans ``dt * A``, and two consumer
warpgroups run the products. The operands it forms itself (the weights
``W``, ``fin o B`` of the state update and the copy of the state that
``C h^T`` reads) go to the tensor cores as a bf16 head and tail, which keeps
them to 16 bits. float32 in one chunk of at least ``TC_MIN_STEPS`` steps
from a zero state (P 64, N 64 or 128: every training call) runs the 6xTF32
kernel: every product on ``mma.sync`` with each operand split into three
TF32 pieces (six products, which keeps float32's precision), the running sum
of dt * A in float64, a block owning a few heads of one sequence so
that C B^T is formed once a tile pair for all of them. Every other float32
shape runs the FMA kernel. Their designs and what holds them back are
described at the top of the ``.cu`` source.

``ssd_scan`` runs the plain version only for tensors on the CPU (and on the
meta device, which computes nothing). On CUDA
tensors it launches the kernel ``forward_route`` names or raises; a launch
that fails is not retried on another kernel.

Gradients. A call whose inputs require a gradient (with grad mode on) goes
through ``SSDScan``, an autograd function whose forward is the call above
and whose backward is ``ssd_scan_backward``: on CUDA tensors it launches
``csrc/ssd_scan_bwd.cu`` (for one chunk of at least ``TC_MIN_STEPS`` steps
without state, as in training, the tensor-core kernel: every product in
6xTF32 on ``mma.sync`` for float32 inputs, 3xTF32 for bf16, float32-
accurate; else the fp32 FMA kernel; both for float32 and bf16 inputs), on
CPU tensors it runs ``ssd_scan_backward_plain`` (the explicit formulas, no
autograd), so that training takes the same route on both. The TPU package
has no Pallas backward: it trains through ``jax.grad`` of its jnp oracle
(``repro.models.ssm.ssd_chunked``), which the backward kernel stands in
for. A backward that fails is not retried on the other kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._grad import wants_grad

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
    Returns (y (b,s,h,p) in x's dtype, final state (b,h,p,n) float32). The
    sums run in float32, in float64 for float64 inputs (the tests' exact
    check of the backward's formulas).
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
    wide = torch.promote_types(x.dtype, torch.float32)
    xc = x.reshape(b, nc, chunk, h, p).to(wide)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).to(wide)
    Cc = C.reshape(b, nc, chunk, n).to(wide)

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
                          (decay_to_end * dtc).to(wide), xc)    # (b,nc,h,p,n)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=wide, device=x.device) \
        if h0 is None else h0.to(wide)
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


def ssd_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                            B: torch.Tensor, C: torch.Tensor,
                            h0: Optional[torch.Tensor], dy: torch.Tensor,
                            dstate: Optional[torch.Tensor], chunk: int):
    """The gradients ``(dx, ddt, dA, dB, dC, dh0)`` of ``ssd_scan_plain`` by
    the explicit formulas, without autograd, in float32 (float64 for
    float64 inputs), for the cotangents ``dy`` of y and ``dstate`` of the
    final state (``None``: zero, as in training, where the loss never reads
    it). Each gradient in its input's dtype; dh0 is ``None`` without ``h0``.

    Per chunk, with a_i the running sum of dt * A inside it, a_L its last
    value, L_ij = exp(a_i - a_j) for i >= j, S_ij = C_i . B_j, M_ij = dy_i . x_j,
    h the state entering the chunk (recomputed by a forward sweep) and G the
    gradient of the state leaving it (carried from the last chunk back):

      dx_j = sum_{i>=j} S_ij L_ij dt_j dy_i + exp(a_L - a_j) dt_j G B_j
      dB_j = sum_h [sum_{i>=j} M_ij L_ij dt_j C_i + exp(a_L - a_j) dt_j G^T x_j]
      dC_i = sum_h [sum_{j<=i} M_ij L_ij dt_j B_j + exp(a_i) h^T dy_i]
      G   <- exp(a_L) G + sum_i exp(a_i) dy_i C_i^T   (the entering state's)

    d(dt_j) is its direct part plus A times the reverse sum, inside the
    chunk, of the gradients of the a_k; dA is dt times that sum, summed over
    b and s. Every exponent is a difference, masked before ``exp``. A ragged
    last chunk is padded with dt = 0 as the forward pads it."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = -s % chunk
    wide = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Bf, Cf, dyf = (t.to(wide) for t in (x, dt, B, C, dy))
    if pad:
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (Bf, Cf))
    nc = (s + pad) // chunk
    xc, dyc = (t.reshape(b, nc, chunk, h, p) for t in (xf, dyf))
    dtc = dtf.reshape(b, nc, chunk, h)
    Bc, Cc = (t.reshape(b, nc, chunk, n) for t in (Bf, Cf))
    Af = A.to(wide)

    a = torch.cumsum(dtc * Af, dim=2)                            # (b,z,L,h)
    a_last = a[:, :, -1]                                         # (b,z,h)
    idx = torch.arange(chunk, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    Lmat = torch.exp(torch.where(mask, a[:, :, :, None] - a[:, :, None], -torch.inf))
    S = torch.einsum("bzin,bzjn->bzij", Cc, Bc)[..., None]      # (b,z,i,j,1)
    M = torch.einsum("bzihp,bzjhp->bzijh", dyc, xc)              # (b,z,i,j,h)
    dt_j = dtc[:, :, None]                                       # (b,z,1,j,h)
    W = S * Lmat * dt_j                                          # dx's weights
    Z = M * Lmat * dt_j                                          # dB's and dC's
    Q = S * Lmat * M                                             # d(dt)'s
    ea = torch.exp(a)                                            # (b,z,L,h)
    fin = torch.exp(a_last[:, :, None] - a) * dtc                # (b,z,L,h)

    # the state entering each chunk, then the gradient of the state leaving it
    states = torch.einsum("bzjn,bzjh,bzjhp->bzhpn", Bc, fin, xc)
    state = torch.zeros((b, h, p, n), dtype=wide, device=x.device) \
        if h0 is None else h0.to(wide)
    entering = []
    for z in range(nc):
        entering.append(state)
        state = torch.exp(a_last[:, z])[..., None, None] * state + states[:, z]
    G = torch.zeros_like(state) if dstate is None else dstate.to(wide)
    leaving = [None] * nc
    for z in range(nc - 1, -1, -1):
        leaving[z] = G
        G = torch.exp(a_last[:, z])[..., None, None] * G + torch.einsum(
            "bihp,bih,bin->bhpn", dyc[:, z], ea[:, z], Cc[:, z])
    Hs, Gs = torch.stack(entering, dim=1), torch.stack(leaving, dim=1)

    GB = torch.einsum("bzhpn,bzjn->bzjhp", Gs, Bc)               # (b,z,j,h,p)
    dx = torch.einsum("bzijh,bzihp->bzjhp", W, dyc) + fin[..., None] * GB
    dB = torch.einsum("bzijh,bzin->bzjn", Z, Cc) + torch.einsum(
        "bzjh,bzhpn,bzjhp->bzjn", fin, Gs, xc)
    hdy = torch.einsum("bzhpn,bzihp->bzihn", Hs, dyc) * ea[..., None]
    dC = torch.einsum("bzijh,bzjn->bzin", Z, Bc) + hdy.sum(dim=3)
    g = torch.exp(a_last[:, :, None] - a) * (xc * GB).sum(-1)   # (b,z,j,h)
    col = Q.sum(dim=2)                                           # sum over i
    da = (Q * dt_j).sum(dim=3) - dtc * col - dtc * g + \
        torch.einsum("bzin,bzihn->bzih", Cc, hdy)
    da[:, :, -1] += torch.exp(a_last) * (Gs * Hs).sum((-1, -2)) + (dtc * g).sum(2)
    r = torch.flip(torch.cumsum(torch.flip(da, [2]), dim=2), [2])
    ddt = col + g + Af * r
    dA = (dtc * r).sum((0, 1, 2))
    dh0 = None if h0 is None else G.to(h0.dtype)
    return (dx.reshape(b, nc * chunk, h, p)[:, :s].to(x.dtype),
            ddt.reshape(b, nc * chunk, h)[:, :s].to(dt.dtype),
            dA.to(A.dtype),
            dB.reshape(b, nc * chunk, n)[:, :s].to(B.dtype),
            dC.reshape(b, nc * chunk, n)[:, :s].to(C.dtype),
            dh0)


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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + \
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

    Tensors on the CPU (and on the meta device, which computes nothing)
    go through ``ssd_scan_plain``; tensors on a CUDA
    device launch the kernel ``forward_route`` names (and count the launch
    in ``ssd_scan.launches``, a bf16 launch of the wgmma kernel also in
    ``ssd_scan.tensor_core_launches``, one of the float32 6xTF32 kernel in
    ``ssd_scan.tf32_launches``) or raise. A call whose inputs require
    a gradient (with grad mode on) goes through ``SSDScan`` on both devices:
    the same forward, and ``ssd_scan_backward`` for its gradient (the
    backward kernel on the card, ``ssd_scan_backward_plain`` on the CPU). A
    call without one takes the forward alone, as serving does.
    """
    if wants_grad(x, dt, A, B, C, h0):
        return SSDScan.apply(x, dt, A, B, C, h0, chunk)
    return _forward(x, dt, A, B, C, h0, chunk)


def _forward(x, dt, A, B, C, h0, chunk):
    """``ssd_scan`` without autograd: the plain version on the CPU (and on
    the meta device), the kernel on a CUDA device."""
    if x.device.type in ("cpu", "meta"):
        return ssd_scan_plain(x, dt, A, B, C, chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: device {x.device} not supported")
    _check(x, dt, A, B, C, h0, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        *y.stride()[:3])
    is_bf16 = x.dtype == torch.bfloat16
    route, heads = forward_route(
        b, s, h, p, n, chunk, h0 is not None, is_bf16,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    with torch.cuda.device(x.device):
        err = _library().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), state.data_ptr(),
            b, s, h, p, n, chunk, int(is_bf16), int(route == "tf32"), heads, strides,
            torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"ssd_scan: cuTensorMapEncodeTiled failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    ssd_scan.tensor_core_launches += int(route == "wgmma")
    ssd_scan.tf32_launches += int(route == "tf32")
    return y, state


ssd_scan.launches = 0   # launches of any CUDA kernel by this wrapper
ssd_scan.tensor_core_launches = 0   # of those, the bf16 wgmma kernel's
ssd_scan.tf32_launches = 0   # of those, the float32 6xTF32 kernel's


# The shapes the forward's 6xTF32 kernel takes (``csrc/ssd_scan.cu``,
# ``ssd_scan_kernel_tf32``): float32, P 64, N 64 or 128, one chunk of
# TC_MIN_STEPS to chunk steps from a zero state, which is every training call
# of mamba2-1.3b and zamba2-2.7b at 16 <= s <= 256. Every other float32 shape
# goes to the FMA kernel.
_TF32_HEAD_DIM = 64
_TF32_STATE_DIMS = (64, 128)
_TF32_MAX_HEADS = 5   # kTfMaxHeads: the heads one block of the 6xTF32 kernel owns
# the fewest steps the tensor-core kernels (forward and backward) take. In a
# short chunk every output is a sum of a few products: the kernel's error and
# the plain float32 version's against float64 are each a few roundings, and
# their ratio has a long tail whatever order either sums in (at s = 1 the
# backward's dC read 5.35x the plain version's on the tensor cores and 4.9x
# on the FMA kernel, each on one of eight or nine draws; 4-5x at s = 4 and
# 8 on the FMA kernel; H100, scripts/ssd_float64_survey_torch.py). From 16
# steps on, the plain version's exponents a_i - a_j carry the roundings of
# its float32 running sums, which the tensor-core kernels' float64 sums do
# not, and the tensor-core kernels stay within chip_smoke.py's factor of 4
# on every draw (at most 1.45x at 16 steps). Shorter calls go to the FMA
# kernels, plain float32 arithmetic like the plain version's
TC_MIN_STEPS = 16


def forward_route(b: int, s: int, h: int, p: int, n: int, chunk: int, has_h0: bool,
                  is_bf16: bool, n_sms: int) -> Tuple[str, int]:
    """``(kernel, heads_per_block)`` of a forward launch, decided on the dtype
    and the shape alone: ``"wgmma"`` for bf16; for float32 ``"tf32"``, the
    6xTF32 kernel, where P is 64, N 64 or 128, ``TC_MIN_STEPS <= s <= chunk``
    and there is no ``h0``, with the heads of a sequence one of its blocks owns (C B^T is
    shared by them): the fewest that fit the b x ceil(h / heads) blocks into
    one wave of ``n_sms`` blocks, at most ``_TF32_MAX_HEADS`` (mamba2-1.3b's
    training shape, 8 x 64 heads on 132 SMs: 4; zamba2's, 8 x 80: 5); else
    ``"fma"``. The other kernels own one head (a part of it) a block."""
    if is_bf16:
        return "wgmma", 1
    if p == _TF32_HEAD_DIM and n in _TF32_STATE_DIMS and TC_MIN_STEPS <= s <= chunk \
            and not has_h0:
        return "tf32", min(_TF32_MAX_HEADS, max(1, -(-b * h // n_sms)))
    return "fma", 1


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with a gradient: the forward is the call without one (the
    kernel on the card, the plain version on the CPU) and saves x, dt, A, B,
    C and h0; the backward is ``ssd_scan_backward``, given the cotangents of
    y and of the final state (``None`` where the loss does not read it, as in
    training). It returns a gradient for ``h0`` only when ``h0`` was given."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk: int):
        y, state = _forward(x, dt, A, B, C, h0, chunk)
        ctx.save_for_backward(x, dt, A, B, C, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
        dx, ddt, dA, dB, dC, dh0 = ssd_scan_backward(x, dt, A, B, C, h0, dy, dstate,
                                                     chunk=ctx.chunk)
        return dx, ddt, dA, dB, dC, dh0, None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _backward_library() -> ctypes.CDLL:
    lib = _build.library("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + \
            [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# The shapes the backward's tensor-core kernel takes (``csrc/ssd_scan_bwd.cu``,
# ``ssd_scan_bwd_tc``): P 64, N 64 or 128, one chunk (s <= chunk), no h0 and
# no final-state cotangent, which is every training call of mamba2-1.3b and
# zamba2-2.7b at s <= 256. Every other shape goes to the FMA kernel.
_TC_HEAD_DIM = 64
_TC_STATE_DIMS = (64, 128)
_TC_MAX_HEADS = 5   # kMaxHeads: the heads one block of the tensor-core kernel owns


def backward_route(b: int, s: int, h: int, p: int, n: int, chunk: int, has_h0: bool,
                   has_dstate: bool, n_sms: int) -> Tuple[bool, int]:
    """``(tensor_cores, heads_per_block)`` of a backward launch: whether the
    shape goes to the tensor-core kernel, and how many heads of a sequence
    one of its blocks owns (its C B^T and the sums of dB and dC over those
    heads are shared): the fewest that fit the b x ceil(h / heads) blocks
    into one wave of ``n_sms`` blocks, at most ``_TC_MAX_HEADS``
    (mamba2-1.3b's training shape, 8 x 64 heads on 132 SMs: 4; zamba2's, 8 x
    80: 5). The FMA kernel owns one head a block."""
    if p == _TC_HEAD_DIM and n in _TC_STATE_DIMS and TC_MIN_STEPS <= s <= chunk \
            and not has_h0 and not has_dstate:
        return True, min(_TC_MAX_HEADS, max(1, -(-b * h // n_sms)))
    return False, 1


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, h0: Optional[torch.Tensor],
                      dy: torch.Tensor, dstate: Optional[torch.Tensor] = None, *,
                      chunk: int = 256):
    """The gradients ``(dx, ddt, dA, dB, dC, dh0)`` of ``ssd_scan(x, dt, A,
    B, C, h0, chunk=chunk)`` for the cotangents ``dy`` of y and ``dstate``
    of the final state (``None``: zero). dx, dB and dC in their inputs'
    dtypes, ddt, dA and dh0 float32; dh0 is ``None`` without ``h0``.

    Tensors on the CPU (and on the meta device, which computes nothing)
    go through ``ssd_scan_backward_plain``; tensors on a
    CUDA device launch ``csrc/ssd_scan_bwd.cu`` (counted in
    ``ssd_scan_backward.launches``, one a call) or raise. The source holds
    two kernels, chosen by ``backward_route`` on the shape alone: the
    tensor-core kernel (6xTF32 ``mma.sync`` products for float32, 3xTF32
    for bf16, a block owning a few heads of one sequence; counted in
    ``ssd_scan_backward.tensor_core_launches`` too) for one chunk of at least
    ``TC_MIN_STEPS`` steps without state, the FMA kernel (one head a block) for the rest; float32 and bf16
    inputs both. x, B, C and dt are read through their strides; dy too where
    its last axis is contiguous and its rows 16-byte aligned (else it is
    made contiguous), dstate is made contiguous. The kernels write partials
    of dB and dC per block (summed over the block's heads) and of dA per
    (batch, head), with no atomics (the same inputs give the same bits); the
    sums over the head groups and over the batch here are the second pass of
    that cross-block reduction.
    """
    if x.device.type in ("cpu", "meta"):
        return ssd_scan_backward_plain(x, dt, A, B, C, h0, dy, dstate, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_backward: device {x.device} not supported")
    _check(x, dt, A, B, C, h0, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("ssd_scan_backward: dy must have x's shape, dtype and device")
    vec = 16 // x.element_size()
    if dy.stride(-1) != 1 or any(st % vec for st in dy.stride()[:-1]) or \
            dy.data_ptr() % 16:
        dy = dy.contiguous()
    if dstate is not None:
        if dstate.shape != (b, h, p, n) or dstate.dtype != torch.float32 or \
                dstate.device != x.device:
            raise ValueError(f"ssd_scan_backward: dstate must be float32 {(b, h, p, n)} "
                             f"on {x.device}")
        dstate = dstate.contiguous()
    tensor_cores, heads = backward_route(
        b, s, h, p, n, chunk, h0 is not None, dstate is not None,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    groups = -(-h // heads)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), **f32)
    dA_part = torch.empty((b, h), **f32)
    dB_part = torch.empty((groups, b, s, n), **f32)
    dC_part = torch.empty((groups, b, s, n), **f32)
    dh0 = None if h0 is None else torch.empty((b, h, p, n), **f32)
    n_chunks = -(-s // chunk)
    # the states entering chunks 1 .., recomputed by the FMA kernel's forward sweep
    scratch = torch.empty((b, h, n_chunks - 1, p, n), **f32) if n_chunks > 1 else None
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        *dy.stride()[:3])
    with torch.cuda.device(x.device):
        err = _backward_library().ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            _ptr(h0), dy.data_ptr(), _ptr(dstate), dx.data_ptr(), ddt.data_ptr(),
            dA_part.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(), _ptr(dh0),
            _ptr(scratch), b, s, h, p, n, chunk, int(x.dtype == torch.bfloat16),
            int(tensor_cores), heads, strides, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_backward kernel launch failed: CUDA error {err}")
    ssd_scan_backward.launches += 1
    ssd_scan_backward.tensor_core_launches += int(tensor_cores)
    return (dx, ddt, dA_part.sum(0), dB_part.sum(0).to(B.dtype),
            dC_part.sum(0).to(C.dtype), dh0)


ssd_scan_backward.launches = 0   # calls that launched a CUDA kernel
ssd_scan_backward.tensor_core_launches = 0   # of those, the tensor-core kernel's
