"""Mamba2 (SSD, state-space duality) layers (PyTorch). [arXiv:2405.21060]

The port of ``repro.models.ssm``: the chunked SSD (``ssd_chunked``, the
``ssd_scan`` kernel's plain version under the reference's name), a
recurrent one-token decode step, and the full block (in_proj -> causal conv
-> SSD -> gated norm -> out_proj) of the ``ssm`` family. A full-sequence
block routes its scan through ``ops.ssd_scan``: the hand-written kernel on
CUDA tensors, the plain version on CPU tensors.

Under a mesh (``runtime_flags.get_mesh()``, set by
``launch.steps.sharded_step``) a rank holds whole heads: its z, x and dt
columns of ``w_in``, B and C whole (one group), its conv channels [x | B |
C], its heads' ``A_log``, ``D``, ``dt_bias``, its slice of ``norm_w`` and
its rows of ``w_out`` (``params.ssm_layout``; ``cfg`` is the rank's, so
``d_inner`` and ``n_ssm_heads`` are its shares). Every rank computes B and
C; each uses them for its heads only. So the z/x/dt product reads the
normed input through ``copy_to_model_axis`` and the B/C product reads it
itself (its gradient there is whole on every rank), while B and C after the
conv pass through ``copy_to_model_axis`` (their gradient is the sum of the
ranks' heads'), as the MoE router does (``moe._router_logits``). The gated
norm sums its squares over the model axis forward and backward
(``layers.sum_model_axis``) and divides by the whole width; ``w_out``'s
product sums over the axis (``layers.row_parallel``). With no mesh nothing
changes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ssd_chunked
from repro_torch.models import runtime_flags
from repro_torch.models.layers import (_dense_init, copy_to_model_axis, rms_norm,
                                       row_parallel, sum_model_axis)

Params = Dict[str, Any]

__all__ = ["ssd_chunked", "ssd_decode_step", "init_mamba_layer",
           "mamba_forward", "mamba_decode"]


# ------------------------------------------------------------- SSD core


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. x (b,h,p), dt (b,h), B/C (b,n), h (b,h,p,n) fp32.

    The state is updated IN PLACE and returned (the reference returns a new
    one): ``h`` is a layer's slice of the engine's state pool, which a
    functional update would copy whole on every layer of every step.
    """
    dA = torch.exp(dt * A)                                       # (b,h)
    u = dt[:, :, None] * x.float()                               # (b,h,p)
    h.mul_(dA[:, :, None, None]).addcmul_(u[..., None], B.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, C.float())
    return y.to(x.dtype), h


# ------------------------------------------------------------- Mamba2 block


def init_mamba_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
                     device) -> Params:
    d = cfg.d_model
    di = cfg.d_inner
    N = cfg.ssm.state_dim
    H = cfg.n_ssm_heads
    conv_ch = di + 2 * N
    f32 = torch.float32
    return {
        # projects to [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": _dense_init(gen, (d, 2 * di + 2 * N + H), dtype, device),
        "conv_w": _dense_init(gen, (cfg.ssm.conv_width, conv_ch), dtype, device,
                              scale=1.0 / math.sqrt(cfg.ssm.conv_width)),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "norm_w": torch.ones((di,), dtype=dtype, device=device),
        "w_out": _dense_init(gen, (di, d), dtype, device),
        "rms_w": torch.ones((d,), dtype=dtype, device=device),   # pre-norm
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm.state_dim
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * N]
    dt = proj[..., di + di + 2 * N:]
    return z, xBC, dt


def _project(cfg: ModelConfig, hid: torch.Tensor, w_in: torch.Tensor) -> torch.Tensor:
    """``hid @ w_in``; under a mesh the z/x and dt columns from ``hid``
    through ``copy_to_model_axis``, the B/C columns from ``hid`` itself
    (module docstring)."""
    if runtime_flags.get_mesh() is None:
        return hid @ w_in
    di, N = cfg.d_inner, cfg.ssm.state_dim
    hc = copy_to_model_axis(hid)
    return torch.cat([hc @ w_in[:, :2 * di], hid @ w_in[:, 2 * di:2 * di + 2 * N],
                      hc @ w_in[:, 2 * di + 2 * N:]], dim=-1)


def _gated_norm(cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """``rms_norm(y * silu(z), w)`` over the whole ``d_inner``: under a mesh
    each rank's squares summed over the model axis (``sum_model_axis``) and
    divided by the ranks' width together."""
    g = y * F.silu(z)
    axis = runtime_flags.get_mesh()
    if axis is None:
        return rms_norm(g, w)
    gf = g.float()
    ss = sum_model_axis(torch.sum(gf * gf, dim=-1, keepdim=True))
    return (gf * torch.rsqrt(ss / (cfg.d_inner * axis.size) + 1e-5) * w.float()).to(g.dtype)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xBC (b,s,ch), w (width,ch)."""
    width = w.shape[0]
    s = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(width))
    return F.silu(out + b)


def mamba_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  h0: Optional[torch.Tensor] = None,
                  conv0: Optional[torch.Tensor] = None):
    """Full-sequence Mamba2 block. x (b,s,d) -> (x + out, final ssm state
    (b,H,P,N) fp32, conv state: the last ``conv_width - 1`` rows of the
    conv input, fewer when ``s`` is shorter)."""
    b, s, _ = x.shape
    di, N, H = cfg.d_inner, cfg.ssm.state_dim, cfg.n_ssm_heads
    P = cfg.ssm.head_dim
    hid = rms_norm(x, p["rms_w"])
    proj = _project(cfg, hid, p["w_in"])
    z, xBC, dt_raw = _split_proj(cfg, proj)
    if conv0 is not None:
        xBC_ext = torch.cat([conv0.to(xBC.dtype), xBC], dim=1)
        conv_out = _causal_conv(xBC_ext, p["conv_w"], p["conv_b"])[:, conv0.shape[1]:]
    else:
        conv_out = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    # strided views of conv_out: the kernel reads them in place
    xs = conv_out[..., :di].reshape(b, s, H, P)
    B = copy_to_model_axis(conv_out[..., di:di + N])
    C = copy_to_model_axis(conv_out[..., di + N:])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_final = ops.ssd_scan(xs, dt, A, B, C, h0, chunk=cfg.ssm.chunk_size)
    y = y + p["D"][None, None, :, None].to(y.dtype) * xs
    y = y.reshape(b, s, di)
    y = _gated_norm(cfg, y, z, p["norm_w"])
    out = row_parallel(y, p["w_out"])
    conv_state = xBC[:, -(cfg.ssm.conv_width - 1):, :]
    return x + out, h_final, conv_state


def mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 h: torch.Tensor, conv_state: torch.Tensor):
    """One-token step. x (b,1,d); h (b,H,P,N) fp32, updated in place;
    conv_state (b,width-1,ch). Returns (x + out, h, new conv state)."""
    b = x.shape[0]
    di, N, H = cfg.d_inner, cfg.ssm.state_dim, cfg.n_ssm_heads
    P = cfg.ssm.head_dim
    hid = rms_norm(x, p["rms_w"])
    proj = _project(cfg, hid, p["w_in"])
    z, xBC, dt_raw = _split_proj(cfg, proj)
    window = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                      + p["conv_b"])[:, None, :]
    xs = conv_out[..., :di].reshape(b, H, P)
    B = conv_out[:, 0, di:di + N]
    C = conv_out[:, 0, di + N:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h = ssd_decode_step(xs, dt, A, B, C, h)
    y = y + p["D"][None, :, None].to(y.dtype) * xs
    y = y.reshape(b, 1, di)
    y = _gated_norm(cfg, y, z, p["norm_w"])
    out = row_parallel(y, p["w_out"])
    return x + out, h, window[:, 1:, :]
