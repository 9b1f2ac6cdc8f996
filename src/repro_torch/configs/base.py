"""Model/architecture configuration for the repro framework.

One ``ModelConfig`` describes everything the model layer, serving runtime,
launcher and dry-run need to know about an architecture. Every assigned
architecture gets its own module in this package exporting ``CONFIG`` (the
exact assigned spec) and ``smoke_config()`` (a reduced same-family variant for
CPU smoke tests: <=2 layers, d_model <= 512, <= 4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared_experts: int = 0     # always-on shared experts
    experts_per_token: int = 0    # top-k
    d_ff: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01  # load-balance loss weight


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 0            # N, the SSM state size per head
    head_dim: int = 64            # P, channels per SSM head
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256         # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free layers
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparametric
    ffn: str = "swiglu"           # swiglu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (zamba2-style): a single shared attention block applied every
    # `attn_every` backbone layers.
    attn_every: int = 0
    # encoder-decoder (whisper-style backbone)
    n_enc_layers: int = 0
    enc_seq: int = 0              # number of (stubbed) frame embeddings
    # vlm: number of (stubbed) vision patch embeddings prepended to the text
    n_vision_tokens: int = 0
    # long-context: sliding-window attention (0 = full causal attention).
    # Beyond-paper option used to run long_500k on dense families.
    sliding_window: int = 0
    dtype: str = "bfloat16"
    source: str = ""              # citation for the assigned config

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm.state_dim else 0

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """True if decode state is sub-quadratic / O(window) in context."""
        return self.arch_type in ("ssm", "hybrid") or self.sliding_window > 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (used by roofline + perf model) ----
    def param_count(self) -> int:
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d            # wq, wk, wv, wo
        if self.ffn == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        n = 0
        if self.arch_type in ("dense", "vlm"):
            n = self.n_layers * (attn + mlp)
        elif self.arch_type == "moe":
            m = self.moe
            expert = (3 * d * m.d_ff) if self.ffn == "swiglu" else (2 * d * m.d_ff)
            per_layer = attn + (m.n_experts + m.n_shared_experts) * expert + d * m.n_experts
            n = self.n_layers * per_layer
        elif self.arch_type == "ssm":
            n = self.n_layers * self._ssm_layer_params()
        elif self.arch_type == "hybrid":
            n = self.n_layers * self._ssm_layer_params()
            # one shared attention block (attn + mlp), reused
            n += attn + mlp
        elif self.arch_type == "audio":
            n = (self.n_layers + self.n_enc_layers) * (attn + mlp)
            n += self.n_layers * (attn)               # cross-attention
        emb = V * d * (1 if self.tie_embeddings else 2)
        return n + emb

    def _ssm_layer_params(self) -> int:
        # B/C are per-group (single group), not per-head — matches
        # models/ssm.init_mamba_layer exactly.
        d, di, N = self.d_model, self.d_inner, self.ssm.state_dim
        H = self.n_ssm_heads
        in_proj = d * (2 * di + 2 * N + H)            # z, x, B, C, dt
        conv = (di + 2 * N) * self.ssm.conv_width
        out = di * d
        return in_proj + conv + out + 3 * H + di + d  # + A,D,dt_bias,norms

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k routed only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        m = self.moe
        expert = (3 * d * m.d_ff) if self.ffn == "swiglu" else (2 * d * m.d_ff)
        inactive = (m.n_experts - m.experts_per_token) * expert
        return self.param_count() - self.n_layers * inactive


@dataclass(frozen=True)
class RankConfig(ModelConfig):
    """One rank's share of a model on a device mesh
    (``launch.steps.local_config``): a ``ModelConfig`` whose SSM inner width
    is given (``inner``), not derived from ``d_model``, since a rank holds
    ``d_inner / m`` of the SSM channels and heads while ``d_model`` stays
    whole. ``inner`` 0 derives it as ``ModelConfig`` does.

    Where the model axis does not divide the KV heads, a rank keeps
    ``n_heads`` and ``n_kv_heads`` whole and holds the reference's column
    blocks of the attention's projections: ``q_cols`` of ``wq`` (and rows of
    ``wo``), ``kv_cols`` of ``wk`` and ``wv``, cut mid-head where the axis
    does not divide the heads; its KV pool holds every KV head at its share
    of each row's pages (``kv_shards``, the model axis's size: round-robin
    pages, ``launch.shardings.seq_place``). 0 everywhere else."""
    inner: int = 0
    q_cols: int = 0
    kv_cols: int = 0
    kv_shards: int = 0

    @property
    def d_inner(self) -> int:
        return self.inner or self.ssm.expand * self.d_model


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
