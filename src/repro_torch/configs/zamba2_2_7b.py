"""Zamba2-2.7B: Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    attn_every=6,   # shared attention block applied every 6 mamba layers
    norm="rmsnorm",
    ffn="swiglu",
    # at 500k-token decode the shared attention blocks run sliding-window so
    # hybrid state stays O(window); mamba state is O(1) regardless.
    sliding_window=4096,
    source="arXiv:2411.15242",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=256, vocab_size=512, attn_every=2,
                        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2,
                                      conv_width=4, chunk_size=32),
                        sliding_window=0)
