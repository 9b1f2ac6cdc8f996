"""Llama-3.1-70B — the paper's "large model" used in Chiron's own evaluation."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-70b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=500000.0,
    source="arXiv:2302.13971 (paper's evaluation model)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_ff=256, vocab_size=512)
