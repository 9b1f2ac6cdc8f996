"""Llama-3.1-8B — the paper's "small model" used in Chiron's own evaluation."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=500000.0,
    source="arXiv:2302.13971 (paper's evaluation model)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_ff=256, vocab_size=512)
