"""Phi-3-mini-3.8B: dense, RoPE + SwiGLU + GQA. [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    norm="rmsnorm",
    ffn="swiglu",
    source="arXiv:2404.14219",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=256, vocab_size=512)
