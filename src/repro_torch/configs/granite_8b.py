"""Granite-8B (code): llama-arch dense GQA. [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    norm="rmsnorm",
    ffn="swiglu",
    source="arXiv:2405.04324",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_ff=256, vocab_size=512)
