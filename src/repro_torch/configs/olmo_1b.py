"""OLMo-1B: dense, non-parametric LayerNorm. [arXiv:2402.00838]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    ffn="swiglu",
    source="arXiv:2402.00838",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=256, vocab_size=512)
