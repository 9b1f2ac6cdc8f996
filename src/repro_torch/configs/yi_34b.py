"""Yi-34B: llama-arch dense GQA. [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    norm="rmsnorm",
    ffn="swiglu",
    source="arXiv:2403.04652",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=224, n_heads=7, n_kv_heads=1,
                        d_ff=448, vocab_size=512)
