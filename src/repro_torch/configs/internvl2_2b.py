"""InternVL2-2B: InternLM2 language backbone; InternViT vision encoder +
projector are a stub providing precomputed patch embeddings. [arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    n_vision_tokens=256,   # one 448x448 tile -> 256 patch embeddings
    norm="rmsnorm",
    ffn="swiglu",
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_ff=256, vocab_size=512, n_vision_tokens=16)
