"""DeepSeekMoE-16B: 2 shared + 64 routed top-6, fine-grained. [arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, n_shared_experts=2, experts_per_token=6,
                  d_ff=1408, capacity_factor=1.25),
    norm="rmsnorm",
    ffn="swiglu",
    source="arXiv:2401.06066",
)


def smoke_config() -> ModelConfig:
    # no-drop capacity factor: see qwen2_moe_a2_7b.smoke_config
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=64, vocab_size=512,
                        moe=MoEConfig(n_experts=4, n_shared_experts=1,
                                      experts_per_token=2, d_ff=64,
                                      capacity_factor=8.0))
