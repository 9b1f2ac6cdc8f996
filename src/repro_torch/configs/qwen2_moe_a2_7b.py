"""Qwen1.5-MoE-A2.7B: 4 shared + 60 routed top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    moe=MoEConfig(n_experts=60, n_shared_experts=4, experts_per_token=4,
                  d_ff=1408, capacity_factor=1.25),
    norm="rmsnorm",
    ffn="swiglu",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def smoke_config() -> ModelConfig:
    # capacity_factor high enough that no token is ever dropped: makes the
    # batched-forward and one-token-decode paths exactly equivalent, which
    # the decode-consistency tests rely on (production keeps 1.25 + drops).
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=64, vocab_size=512,
                        moe=MoEConfig(n_experts=4, n_shared_experts=1,
                                      experts_per_token=2, d_ff=64,
                                      capacity_factor=8.0))
