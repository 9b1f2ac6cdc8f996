"""Mamba2-1.3B: attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    norm="rmsnorm",
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, vocab_size=512,
                        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2,
                                      conv_width=4, chunk_size=32))
