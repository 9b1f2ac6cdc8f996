"""Whisper-base: encoder-decoder transformer backbone; the conv/mel frontend
is a stub providing precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    n_layers=6,           # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    enc_seq=1500,         # 30 s of audio at 50 frames/s (post-conv stub)
    norm="layernorm",
    ffn="gelu",
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
                        n_kv_heads=4, d_ff=256, vocab_size=512, enc_seq=32)
