"""phi3-mini-3.8b [dense] — RoPE SwiGLU [arXiv:2404.14219].

Same numbers as `repro.configs.phi3_mini_3_8b`: 32 layers, d 3072, MHA
(32 heads of 96), a dense SwiGLU FFN of 8192, vocab 32064, rope_theta
1e4, NormHead (the base default).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-mini-3.8b", family="dense", source="arXiv:2404.14219",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32064, block_pattern=("attn",), mlp_act="swiglu",
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512)
