"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

Same numbers as `repro.configs.nemotron_4_15b`: 32 layers, d 6144, GQA
48 over 8 heads of 128, a squared-ReLU FFN of 24576, vocab 256000,
LayerNorm (`layers.apply_norm`).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-15b", family="dense", source="arXiv:2402.16819",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256000, block_pattern=("attn",), mlp_act="squared_relu",
    norm_type="layernorm",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512)
