"""chameleon-34b [vlm] — early fusion, VQ image tokens [arXiv:2405.09818].

Same numbers as `repro.configs.chameleon_34b`: 48 layers, d 8192, 64
heads over 8 kv heads, a dense SwiGLU FFN of 22016, vocab 65536 (text
and VQ image tokens in one stream), NormHead (the base default).  Early
fusion means image patches arrive as ordinary vocabulary tokens from a
VQ tokenizer, so the transformer is a plain decoder: `early_fusion_vlm`
is declared only, and no model code reads it (nor the reference's).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b", family="vlm", source="arXiv:2405.09818",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=65536, block_pattern=("attn",), mlp_act="swiglu",
    early_fusion_vlm=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512)
