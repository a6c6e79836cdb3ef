"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066].

Same numbers as `repro.configs.deepseek_moe_16b`: 28 layers, d 2048, MHA
(16 heads of 128), 64 experts top-6 (ff 1408) beside two shared experts
(one MLP of 2 x 1408), vocab 102400, NormHead (the base default).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b", family="moe", source="arXiv:2401.06066",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, block_pattern=("attn",), mlp_act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, expert_d_ff=1408,
                  n_shared_experts=2),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=256,
                      n_shared_experts=1, router_warmup_steps=4))
