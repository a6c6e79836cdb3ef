"""Ling-Lite — the paper's 16.8B-total / 2.75B-activated MoE (§3.2, Table 5).

Same numbers as `repro.configs.ling_lite`: fine-grained 64-expert top-6
MoE with one shared expert and NormHead.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="ling-lite", family="moe", source="Ling paper (this repro)",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=4, d_ff=1408,
    vocab_size=126464, block_pattern=("attn",), mlp_act="swiglu",
    norm_head=True,
    moe=MoEConfig(n_experts=64, top_k=6, expert_d_ff=1408,
                  n_shared_experts=1, balance_loss_coef=0.015,
                  z_loss_coef=1e-4, router_warmup_steps=2000),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=256,
                      n_shared_experts=1, router_warmup_steps=4))
