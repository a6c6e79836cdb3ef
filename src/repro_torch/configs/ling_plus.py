"""Ling-Plus — the paper's 290B-total / 28.8B-activated MoE.

Same numbers as `repro.configs.ling_plus`: 80 layers, d 8192, 64 heads
over 8 kv heads, 96 routed experts (ff 1408) top-4 beside one shared
expert, NormHead, vocab 126464.  It pins `dispatch="ep"`, the all-to-all
expert-parallel dispatch the reference picks at this scale; at tp=1 the
port resolves it to the fused K1 path (`core.moe.resolve_dispatch`).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="ling-plus", family="moe", source="Ling paper (this repro)",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=1408,
    vocab_size=126464, block_pattern=("attn",), mlp_act="swiglu",
    norm_head=True,
    moe=MoEConfig(n_experts=96, top_k=4, expert_d_ff=1408,
                  n_shared_experts=1, balance_loss_coef=0.015,
                  z_loss_coef=1e-4, router_warmup_steps=2000,
                  dispatch="ep"),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=256,
                      n_shared_experts=1, router_warmup_steps=4))
