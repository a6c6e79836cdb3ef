"""granite-moe-3b-a800m [moe] — 40 fine-grained experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

Same numbers as `repro.configs.granite_moe_3b_a800m`: 32 layers, d 1536,
24 heads over 8 kv heads (head_dim 64), 40 experts top-8 (ff 512), no
shared expert, vocab 49155 (padded to 49280 in the embedding), NormHead
(the base default).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, block_pattern=("attn",), mlp_act="swiglu",
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512,
                  n_shared_experts=0),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=256,
                      n_shared_experts=0, router_warmup_steps=4))
