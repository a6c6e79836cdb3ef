"""moonshot-v1-16b-a3b — MoE 64e top-6 + 2 shared
[hf:moonshotai/Moonlight-16B-A3B].

Same numbers as `repro.configs.moonshot_v1_16b_a3b` (built as the
published Moonlight MoE): 48 layers, d 2048, MHA (16 heads of 128), 64
experts top-6 (ff 1408) beside two shared experts, vocab 163840,
NormHead (the base default).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b", family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163840, block_pattern=("attn",), mlp_act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, expert_d_ff=1408,
                  n_shared_experts=2),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=256,
                      n_shared_experts=1, router_warmup_steps=4))
