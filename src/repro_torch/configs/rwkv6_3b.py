"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892].

Same numbers as `repro.configs.rwkv6_3b`: 32 rwkv blocks (time mix with
the WKV6 recurrence, 40 heads of 64; squared-ReLU channel mix, d_ff
8960), vocab 65536, NormHead (the base default).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b", family="ssm", source="arXiv:2404.05892",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab_size=65536, block_pattern=("rwkv",), mlp_act="squared_relu",
    use_rope=False, rwkv_head_dim=64,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512)
