"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427].

Same numbers as `repro.configs.recurrentgemma_2b`: 26 layers cycling
("rglru", "rglru", "swa") (`models.rglru`; windows of 2048), d 2560,
10 query heads of 256 over one KV head, a GeGLU FFN of 7680, vocab
256000.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b", family="hybrid", source="arXiv:2402.19427",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, block_pattern=("rglru", "rglru", "swa"),
    attn_window=2048, mlp_act="geglu",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512,
        vocab_size=512, attn_window=64, block_pattern=("rglru", "swa"))
