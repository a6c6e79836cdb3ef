"""h2o-danube-1.8b [dense] — llama + mistral mix, sliding-window attention
[arXiv:2401.16818].

Same numbers as `repro.configs.h2o_danube_1_8b`: 24 "swa" layers, each
query attending the 4096 positions up to its own (a rolling decode cache
of min(4096, seq_len) rows), d 2560, GQA 32 over 8 heads of 80, SwiGLU
6912, vocab 32000.  `serving.draft.adapt_drafter_config` also rewrites
it into an all-"attn" drafter for paged serving, which refuses windows.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b", family="dense", source="arXiv:2401.16818",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab_size=32000, block_pattern=("swa",), attn_window=4096,
    mlp_act="swiglu",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512, attn_window=64)
