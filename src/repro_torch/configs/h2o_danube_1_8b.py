"""h2o-danube-1.8b [dense] — llama + mistral mix, sliding-window attention
[arXiv:2401.16818].

Same numbers as `repro.configs.h2o_danube_1_8b`.  The port does not
build its "swa" blocks as a model (`models.model.check_ported_blocks`);
the config is here for `serving.draft.adapt_drafter_config`, which
rewrites it into an all-"attn" drafter.
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
