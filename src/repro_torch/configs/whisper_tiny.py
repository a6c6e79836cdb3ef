"""whisper-tiny [audio] — enc-dec transformer backbone [arXiv:2212.04356].

Same numbers as `repro.configs.whisper_tiny`: 4 encoder and 4 decoder
layers, d 384, 6 heads of 64, a GELU FFN of 1536, vocab 51865,
LayerNorm, no RoPE (learned absolute positions).  The mel-spectrogram
and conv frontend is the reference's stub: the encoder takes
precomputed (B, 1504, d) frame embeddings (1500 conv frames right-padded
to 1504).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny", family="audio", source="arXiv:2212.04356",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51865, block_pattern=("attn",), mlp_act="gelu",
    norm_type="layernorm", use_rope=False,
    is_encoder_decoder=True, encoder_layers=4, encoder_seq_len=1504,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab_size=512, encoder_seq_len=64)
