"""Embedding, LM head and greedy argmax at tp=1 (counterpart of
`repro.models.embedding`).  Vocab is padded to a multiple of 128.

Two forms of the head: `lm_logits`, the plain fp32 NormHead with
autograd (the training loss), and `serve_logits`, the same function on
K5 (`kernels.ops.normhead_logits`) for every serving step."""
from __future__ import annotations

import torch

from repro_torch.core import normhead
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // 128) * 128


def init_embedding(cfg, init: L.Init):
    vp = padded_vocab(cfg)
    params = {"table": init.normal((vp, cfg.d_model),
                                   init.weight_dtype(cfg))}
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((vp, cfg.d_model),
                                        L.dtype_of(cfg.param_dtype))
    return params


def embed_tokens(cfg, params, ids: torch.Tensor) -> torch.Tensor:
    """ids (T,) -> (T, d) in compute dtype; out-of-range ids give 0."""
    cdt = L.dtype_of(cfg.compute_dtype)
    table = params["table"].to(cdt)
    v = table.shape[0]
    in_range = (ids >= 0) & (ids < v)
    rows = table[ids.clamp(0, v - 1).long()]
    return torch.where(in_range[:, None], rows, 0.0).to(cdt)


def lm_logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """x (T, d) -> logits (T, Vp) fp32 (NormHead per cfg)."""
    w = params["table"] if cfg.tie_embeddings else params["lm_head"]
    return normhead.normhead_logits(cfg, w, x)


def serve_logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Inference logits x (T, d) -> (T, Vp) fp32: the NormHead on K5, or
    the plain fp32 product when cfg.norm_head is False."""
    w = params["table"] if cfg.tie_embeddings else params["lm_head"]
    if not cfg.norm_head:
        return normhead.normhead_logits(cfg, w, x)
    return kops.normhead_logits(x, w)


def sharded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token per row, (T, V) -> (T,); ties pick the lowest id."""
    return torch.argmax(logits, dim=-1)
