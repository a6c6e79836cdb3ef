"""Embedding, LM head, greedy argmax and sampling at tp=1 (counterpart of
`repro.models.embedding`).  Vocab is padded to a multiple of 128.

Two forms of the head: `lm_logits`, the plain fp32 NormHead with
autograd (the training loss), and `serve_logits`, the same function on
K5 (`kernels.ops.normhead_logits`) for every serving step.

Sampling keeps the reference's counter-based key schedule: every draw is
keyed by (seed, position, stream) through JAX's threefry (`prng`), so a
stream is a pure function of (logits, seed, position), equal to the
reference's for the same logits, and preemption replay is exact.  The
sampling knobs are per-row data; rows at temperature <= 0 give the
greedy token bit for bit."""
from __future__ import annotations

import torch

from repro_torch.core import normhead
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import prng


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


# ---------------------------------------------------------------------------
# sampling (temperature / top-k / top-p) under the (seed, pos, stream) keys
# ---------------------------------------------------------------------------

STREAM_SAMPLE = 0     # canonical next-token draw (offline == online)
STREAM_DRAFT = 1      # drafter proposals (spec decode)
STREAM_ACCEPT = 2     # accept/reject uniforms (spec decode)
STREAM_RESID = 3      # residual/bonus draw on rejection (spec decode)


def sample_keys(seeds: torch.Tensor, pos: torch.Tensor,
                stream: int) -> torch.Tensor:
    """Per-row keys of the (seed, position, stream) schedule: PRNGKey(0)
    folded with the seed, the position and the stream, each taken as
    uint32.  seeds, pos (T,) -> (T, 2) uint32 key words in int64."""
    base = torch.zeros((seeds.shape[0], 2), dtype=torch.int64,
                       device=seeds.device)            # PRNGKey(0)'s data
    k = prng.fold_in(base, seeds)
    k = prng.fold_in(k, pos)
    return prng.fold_in(k, torch.full_like(k[:, 0], stream))


def transform_logits(full_logits: torch.Tensor, temperature: torch.Tensor,
                     top_p: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Full-vocab logits (T, V) -> sampling distribution (T, V) fp32, in
    the reference's order: temperature scale -> top-k cut -> softmax ->
    top-p (nucleus) cut -> renormalize.  Knobs are (T,) per-row data;
    temperature <= 0 rows come back as they are (`sampled_probs` puts the
    argmax one-hot there), top_k <= 0 and top_p >= 1 disable their cuts,
    and ties at either boundary keep every equal-scoring token."""
    V = full_logits.shape[-1]
    x = full_logits.float()
    t = temperature.float().clamp_min(1e-6)[:, None]
    x = x / t
    srt = torch.sort(x, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, top_k.long().clamp(1, V)[:, None] - 1)
    x = torch.where((top_k[:, None] > 0) & (x < kth), float("-inf"), x)
    probs = torch.softmax(x, dim=-1)
    ps = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(ps, dim=-1) - ps                     # exclusive
    keep_sorted = cum < top_p.float().clamp(max=1.0)[:, None]
    thr = torch.where(keep_sorted, ps, float("inf")).amin(dim=-1)
    keep = (top_p[:, None] >= 1.0) | (probs >= thr[:, None])
    probs = torch.where(keep, probs, 0.0)
    return probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def sampled_probs(cfg, logits: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor, top_k: torch.Tensor):
    """(T, Vp) logits -> (greedy (T,) int32, probs (T, Vp) fp32): the
    transformed distribution with padding columns (id >= vocab_size)
    exactly 0, and the argmax one-hot on rows with temperature <= 0, so
    greedy spec-decode acceptance is token equality."""
    greedy = sharded_argmax(logits).to(torch.int32)
    vp = logits.shape[-1]
    gid = torch.arange(vp, device=logits.device)
    full = torch.where(gid[None, :] < cfg.vocab_size, logits, float("-inf"))
    probs = transform_logits(full, temperature, top_p, top_k)
    onehot = torch.nn.functional.one_hot(greedy.long(), vp).float()
    probs = torch.where((temperature <= 0.0)[:, None], onehot, probs)
    return greedy, probs


def sharded_sample(cfg, logits: torch.Tensor, *, seeds: torch.Tensor,
                   pos: torch.Tensor, temperature: torch.Tensor,
                   top_p: torch.Tensor, top_k: torch.Tensor,
                   stream: int = STREAM_SAMPLE):
    """Temperature / top-k / top-p sampling: logits (T, Vp), knobs (T,).
    Returns (token (T,) int32, probs (T, Vp), the distribution sampled
    from, which spec decoding reads as p and q).  Rows at temperature
    <= 0 return the `sharded_argmax` token bit for bit."""
    greedy, probs = sampled_probs(cfg, logits, temperature, top_p, top_k)
    keys = sample_keys(seeds, pos, stream)
    cat = prng.categorical(keys, torch.log(probs)).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, cat), probs
