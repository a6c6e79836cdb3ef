"""Embedding, LM head, greedy argmax and sampling (counterpart of
`repro.models.embedding`).  Vocab is padded to a multiple of tp * 128
and sharded over tp (rank r holds ids [r*V_loc, (r+1)*V_loc)); the
lookup is masked per rank and combined over tp, the head gives each rank
its vocab rows' logits, and argmax, the cross entropy and sampling
combine those over tp (`sharded_argmax`, `model.loss_fn`,
`sampled_probs`), so no rank holds a replicated (T, V) before sampling
gathers the rows it draws from.

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

from repro_torch import sharding
from repro_torch.core import normhead
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import prng
from repro_torch.sharding import LOCAL, AxisEnv


def padded_vocab(cfg, env: AxisEnv = LOCAL) -> int:
    return sharding.pad_to_multiple(cfg.vocab_size, env.tp * 128)


def init_embedding(cfg, init: L.Init):
    vp = padded_vocab(cfg, init.env)
    spec = sharding.fsdp_spec(init.env, 2, 1, 0)     # vocab over tp
    params = {"table": init.normal((vp, cfg.d_model),
                                   init.weight_dtype(cfg), spec=spec)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((vp, cfg.d_model),
                                        L.dtype_of(cfg.param_dtype),
                                        spec=spec)
    return params


def embed_tokens(cfg, params, ids: torch.Tensor,
                 env: AxisEnv = LOCAL) -> torch.Tensor:
    """ids (T,) -> (T, d) in compute dtype; out-of-range ids give 0.  Over
    tp each rank looks up the ids in its vocab rows (0 elsewhere) and the
    partials combine by `env.sp_scatter`: (T / tp, d) SP activations, or
    (T, d) on every rank when SP is off."""
    cdt = L.dtype_of(cfg.compute_dtype)
    table = env.gather_fsdp(params["table"], 1, dtype=cdt)
    v = table.shape[0]
    local = ids - env.tp_index() * v
    in_range = (local >= 0) & (local < v)
    rows = table[local.clamp(0, v - 1).long()]
    return env.sp_scatter(torch.where(in_range[:, None], rows, 0.0).to(cdt))


def lm_logits(cfg, params, x: torch.Tensor,
              env: AxisEnv = LOCAL) -> torch.Tensor:
    """x (T, d) -> the rank's vocab rows' logits (T, V_loc) fp32 (NormHead
    per cfg)."""
    w = params["table"] if cfg.tie_embeddings else params["lm_head"]
    return normhead.normhead_logits(cfg, w, x, env)


def serve_logits(cfg, params, x: torch.Tensor,
                 env: AxisEnv = LOCAL) -> torch.Tensor:
    """Inference logits x (T, d) -> the rank's vocab rows (T, V_loc) fp32:
    the NormHead on K5, or the plain fp32 product when cfg.norm_head is
    False."""
    w = params["table"] if cfg.tie_embeddings else params["lm_head"]
    if not cfg.norm_head:
        return normhead.normhead_logits(cfg, w, x, env)
    return kops.normhead_logits(x, env.gather_fsdp(w, 1))


def token_xent(cfg, logits: torch.Tensor, labels: torch.Tensor,
               env: AxisEnv = LOCAL) -> torch.Tensor:
    """Per-token cross entropy over the tp-sharded vocab: logits (T,
    V_loc) fp32, labels (T,) with -1 ignored -> (T,) fp32, 0 where
    ignored.  The row max (no gradient) and the sum of exponentials
    combine over tp, the label's logit comes from the rank holding it,
    and vocab padding rows (id >= vocab_size) are -1e30."""
    v_loc = logits.shape[-1]
    lo = env.tp_index() * v_loc
    gid = lo + torch.arange(v_loc, device=logits.device)
    logits = torch.where(gid[None, :] < cfg.vocab_size, logits, -1e30)
    m = env.pmax_tp(torch.max(logits, dim=-1).values.detach())
    se = env.psum_tp(torch.sum(torch.exp(logits - m[:, None]), dim=-1))
    lse = m + torch.log(se)
    local = labels - lo
    in_range = (local >= 0) & (local < v_loc)
    picked = torch.gather(logits, 1, local.clamp(0, v_loc - 1)[:, None])[:, 0]
    correct = env.psum_tp(torch.where(in_range, picked, 0.0))
    return torch.where(labels >= 0, lse - correct, 0.0)


def sharded_xent(cfg, logits: torch.Tensor, labels: torch.Tensor,
                 env: AxisEnv = LOCAL):
    """The reference's `sharded_xent`: (the mean cross entropy over every
    dp rank's valid tokens, this rank's count of valid tokens)."""
    n_valid = torch.sum((labels >= 0).float())
    total = env.psum_dp(torch.sum(token_xent(cfg, logits, labels, env)))
    return total / torch.clamp(env.psum_dp(n_valid), min=1.0), n_valid


def sharded_argmax(logits: torch.Tensor,
                   env: AxisEnv = LOCAL) -> torch.Tensor:
    """Greedy token per row over the tp-sharded vocab, (T, V_loc) -> (T,);
    ties pick the lowest global id."""
    idx = torch.argmax(logits, dim=-1)
    if env.tp == 1:
        return idx
    v_loc = logits.shape[-1]
    loc_max = torch.gather(logits, 1, idx[:, None])[:, 0]
    gmax = env.pmax_tp(loc_max)
    cand = torch.where(loc_max >= gmax, env.tp_index() * v_loc + idx,
                       torch.iinfo(torch.int64).max)
    return env.pmin_tp(cand)


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
                  top_p: torch.Tensor, top_k: torch.Tensor,
                  env: AxisEnv = LOCAL):
    """(T, V_loc) logits -> (greedy (T,) int32, probs (T, Vp) fp32): the
    transformed distribution over the whole padded vocab (the rows
    gathered over tp; identical on every rank) with padding columns (id
    >= vocab_size) exactly 0, and the argmax one-hot on rows with
    temperature <= 0, so greedy spec-decode acceptance is token
    equality."""
    greedy = sharded_argmax(logits, env).to(torch.int32)
    logits = env.all_gather_tp(logits, axis=1)
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
                   stream: int = STREAM_SAMPLE, env: AxisEnv = LOCAL):
    """Temperature / top-k / top-p sampling: logits (T, V_loc), knobs
    (T,).  Returns (token (T,) int32, probs (T, Vp), the distribution
    sampled from, which spec decoding reads as p and q).  Rows at
    temperature <= 0 return the `sharded_argmax` token bit for bit."""
    greedy, probs = sampled_probs(cfg, logits, temperature, top_p, top_k,
                                  env)
    keys = sample_keys(seeds, pos, stream)
    cat = prng.categorical(keys, torch.log(probs)).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, cat), probs
