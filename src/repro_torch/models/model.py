"""Model assembly at tp=1 (counterpart of `repro.models.model`):
parameter init; the forward (training, and the prefill with caches) and
the loss (`forward`, `loss_fn`); dense decode caches and the `prefill` /
`decode_step` (KV caches of "attn" blocks, the state of "rwkv" blocks);
paged KV pools and the fixed shape serving steps of attention models —
one paged decode tick over every slot, one chunked-prefill chunk for one
request, and speculative decoding's draft proposals and verify pass.
Every decode, prefill and verify step may sample (temperature / top-k /
top-p under the reference's (seed, position, stream) threefry keys).

Two block kinds are ported: "attn" (training, prefill and dense decode,
and paged serving of all-attn models) and "rwkv" (training, prefill and
dense decode).  Other kinds and mixed patterns raise NotImplementedError
naming their ROADMAP item.

Parameters keep the reference's nested-dict keys with a leading layer
dim on every `blocks` leaf; a Python loop over layers replaces
`lax.scan`.  The dense caches and the KV pools carry the same leading
layer dim and are updated in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import router as router_lib
from repro_torch.core import moe as moe_lib
from repro_torch.models import embedding as emb
from repro_torch.models import layers as L
from repro_torch.models import prng
from repro_torch.models import rwkv6 as rwkv_lib


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Run knobs, with the reference's defaults.  moe_dispatch: "auto" |
    "fused" | "ragged" ("auto" is the K1/K2 kernel path).  paged_attn:
    "auto" | "fused" | "gathered" ("auto" is the K3/K4 kernel path).  On
    CPU tensors the kernel paths run their plain versions.  Training:
    `remat` recomputes each block and each loss chunk in the backward
    (torch.utils.checkpoint); `loss_chunk` is the token chunk of the
    cross entropy, so no (T, V) fp32 logits are held whole.  The
    reference's `attn_block` has no counterpart: the port's SDPA
    attention picks its own tiles.  `rwkv_chunk` > 0 trains rwkv blocks
    on the chunked-parallel WKV6 form (`rwkv6.wkv6_chunked`)."""
    moe_dispatch: str = "auto"
    paged_attn: str = "auto"
    remat: bool = True
    loss_chunk: int = 2048
    rwkv_chunk: int = 0


DEFAULT_FLAGS = RunFlags()


def _ffn_kind(cfg: ModelConfig, layer: int) -> str:
    if cfg.moe is not None and layer >= cfg.moe.first_dense_layers:
        return "moe"
    return "mlp"


def check_ported_blocks(cfg: ModelConfig):
    """The port builds uniform "attn" or "rwkv" decoders; other block
    kinds, mixed patterns and encoder-decoders raise."""
    kinds = sorted({cfg.block_kind(i) for i in range(cfg.n_layers)})
    if cfg.is_encoder_decoder or kinds not in (["attn"], ["rwkv"]):
        raise NotImplementedError(
            f"{cfg.arch_id}: blocks {kinds}"
            f"{' (encoder-decoder)' if cfg.is_encoder_decoder else ''} are "
            f"not yet ported to repro_torch (ROADMAP queue 1 item 10)")


def init_block(cfg: ModelConfig, init: L.Init, kind: str,
               ffn: str) -> Dict[str, Any]:
    params: Dict[str, Any] = {"norm1": L.init_norm(cfg, init)}
    if kind == "rwkv":
        params["tmix"] = rwkv_lib.init_time_mix(cfg, init)
    else:
        params["attn"] = L.init_attention(cfg, init)
    params["norm2"] = L.init_norm(cfg, init)
    if kind == "rwkv":
        params["cmix"] = rwkv_lib.init_channel_mix(cfg, init)
    elif ffn == "moe":
        params["moe"] = moe_lib.init_moe(cfg, init)
    else:
        params["mlp"] = L.init_mlp(cfg, init)
    return params


def init_model(cfg: ModelConfig, *, device="cuda",
               generator: Optional[torch.Generator] = None,
               masters: bool = False) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and scales
    (`layers.dense_init`: normal * 0.02, output projections * 0.02 /
    sqrt(n_layers), norms at 1), drawn on `device` from `generator`.
    With `masters` (training) every leaf is stored in `cfg.param_dtype`,
    as the reference keeps it; otherwise (serving) the leaves the
    reference casts to the compute dtype at use are stored in that dtype,
    and the router, the norms and the LM head stay fp32 (rwkv6.py says
    which rwkv leaves stay fp32).  On the meta device only shapes are
    built."""
    check_ported_blocks(cfg)
    device = torch.device(device)
    init = L.Init(device=device, generator=generator, masters=masters)
    params: Dict[str, Any] = {"embed": emb.init_embedding(cfg, init),
                              "final_norm": L.init_norm(cfg, init)}
    stacked = dataclasses.replace(init, lead=(cfg.n_layers,))
    params["blocks"] = init_block(cfg, stacked, cfg.block_pattern[0],
                                  _ffn_kind(cfg, cfg.n_layers - 1))
    return params


def layer_params(blocks, i: int):
    """Layer i's parameters: views into the stacked leaves."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


# ---- forward and loss (training) -------------------------------------------


def choose_block(s: int, target: int = 1024) -> int:
    """Largest divisor of s that is <= target (chunks must tile s)."""
    if s <= target:
        return s
    return max(b for b in range(1, target + 1) if s % b == 0)


def warmup_noise(cfg: ModelConfig, rng, step, T: int):
    """Each layer's router-warmup noise for T tokens, as the reference
    draws it: the layer keys are `split(rng, n_layers)` and layer i's eps
    is `normal(keys[i], (T, n_experts))`, all layers in one draw: (L, T,
    E) fp32.  None where no warmup mix applies (no rng, no MoE, no
    warmup, or step past it, where alpha = 1 gives the learned logits
    whatever eps is)."""
    m = cfg.moe
    if (rng is None or _ffn_kind(cfg, cfg.n_layers - 1) != "moe"
            or m.router_warmup_steps <= 0 or step is None
            or step >= m.router_warmup_steps):
        return None
    return router_lib.warmup_noise(prng.split(rng, cfg.n_layers),
                                   (T, m.n_experts))


def _rwkv_block(cfg: ModelConfig, params, x, *, B: int, S: int,
                train: bool, chunk: int):
    """One rwkv block: x (T, d) -> (x, its decode cache).  The time mix
    and the channel mix shift their (normed) inputs by one token with a
    zero first row; the cache keeps each one's last input.  `train` runs
    the time mix's plain forms (`rwkv6.time_mix`)."""
    d = cfg.d_model
    h = L.apply_norm(cfg, params["norm1"], x)
    partial, state = rwkv_lib.time_mix(cfg, params["tmix"],
                                       h.reshape(B, S, d), train=train,
                                       chunk=chunk)
    x = x + partial.reshape(B * S, d)
    h = L.apply_norm(cfg, params["norm2"], x)
    hB = h.reshape(B, S, d)
    h_prev = F.pad(hB, (0, 0, 1, 0))[:, :-1].reshape(-1, d)
    partial, gate = rwkv_lib.channel_mix(cfg, params["cmix"], h, h_prev)
    return x + gate * partial, {"rwkv": state, "cmix_prev": hB[:, -1]}


def block_forward(cfg: ModelConfig, params, x, eps, *, B: int, S: int,
                  kind: str, ffn: str, step=None, train: bool = True,
                  flags: RunFlags = DEFAULT_FLAGS, want_cache: bool = False):
    """One block: x (T, d) -> (x, aux, metrics, cache or None).  eps
    (T, E) is the layer's router-warmup noise, or None.  Both kinds run
    for training and, with `train=False`, for inference ("attn": the MoE
    on the serving router; rwkv: K6 and the decay kernel), where
    `want_cache` returns {"self": {"k", "v"}} ("attn") or {"rwkv":
    {"wkv", "last_x"}, "cmix_prev"} ("rwkv")."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv":
        x, cache = _rwkv_block(cfg, params, x, B=B, S=S, train=train,
                               chunk=flags.rwkv_chunk)
        return x, zero, {}, (cache if want_cache else None)
    d = cfg.d_model
    h = L.apply_norm(cfg, params["norm1"], x)
    out = L.apply_attention(cfg, params["attn"], h.reshape(B, S, d),
                            return_cache=want_cache)
    cache = None
    if want_cache:
        out, kv = out
        cache = {"self": kv}
    x = x + out.reshape(B * S, d)
    h = L.apply_norm(cfg, params["norm2"], x)
    aux, metrics = zero, {}
    if ffn == "moe" and train:
        partial, aux, metrics = moe_lib.moe_ffn(
            cfg, params["moe"], h, dispatch=flags.moe_dispatch, train=True,
            step=step, eps=eps)
    elif ffn == "moe":
        partial, metrics = moe_lib.moe_ffn(cfg, params["moe"], h,
                                           dispatch=flags.moe_dispatch)
    else:
        partial = L.apply_mlp(cfg, params["mlp"], h)
    return x + partial, aux, metrics, cache


def _stack(trees):
    """Per-layer cache trees -> one tree with a leading layer dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _run_blocks(cfg: ModelConfig, params, x, *, B: int, S: int, step,
                rng, train: bool, flags: RunFlags, want_cache: bool):
    """The layer loop.  In training with `flags.remat` every block runs
    under torch.utils.checkpoint and is recomputed in the backward.  The
    warmup noise (`warmup_noise`) is drawn here, outside the checkpointed
    blocks, so the recompute routes as the forward did.  Returns (x, aux
    summed over layers, metrics averaged over layers, caches stacked over
    layers or None)."""
    kind = cfg.block_pattern[0]
    ffn = _ffn_kind(cfg, cfg.n_layers - 1)
    noise = warmup_noise(cfg, rng, step, x.shape[0]) if train else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    metrics_all, caches = [], []
    for i in range(cfg.n_layers):
        eps = noise[i] if noise is not None else None
        fn = functools.partial(block_forward, cfg, B=B, S=S, kind=kind,
                               ffn=ffn, step=step, train=train, flags=flags,
                               want_cache=want_cache)
        lp = layer_params(params["blocks"], i)
        if flags.remat and train:
            x, a, mets, cache = checkpoint(fn, lp, x, eps,
                                           use_reentrant=False,
                                           preserve_rng_state=False)
        else:
            x, a, mets, cache = fn(lp, x, eps)
        aux = aux + a
        metrics_all.append(mets)
        caches.append(cache)
    metrics = {k: torch.mean(torch.stack([m[k] for m in metrics_all]))
               for k in metrics_all[0]}
    return x, aux, metrics, (_stack(caches) if want_cache else None)


def forward(cfg: ModelConfig, params, batch, *, step=None, rng=None,
            train: bool = True, flags: RunFlags = DEFAULT_FLAGS,
            want_cache: bool = False):
    """batch["tokens"] (B, S) -> (x_final (T, d), aux, metrics, caches).
    `rng`, a threefry key (`models.prng`), draws the router-warmup noise
    (`warmup_noise`); None draws none.
    With `want_cache` (inference) caches is the stacked decode cache the
    prompt leaves behind (`init_caches`' layout, attention caches S
    positions long), else None."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = emb.embed_tokens(cfg, params["embed"], tokens.reshape(-1))
    x, aux, metrics, caches = _run_blocks(
        cfg, params, x, B=B, S=S, step=step, rng=rng, train=train,
        flags=flags, want_cache=want_cache)
    return L.apply_norm(cfg, params["final_norm"], x), aux, metrics, caches


def _chunk_xent(cfg: ModelConfig, embed, xc, lc):
    """Summed cross entropy of one token chunk over valid labels (>= 0);
    the logits of vocab padding rows are -1e30."""
    logits = emb.lm_logits(cfg, embed, xc)                # (C, Vp) fp32
    vp = logits.shape[-1]
    gid = torch.arange(vp, device=xc.device)
    logits = torch.where(gid[None, :] < cfg.vocab_size, logits, -1e30)
    m = torch.max(logits, dim=-1).values.detach()
    lse = m + torch.log(torch.sum(torch.exp(logits - m[:, None]), dim=-1))
    in_range = (lc >= 0) & (lc < vp)
    picked = torch.gather(logits, 1, lc.clamp(0, vp - 1)[:, None])[:, 0]
    correct = torch.where(in_range, picked, 0.0)
    return torch.sum(torch.where(lc >= 0, lse - correct, 0.0))


def loss_fn(cfg: ModelConfig, params, batch, *, step=None, rng=None,
            flags: RunFlags = DEFAULT_FLAGS):
    """Training loss: chunked NormHead cross entropy + MoE aux losses.
    Each chunk of `flags.loss_chunk` tokens is checkpointed under
    `flags.remat`, so its (chunk, V) fp32 logits live only inside it.
    Returns (loss, metrics)."""
    x, aux, block_metrics, _ = forward(cfg, params, batch, step=step,
                                       rng=rng, flags=flags)
    labels = batch["labels"].reshape(-1)
    T = x.shape[0]
    chunk = choose_block(T, flags.loss_chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, T, chunk):
        args = (cfg, params["embed"], x[i:i + chunk], labels[i:i + chunk])
        total = total + (checkpoint(_chunk_xent, *args, use_reentrant=False,
                                    preserve_rng_state=False)
                         if flags.remat else _chunk_xent(*args))
    n_valid = torch.sum((labels >= 0).float())
    ce = total / torch.clamp(n_valid, min=1.0)
    return ce + aux, {"loss/ce": ce, "loss/aux": aux, **block_metrics}


# ---- prefill and dense decode ----------------------------------------------


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, device,
                     seq_len: Optional[int] = None,
                     lead=()) -> Dict[str, Any]:
    """One layer's zeroed decode cache: for "attn" the KV cache of
    `seq_len` positions ({"self": {"k", "v"}}, `layers.init_decode_cache`,
    with the leading dims `lead`); for "rwkv" the wkv state and the last
    normed inputs of the time mix and the channel mix (no length: the
    state does not grow)."""
    if kind == "attn":
        if seq_len is None:
            raise ValueError("an attention model's decode cache needs "
                             "seq_len")
        return {"self": L.init_decode_cache(cfg, batch, seq_len, device,
                                            lead=lead)}
    return {"rwkv": rwkv_lib.init_decode_state(cfg, batch, device),
            "cmix_prev": torch.zeros((batch, cfg.d_model),
                                     dtype=L.dtype_of(cfg.compute_dtype),
                                     device=device)}


def init_caches(cfg: ModelConfig, batch: int, device,
                seq_len: Optional[int] = None):
    """Zeroed dense decode caches with a leading layer dim; `seq_len` is
    the KV caches' length (attention models), ignored by rwkv."""
    check_ported_blocks(cfg)
    kind = cfg.block_pattern[0]
    if kind == "attn":      # views of padded storage: not a stack's copy
        return init_block_cache(cfg, kind, batch, device, seq_len,
                                lead=(cfg.n_layers,))
    one = init_block_cache(cfg, kind, batch, device, seq_len)
    return _stack([one] * cfg.n_layers)


def block_decode(cfg: ModelConfig, params, x, cache, pos=None, *, kind: str,
                 ffn: str = "moe", flags: RunFlags = DEFAULT_FLAGS,
                 view=None):
    """One layer of the decode tick: x (B, d); `cache` the layer's views
    into the stacked caches, updated in place; `pos` the position every
    sequence writes (attention; rwkv carries it in its state) and `view`
    the tick's page view of the KV cache (`layers.dense_page_view`).
    Returns (x, cache)."""
    if kind == "attn":
        h = L.apply_norm(cfg, params["norm1"], x)
        partial, _ = L.decode_attention(
            cfg, params["attn"], h, cache["self"], pos,
            paged_attn=flags.paged_attn, view=view)
        return _block_ffn(cfg, params, x + partial, ffn, flags), cache
    h = L.apply_norm(cfg, params["norm1"], x)
    partial, _ = rwkv_lib.time_mix_decode(cfg, params["tmix"], h,
                                          cache["rwkv"])
    x = x + partial
    h = L.apply_norm(cfg, params["norm2"], x)
    partial, gate = rwkv_lib.channel_mix(cfg, params["cmix"], h,
                                         cache["cmix_prev"])
    cache["cmix_prev"].copy_(h)
    return x + gate * partial, cache


def prefill_logits(cfg: ModelConfig, params, batch,
                   flags: RunFlags = DEFAULT_FLAGS,
                   seq_len: Optional[int] = None):
    """The prompt batch ["tokens"] (B, S) -> (logits (B, Vp) fp32 at each
    sequence's last token, caches).  Attention caches hold the prompt's S
    positions, or `seq_len` (zero rows after the prompt's) when given."""
    x, _, _, caches = forward(cfg, params, batch, train=False, flags=flags,
                              want_cache=True)
    if "self" in caches:
        caches = L.expand_cache_from_prefill(caches, seq_len)
    B, S = batch["tokens"].shape
    last = x.reshape(B, S, -1)[:, -1]
    return emb.serve_logits(cfg, params["embed"], last), caches


def prefill(cfg: ModelConfig, params, batch,
            flags: RunFlags = DEFAULT_FLAGS, seq_len: Optional[int] = None):
    """Greedy prefill: (first generated token (B,) int32, caches)."""
    logits, caches = prefill_logits(cfg, params, batch, flags, seq_len)
    return emb.sharded_argmax(logits).to(torch.int32), caches


def decode_logits(cfg: ModelConfig, params, caches, token, pos=None,
                  flags: RunFlags = DEFAULT_FLAGS):
    """One token per sequence -> (logits (B, Vp) fp32, caches); the
    caches update in place.  Attention models read `pos`, the position
    every sequence writes (an int)."""
    x = emb.embed_tokens(cfg, params["embed"], token)          # (B, d)
    kind = cfg.block_pattern[0]
    ffn = _ffn_kind(cfg, cfg.n_layers - 1)
    view = None
    if kind == "attn":
        if pos is None:
            raise ValueError("an attention model's decode tick needs pos")
        B, S = caches["self"]["k"].shape[1:3]
        view = L.dense_page_view(B, S, pos, x.device)
    for i in range(cfg.n_layers):
        x, _ = block_decode(cfg, layer_params(params["blocks"], i), x,
                            layer_params(caches, i), pos, kind=kind,
                            ffn=ffn, flags=flags, view=view)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return emb.serve_logits(cfg, params["embed"], x), caches


def decode_step(cfg: ModelConfig, params, caches, token, pos, sample=None,
                flags: RunFlags = DEFAULT_FLAGS):
    """One decode step: token (B,) -> (next (B,) int32, caches).  `pos`,
    the position being written (shared by every sequence), is the
    reference's argument: attention blocks write and attend by it; rwkv
    blocks carry their position in the state and do not read it (nor any
    RunFlags knob), but a sampled step keys its draws by it.  Greedy by
    default; `sample=(seeds, temperature, top_p, top_k)`, (B,) each,
    draws under the online paged path's (seed, pos, stream) schedule."""
    logits, caches = decode_logits(cfg, params, caches, token, pos, flags)
    if sample is None:
        return emb.sharded_argmax(logits).to(torch.int32), caches
    seeds, temp, top_p, top_k = sample
    B = token.shape[0]
    pos_b = (pos.expand(B) if isinstance(pos, torch.Tensor)
             else torch.full((B,), pos, dtype=torch.int64,
                             device=token.device))
    nxt, _ = emb.sharded_sample(cfg, logits, seeds=seeds, pos=pos_b,
                                temperature=temp, top_p=top_p, top_k=top_k,
                                stream=emb.STREAM_SAMPLE)
    return nxt, caches


# ---- paged decode / chunked prefill (online serving) -----------------------


def check_paged_support(cfg: ModelConfig):
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    if kinds != {"attn"} or cfg.is_encoder_decoder:
        raise ValueError(
            f"paged online serving supports decoder-only all-'attn' "
            f"architectures; {cfg.arch_id} has blocks {sorted(kinds)}"
            f"{' (encoder-decoder)' if cfg.is_encoder_decoder else ''}")


def init_paged_caches(cfg: ModelConfig, n_pages: int, page_size: int,
                      device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-layer paged KV pools with a leading layer dim (page 0 is the
    engine's scratch page)."""
    check_paged_support(cfg)
    one = L.init_paged_kv_pool(cfg, n_pages, page_size, device)
    return {"self": {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                                    dtype=v.dtype, device=v.device)
                     for k, v in one.items()}}


def _layer_pool(pools, i: int):
    return {"self": {k: v[i] for k, v in pools["self"].items()}}


def _block_ffn(cfg, params, x, ffn: str, flags: RunFlags):
    h = L.apply_norm(cfg, params["norm2"], x)
    if ffn == "moe":
        partial, _ = moe_lib.moe_ffn(cfg, params["moe"], h,
                                     dispatch=flags.moe_dispatch)
    else:
        partial = L.apply_mlp(cfg, params["mlp"], h)
    return x + partial


def block_decode_paged(cfg, params, x, pool, pos, table, active, *,
                       page_size: int, ffn: str,
                       flags: RunFlags = DEFAULT_FLAGS, valid=None):
    """One layer of the paged decode tick: x (B, d)."""
    h = L.apply_norm(cfg, params["norm1"], x)
    partial, _ = L.paged_decode_attention(
        cfg, params["attn"], h, pool["self"], pos, table, active,
        page_size=page_size, paged_attn=flags.paged_attn, valid=valid)
    return _block_ffn(cfg, params, x + partial, ffn, flags), pool


def _paged_decode_logits(cfg: ModelConfig, params, pools, token, pos, table,
                         active, *, page_size: int,
                         flags: RunFlags = DEFAULT_FLAGS):
    """One token per slot -> (logits (B, Vp) fp32, pools)."""
    x = emb.embed_tokens(cfg, params["embed"], token)         # (B, d)
    ffn = _ffn_kind(cfg, cfg.n_layers - 1)
    valid = L.paged_valid_mask(table, pos[:, None], page_size=page_size)
    for i in range(cfg.n_layers):
        x, _ = block_decode_paged(
            cfg, layer_params(params["blocks"], i), x, _layer_pool(pools, i),
            pos, table, active, page_size=page_size, ffn=ffn, flags=flags,
            valid=valid)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return emb.serve_logits(cfg, params["embed"], x), pools


def _one(v, dtype, device) -> torch.Tensor:
    """A scalar knob (Python number or 0-d tensor) as a (1,) tensor on
    `device`; a number is filled there, not copied from the host."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1).to(device=device, dtype=dtype)
    return torch.full((1,), v, dtype=dtype, device=device)


def paged_decode_step(cfg: ModelConfig, params, pools, token, pos, table,
                      active, *, page_size: int,
                      flags: RunFlags = DEFAULT_FLAGS, sample=None):
    """One decode tick over the slot batch.  token (B,) input token per
    slot; pos (B,) position being written; table (B, n_lp); active (B,)
    bool.  Inactive slots compute harmlessly (their writes land in the
    scratch page).  `sample=None` is greedy; `sample=(seeds, temperature,
    top_p, top_k)`, all (B,), draws under the (seed, pos, STREAM_SAMPLE)
    keys, rows at temperature <= 0 bit for bit greedy.  Returns (next
    (B,) int32, pools)."""
    logits, pools = _paged_decode_logits(cfg, params, pools, token, pos,
                                         table, active, page_size=page_size,
                                         flags=flags)
    if sample is None:
        return emb.sharded_argmax(logits).to(torch.int32), pools
    seeds, temp, top_p, top_k = sample
    nxt, _ = emb.sharded_sample(cfg, logits, seeds=seeds, pos=pos,
                                temperature=temp, top_p=top_p, top_k=top_k,
                                stream=emb.STREAM_SAMPLE)
    return nxt, pools


# ---- speculative decoding (draft proposals + one verify pass) --------------
#
# The drafter (serving/draft.py) proposes k tokens per slot with
# `paged_draft_propose`: k+1 chained sampled decode ticks over its OWN
# pools (the target's page ids), the last only writing d_k's KV.
# `paged_verify_step` then scores all k+1 positions in one prefill-shaped
# target pass and accepts or rejects on the device: draft d while
# u*q(d) < p(d), then one residual draw from (p - q)+ (the bonus draw
# from p when every draft was accepted is its q = 0 case).  Rows at
# temperature <= 0 use argmax one-hots for p and q, so acceptance is
# token equality and the stream is bit for bit the greedy one.


def paged_draft_propose(cfg: ModelConfig, params, pools, token, pos0, table,
                        active, sample, *, k: int, page_size: int,
                        flags: RunFlags = DEFAULT_FLAGS):
    """k draft tokens per slot from the drafter.  token (B,) the pending
    (last emitted, unwritten) token per slot at position pos0 (B,); k+1
    chained sampled decode ticks on stream STREAM_DRAFT: ticks 0..k-1
    give d_1..d_k, tick k only writes d_k's KV.  Returns (drafts (B, k)
    int32, draft_probs (B, k, Vp), pools)."""
    seeds, temp, top_p, top_k = sample
    tok, toks, probs = token, [], []
    for i in range(k + 1):
        pos = pos0 + i
        logits, pools = _paged_decode_logits(cfg, params, pools, tok, pos,
                                             table, active,
                                             page_size=page_size, flags=flags)
        if i == k:
            break
        tok, p = emb.sharded_sample(cfg, logits, seeds=seeds, pos=pos,
                                    temperature=temp, top_p=top_p,
                                    top_k=top_k, stream=emb.STREAM_DRAFT)
        toks.append(tok)
        probs.append(p)
    return torch.stack(toks, 1), torch.stack(probs, 1), pools


def block_verify_paged(cfg, params, x, pool, pos, table, active, *, B: int,
                       Q: int, page_size: int, ffn: str,
                       flags: RunFlags = DEFAULT_FLAGS, valid=None):
    """One layer of the k+1-token verify pass: x (B*Q, d)."""
    h = L.apply_norm(cfg, params["norm1"], x)
    partial, _ = L.paged_verify_attention(
        cfg, params["attn"], h.reshape(B, Q, -1), pool["self"], pos, table,
        active, page_size=page_size, paged_attn=flags.paged_attn,
        valid=valid)
    return _block_ffn(cfg, params, x + partial, ffn, flags), pool


def _paged_verify_logits(cfg: ModelConfig, params, pools, tokens, pos, table,
                         active, *, page_size: int,
                         flags: RunFlags = DEFAULT_FLAGS):
    """tokens (B, Q) at positions pos (B, Q) -> (logits (B*Q, Vp) fp32,
    pools), every candidate's KV written."""
    B, Q = tokens.shape
    x = emb.embed_tokens(cfg, params["embed"], tokens.reshape(-1))
    ffn = _ffn_kind(cfg, cfg.n_layers - 1)
    valid = L.paged_valid_mask(table, pos, page_size=page_size)
    for i in range(cfg.n_layers):
        x, _ = block_verify_paged(
            cfg, layer_params(params["blocks"], i), x, _layer_pool(pools, i),
            pos, table, active, B=B, Q=Q, page_size=page_size, ffn=ffn,
            flags=flags, valid=valid)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return emb.serve_logits(cfg, params["embed"], x), pools


def paged_verify_step(cfg: ModelConfig, params, pools, tokens, pos0, table,
                      active, draft_probs, sample, *, page_size: int,
                      flags: RunFlags = DEFAULT_FLAGS):
    """Score k+1 candidate positions per slot and accept or reject the
    drafts.  tokens (B, K+1): column 0 the pending token, 1..K the
    drafts; pos0 (B,) the pending token's position; draft_probs (B, K,
    Vp) the distributions the drafts were drawn from; sample the (B,)
    (seeds, temperature, top_p, top_k).  Returns (n_acc (B,) int32
    accepted drafts in [0, K], out (B, K+1) int32 — out[:, :n_acc] the
    accepted drafts, out[:, n_acc] the residual or bonus token, zeros
    after — and the pools, with the target KV of all K+1 positions
    written; the host commits n_acc+1 tokens and trims the page tail)."""
    B, K1 = tokens.shape
    K = K1 - 1
    dev = tokens.device
    seeds, temp, top_p, top_k = sample
    pos = pos0[:, None] + torch.arange(K1, device=dev)[None, :]  # (B, K1)
    logits, pools = _paged_verify_logits(cfg, params, pools, tokens, pos,
                                         table, active, page_size=page_size,
                                         flags=flags)        # (B*K1, Vp)

    rep = lambda a: torch.repeat_interleave(a, K1, dim=0)
    greedy, probs = emb.sampled_probs(cfg, logits, rep(temp), rep(top_p),
                                      rep(top_k))
    vp = probs.shape[-1]
    greedy = greedy.reshape(B, K1)
    probs = probs.reshape(B, K1, vp)

    # accept while u * q(d) < p(d): sequential through a cumprod
    d = tokens[:, 1:].long()                                 # (B, K)
    p_d = torch.gather(probs[:, :K], 2, d[..., None])[..., 0]
    q_d = torch.gather(draft_probs, 2, d[..., None])[..., 0]
    ukeys = emb.sample_keys(rep(seeds).reshape(B, K1)[:, :K].reshape(-1),
                            pos[:, :K].reshape(-1), emb.STREAM_ACCEPT)
    u = prng.uniform(ukeys).reshape(B, K)
    acc = (u * q_d < p_d) & active[:, None]
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)  # (B,)

    # the residual (or bonus) draw at position n_acc
    sel = n_acc.long()[:, None, None].expand(B, 1, vp)
    p_sel = torch.gather(probs, 1, sel)[:, 0]                # (B, Vp)
    q_pad = torch.cat([draft_probs, draft_probs.new_zeros((B, 1, vp))], 1)
    q_sel = torch.gather(q_pad, 1, sel)[:, 0]
    res = torch.clamp_min(p_sel - q_sel, 0.0)
    res = torch.where(res.sum(dim=-1, keepdim=True) > 0, res, p_sel)
    rkeys = emb.sample_keys(seeds, pos0 + n_acc, emb.STREAM_RESID)
    cat = prng.categorical(rkeys, torch.log(res)).to(torch.int32)
    g_sel = torch.gather(greedy, 1, n_acc.long()[:, None])[:, 0]
    extra = torch.where(temp <= 0.0, g_sel, cat)

    j = torch.arange(K1, device=dev)[None, :]
    d_pad = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], 1)
    na = n_acc[:, None]
    out = torch.where(j < na, d_pad,
                      torch.where(j == na, extra[:, None], 0))
    return n_acc.to(torch.int32), out.to(torch.int32), pools


def block_prefill_paged(cfg, params, x, pool, base, n_valid, table_row, *,
                        page_size: int, ffn: str,
                        flags: RunFlags = DEFAULT_FLAGS, valid=None):
    """One layer of chunked prefill for a single request: x (C, d)."""
    h = L.apply_norm(cfg, params["norm1"], x)
    partial, _ = L.paged_prefill_attention(
        cfg, params["attn"], h, pool["self"], base, n_valid, table_row,
        page_size=page_size, paged_attn=flags.paged_attn, valid=valid)
    return _block_ffn(cfg, params, x + partial, ffn, flags), pool


def _paged_prefill_logits(cfg: ModelConfig, params, pools, tokens, base,
                          n_valid, table_row, *, page_size: int,
                          flags: RunFlags = DEFAULT_FLAGS):
    """Prefill one chunk; returns (logits (1, Vp) fp32 at the last valid
    chunk position, pools)."""
    C = tokens.shape[0]
    x = emb.embed_tokens(cfg, params["embed"], tokens)        # (C, d)
    ffn = _ffn_kind(cfg, cfg.n_layers - 1)
    posq = base + torch.arange(C, device=tokens.device)
    valid = L.paged_valid_mask(table_row[None], posq[None],
                               page_size=page_size)
    for i in range(cfg.n_layers):
        x, _ = block_prefill_paged(
            cfg, layer_params(params["blocks"], i), x, _layer_pool(pools, i),
            base, n_valid, table_row, page_size=page_size, ffn=ffn,
            flags=flags, valid=valid)
    x = L.apply_norm(cfg, params["final_norm"], x)
    last = min(max(int(n_valid) - 1, 0), C - 1)
    return emb.serve_logits(cfg, params["embed"], x[last:last + 1]), pools


def paged_prefill_chunk(cfg: ModelConfig, params, pools, tokens, base,
                        n_valid, table_row, *, page_size: int,
                        flags: RunFlags = DEFAULT_FLAGS, sample=None):
    """Prefill one chunk of one request's prompt into its pages.  tokens
    (C,) (tail past n_valid is padding); base (int) tokens already
    written; table_row (n_lp,).  Returns (next token, a 0-d int32 tensor
    meaningful on the request's final chunk, and the pools).  `sample=
    (seed, temperature, top_p, top_k)` scalars draw that token at
    position base + n_valid - 1 under the shared key schedule (bit for
    bit greedy at temperature <= 0)."""
    logits, pools = _paged_prefill_logits(cfg, params, pools, tokens, base,
                                          n_valid, table_row,
                                          page_size=page_size, flags=flags)
    if sample is None:
        return emb.sharded_argmax(logits)[0].to(torch.int32), pools
    seed, temp, top_p, top_k = sample
    dev = logits.device
    nxt, _ = emb.sharded_sample(
        cfg, logits, seeds=_one(seed, torch.int64, dev),
        pos=_one(base + n_valid - 1, torch.int64, dev),
        temperature=_one(temp, torch.float32, dev),
        top_p=_one(top_p, torch.float32, dev),
        top_k=_one(top_k, torch.int64, dev), stream=emb.STREAM_SAMPLE)
    return nxt[0], pools
