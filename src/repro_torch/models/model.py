"""Model assembly (counterpart of `repro.models.model`):
parameter init; the forward (training, and the prefill with caches) and
the loss (`forward`, `loss_fn`); dense decode caches and the `prefill` /
`decode_step`; paged KV pools and the fixed shape serving steps of
attention models — one paged decode tick over every slot, one
chunked-prefill chunk for one request, and speculative decoding's draft
proposals and verify pass.  Every decode, prefill and verify step may
sample (temperature / top-k / top-p under the reference's (seed,
position, stream) threefry keys).

Every block kind of the reference is ported, in any pattern: "attn",
"swa" (a sliding window: a rolling decode cache), "rwkv" and "rglru"
(recurrent state), and the whisper encoder-decoder (learned positions,
a non-causal encoder, decoder blocks with cross attention over the
encoder's output).  Paged online serving takes decoder-only all-"attn"
models, as the reference's (`check_paged_support`).

Parameters keep the reference's nested-dict keys and its two layouts:
a uniform decoder-only pattern has a leading layer dim on every `blocks`
leaf (`stacked`), a mixed pattern and the encoder-decoder a list of
per-layer trees (`blocks`, and `enc_blocks`).  A Python loop over layers
replaces `lax.scan`.  The dense caches take the same layout (a leading
layer dim, or a list) and the KV pools a leading layer dim; all are
updated in place.

Over a (dp, tp) mesh (`env`, a `sharding.AxisEnv`; default one rank)
every function sees the rank's shards: `init_model` cuts each leaf of
the same global parameters by its spec (`param_specs`), the training
blocks gather their sequence-parallel inputs over tp and reduce-scatter
their partial outputs back (`env.sp_gather` / `env.sp_scatter`), the
loss is the vocab-sharded cross entropy summed over dp, and the serving
steps keep activations replicated over tp (`sharding.denv`) and psum
each block's partial outputs.  At dp * tp > 1 only Ling-Lite's blocks
run (`check_mesh_support`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.core import router as router_lib
from repro_torch.core import moe as moe_lib
from repro_torch.models import embedding as emb
from repro_torch.models import layers as L
from repro_torch.models import prng
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.sharding import LOCAL, AxisEnv

BLOCK_KINDS = ("attn", "swa", "rwkv", "rglru")


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Run knobs, with the reference's defaults.  moe_dispatch: "auto" |
    "fused" | "ragged" | "ep" ("auto" is the K1/K2 kernel path: "fused"
    at tp=1, "ep" at tp > 1).  paged_attn:
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


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.attn_window if kind == "swa" else None


def stacked(cfg: ModelConfig) -> bool:
    """True where the blocks (and the dense caches) carry a leading layer
    dim: uniform decoder-only patterns.  Mixed patterns and the
    encoder-decoder keep lists of per-layer trees, as the reference."""
    return cfg.uniform_blocks and not cfg.is_encoder_decoder


def check_ported_blocks(cfg: ModelConfig):
    """Raises ValueError for a block kind the reference does not build."""
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    unknown = sorted(kinds - set(BLOCK_KINDS))
    if unknown:
        raise ValueError(f"{cfg.arch_id}: unknown block kinds {unknown} "
                         f"(known: {list(BLOCK_KINDS)})")


# the architectures held at dp * tp > 1 (ROADMAP item 9 lists the rest)
MESH_ARCHS = ("ling-lite",)


def check_mesh_support(cfg: ModelConfig, env: AxisEnv):
    """Raises NotImplementedError for an architecture the port does not
    run over a mesh of more than one rank."""
    if env.dp * env.tp > 1 and cfg.arch_id not in MESH_ARCHS:
        raise NotImplementedError(
            f"{cfg.arch_id} on a (dp={env.dp}, tp={env.tp}) mesh is not "
            f"yet ported (ROADMAP item 9: {', '.join(MESH_ARCHS)} runs "
            f"over more than one rank)")


def init_block(cfg: ModelConfig, init: L.Init, kind: str, ffn: str,
               cross: bool = False) -> Dict[str, Any]:
    params: Dict[str, Any] = {"norm1": L.init_norm(cfg, init)}
    if kind in ("attn", "swa"):
        params["attn"] = L.init_attention(cfg, init)
    elif kind == "rwkv":
        params["tmix"] = rwkv_lib.init_time_mix(cfg, init)
    elif kind == "rglru":
        params["rec"] = rglru_lib.init_rglru(cfg, init)
    else:
        raise ValueError(kind)
    if cross:
        params["norm_x"] = L.init_norm(cfg, init)
        params["xattn"] = L.init_attention(cfg, init)
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
               masters: bool = False, max_seq: int = 4096,
               env: AxisEnv = LOCAL, init: Optional[L.Init] = None
               ) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and scales
    (`layers.dense_init`: normal * 0.02, output projections * 0.02 /
    sqrt(n_layers), norms at 1 (and 0 for LayerNorm's bias)), drawn on
    `device` from `generator`.  With `masters` (training) every leaf is
    stored in `cfg.param_dtype`, as the reference keeps it; otherwise
    (serving) the leaves the reference casts to the compute dtype at use
    are stored in that dtype, and the router, the norms and the LM head
    stay fp32 (rwkv6.py and rglru.py say which of their leaves stay
    fp32).  An encoder-decoder also has learned positions: `pos_enc`
    (encoder_seq_len, d) and `pos_dec` (max_seq, d).  On the meta device
    only shapes are built.  Over a mesh (`env`) each rank gets its shards
    of the same global parameters: every leaf is drawn whole and cut by
    its spec (`L.Init`).  `init`, where given, is the factory to use
    (`param_specs` reads the specs it records)."""
    check_ported_blocks(cfg)
    check_mesh_support(cfg, env)
    device = torch.device(device)
    init = init or L.Init(device=device, generator=generator,
                          masters=masters, env=env)
    params: Dict[str, Any] = {"embed": emb.init_embedding(cfg, init),
                              "final_norm": L.init_norm(cfg, init)}
    if cfg.is_encoder_decoder:
        wdt = init.weight_dtype(cfg)
        params["pos_enc"] = init.normal((cfg.encoder_seq_len, cfg.d_model),
                                        wdt)
        params["pos_dec"] = init.normal((max_seq, cfg.d_model), wdt)
        params["enc_norm"] = L.init_norm(cfg, init)
        params["enc_blocks"] = [init_block(cfg, init, "attn", "mlp")
                                for _ in range(cfg.encoder_layers)]
        params["blocks"] = [init_block(cfg, init, "attn", "mlp", cross=True)
                            for _ in range(cfg.n_layers)]
    elif stacked(cfg):
        lead = dataclasses.replace(init, lead=(cfg.n_layers,))
        params["blocks"] = init_block(cfg, lead, cfg.block_pattern[0],
                                      _ffn_kind(cfg, cfg.n_layers - 1))
    else:
        params["blocks"] = [init_block(cfg, init, cfg.block_kind(i),
                                       _ffn_kind(cfg, i))
                            for i in range(cfg.n_layers)]
    return params


def param_specs(cfg: ModelConfig, env: AxisEnv = LOCAL,
                max_seq: int = 4096):
    """The spec tree of `init_model`'s parameters over `env`'s mesh (a
    `sharding.P` per leaf, the stacked layer dim whole), in the same
    layout."""
    init = L.Init(device=torch.device("meta"), env=env)
    params = init_model(cfg, device="meta", max_seq=max_seq, env=env,
                        init=init)

    def spec(t):
        if isinstance(t, dict):
            return {k: spec(v) for k, v in t.items()}
        if isinstance(t, list):
            return [spec(v) for v in t]
        return init.spec_of(t)
    return spec(params)


def layer_params(blocks, i: int):
    """Layer i's parameters (or caches): a list's entry, or views into the
    stacked leaves."""
    if isinstance(blocks, list):
        return blocks[i]
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def _layer_ffn(cfg: ModelConfig, i: int) -> str:
    """Layer i's FFN kind; a stacked pattern takes its last layer's for
    every layer, as the reference's scan does."""
    return _ffn_kind(cfg, cfg.n_layers - 1 if stacked(cfg) else i)


# ---- forward and loss (training) -------------------------------------------


def choose_block(s: int, target: int = 1024) -> int:
    """Largest divisor of s that is <= target (chunks must tile s)."""
    if s <= target:
        return s
    return max(b for b in range(1, target + 1) if s % b == 0)


def warmup_noise(cfg: ModelConfig, rng, step, T: int,
                 env: AxisEnv = LOCAL):
    """Each layer's router-warmup noise for T tokens, as the reference
    draws it: layer i's eps is `normal(key_i, (T, n_experts))` with the
    layer keys `split(rng, n_layers)` (stacked blocks) or `fold_in(rng,
    i)` (a list), all layers in one draw: (L, T, E) fp32.  Over tp (the
    "ep" dispatch) rank r routes T / tp owned tokens under key_i folded
    with r.  None where no warmup mix applies (no rng, no MoE, no warmup,
    or step past it, where alpha = 1 gives the learned logits whatever
    eps is)."""
    m = cfg.moe
    if (rng is None or m is None or m.router_warmup_steps <= 0
            or step is None or step >= m.router_warmup_steps):
        return None
    if stacked(cfg):
        if _ffn_kind(cfg, cfg.n_layers - 1) != "moe":
            return None
        keys = prng.split(rng, cfg.n_layers)
    else:
        keys = torch.stack([prng.fold_in(rng, i)
                            for i in range(cfg.n_layers)])
    if env.tp > 1:
        keys = prng.fold_in(keys, env.tp_index())
        T = T // env.tp
    return router_lib.warmup_noise(keys, (T, m.n_experts))


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
                  flags: RunFlags = DEFAULT_FLAGS, want_cache: bool = False,
                  causal: bool = True, enc_out=None, env: AxisEnv = LOCAL):
    """One block: x (T, d) -> (x, aux, metrics, cache or None).  eps
    (T, E) is the layer's router-warmup noise, or None.  Over tp x is the
    rank's sequence-parallel slice (T / tp, d): each sublayer gathers its
    normed input (`env.sp_gather`) and reduce-scatters its partial output
    (`env.sp_scatter`).  Every kind runs
    for training and, with `train=False`, for inference (the MoE on the
    serving router; rwkv: K6 and the decay kernel), where `want_cache`
    returns the layer's decode cache: {"self": {"k", "v"}} ("attn",
    "swa"), {"rglru": {"h", "conv"}}, {"rwkv": {"wkv", "last_x"},
    "cmix_prev"}, and {"cross": {"k", "v"}} beside it in a decoder block
    with cross attention over `enc_out` (B, S_enc, d).  `causal=False`
    is the encoder's attention."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv":
        x, cache = _rwkv_block(cfg, params, x, B=B, S=S, train=train,
                               chunk=flags.rwkv_chunk)
        return x, zero, {}, (cache if want_cache else None)
    d = cfg.d_model
    cache = {}
    h = env.sp_gather(L.apply_norm(cfg, params["norm1"], x, env)) \
        .reshape(B, S, d)
    if kind == "rglru":
        partial, cache["rglru"] = rglru_lib.recurrent_block(
            cfg, params["rec"], h)
    else:
        partial = L.apply_attention(cfg, params["attn"], h, causal=causal,
                                    window=_window(cfg, kind),
                                    return_cache=want_cache, env=env)
        if want_cache:
            partial, cache["self"] = partial
    x = x + env.sp_scatter(partial.reshape(B * S, d))
    if "xattn" in params:
        h = L.apply_norm(cfg, params["norm_x"], x).reshape(B, S, d)
        partial = L.apply_attention(cfg, params["xattn"], h, causal=False,
                                    kv_source=enc_out, use_rope=False,
                                    return_cache=want_cache)
        if want_cache:
            partial, cache["cross"] = partial
        x = x + partial.reshape(B * S, d)
    h = env.sp_gather(L.apply_norm(cfg, params["norm2"], x, env))
    aux, metrics = zero, {}
    if ffn == "moe" and train:
        partial, aux, metrics = moe_lib.moe_ffn(
            cfg, params["moe"], h, dispatch=flags.moe_dispatch, train=True,
            step=step, eps=eps, env=env)
    elif ffn == "moe":
        partial, metrics = moe_lib.moe_ffn(cfg, params["moe"], h,
                                           dispatch=flags.moe_dispatch,
                                           env=env)
    else:
        partial = L.apply_mlp(cfg, params["mlp"], h, env=env)
    return (x + env.sp_scatter(partial), aux, metrics,
            (cache if want_cache else None))


def _stack(trees):
    """Per-layer cache trees -> one tree with a leading layer dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _run_blocks(cfg: ModelConfig, params, x, *, B: int, S: int, step,
                rng, train: bool, flags: RunFlags, want_cache: bool,
                enc_out=None, env: AxisEnv = LOCAL):
    """The layer loop.  In training with `flags.remat` every block runs
    under torch.utils.checkpoint and is recomputed in the backward.  The
    warmup noise (`warmup_noise`) is drawn here, outside the checkpointed
    blocks, so the recompute routes as the forward did.  Returns (x, aux
    summed over layers, metrics averaged over the layers that report
    them, caches in `init_caches`' layout or None)."""
    noise = warmup_noise(cfg, rng, step, B * S, env) if train else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    metrics_all, caches = [], []
    for i in range(cfg.n_layers):
        eps = noise[i] if noise is not None else None
        fn = functools.partial(block_forward, cfg, B=B, S=S,
                               kind=cfg.block_kind(i),
                               ffn=_layer_ffn(cfg, i), step=step,
                               train=train, flags=flags,
                               want_cache=want_cache, enc_out=enc_out,
                               env=env)
        lp = layer_params(params["blocks"], i)
        if flags.remat and train:
            x, a, mets, cache = checkpoint(fn, lp, x, eps,
                                           use_reentrant=False,
                                           preserve_rng_state=False)
        else:
            x, a, mets, cache = fn(lp, x, eps)
        aux = aux + a
        if mets:
            metrics_all.append(mets)
        caches.append(cache)
    metrics = {k: torch.mean(torch.stack([m[k] for m in metrics_all]))
               for k in (metrics_all[0] if metrics_all else {})}
    if not want_cache:
        caches = None
    elif stacked(cfg):
        caches = _stack(caches)
    return x, aux, metrics, caches


def encode(cfg: ModelConfig, params, frames, flags: RunFlags = DEFAULT_FLAGS):
    """The whisper encoder over the stub frontend's frame embeddings
    (B, S_enc, d): learned positions, non-causal "attn" blocks (no
    cache, the inference router: the reference's `_encode`), the encoder
    norm.  Returns (B, S_enc, d) in the compute dtype."""
    B, S_enc, d = frames.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    x = (frames.to(cdt) + params["pos_enc"].to(cdt)[None]).reshape(-1, d)
    for lp in params["enc_blocks"]:
        x, _, _, _ = block_forward(cfg, lp, x, None, B=B, S=S_enc,
                                   kind="attn", ffn="mlp", train=False,
                                   flags=flags, causal=False)
    return L.apply_norm(cfg, params["enc_norm"], x).reshape(B, S_enc, d)


def forward(cfg: ModelConfig, params, batch, *, step=None, rng=None,
            train: bool = True, flags: RunFlags = DEFAULT_FLAGS,
            want_cache: bool = False, env: AxisEnv = LOCAL):
    """batch["tokens"] (B, S) (the rank's rows over dp) -> (x_final (T, d),
    gathered over tp, aux, metrics, caches);
    an encoder-decoder also reads batch["enc_frames"] (B, S_enc, d).
    `rng`, a threefry key (`models.prng`), draws the router-warmup noise
    (`warmup_noise`); None draws none.  With `want_cache` (inference)
    caches is the decode cache the prompt leaves behind (`init_caches`'
    layout; attention caches S positions long, cross caches S_enc), else
    None."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = None
    x = emb.embed_tokens(cfg, params["embed"], tokens.reshape(-1), env)
    if cfg.is_encoder_decoder:
        enc_out = encode(cfg, params, batch["enc_frames"], flags)
        x = x + params["pos_dec"].to(x.dtype)[:S].repeat(B, 1)
    x, aux, metrics, caches = _run_blocks(
        cfg, params, x, B=B, S=S, step=step, rng=rng, train=train,
        flags=flags, want_cache=want_cache, enc_out=enc_out, env=env)
    x = env.sp_gather(L.apply_norm(cfg, params["final_norm"], x, env))
    return x, aux, metrics, caches


def _chunk_xent(cfg: ModelConfig, embed, xc, lc, env: AxisEnv = LOCAL):
    """Summed cross entropy of one token chunk over valid labels (>= 0),
    over the tp-sharded vocab (`embedding.token_xent`)."""
    return torch.sum(emb.token_xent(cfg, emb.lm_logits(cfg, embed, xc, env),
                                    lc, env))


def loss_fn(cfg: ModelConfig, params, batch, *, step=None, rng=None,
            flags: RunFlags = DEFAULT_FLAGS, env: AxisEnv = LOCAL):
    """Training loss: chunked NormHead cross entropy + MoE aux losses.
    Each chunk of `flags.loss_chunk` tokens is checkpointed under
    `flags.remat`, so its (chunk, V) fp32 logits live only inside it.
    Over dp the sums of the losses and of the valid labels are taken over
    every rank's rows.  Returns (loss, metrics)."""
    x, aux, block_metrics, _ = forward(cfg, params, batch, step=step,
                                       rng=rng, flags=flags, env=env)
    labels = batch["labels"].reshape(-1)
    T = x.shape[0]
    chunk = choose_block(T, flags.loss_chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, T, chunk):
        args = (cfg, params["embed"], x[i:i + chunk], labels[i:i + chunk],
                env)
        total = total + (checkpoint(_chunk_xent, *args, use_reentrant=False,
                                    preserve_rng_state=False)
                         if flags.remat else _chunk_xent(*args))
    n_valid = env.psum_dp(torch.sum((labels >= 0).float()))
    ce = env.psum_dp(total) / torch.clamp(n_valid, min=1.0)
    return ce + aux, {"loss/ce": ce, "loss/aux": aux, **block_metrics}


# ---- prefill and dense decode ----------------------------------------------


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, device,
                     seq_len: Optional[int] = None,
                     lead=(), env: AxisEnv = LOCAL) -> Dict[str, Any]:
    """One layer's zeroed decode cache: for "attn" / "swa" the KV cache of
    `seq_len` positions (a rolling cache of min(window, seq_len) for
    "swa"; {"self": {"k", "v"}}, `layers.init_decode_cache`, with the
    leading dims `lead`); for "rglru" its recurrence and conv state
    ({"rglru": {"h", "conv"}}); for "rwkv" the wkv state and the last
    normed inputs of the time mix and the channel mix (no length: the
    state does not grow); in an encoder-decoder also the cross cache of
    `cfg.encoder_seq_len` positions ({"cross": {"k", "v"}})."""
    cache: Dict[str, Any] = {}
    if kind in ("attn", "swa"):
        if seq_len is None:
            raise ValueError("an attention model's decode cache needs "
                             "seq_len")
        cache["self"] = L.init_decode_cache(cfg, batch, seq_len, device,
                                            window=_window(cfg, kind),
                                            lead=lead, env=env)
    elif kind == "rglru":
        cache["rglru"] = rglru_lib.init_decode_state(cfg, batch, device)
    else:
        cache["rwkv"] = rwkv_lib.init_decode_state(cfg, batch, device)
        cache["cmix_prev"] = torch.zeros(
            (batch, cfg.d_model), dtype=L.dtype_of(cfg.compute_dtype),
            device=device)
    if cfg.is_encoder_decoder:
        cache["cross"] = L.init_decode_cache(
            cfg, batch, cfg.encoder_seq_len, device, lead=lead)
    return cache


def init_caches(cfg: ModelConfig, batch: int, device,
                seq_len: Optional[int] = None, env: AxisEnv = LOCAL):
    """Zeroed dense decode caches: a leading layer dim (`stacked`) or a
    list of per-layer caches.  `seq_len` is the KV caches' length
    (attention layers; over tp each rank holds seq_len / tp of the
    positions), ignored by recurrent ones; an encoder-decoder's cross
    caches hold `cfg.encoder_seq_len` positions."""
    check_ported_blocks(cfg)
    check_mesh_support(cfg, env)
    if not stacked(cfg):
        return [init_block_cache(cfg, cfg.block_kind(i), batch, device,
                                 seq_len)
                for i in range(cfg.n_layers)]
    kind = cfg.block_pattern[0]
    if kind in ("attn", "swa"):   # views of padded storage: not a stack
        return init_block_cache(cfg, kind, batch, device, seq_len,
                                lead=(cfg.n_layers,), env=env)
    one = init_block_cache(cfg, kind, batch, device, seq_len)
    return _stack([one] * cfg.n_layers)


class TickViews:
    """The page views (`layers.dense_page_view`) of one decode tick, one
    per cache length and kind, built on first use: the layers of one
    length share it.  S is the rank's positions, offset by r*S over
    tp."""

    def __init__(self, batch: int, pos, device, env: AxisEnv = LOCAL):
        self.batch, self.pos, self.device = batch, pos, device
        self.env = env
        self._views = {}

    def __call__(self, S: int, cross: bool = False):
        key = (S, cross)
        if key not in self._views:
            tp = self.env.tp
            self._views[key] = L.dense_page_view(
                self.batch, S, S * tp - 1 if cross else self.pos,
                self.device, offset=self.env.tp_index() * S)
        return self._views[key]


def block_decode(cfg: ModelConfig, params, x, cache, pos=None, *, kind: str,
                 ffn: str = "moe", flags: RunFlags = DEFAULT_FLAGS,
                 views: Optional[TickViews] = None, env: AxisEnv = LOCAL):
    """One layer of the decode tick: x (B, d) (replicated over tp);
    `cache` the layer's cache (views into stacked caches, or a list's
    entry), updated in place; `pos` the position every sequence writes
    (attention; the recurrent kinds carry it in their state) and `views`
    the tick's page views of the KV caches.  Partial sublayer outputs are
    summed over tp.  Returns (x, cache)."""
    if kind == "rwkv":
        h = L.apply_norm(cfg, params["norm1"], x)
        partial, _ = rwkv_lib.time_mix_decode(cfg, params["tmix"], h,
                                              cache["rwkv"])
        x = x + partial
        h = L.apply_norm(cfg, params["norm2"], x)
        partial, gate = rwkv_lib.channel_mix(cfg, params["cmix"], h,
                                             cache["cmix_prev"])
        cache["cmix_prev"].copy_(h)
        return x + gate * partial, cache
    views = views or TickViews(x.shape[0], pos, x.device, env)
    h = L.apply_norm(cfg, params["norm1"], x, env)
    if kind == "rglru":
        partial = rglru_lib.decode_step(cfg, params["rec"], h,
                                        cache["rglru"])
    else:
        partial, _ = L.decode_attention(
            cfg, params["attn"], h, cache["self"], pos,
            window=_window(cfg, kind), paged_attn=flags.paged_attn,
            view=views(cache["self"]["k"].shape[1]), env=env)
    x = x + env.psum_tp(partial)
    if "xattn" in params:
        h = L.apply_norm(cfg, params["norm_x"], x)
        partial, _ = L.decode_attention(
            cfg, params["xattn"], h, cache["cross"], pos, cross=True,
            paged_attn=flags.paged_attn,
            view=views(cache["cross"]["k"].shape[1], cross=True))
        x = x + partial
    return _block_ffn(cfg, params, x, ffn, flags, env), cache


def _expand_layer_cache(cfg: ModelConfig, cache, kind: str,
                        seq_len: Optional[int], env: AxisEnv = LOCAL):
    """A layer's prefill cache laid out for the ticks
    (`layers.expand_cache_from_prefill`): the self-attention cache at
    seq_len (a rolling window's at min(window, seq_len); over tp the
    rank's positions), the cross cache at its own length; recurrent state
    as it is."""
    out = dict(cache)
    if "self" in cache:
        out["self"] = L.expand_cache_from_prefill(cache["self"], seq_len,
                                                  _window(cfg, kind), env)
    if "cross" in cache:
        out["cross"] = L.expand_cache_from_prefill(cache["cross"])
    return out


def prefill_logits(cfg: ModelConfig, params, batch,
                   flags: RunFlags = DEFAULT_FLAGS,
                   seq_len: Optional[int] = None, env: AxisEnv = LOCAL):
    """The prompt batch ["tokens"] (B, S) (and ["enc_frames"] for an
    encoder-decoder) -> (logits (B, V_loc) fp32 at each sequence's last
    token, the rank's vocab rows, caches).  Attention caches hold the
    prompt's S positions, or `seq_len` (zero rows after the prompt's)
    when given (over tp the rank's share); a sliding window's,
    min(window, that); a prompt longer than the window raises."""
    x, _, _, caches = forward(cfg, params, batch, train=False, flags=flags,
                              want_cache=True, env=env)
    if stacked(cfg):
        caches = _expand_layer_cache(cfg, caches, cfg.block_pattern[0],
                                     seq_len, env)
    else:
        caches = [_expand_layer_cache(cfg, c, cfg.block_kind(i), seq_len)
                  for i, c in enumerate(caches)]
    B, S = batch["tokens"].shape
    last = x.reshape(B, S, -1)[:, -1]
    return emb.serve_logits(cfg, params["embed"], last, env), caches


def prefill(cfg: ModelConfig, params, batch,
            flags: RunFlags = DEFAULT_FLAGS, seq_len: Optional[int] = None,
            env: AxisEnv = LOCAL):
    """Greedy prefill: (first generated token (B,) int32, caches)."""
    logits, caches = prefill_logits(cfg, params, batch, flags, seq_len, env)
    return emb.sharded_argmax(logits, env).to(torch.int32), caches


def _attends(cfg: ModelConfig) -> bool:
    return cfg.is_encoder_decoder or any(
        cfg.block_kind(i) in ("attn", "swa") for i in range(cfg.n_layers))


def decode_logits(cfg: ModelConfig, params, caches, token, pos=None,
                  flags: RunFlags = DEFAULT_FLAGS, env: AxisEnv = LOCAL):
    """One token per sequence -> (logits (B, V_loc) fp32, caches); the
    caches update in place.  Attention models read `pos`, the position
    every sequence writes (an int); an encoder-decoder adds its learned
    position `pos_dec[pos]` to the embedding."""
    env = sharding.denv(env)
    x = emb.embed_tokens(cfg, params["embed"], token, env)     # (B, d)
    if pos is None and _attends(cfg):
        raise ValueError("an attention model's decode tick needs pos")
    if cfg.is_encoder_decoder:
        n_pos = params["pos_dec"].shape[0]
        if not 0 <= int(pos) < n_pos:
            raise ValueError(f"decode position {int(pos)} is past the "
                             f"{n_pos} learned positions (pos_dec; "
                             f"Runner.max_seq)")
        x = x + params["pos_dec"][int(pos)].to(x.dtype)[None]
    views = TickViews(x.shape[0], pos, x.device, env)
    for i in range(cfg.n_layers):
        x, _ = block_decode(cfg, layer_params(params["blocks"], i), x,
                            layer_params(caches, i), pos,
                            kind=cfg.block_kind(i), ffn=_layer_ffn(cfg, i),
                            flags=flags, views=views, env=env)
    x = L.apply_norm(cfg, params["final_norm"], x, env)
    return emb.serve_logits(cfg, params["embed"], x, env), caches


def decode_step(cfg: ModelConfig, params, caches, token, pos, sample=None,
                flags: RunFlags = DEFAULT_FLAGS, env: AxisEnv = LOCAL):
    """One decode step: token (B,) -> (next (B,) int32, caches).  `pos`,
    the position being written (shared by every sequence), is the
    reference's argument: attention blocks write and attend by it; the
    recurrent blocks carry their position in the state and do not read
    it, but a sampled step keys its draws by it.  Greedy by default;
    `sample=(seeds, temperature, top_p, top_k)`, (B,) each, draws under
    the online paged path's (seed, pos, stream) schedule."""
    logits, caches = decode_logits(cfg, params, caches, token, pos, flags,
                                   env)
    if sample is None:
        return emb.sharded_argmax(logits, env).to(torch.int32), caches
    seeds, temp, top_p, top_k = sample
    B = token.shape[0]
    pos_b = (pos.expand(B) if isinstance(pos, torch.Tensor)
             else torch.full((B,), pos, dtype=torch.int64,
                             device=token.device))
    nxt, _ = emb.sharded_sample(cfg, logits, seeds=seeds, pos=pos_b,
                                temperature=temp, top_p=top_p, top_k=top_k,
                                stream=emb.STREAM_SAMPLE, env=env)
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
                      device, env: AxisEnv = LOCAL
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-layer paged KV pools with a leading layer dim (page 0 is the
    engine's scratch page); over tp the rank's in-page offsets."""
    check_paged_support(cfg)
    check_mesh_support(cfg, env)
    one = L.init_paged_kv_pool(cfg, n_pages, page_size, device, env)
    return {"self": {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                                    dtype=v.dtype, device=v.device)
                     for k, v in one.items()}}


def _layer_pool(pools, i: int):
    return {"self": {k: v[i] for k, v in pools["self"].items()}}


def _block_ffn(cfg, params, x, ffn: str, flags: RunFlags,
               env: AxisEnv = LOCAL):
    """The FFN sublayer of a serving step (x replicated over tp, the
    partial output summed over tp)."""
    h = L.apply_norm(cfg, params["norm2"], x, env)
    if ffn == "moe":
        partial, _ = moe_lib.moe_ffn(cfg, params["moe"], h,
                                     dispatch=flags.moe_dispatch, env=env)
    else:
        partial = L.apply_mlp(cfg, params["mlp"], h, env=env)
    return x + env.psum_tp(partial)


def block_decode_paged(cfg, params, x, pool, pos, table, active, *,
                       page_size: int, ffn: str,
                       flags: RunFlags = DEFAULT_FLAGS, valid=None,
                       env: AxisEnv = LOCAL):
    """One layer of the paged decode tick: x (B, d)."""
    h = L.apply_norm(cfg, params["norm1"], x, env)
    partial, _ = L.paged_decode_attention(
        cfg, params["attn"], h, pool["self"], pos, table, active,
        page_size=page_size, paged_attn=flags.paged_attn, valid=valid,
        env=env)
    return _block_ffn(cfg, params, x + env.psum_tp(partial), ffn, flags,
                      env), pool


def _paged_decode_logits(cfg: ModelConfig, params, pools, token, pos, table,
                         active, *, page_size: int,
                         flags: RunFlags = DEFAULT_FLAGS,
                         env: AxisEnv = LOCAL):
    """One token per slot -> (logits (B, V_loc) fp32, pools)."""
    env = sharding.denv(env)
    x = emb.embed_tokens(cfg, params["embed"], token, env)    # (B, d)
    ffn = _ffn_kind(cfg, cfg.n_layers - 1)
    valid = L.paged_valid_mask(table, pos[:, None], page_size=page_size,
                               env=env)
    for i in range(cfg.n_layers):
        x, _ = block_decode_paged(
            cfg, layer_params(params["blocks"], i), x, _layer_pool(pools, i),
            pos, table, active, page_size=page_size, ffn=ffn, flags=flags,
            valid=valid, env=env)
    x = L.apply_norm(cfg, params["final_norm"], x, env)
    return emb.serve_logits(cfg, params["embed"], x, env), pools


def _one(v, dtype, device) -> torch.Tensor:
    """A scalar knob (Python number or 0-d tensor) as a (1,) tensor on
    `device`; a number is filled there, not copied from the host."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1).to(device=device, dtype=dtype)
    return torch.full((1,), v, dtype=dtype, device=device)


def paged_decode_step(cfg: ModelConfig, params, pools, token, pos, table,
                      active, *, page_size: int,
                      flags: RunFlags = DEFAULT_FLAGS, sample=None,
                      env: AxisEnv = LOCAL):
    """One decode tick over the slot batch.  token (B,) input token per
    slot; pos (B,) position being written; table (B, n_lp); active (B,)
    bool.  Inactive slots compute harmlessly (their writes land in the
    scratch page).  `sample=None` is greedy; `sample=(seeds, temperature,
    top_p, top_k)`, all (B,), draws under the (seed, pos, STREAM_SAMPLE)
    keys, rows at temperature <= 0 bit for bit greedy.  Returns (next
    (B,) int32, pools)."""
    logits, pools = _paged_decode_logits(cfg, params, pools, token, pos,
                                         table, active, page_size=page_size,
                                         flags=flags, env=env)
    if sample is None:
        return emb.sharded_argmax(logits, env).to(torch.int32), pools
    seeds, temp, top_p, top_k = sample
    nxt, _ = emb.sharded_sample(cfg, logits, seeds=seeds, pos=pos,
                                temperature=temp, top_p=top_p, top_k=top_k,
                                stream=emb.STREAM_SAMPLE, env=env)
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
                        flags: RunFlags = DEFAULT_FLAGS, valid=None,
                        env: AxisEnv = LOCAL):
    """One layer of chunked prefill for a single request: x (C, d)."""
    h = L.apply_norm(cfg, params["norm1"], x, env)
    partial, _ = L.paged_prefill_attention(
        cfg, params["attn"], h, pool["self"], base, n_valid, table_row,
        page_size=page_size, paged_attn=flags.paged_attn, valid=valid,
        env=env)
    return _block_ffn(cfg, params, x + env.psum_tp(partial), ffn, flags,
                      env), pool


def _paged_prefill_logits(cfg: ModelConfig, params, pools, tokens, base,
                          n_valid, table_row, *, page_size: int,
                          flags: RunFlags = DEFAULT_FLAGS,
                          env: AxisEnv = LOCAL):
    """Prefill one chunk; returns (logits (1, V_loc) fp32 at the last
    valid chunk position, pools)."""
    env = sharding.denv(env)
    C = tokens.shape[0]
    x = emb.embed_tokens(cfg, params["embed"], tokens, env)   # (C, d)
    ffn = _ffn_kind(cfg, cfg.n_layers - 1)
    posq = base + torch.arange(C, device=tokens.device)
    valid = L.paged_valid_mask(table_row[None], posq[None],
                               page_size=page_size, env=env)
    for i in range(cfg.n_layers):
        x, _ = block_prefill_paged(
            cfg, layer_params(params["blocks"], i), x, _layer_pool(pools, i),
            base, n_valid, table_row, page_size=page_size, ffn=ffn,
            flags=flags, valid=valid, env=env)
    x = L.apply_norm(cfg, params["final_norm"], x, env)
    last = min(max(int(n_valid) - 1, 0), C - 1)
    return emb.serve_logits(cfg, params["embed"], x[last:last + 1],
                            env), pools


def paged_prefill_chunk(cfg: ModelConfig, params, pools, tokens, base,
                        n_valid, table_row, *, page_size: int,
                        flags: RunFlags = DEFAULT_FLAGS, sample=None,
                        env: AxisEnv = LOCAL):
    """Prefill one chunk of one request's prompt into its pages.  tokens
    (C,) (tail past n_valid is padding); base (int) tokens already
    written; table_row (n_lp,).  Returns (next token, a 0-d int32 tensor
    meaningful on the request's final chunk, and the pools).  `sample=
    (seed, temperature, top_p, top_k)` scalars draw that token at
    position base + n_valid - 1 under the shared key schedule (bit for
    bit greedy at temperature <= 0)."""
    logits, pools = _paged_prefill_logits(cfg, params, pools, tokens, base,
                                          n_valid, table_row,
                                          page_size=page_size, flags=flags,
                                          env=env)
    if sample is None:
        return emb.sharded_argmax(logits, env)[0].to(torch.int32), pools
    seed, temp, top_p, top_k = sample
    dev = logits.device
    nxt, _ = emb.sharded_sample(
        cfg, logits, seeds=_one(seed, torch.int64, dev),
        pos=_one(base + n_valid - 1, torch.int64, dev),
        temperature=_one(temp, torch.float32, dev),
        top_p=_one(top_p, torch.float32, dev),
        top_k=_one(top_k, torch.int64, dev), stream=emb.STREAM_SAMPLE,
        env=env)
    return nxt[0], pools
