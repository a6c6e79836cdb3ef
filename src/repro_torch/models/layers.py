"""Core transformer layers (counterpart of `repro.models.layers`).

Every function sees the rank's *local* shards and takes the mesh's
`sharding.AxisEnv` as `env` (default `sharding.LOCAL`, one rank, where
every collective is an identity).  Weight layout as the reference's:
FSDP over dp on one dim (gathered at use), tensor parallel over tp on
another; query heads column-sharded over tp, K/V projections replicated
over tp (computed on every rank).  The paged KV pools shard the in-page
offset over tp (rank r owns offsets [r*ps_loc, (r+1)*ps_loc) of every
page) and a dense decode cache its positions (rank r owns
[r*s_loc, (r+1)*s_loc)): each rank attends its part with every query
head (`q_all`, gathered over tp), and the online-softmax (num, den)
partials combine over tp after a pmax of pass 1's row maxima.  Dtypes
follow JAX's promotion: bf16 operands of a matmul give bf16, bf16 times
fp32 gives fp32 (`apply_rope`), and products the reference takes with
`preferred_element_type=float32` upcast their operands to fp32 first.

Weights the reference casts to `compute_dtype` at use are stored in that
dtype for serving and in `param_dtype` (fp32 masters) for training
(`Init.masters`, interop.py / `init_model`); the `.to(cdt)` calls below
cast masters at use, as the reference's `gather_fsdp(..., dtype=cdt)`
does, and are no-ops on serving storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from repro_torch import sharding
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import ops as kops
from repro_torch.sharding import LOCAL, AxisEnv, P

Params = Dict[str, torch.Tensor]
GATED_ACTS = _gm.GATED_ACTS


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Init:
    """Random-parameter factory: normal(0, scale) leaves drawn from one
    explicit `torch.Generator` on `device`, each shape prefixed by `lead`
    (the stacked layer dim).  On the meta device it only allocates
    shapes.  `masters` picks the storage of the leaves the reference casts
    to the compute dtype at use: `param_dtype` (training's fp32 masters)
    or the compute dtype (serving).

    Each leaf has a spec (`sharding.P` over its dims after `lead`; whole
    when none is given) and `env` is the mesh it is cut for: a random
    leaf is drawn whole and the rank keeps its slice (`sharding.shard`),
    so every mesh gets shards of the same global parameters and the peak
    is the shards plus one leaf.  `specs` records each leaf it makes with
    its full spec (lead dims whole), for `spec_of`."""
    device: torch.device
    generator: Optional[torch.Generator] = None
    lead: Tuple[int, ...] = ()
    masters: bool = False
    env: AxisEnv = LOCAL
    specs: Dict[int, Tuple[torch.Tensor, P]] = dataclasses.field(
        default_factory=dict)

    def weight_dtype(self, cfg) -> torch.dtype:
        return dtype_of(cfg.param_dtype if self.masters
                        else cfg.compute_dtype)

    def _leaf(self, t: torch.Tensor, spec) -> torch.Tensor:
        spec = P(*(spec or ()))
        self.specs[id(t)] = (t, P(*((None,) * len(self.lead) + tuple(spec))))
        return t

    def spec_of(self, t: torch.Tensor) -> P:
        """The spec of a parameter leaf this factory made; whole (P()) for
        one computed from such a leaf (the rwkv and RG-LRU blocks' scaled
        constants, never sharded)."""
        made, spec = self.specs.get(id(t), (None, P()))
        return spec if made is t else P()

    def _local(self, shape, spec) -> Tuple[int, ...]:
        return self.lead + sharding.local_shape(spec or (), shape, self.env)

    def normal(self, shape, dtype, scale: float = 0.02,
               spec=None) -> torch.Tensor:
        if self.device.type == "meta":
            return self._leaf(torch.empty(self._local(shape, spec),
                                          dtype=dtype, device=self.device),
                              spec)
        t = torch.empty(self.lead + tuple(shape), dtype=dtype,
                        device=self.device)
        t.normal_(0.0, scale, generator=self.generator)
        part = sharding.shard(t, spec or (), self.env, lead=len(self.lead))
        if part is not t:
            part = part.clone()
            del t
        return self._leaf(part, spec)

    def ones(self, shape, dtype, spec=None) -> torch.Tensor:
        return self._leaf(torch.ones(self._local(shape, spec), dtype=dtype,
                                     device=self.device), spec)

    def zeros(self, shape, dtype, spec=None) -> torch.Tensor:
        return self._leaf(torch.zeros(self._local(shape, spec), dtype=dtype,
                                      device=self.device), spec)

    def const(self, values: torch.Tensor, dtype) -> torch.Tensor:
        """`values` (a CPU tensor) cast to dtype and repeated over `lead`
        (whole on every rank)."""
        t = torch.empty(self.lead + tuple(values.shape), dtype=dtype,
                        device=self.device)
        if self.device.type != "meta":
            t.copy_(values.to(dtype).expand_as(t))
        return self._leaf(t, None)


# ---------------------------------------------------------------------------
# norms, RoPE, MLP
# ---------------------------------------------------------------------------


def init_norm(cfg, init: Init) -> Params:
    """RMSNorm: a scale of ones; LayerNorm: also a bias of zeros."""
    if cfg.norm_type not in ("rmsnorm", "layernorm"):
        raise ValueError(f"norm_type={cfg.norm_type!r}")
    dt = dtype_of(cfg.param_dtype)
    spec = sharding.fsdp_spec(init.env, 1, 0)
    params = {"scale": init.ones((cfg.d_model,), dt, spec)}
    if cfg.norm_type == "layernorm":
        params["bias"] = init.zeros((cfg.d_model,), dt, spec)
    return params


def apply_norm(cfg, params: Params, x: torch.Tensor,
               env: AxisEnv = LOCAL) -> torch.Tensor:
    """The reference's RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5, the
    population variance, then scale and bias), in fp32, cast back to x's
    dtype.  The row statistics are taken in fp64 and each rounded once to
    fp32: a reduction's order follows the number of rows in the call, and
    in fp32 a row's statistics could then differ by an ulp between a
    prefill and a decode tick.  The scale (and bias) are gathered over
    dp under FSDP."""
    scale = env.gather_fsdp(params["scale"], 0).float()
    xf = x.float()
    xd = xf.double()
    if cfg.norm_type == "layernorm":
        mu = torch.mean(xd, dim=-1, keepdim=True)
        var = torch.mean((xd - mu).square(), dim=-1, keepdim=True)
        out = ((xf - mu.float()) * torch.rsqrt(var + 1e-5).float() * scale
               + env.gather_fsdp(params["bias"], 0).float())
    else:
        ms = torch.mean(xd.square(), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6).float() * scale
    return out.to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin of shape (..., head_dim/2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # torch.full, not torch.tensor: a 0-d fill on the device, no copy
    # from the host (which would wait for the device)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads.
    bf16 x times fp32 cos/sin computes in fp32, then casts back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    return _gm.apply_act(name, x)


def init_mlp(cfg, init: Init, d_ff: Optional[int] = None,
             scale_out: float = 0.02) -> Params:
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    wdt = init.weight_dtype(cfg)
    col = sharding.fsdp_spec(init.env, 2, 0, 1)       # ff over tp
    row = sharding.fsdp_spec(init.env, 2, 1, 0)
    params = {"w1": init.normal((d, ff), wdt, spec=col),
              "w2": init.normal((ff, d), wdt, scale_out, spec=row)}
    if cfg.mlp_act in GATED_ACTS:
        params["w3"] = init.normal((d, ff), wdt, spec=col)
    return params


def apply_mlp(cfg, params: Params, x: torch.Tensor,
              act: Optional[str] = None,
              env: AxisEnv = LOCAL) -> torch.Tensor:
    """x (T, d) -> (T, d), in compute dtype: the rank's ff slice, a
    partial sum the caller combines over tp."""
    act = act or cfg.mlp_act
    cdt = dtype_of(cfg.compute_dtype)
    h = x @ env.gather_fsdp(params["w1"], 0, dtype=cdt)
    if act in GATED_ACTS:
        h = _act(act, h) * (x @ env.gather_fsdp(params["w3"], 0, dtype=cdt))
    else:
        h = _act(act, h)
    return h @ env.gather_fsdp(params["w2"], 1, dtype=cdt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int          # logical query heads
    n_kv: int             # kv heads (replicated over tp)
    heads_padded: int     # padded to a multiple of tp
    local_heads: int      # this rank's: heads_padded / tp
    head_dim: int

    @classmethod
    def build(cls, cfg, env: AxisEnv = LOCAL) -> "AttnDims":
        if cfg.n_heads % cfg.n_kv_heads:
            raise NotImplementedError(
                f"{cfg.n_heads} query heads over {cfg.n_kv_heads} kv heads: "
                f"uneven GQA grouping is not yet ported")
        hp = sharding.pad_to_multiple(cfg.n_heads, env.tp)
        if hp != cfg.n_heads:
            raise NotImplementedError(
                f"{cfg.n_heads} query heads over tp={env.tp}: padded heads "
                f"are not yet ported (ROADMAP item 9)")
        return cls(cfg.n_heads, cfg.n_kv_heads, hp, hp // env.tp,
                   cfg.head_dim)


def init_attention(cfg, init: Init) -> Params:
    ad = AttnDims.build(cfg, init.env)
    d, hd = cfg.d_model, ad.head_dim
    wdt = init.weight_dtype(cfg)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    env = init.env
    return {
        "wq": init.normal((d, ad.heads_padded * hd), wdt,
                          spec=sharding.fsdp_spec(env, 2, 0, 1)),
        "wk": init.normal((d, ad.n_kv * hd), wdt,
                          spec=sharding.fsdp_spec(env, 2, 0, None)),
        "wv": init.normal((d, ad.n_kv * hd), wdt,
                          spec=sharding.fsdp_spec(env, 2, 0, None)),
        "wo": init.normal((ad.heads_padded * hd, d), wdt, out_scale,
                          spec=sharding.fsdp_spec(env, 2, 1, 0)),
    }


def _kv_index_for_local_heads(ad: AttnDims, env: AxisEnv,
                              device) -> torch.Tensor:
    """GQA: query head g reads kv head g // (H / KV); (local_heads,)
    indices of this rank's heads."""
    g = env.tp_index() * ad.local_heads + torch.arange(ad.local_heads,
                                                       device=device)
    return (g // max(ad.n_heads // ad.n_kv, 1)).clamp_max(ad.n_kv - 1)


def _attn_weights(params: Params, env: AxisEnv, cdt):
    """wq, wk, wv, wo gathered over dp (FSDP) in the compute dtype."""
    return (env.gather_fsdp(params["wq"], 0, dtype=cdt),
            env.gather_fsdp(params["wk"], 0, dtype=cdt),
            env.gather_fsdp(params["wv"], 0, dtype=cdt),
            env.gather_fsdp(params["wo"], 1, dtype=cdt))


def _local_heads(ad: AttnDims, env: AxisEnv, attn: torch.Tensor):
    """(..., Hp, hd) -> this rank's heads, (..., local_heads, hd)."""
    lo = env.tp_index() * ad.local_heads
    return attn[..., lo:lo + ad.local_heads, :]


# ---------------------------------------------------------------------------
# Training attention
# ---------------------------------------------------------------------------


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k, v (B, Sk, H, hd), kv already expanded to H
    heads -> (B, Sq, H, hd) in q's dtype.  Key k is visible to query q
    where k <= q (`causal`) and, with `window`, k > q - window (the
    reference's `_pair_mask`; the window goes in as an explicit boolean
    mask).  The reference's `attention_core` is a blockwise flash
    attention in pure JAX (not a Pallas kernel) with fp32 scores, fp32
    probabilities and an fp32 PV product; here the same math is
    PyTorch's `scaled_dot_product_attention` on fp32 upcasts of the
    operands, so the two differ by fp32 summation order.  It runs on
    SDPA's math backend: the backend PyTorch picks for fp32 on a card
    (memory-efficient attention) sums dq by atomics in no fixed order, so
    two runs of a step would differ and no resume could be exact."""
    mask = None
    if window is not None:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = kpos > qpos - window
        if causal:
            mask = mask & (kpos <= qpos)
    with sdpa_kernel(SDPBackend.MATH):
        out = F.scaled_dot_product_attention(
            q.float().transpose(1, 2), k.float().transpose(1, 2),
            v.float().transpose(1, 2), attn_mask=mask,
            is_causal=causal and mask is None)
    return out.transpose(1, 2).to(q.dtype)


def apply_attention(cfg, params: Params, x: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    kv_source: Optional[torch.Tensor] = None,
                    use_rope: Optional[bool] = None,
                    return_cache: bool = False, env: AxisEnv = LOCAL):
    """Training and prefill attention: x (B, S, d) -> (B, S, d) in the
    compute dtype, the rank's heads' partial sum (the caller combines
    over tp).  QKV projections (keys and values from `kv_source`
    (B, Skv, d) where given: cross attention), RoPE at positions 0..S-1
    and 0..Skv-1 (`use_rope`, default `cfg.use_rope`), GQA attention
    (query head h reads kv head h // (H / KV)) under `causal` and
    `window` (`attention_core`), output projection.  With `return_cache`
    (prefill) it returns (out, {"k", "v"}): the keys after RoPE and the
    values of every kv head and position, (B, Skv, KV, hd) in the compute
    dtype, the dense decode cache's layout."""
    ad = AttnDims.build(cfg, env)
    cdt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    kv_in = x if kv_source is None else kv_source
    Skv = kv_in.shape[1]
    hd = ad.head_dim
    wq, wk, wv, wo = _attn_weights(params, env, cdt)
    q = (x @ wq).reshape(B, S, ad.local_heads, hd)
    k = (kv_in @ wk).reshape(B, Skv, ad.n_kv, hd)
    v = (kv_in @ wv).reshape(B, Skv, ad.n_kv, hd)
    if cfg.use_rope if use_rope is None else use_rope:
        cos, sin = rope_angles(torch.arange(S, device=x.device), hd,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        if Skv != S:
            cos, sin = rope_angles(torch.arange(Skv, device=x.device), hd,
                                   cfg.rope_theta)
        k = apply_rope(k, cos, sin)
    kv_idx = _kv_index_for_local_heads(ad, env, x.device)
    out = attention_core(q, k[:, :, kv_idx], v[:, :, kv_idx], causal=causal,
                         window=window)
    out = out.reshape(B, S, ad.local_heads * hd) @ wo
    if return_cache:
        return out, {"k": k, "v": v}
    return out


# ---------------------------------------------------------------------------
# Paged KV attention (online serving)
# ---------------------------------------------------------------------------
#
# Pool k/v are (n_pages, ps_loc, KV, hd); a per-slot page table maps
# logical page -> physical page, and physical page 0 is the scratch page
# that masked lanes write to.  The in-page offset is sharded over tp:
# ps_loc = page_size / tp, rank r holding offsets [r*ps_loc,
# (r+1)*ps_loc) of every page (at tp=1 the whole page).


def init_paged_kv_pool(cfg, n_pages: int, page_size: int, device,
                       env: AxisEnv = LOCAL) -> Dict[str, torch.Tensor]:
    """This rank's paged KV pool for one attention layer (zeros):
    (n_pages, page_size / tp, KV, hd)."""
    cdt = dtype_of(cfg.compute_dtype)
    ps_loc = sharding.divide(page_size, env.tp, "page_size over tp")
    shape = (n_pages, ps_loc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def paged_valid_mask(table: torch.Tensor, pos: torch.Tensor, *,
                     page_size: int, env: AxisEnv = LOCAL) -> torch.Tensor:
    """(B, Q, S_g) validity mask over the rank's pool rows, S_g = n_lp *
    ps_loc: row j of logical page i sits at position i*page_size +
    r*ps_loc + j on rank r and is attendable iff the page is allocated
    and the position is <= the query's.  Identical across layers, so the
    model computes it once per step."""
    n_lp = table.shape[-1]
    ps_loc = page_size // env.tp
    j = torch.arange(n_lp * ps_loc, device=table.device)
    gpos = (j // ps_loc) * page_size + env.tp_index() * ps_loc + j % ps_loc
    pvalid = torch.repeat_interleave(table > 0, ps_loc, dim=-1)
    return pvalid[:, None, :] & (gpos[None, None, :] <= pos[:, :, None])


def _paged_write(pool, k_new, v_new, pos, page_table, owns, *,
                 page_size: int, cdt, env: AxisEnv = LOCAL):
    """Write per-lane KV rows into their pages, IN PLACE.

    The reference returns a new pool and relies on buffer donation; the
    port updates `pool` in place instead (`index_put_`), which is what
    donation buys.  Lanes that do not own a row (inactive, unallocated,
    or an in-page offset of another tp rank) write to scratch page 0.
    Returns `pool`."""
    ps_loc = pool["k"].shape[1]
    dest = torch.where(owns, page_table, 0).long()
    o = (pos % page_size - env.tp_index() * ps_loc).clamp(0, ps_loc - 1)
    o = o.long()
    pool["k"][dest, o] = k_new.to(cdt)
    pool["v"][dest, o] = v_new.to(cdt)
    return pool


def _owns_offset(pos, page_size: int, ps_loc: int, env: AxisEnv):
    """Lanes whose position's in-page offset lives on this rank."""
    if env.tp == 1:
        return True
    return (pos % page_size) // ps_loc == env.tp_index()


def _paged_scores_combine(cfg, ad: AttnDims, q_all, k_g, v_g, valid, cdt,
                          env: AxisEnv = LOCAL):
    """The gathered path: q_all (B, Q, Hp, hd) against one shared cache
    view k_g/v_g (B, S, KV, hd) under valid (B, Q, S).  Scores and the PV
    product are fp32 contractions of the compute-dtype operands; the row
    max is taken over tp, p is rounded to cdt before the PV product, and
    (num, den) are summed over tp.  Returns (B, Q, Hp, hd)."""
    hd = ad.head_dim
    B, Qn, S_g = valid.shape
    g = ad.heads_padded // ad.n_kv
    q_g = q_all.reshape(B, Qn, ad.n_kv, g, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", q_g.float(), k_g.float()) \
        * hd ** -0.5
    s = s.reshape(B, Qn, ad.heads_padded, S_g)
    s = torch.where(valid[:, :, None, :], s, float("-inf"))
    m = env.pmax_tp(s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid[:, :, None, :], torch.exp(s - m_safe[..., None]),
                    0.0)
    p_g = p.to(cdt).reshape(B, Qn, ad.n_kv, g, S_g)
    num = torch.einsum("bqkgs,bskd->bqkgd", p_g.float(), v_g.float())
    num = num.reshape(B, Qn, ad.heads_padded, hd)
    den = p.sum(dim=-1)
    num, den = env.psum_tp((num, den))
    return (num / den.clamp_min(1e-20)[..., None]).to(cdt)


def resolve_paged_attn(mode: str) -> str:
    """RunFlags.paged_attn -> concrete mode.  "auto" is "fused": the K3/K4
    wrappers launch the CUDA kernels on CUDA tensors and take their plain
    versions on CPU tensors."""
    if mode == "auto":
        return "fused"
    if mode not in ("fused", "gathered"):
        raise ValueError(f"paged_attn must be auto|fused|gathered: {mode}")
    return mode


def _paged_attention_core(cfg, ad: AttnDims, q_all, pool, table, valid,
                          cdt, *, paged_attn: str, env: AxisEnv = LOCAL):
    """Query-batched paged-attention core (decode Q=1, prefill Q=C) over
    the rank's pool rows.

    "fused": pass 1 (K3) -> max over tp -> safe max -> pass 2 (K4) ->
    (num, den) summed over tp -> normalize, the page table walked inside
    the kernels.  "gathered": `ops.paged_gather` materializes the view
    and `_paged_scores_combine` finishes.  Returns (B, Q, Hp, hd)."""
    hd = ad.head_dim
    B = q_all.shape[0]
    if resolve_paged_attn(paged_attn) == "fused":
        m = kops.paged_attention_scores_max(q_all, pool["k"], table, valid)
        m = env.pmax_tp(m)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        num, den = kops.paged_attention_accumulate(
            q_all, pool["k"], pool["v"], table, valid, m_safe)
        num, den = env.psum_tp((num, den))
        return (num / den.clamp_min(1e-20)[..., None]).to(cdt)
    S_g = valid.shape[-1]
    k_g = kops.paged_gather(pool["k"], table).reshape(B, S_g, ad.n_kv, hd)
    v_g = kops.paged_gather(pool["v"], table).reshape(B, S_g, ad.n_kv, hd)
    return _paged_scores_combine(cfg, ad, q_all, k_g, v_g, valid, cdt, env)


def _qkv(cfg, ad: AttnDims, params: Params, x, pos, cdt,
         env: AxisEnv = LOCAL):
    """Projections + RoPE: x (N, d), pos (N,) -> q_all (N, Hp, hd) (the
    rank's heads gathered over tp), k/v (N, KV, hd), and wo (FSDP
    gathered)."""
    N = x.shape[0]
    hd = ad.head_dim
    wq, wk, wv, wo = _attn_weights(params, env, cdt)
    q = (x @ wq).reshape(N, ad.local_heads, hd)
    k = (x @ wk).reshape(N, ad.n_kv, hd)
    v = (x @ wv).reshape(N, ad.n_kv, hd)
    if cfg.use_rope:
        cos, sin = rope_angles(pos, hd, cfg.rope_theta)      # (N, hd/2)
        q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    return env.all_gather_tp(q, axis=1), k, v, wo


def _out_proj(ad: AttnDims, env: AxisEnv, attn, wo):
    """attn (N, Hp, hd) -> the rank's heads through wo: (N, d), a partial
    sum over tp."""
    local = _local_heads(ad, env, attn)
    return local.reshape(attn.shape[0], ad.local_heads * ad.head_dim) @ wo


def paged_decode_attention(cfg, params: Params, x: torch.Tensor,
                           pool: Dict[str, torch.Tensor], pos: torch.Tensor,
                           table: torch.Tensor, active: torch.Tensor, *,
                           page_size: int, paged_attn: str = "auto",
                           valid: Optional[torch.Tensor] = None,
                           env: AxisEnv = LOCAL):
    """Single-token decode against a paged KV pool.  x (B, d) replicated
    over tp; pos (B,) position written per slot; table (B, n_lp); active
    (B,) bool.  Writes the new token's KV into its page (in place; on the
    rank owning its in-page offset), then attends.  Returns (out (B, d),
    a partial sum over tp, and pool)."""
    ad = AttnDims.build(cfg, env)
    cdt = dtype_of(cfg.compute_dtype)
    n_lp = table.shape[1]
    ps_loc = pool["k"].shape[1]
    q, k_new, v_new, wo = _qkv(cfg, ad, params, x, pos, cdt, env)

    lp = (pos // page_size).clamp(0, n_lp - 1)
    pp = torch.gather(table, 1, lp[:, None].long())[:, 0]
    owns = active & (pp > 0) & _owns_offset(pos, page_size, ps_loc, env)
    _paged_write(pool, k_new, v_new, pos, pp, owns, page_size=page_size,
                 cdt=cdt, env=env)

    if valid is None:
        valid = paged_valid_mask(table, pos[:, None], page_size=page_size,
                                 env=env)
    attn = _paged_attention_core(cfg, ad, q[:, None], pool, table, valid,
                                 cdt, paged_attn=paged_attn, env=env)[:, 0]
    return _out_proj(ad, env, attn, wo), pool


def paged_prefill_attention(cfg, params: Params, x: torch.Tensor,
                            pool: Dict[str, torch.Tensor], base, n_valid,
                            table_row: torch.Tensor, *, page_size: int,
                            paged_attn: str = "auto",
                            valid: Optional[torch.Tensor] = None,
                            env: AxisEnv = LOCAL):
    """One chunked-prefill attention step for a single request.  x (C, d)
    replicated over tp; base tokens already written; n_valid real tokens
    in the chunk; table_row (n_lp,).  Writes the chunk's KV (in place),
    then every chunk query attends causally over the request's pages as
    one query batch.  Returns (out (C, d), a partial sum over tp, and
    pool)."""
    ad = AttnDims.build(cfg, env)
    cdt = dtype_of(cfg.compute_dtype)
    C = x.shape[0]
    n_lp = table_row.shape[0]
    ps_loc = pool["k"].shape[1]
    ar = torch.arange(C, device=x.device)
    posq = base + ar
    q, k_new, v_new, wo = _qkv(cfg, ad, params, x, posq, cdt, env)

    lp = (posq // page_size).clamp(0, n_lp - 1)
    pp = table_row[lp]
    owns = ((ar < n_valid) & (pp > 0)
            & _owns_offset(posq, page_size, ps_loc, env))
    _paged_write(pool, k_new, v_new, posq, pp, owns, page_size=page_size,
                 cdt=cdt, env=env)

    if valid is None:
        valid = paged_valid_mask(table_row[None], posq[None],
                                 page_size=page_size, env=env)
    attn = _paged_attention_core(cfg, ad, q[None], pool, table_row[None],
                                 valid, cdt, paged_attn=paged_attn,
                                 env=env)[0]
    return _out_proj(ad, env, attn, wo), pool


def paged_verify_attention(cfg, params: Params, x: torch.Tensor,
                           pool: Dict[str, torch.Tensor], pos: torch.Tensor,
                           table: torch.Tensor, active: torch.Tensor, *,
                           page_size: int, paged_attn: str = "auto",
                           valid: Optional[torch.Tensor] = None):
    """Speculative-decode verify: Q consecutive tokens per slot in one
    prefill-shaped pass over the slot batch.  x (B, Q, d), slot b's
    candidates at positions pos[b, 0..Q-1]; table (B, n_lp); active (B,).
    Writes all B*Q candidate KV rows (in place; lanes that own none go to
    scratch page 0), then each query attends causally over its slot's
    pages through `_paged_attention_core` (K3/K4 at Q rows a slot), so
    the verify logits at a position are the decode logits there.
    Returns (out (B*Q, d), pool)."""
    ad = AttnDims.build(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    B, Q, d = x.shape
    hd = ad.head_dim
    n_lp = table.shape[1]
    q, k_new, v_new, wo = _qkv(cfg, ad, params, x.reshape(B * Q, d),
                               pos.reshape(B * Q), cdt)

    lp = (pos // page_size).clamp(0, n_lp - 1)               # (B, Q)
    pp = torch.gather(table, 1, lp.long())
    owns = active[:, None] & (pp > 0)
    _paged_write(pool, k_new.reshape(B, Q, ad.n_kv, hd),
                 v_new.reshape(B, Q, ad.n_kv, hd), pos, pp, owns,
                 page_size=page_size, cdt=cdt)

    if valid is None:
        valid = paged_valid_mask(table, pos, page_size=page_size)
    attn = _paged_attention_core(cfg, ad, q.reshape(B, Q, ad.heads_padded, hd),
                                 pool, table, valid, cdt,
                                 paged_attn=paged_attn)
    out = attn.reshape(B * Q, ad.local_heads * hd) @ wo
    return out, pool


# ---------------------------------------------------------------------------
# Dense KV-cache decode (offline serving, generation-based evaluation)
# ---------------------------------------------------------------------------
#
# A layer's cache is (B, S, KV, hd) in the compute dtype, as the
# reference's `init_decode_cache` lays it out at tp=1; over tp each rank
# holds s_loc = S / tp positions, rank r positions [r*s_loc,
# (r+1)*s_loc) (the cache's S below is then the rank's s_loc, its
# positions offset by r*s_loc).  Three kinds:
#   * "attn": S = seq_len, row s holding the key (after RoPE) and value
#     of position s; a tick writes row pos where pos < S and attends the
#     rows kpos <= pos (all of them once pos >= S: the reference's
#     overflow branch).
#   * "swa" (sliding window): a rolling cache of S = min(window, seq_len)
#     rows; a tick writes slot pos % S and attends the slots kpos <
#     min(pos + 1, S), the ones written so far, which is the "attn" rule.
#   * cross attention (whisper's decoder): S = the encoder's length, keys
#     and values of the encoder output, never written by a tick; every
#     row is attended.
# A tick attends through the paged path's core over a page view of the
# cache: the cache read as (B*S16/ps, ps, KV, hd) pages, slot b's logical
# page i being physical page b*S16/ps + i, with S16 = S rounded up to the
# page, and the mask above (and kpos < S).  So that the view exists for
# any S, the cache tensors are views of storage that holds S16 rows a
# sequence (`init_decode_cache`, `expand_cache_from_prefill`): their
# shape is the reference's, and the S16 - S padding rows past each
# sequence's end stay zero and are never attended.  At a multiple of 16
# (S16 = S) the tensors are contiguous and the view is a plain reshape.
# The reference computes the same function with the paged path's gathered
# combine (`_decode_scores_combine`), so that dense and paged decode agree
# by construction; here "fused" (the default) runs K3 and K4 over the
# view, so a dense tick and an online tick at the same context capacity
# (max_context == S) do the same arithmetic on the card.  K3/K4 read
# validity from the mask alone: the view's page 0 holds real rows and is
# no scratch page.

DENSE_PAGE = 16     # the view's page size (K3/K4 take pages of <= 32)


def dense_rows(seq_len: int) -> int:
    """Rows a sequence's dense cache storage holds: seq_len rounded up to
    the view's page (DENSE_PAGE)."""
    if seq_len < 1:
        raise ValueError(f"a dense decode cache needs seq_len >= 1, got "
                         f"{seq_len}")
    return -(-seq_len // DENSE_PAGE) * DENSE_PAGE


def cache_len(seq_len: int, window: Optional[int] = None) -> int:
    """Positions a dense cache holds: seq_len, or min(window, seq_len) for
    a sliding window's rolling cache."""
    return min(window, seq_len) if window else seq_len


def init_decode_cache(cfg, batch: int, seq_len: int, device,
                      window: Optional[int] = None,
                      lead: Tuple[int, ...] = (),
                      env: AxisEnv = LOCAL) -> Dict[str, torch.Tensor]:
    """Zeroed dense KV cache for attention layers: k and v of shape (*lead,
    batch, S / tp, KV, hd) in the compute dtype (`lead` the stacked layer
    dim; S = `cache_len(seq_len, window)`, the rank's share of its
    positions), each a view of zeroed storage of `dense_rows(S / tp)`
    rows a sequence, the rows the tick's page view reads."""
    S = sharding.divide(cache_len(seq_len, window), env.tp,
                        "decode cache positions over tp")
    rows = dense_rows(S)
    cdt = dtype_of(cfg.compute_dtype)
    shape = tuple(lead) + (batch, rows, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cdt, device=device)
            [..., :S, :, :] for name in ("k", "v")}


def expand_cache_from_prefill(prefill_cache, seq_len: Optional[int] = None,
                              window: Optional[int] = None,
                              env: AxisEnv = LOCAL):
    """Prefill emits (..., B, S_prompt, KV, hd) caches of every position
    (replicated over tp).  They are laid out as `init_decode_cache` lays a
    cache of `cache_len(seq_len or S_prompt, window)` positions: the
    prompt's rows, then zero rows (views of `dense_rows` rows a
    sequence), which the decode mask never reads before they are written;
    over tp the rank keeps its positions [r*s_loc, (r+1)*s_loc).  A
    prompt longer than that raises: past a window the rolling cache would
    have to drop rows the reference's prefill cannot leave out."""
    if isinstance(prefill_cache, dict):
        return {k: expand_cache_from_prefill(v, seq_len, window, env)
                for k, v in prefill_cache.items()}
    s = prefill_cache.shape[-3]
    if window and s > window:
        raise ValueError(f"prompt of {s} positions exceeds the sliding "
                         f"window of {window}: its rolling decode cache "
                         f"cannot take the prefill's rows")
    S = cache_len(s if seq_len is None else seq_len, window)
    if s > S:
        raise ValueError(f"prompt of {s} positions exceeds the cache's "
                         f"seq_len={seq_len}")
    if env.tp > 1:
        s_loc = sharding.divide(S, env.tp, "decode cache positions over tp")
        lo = env.tp_index() * s_loc
        mine = prefill_cache[..., lo:min(lo + s_loc, s), :, :]
        return F.pad(mine, (0, 0, 0, 0, 0, dense_rows(s_loc)
                            - mine.shape[-3]))[..., :s_loc, :, :]
    if s == S and S == dense_rows(S):
        return prefill_cache
    return F.pad(prefill_cache, (0, 0, 0, 0, 0, dense_rows(S) - s)) \
        [..., :S, :, :]


def dense_page_view(batch: int, seq_len: int, pos: int, device,
                    offset: int = 0):
    """The page view of a (batch, seq_len) dense cache for a tick writing
    position `pos` (shared by every sequence):
    (table (batch, S16/16) int32, valid (batch, 1, S16) bool) with S16 =
    `dense_rows(seq_len)`.  Row j holds position offset + j (a rank's
    share of a cache sharded over tp).  valid is kpos <= pos and j <
    seq_len, so once pos is past the cache every cached position is
    valid (the reference's overflow branch; a rolling window cache; a
    cross cache, viewed at its last position) and the padding rows never
    are.  Identical across the layers of one cache length: the model
    builds it once per tick."""
    rows = dense_rows(seq_len)
    n_lp = rows // DENSE_PAGE
    table = torch.arange(batch * n_lp, dtype=torch.int32,
                         device=device).reshape(batch, n_lp)
    j = torch.arange(rows, device=device)
    valid = ((j + offset <= pos) & (j < seq_len))[None, None, :] \
        .expand(batch, 1, rows)
    return table, valid.contiguous()


def dense_pages(t: torch.Tensor) -> torch.Tensor:
    """A layer's dense cache tensor (B, S, KV, hd) as the page pool of its
    view, (B*S16/16, 16, KV, hd) over the storage's S16 rows a sequence.
    Raises on a tensor whose storage does not hold them (a copy of the
    cache's S rows: only `init_decode_cache` and the prefill lay them
    out)."""
    B, S, KV, hd = t.shape
    row, rows = KV * hd, dense_rows(S)
    need = (t.storage_offset() + B * rows * row) * t.element_size()
    if (t.stride()[1:] != (row, hd, 1)
            or (B > 1 and t.stride(0) != rows * row)
            or t.untyped_storage().nbytes() < need):
        raise ValueError(f"a dense cache of {S} positions is read through "
                         f"storage of {rows} rows a sequence "
                         f"(init_decode_cache, the prefill); got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    return t.as_strided((B * rows // DENSE_PAGE, DENSE_PAGE, KV, hd),
                        (DENSE_PAGE * row, row, hd, 1))


def decode_attention(cfg, params: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: int, *,
                     window: Optional[int] = None, cross: bool = False,
                     paged_attn: str = "auto", view=None,
                     env: AxisEnv = LOCAL):
    """Single-token decode against a dense cache.  x (B, d) replicated
    over tp; cache k/v (B, S, KV, hd), the rank's S positions (S * tp in
    all), updated in place; pos the position every sequence writes.
    Self attention: projections and RoPE as the paged steps (`_qkv`), the
    new row written at slot pos where pos < S * tp ("attn") or at pos %
    (S * tp) (`window`: the rolling cache), by the rank that holds the
    slot.  `cross`: the query alone, no RoPE and no write.  Then every
    query head attends the rank's positions through the cache's page
    view (`dense_page_view`, or `view` built once per tick) and
    `_paged_attention_core`.  Returns (out (B, d), a partial sum over tp,
    and cache)."""
    ad = AttnDims.build(cfg, env)
    cdt = dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    S = cache["k"].shape[1]
    lo = env.tp_index() * S
    if cross:
        wq, _, _, wo = _attn_weights(params, env, cdt)
        q = env.all_gather_tp((x @ wq).reshape(B, ad.local_heads,
                                               ad.head_dim), axis=1)
    else:
        pos_b = torch.full((B,), pos, dtype=torch.long, device=x.device)
        q, k_new, v_new, wo = _qkv(cfg, ad, params, x, pos_b, cdt, env)
        slot = pos % (S * env.tp) if window else pos
        if lo <= slot < lo + S:  # past the end nothing is written
            cache["k"][:, slot - lo] = k_new.to(cdt)
            cache["v"][:, slot - lo] = v_new.to(cdt)
    if view is None:
        view = dense_page_view(B, S, S * env.tp - 1 if cross else pos,
                               x.device, offset=lo)
    table, valid = view
    pool = {name: dense_pages(cache[name]) for name in ("k", "v")}
    attn = _paged_attention_core(cfg, ad, q[:, None], pool, table, valid,
                                 cdt, paged_attn=paged_attn, env=env)[:, 0]
    return _out_proj(ad, env, attn, wo), cache
