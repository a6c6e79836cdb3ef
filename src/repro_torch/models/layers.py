"""Core transformer layers at tp=1 (counterpart of `repro.models.layers`).

The reference runs inside shard_map with an `AxisEnv`; at tp=1 every
collective is an identity, so the port drops the env argument and keeps
the math.  Dtypes follow JAX's promotion: bf16 operands of a matmul give
bf16, bf16 times fp32 gives fp32 (`apply_rope`), and products the
reference takes with `preferred_element_type=float32` upcast their
operands to fp32 first.

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

from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import ops as kops

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
    or the compute dtype (serving)."""
    device: torch.device
    generator: Optional[torch.Generator] = None
    lead: Tuple[int, ...] = ()
    masters: bool = False

    def weight_dtype(self, cfg) -> torch.dtype:
        return dtype_of(cfg.param_dtype if self.masters
                        else cfg.compute_dtype)

    def normal(self, shape, dtype, scale: float = 0.02) -> torch.Tensor:
        t = torch.empty(self.lead + tuple(shape), dtype=dtype,
                        device=self.device)
        if self.device.type != "meta":
            t.normal_(0.0, scale, generator=self.generator)
        return t

    def ones(self, shape, dtype) -> torch.Tensor:
        return torch.ones(self.lead + tuple(shape), dtype=dtype,
                          device=self.device)


# ---------------------------------------------------------------------------
# norms, RoPE, MLP
# ---------------------------------------------------------------------------


def init_norm(cfg, init: Init) -> Params:
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(
            f"norm_type={cfg.norm_type!r} is not yet ported")
    return {"scale": init.ones((cfg.d_model,), dtype_of(cfg.param_dtype))}


def apply_norm(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    scale = params["scale"].float()
    xf = x.float()
    # the mean square in fp64, its inverse root rounded once to fp32: the
    # reduction's order follows the number of rows in the call, and in
    # fp32 a row's scale could then differ by an ulp between a prefill
    # and a decode tick
    ms = torch.mean(xf.double().square(), dim=-1, keepdim=True)
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
    params = {"w1": init.normal((d, ff), wdt),
              "w2": init.normal((ff, d), wdt, scale_out)}
    if cfg.mlp_act in GATED_ACTS:
        params["w3"] = init.normal((d, ff), wdt)
    return params


def apply_mlp(cfg, params: Params, x: torch.Tensor,
              act: Optional[str] = None) -> torch.Tensor:
    """x (T, d) -> (T, d), in compute dtype."""
    act = act or cfg.mlp_act
    cdt = dtype_of(cfg.compute_dtype)
    h = x @ params["w1"].to(cdt)
    if act in GATED_ACTS:
        h = _act(act, h) * (x @ params["w3"].to(cdt))
    else:
        h = _act(act, h)
    return h @ params["w2"].to(cdt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int          # logical query heads
    n_kv: int             # kv heads
    heads_padded: int     # == n_heads at tp=1
    local_heads: int      # == n_heads at tp=1
    head_dim: int

    @classmethod
    def build(cls, cfg) -> "AttnDims":
        if cfg.n_heads % cfg.n_kv_heads:
            raise NotImplementedError(
                f"{cfg.n_heads} query heads over {cfg.n_kv_heads} kv heads: "
                f"uneven GQA grouping is not yet ported")
        return cls(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads, cfg.n_heads,
                   cfg.head_dim)


def init_attention(cfg, init: Init) -> Params:
    ad = AttnDims.build(cfg)
    d, hd = cfg.d_model, ad.head_dim
    wdt = init.weight_dtype(cfg)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    return {
        "wq": init.normal((d, ad.heads_padded * hd), wdt),
        "wk": init.normal((d, ad.n_kv * hd), wdt),
        "wv": init.normal((d, ad.n_kv * hd), wdt),
        "wo": init.normal((ad.heads_padded * hd, d), wdt, out_scale),
    }


# ---------------------------------------------------------------------------
# Training attention
# ---------------------------------------------------------------------------


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True) -> torch.Tensor:
    """q, k, v (B, S, H, hd), kv already expanded to H heads -> (B, S, H,
    hd) in q's dtype.  The reference's `attention_core` is a blockwise
    flash attention in pure JAX (not a Pallas kernel) with fp32 scores,
    fp32 probabilities and an fp32 PV product; here the same math is
    PyTorch's `scaled_dot_product_attention` on fp32 upcasts of the
    operands, so the two differ by fp32 summation order.  It runs on
    SDPA's math backend: the backend PyTorch picks for fp32 on a card
    (memory-efficient attention) sums dq by atomics in no fixed order, so
    two runs of a step would differ and no resume could be exact."""
    with sdpa_kernel(SDPBackend.MATH):
        out = F.scaled_dot_product_attention(
            q.float().transpose(1, 2), k.float().transpose(1, 2),
            v.float().transpose(1, 2), is_causal=causal)
    return out.transpose(1, 2).to(q.dtype)


def apply_attention(cfg, params: Params, x: torch.Tensor, *,
                    causal: bool = True, return_cache: bool = False):
    """Training and prefill attention: x (B, S, d) -> (B, S, d) in the
    compute dtype.  QKV projections, RoPE at positions 0..S-1, causal GQA
    attention (query head h reads kv head h // (H / KV)), output
    projection.  With `return_cache` (prefill) it returns (out, {"k",
    "v"}): the keys after RoPE and the values, (B, S, KV, hd) in the
    compute dtype, the dense decode cache's layout."""
    ad = AttnDims.build(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    hd = ad.head_dim
    q = (x @ params["wq"].to(cdt)).reshape(B, S, ad.local_heads, hd)
    k = (x @ params["wk"].to(cdt)).reshape(B, S, ad.n_kv, hd)
    v = (x @ params["wv"].to(cdt)).reshape(B, S, ad.n_kv, hd)
    if cfg.use_rope:
        cos, sin = rope_angles(torch.arange(S, device=x.device), hd,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    kv_idx = torch.arange(ad.local_heads, device=x.device) \
        // max(ad.n_heads // ad.n_kv, 1)
    kv_idx = kv_idx.clamp_max(ad.n_kv - 1)
    out = attention_core(q, k[:, :, kv_idx], v[:, :, kv_idx], causal=causal)
    out = out.reshape(B, S, ad.local_heads * hd) @ params["wo"].to(cdt)
    if return_cache:
        return out, {"k": k, "v": v}
    return out


# ---------------------------------------------------------------------------
# Paged KV attention (online serving)
# ---------------------------------------------------------------------------
#
# Pool k/v are (n_pages, page_size, KV, hd); a per-slot page table maps
# logical page -> physical page, and physical page 0 is the scratch page
# that masked lanes write to.  At tp=1 a page's rows all live on the one
# device (ps_loc == page_size).


def init_paged_kv_pool(cfg, n_pages: int, page_size: int,
                       device) -> Dict[str, torch.Tensor]:
    """Paged KV pool for one attention layer (zeros)."""
    cdt = dtype_of(cfg.compute_dtype)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def paged_valid_mask(table: torch.Tensor, pos: torch.Tensor, *,
                     page_size: int) -> torch.Tensor:
    """(B, Q, S_g) validity mask: pool row j of logical page i sits at
    position i*page_size + j and is attendable iff the page is allocated
    and the position is <= the query's.  Identical across layers, so the
    model computes it once per step."""
    n_lp = table.shape[-1]
    gpos = torch.arange(n_lp * page_size, device=table.device)
    pvalid = torch.repeat_interleave(table > 0, page_size, dim=-1)
    return pvalid[:, None, :] & (gpos[None, None, :] <= pos[:, :, None])


def _paged_write(pool, k_new, v_new, pos, page_table, owns, *,
                 page_size: int, cdt):
    """Write per-lane KV rows into their pages, IN PLACE.

    The reference returns a new pool and relies on buffer donation; the
    port updates `pool` in place instead (`index_put_`), which is what
    donation buys.  Lanes that do not own a row (inactive, unallocated)
    write to scratch page 0.  Returns `pool`."""
    dest = torch.where(owns, page_table, 0).long()
    o = (pos % page_size).long()
    pool["k"][dest, o] = k_new.to(cdt)
    pool["v"][dest, o] = v_new.to(cdt)
    return pool


def _paged_scores_combine(cfg, ad: AttnDims, q_all, k_g, v_g, valid, cdt):
    """The gathered path: q_all (B, Q, Hp, hd) against one shared cache
    view k_g/v_g (B, S, KV, hd) under valid (B, Q, S).  Scores and the PV
    product are fp32 contractions of the compute-dtype operands; p is
    rounded to cdt before the PV product.  Returns (B, Q, Hp, hd)."""
    hd = ad.head_dim
    B, Qn, S_g = valid.shape
    g = ad.heads_padded // ad.n_kv
    q_g = q_all.reshape(B, Qn, ad.n_kv, g, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", q_g.float(), k_g.float()) \
        * hd ** -0.5
    s = s.reshape(B, Qn, ad.heads_padded, S_g)
    s = torch.where(valid[:, :, None, :], s, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid[:, :, None, :], torch.exp(s - m_safe[..., None]),
                    0.0)
    p_g = p.to(cdt).reshape(B, Qn, ad.n_kv, g, S_g)
    num = torch.einsum("bqkgs,bskd->bqkgd", p_g.float(), v_g.float())
    num = num.reshape(B, Qn, ad.heads_padded, hd)
    den = p.sum(dim=-1)
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
                          cdt, *, paged_attn: str):
    """Query-batched paged-attention core (decode Q=1, prefill Q=C).

    "fused": pass 1 (K3) -> safe max -> pass 2 (K4) -> normalize, the
    page table walked inside the kernels.  "gathered": `ops.paged_gather`
    materializes the view and `_paged_scores_combine` finishes.  Returns
    (B, Q, Hp, hd)."""
    hd = ad.head_dim
    B = q_all.shape[0]
    if resolve_paged_attn(paged_attn) == "fused":
        m = kops.paged_attention_scores_max(q_all, pool["k"], table, valid)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        num, den = kops.paged_attention_accumulate(
            q_all, pool["k"], pool["v"], table, valid, m_safe)
        return (num / den.clamp_min(1e-20)[..., None]).to(cdt)
    S_g = valid.shape[-1]
    k_g = kops.paged_gather(pool["k"], table).reshape(B, S_g, ad.n_kv, hd)
    v_g = kops.paged_gather(pool["v"], table).reshape(B, S_g, ad.n_kv, hd)
    return _paged_scores_combine(cfg, ad, q_all, k_g, v_g, valid, cdt)


def _qkv(cfg, ad: AttnDims, params: Params, x, pos, cdt):
    """Projections + RoPE: x (N, d), pos (N,) -> q (N, Hp, hd), k/v
    (N, KV, hd)."""
    N = x.shape[0]
    hd = ad.head_dim
    q = (x @ params["wq"].to(cdt)).reshape(N, ad.local_heads, hd)
    k = (x @ params["wk"].to(cdt)).reshape(N, ad.n_kv, hd)
    v = (x @ params["wv"].to(cdt)).reshape(N, ad.n_kv, hd)
    if cfg.use_rope:
        cos, sin = rope_angles(pos, hd, cfg.rope_theta)      # (N, hd/2)
        q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    return q, k, v


def paged_decode_attention(cfg, params: Params, x: torch.Tensor,
                           pool: Dict[str, torch.Tensor], pos: torch.Tensor,
                           table: torch.Tensor, active: torch.Tensor, *,
                           page_size: int, paged_attn: str = "auto",
                           valid: Optional[torch.Tensor] = None):
    """Single-token decode against a paged KV pool.  x (B, d); pos (B,)
    position written per slot; table (B, n_lp); active (B,) bool.  Writes
    the new token's KV into its page (in place), then attends.  Returns
    (out (B, d), pool)."""
    ad = AttnDims.build(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    n_lp = table.shape[1]
    q, k_new, v_new = _qkv(cfg, ad, params, x, pos, cdt)

    lp = (pos // page_size).clamp(0, n_lp - 1)
    pp = torch.gather(table, 1, lp[:, None].long())[:, 0]
    owns = active & (pp > 0)
    _paged_write(pool, k_new, v_new, pos, pp, owns, page_size=page_size,
                 cdt=cdt)

    if valid is None:
        valid = paged_valid_mask(table, pos[:, None], page_size=page_size)
    attn = _paged_attention_core(cfg, ad, q[:, None], pool, table, valid,
                                 cdt, paged_attn=paged_attn)[:, 0]
    out = attn.reshape(B, ad.local_heads * ad.head_dim) @ params["wo"].to(cdt)
    return out, pool


def paged_prefill_attention(cfg, params: Params, x: torch.Tensor,
                            pool: Dict[str, torch.Tensor], base, n_valid,
                            table_row: torch.Tensor, *, page_size: int,
                            paged_attn: str = "auto",
                            valid: Optional[torch.Tensor] = None):
    """One chunked-prefill attention step for a single request.  x (C, d);
    base tokens already written; n_valid real tokens in the chunk;
    table_row (n_lp,).  Writes the chunk's KV (in place), then every
    chunk query attends causally over the request's pages as one query
    batch.  Returns (out (C, d), pool)."""
    ad = AttnDims.build(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    C = x.shape[0]
    n_lp = table_row.shape[0]
    ar = torch.arange(C, device=x.device)
    posq = base + ar
    q, k_new, v_new = _qkv(cfg, ad, params, x, posq, cdt)

    lp = (posq // page_size).clamp(0, n_lp - 1)
    pp = table_row[lp]
    owns = (ar < n_valid) & (pp > 0)
    _paged_write(pool, k_new, v_new, posq, pp, owns, page_size=page_size,
                 cdt=cdt)

    if valid is None:
        valid = paged_valid_mask(table_row[None], posq[None],
                                 page_size=page_size)
    attn = _paged_attention_core(cfg, ad, q[None], pool, table_row[None],
                                 valid, cdt, paged_attn=paged_attn)[0]
    out = attn.reshape(C, ad.local_heads * ad.head_dim) @ params["wo"].to(cdt)
    return out, pool


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
    q, k_new, v_new = _qkv(cfg, ad, params, x.reshape(B * Q, d),
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
    out = attn.reshape(B * Q, ad.local_heads * hd) @ params["wo"].to(cdt)
    return out, pool


# ---------------------------------------------------------------------------
# Dense KV-cache decode (offline serving, generation-based evaluation)
# ---------------------------------------------------------------------------
#
# A layer's cache is (B, S, KV, hd) in the compute dtype, row s holding the
# key (after RoPE) and value of position s, as the reference's
# `init_decode_cache` lays it out at tp=1.  A decode tick writes the new
# token's row and attends through the paged path's core over a page view
# of the cache: the cache read as (B*S16/ps, ps, KV, hd) pages, slot b's
# logical page i being physical page b*S16/ps + i, with S16 = S rounded up
# to the page, and the mask kpos <= pos and kpos < S.  So that the view
# exists for any S, the cache tensors are views of storage that holds S16
# rows a sequence (`init_decode_cache`, `expand_cache_from_prefill`): their
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

DENSE_UNPORTED = ("sliding-window and cross-attention decode caches are "
                  "not yet ported to repro_torch (ROADMAP queue 1 item 10)")


def dense_rows(seq_len: int) -> int:
    """Rows a sequence's dense cache storage holds: seq_len rounded up to
    the view's page (DENSE_PAGE)."""
    if seq_len < 1:
        raise ValueError(f"a dense decode cache needs seq_len >= 1, got "
                         f"{seq_len}")
    return -(-seq_len // DENSE_PAGE) * DENSE_PAGE


def init_decode_cache(cfg, batch: int, seq_len: int, device,
                      window: Optional[int] = None,
                      lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Zeroed dense KV cache for attention layers: k and v of shape (*lead,
    batch, seq_len, KV, hd) in the compute dtype (`lead` the stacked layer
    dim), each a view of zeroed storage of `dense_rows(seq_len)` rows a
    sequence, the rows the tick's page view reads."""
    if window:
        raise NotImplementedError(DENSE_UNPORTED)
    rows = dense_rows(seq_len)
    cdt = dtype_of(cfg.compute_dtype)
    shape = tuple(lead) + (batch, rows, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cdt, device=device)
            [..., :seq_len, :, :] for name in ("k", "v")}


def expand_cache_from_prefill(prefill_cache, seq_len: Optional[int] = None):
    """Prefill emits (..., B, S_prompt, KV, hd) caches already in decode
    layout; with `seq_len` the position axis (the third from the end) is
    padded with zero rows to seq_len (views of `dense_rows(seq_len)` rows
    a sequence, as `init_decode_cache` makes them), which the decode mask
    never reads before they are written."""
    if seq_len is None:
        return prefill_cache
    if isinstance(prefill_cache, dict):
        return {k: expand_cache_from_prefill(v, seq_len)
                for k, v in prefill_cache.items()}
    s = prefill_cache.shape[-3]
    if s > seq_len:
        raise ValueError(f"prompt of {s} positions exceeds the cache's "
                         f"seq_len={seq_len}")
    return F.pad(prefill_cache, (0, 0, 0, 0, 0, dense_rows(seq_len) - s)) \
        [..., :seq_len, :, :]


def dense_page_view(batch: int, seq_len: int, pos: int, device):
    """The page view of a (batch, seq_len) dense cache for a tick writing
    position `pos` (shared by every sequence):
    (table (batch, S16/16) int32, valid (batch, 1, S16) bool) with S16 =
    `dense_rows(seq_len)`.  valid is kpos <= pos and kpos < seq_len, so
    once pos >= seq_len every cached position is valid (the reference's
    overflow branch) and the padding rows never are.  Identical across
    layers: the model builds it once per tick."""
    rows = dense_rows(seq_len)
    n_lp = rows // DENSE_PAGE
    table = torch.arange(batch * n_lp, dtype=torch.int32,
                         device=device).reshape(batch, n_lp)
    kpos = torch.arange(rows, device=device)
    valid = ((kpos <= pos) & (kpos < seq_len))[None, None, :] \
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


def _dense_write(cache, k_new, v_new, pos: int, cdt):
    """Write row `pos` of every sequence's cache in place, only where
    pos < seq_len (the reference's `owns`; past the end nothing is
    written)."""
    if 0 <= pos < cache["k"].shape[1]:
        cache["k"][:, pos] = k_new.to(cdt)
        cache["v"][:, pos] = v_new.to(cdt)


def decode_attention(cfg, params: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: int, *,
                     window: Optional[int] = None, cross: bool = False,
                     paged_attn: str = "auto", view=None):
    """Single-token decode against a dense cache.  x (B, d); cache k/v (B,
    S, KV, hd), updated in place; pos the position every sequence writes.
    Projections and RoPE as the paged steps
    (`_qkv`), the new row written where pos < S, then attention over the
    cache's page view (`dense_page_view`, or `view` built once per tick)
    through `_paged_attention_core`.  Returns (out (B, d), cache)."""
    if window or cross:
        raise NotImplementedError(DENSE_UNPORTED)
    ad = AttnDims.build(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    S = cache["k"].shape[1]
    pos_b = torch.full((B,), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _qkv(cfg, ad, params, x, pos_b, cdt)
    _dense_write(cache, k_new, v_new, pos, cdt)
    table, valid = (view if view is not None
                    else dense_page_view(B, S, pos, x.device))
    pool = {name: dense_pages(cache[name]) for name in ("k", "v")}
    attn = _paged_attention_core(cfg, ad, q[:, None], pool, table, valid,
                                 cdt, paged_attn=paged_attn)[:, 0]
    out = attn.reshape(B, ad.local_heads * ad.head_dim) @ params["wo"].to(cdt)
    return out, cache
