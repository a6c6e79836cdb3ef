"""Public kernel entry points (counterpart of `repro.kernels.ops`).

Layout and grouping stay plain torch index ops on the tensor's device;
the kernel wrappers they call (grouped_matmul.py, paged_attn.py) take
the plain versions for CPU tensors and launch the CUDA kernels for CUDA
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import paged_attn as _pa


def _fused_layout(tok, gate, group_sizes, n_tokens: int, bm: int):
    """Index-only expert-aligned layout for the fused MoE FFN.

    tok (cap,) source token per expert-sorted slot; gate (cap,) router
    weight per slot (0 where masked); group_sizes (G,) rows per expert
    among the first sum(group_sizes) slots.  Returns (row_idx (n_m, bm)
    int32 token per padded row, clamped to [0, T); gates (n_m, bm) fp32,
    0 for padding; tile_group (n_m,) int32 expert per tile, G for
    all-padding tiles) — the reference's `_fused_layout`, op for op."""
    cap = tok.shape[0]
    G = group_sizes.shape[0]
    group_sizes = group_sizes.long()
    padded = ((group_sizes + bm - 1) // bm) * bm
    bounds = torch.cumsum(padded, 0)                     # aligned group ends
    out_starts = bounds - padded
    in_starts = torch.cumsum(group_sizes, 0) - group_sizes
    M_pad = cap + G * (bm - 1)
    M_pad = ((M_pad + bm - 1) // bm) * bm
    rows = torch.arange(M_pad, device=tok.device)
    gid = torch.searchsorted(bounds, rows, right=True)
    gid_c = gid.clamp(0, G - 1)
    off = rows - out_starts[gid_c]
    valid = (gid < G) & (off < group_sizes[gid_c])
    src = (in_starts[gid_c] + off).clamp(0, cap - 1)
    row_idx = torch.where(valid, tok[src].long(), 0)
    row_idx = row_idx.clamp(0, n_tokens - 1).to(torch.int32)
    gates = torch.where(valid, gate[src].float(), 0.0)
    tile_group = torch.where(valid[::bm], gid_c[::bm], G).to(torch.int32)
    return row_idx.reshape(-1, bm), gates.reshape(-1, bm), tile_group


def moe_fused_ffn(x, w1, w2, w3, tok, gate, group_sizes, *,
                  act: str = "swiglu", bm: int = 128):
    """Fused MoE FFN: gather -> w1/(w3) -> act -> w2 -> gate * out
    combine (K1).  x (T, d); w1/w3 (G, d, ff), w2 (G, ff, d) (w3 None for
    non-gated acts); tok (cap,) token per expert-sorted slot; gate (cap,);
    group_sizes (G,).  Slots beyond sum(group_sizes) are dropped.
    Returns the combined (T, d) fp32."""
    T = x.shape[0]
    cap = tok.shape[0]
    bm = min(bm, max(8, cap))
    row_idx, gates, tile_group = _fused_layout(tok, gate, group_sizes, T,
                                               bm)
    return _gm.fused_moe_ffn(x, w1, w2, w3, row_idx, gates, tile_group,
                             act=act)


def paged_gather(pool, table):
    """pool (n_pages, ps, ...) gathered by table (..., n_lp) ->
    (..., n_lp, ps, ...): each slot's logical KV in logical-page order
    (the "gathered" paged-attention mode)."""
    return pool[table.long()]


def _pa_group_q(q, KV):
    """(B, Q, Hp, hd) -> (B, KV, g*Q, hd), g-major."""
    B, Qn, Hp, hd = q.shape
    g = Hp // KV
    return q.reshape(B, Qn, KV, g, hd).permute(0, 2, 3, 1, 4) \
            .reshape(B, KV, g * Qn, hd).contiguous()


def _pa_ungroup(x, Qn, Hp):
    """(B, KV, g*Q, ...) -> (B, Q, Hp, ...), inverse of `_pa_group_q`."""
    B, KV = x.shape[:2]
    g = Hp // KV
    y = x.reshape((B, KV, g, Qn) + tuple(x.shape[3:]))
    y = torch.movedim(y, 3, 1)
    return y.reshape((B, Qn, Hp) + tuple(x.shape[3:]))


def paged_attention_scores_max(q, k_pool, table, mask):
    """Pass 1 (K3): q (B, Q, Hp, hd); k_pool (n_pages, ps, KV, hd); table
    (B, n_lp); mask (B, Q, n_lp * ps) bool.  Returns m (B, Q, Hp) fp32,
    -inf where nothing is valid."""
    B, Qn, Hp, hd = q.shape
    _, ps, KV, _ = k_pool.shape
    n_lp = table.shape[1]
    m = _pa.paged_attn_scores_max(_pa_group_q(q, KV), k_pool, table,
                                  mask.reshape(B, Qn, n_lp, ps))
    return _pa_ungroup(m, Qn, Hp)


def paged_attention_accumulate(q, k_pool, v_pool, table, mask, m_safe):
    """Pass 2 (K4): operands as pass 1 plus v_pool and m_safe (B, Q, Hp)
    fp32 (the row max with -inf replaced by 0).  Returns fp32
    (num (B, Q, Hp, hd), den (B, Q, Hp))."""
    B, Qn, Hp, hd = q.shape
    _, ps, KV, _ = k_pool.shape
    n_lp = table.shape[1]
    num, den = _pa.paged_attn_accumulate(
        _pa_group_q(q, KV), k_pool, v_pool, table,
        mask.reshape(B, Qn, n_lp, ps),
        _pa_group_q(m_safe[..., None], KV)[..., 0])
    return _pa_ungroup(num, Qn, Hp), _pa_ungroup(den, Qn, Hp)
