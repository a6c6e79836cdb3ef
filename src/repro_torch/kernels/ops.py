"""Public kernel entry points (counterpart of `repro.kernels.ops`).

Layout and grouping stay plain torch index ops on the tensor's device;
the kernel wrappers they call (grouped_matmul.py, paged_attn.py,
normhead.py, wkv6.py, rwkv_decay.py) take the plain versions for CPU
tensors and launch the CUDA kernels for CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import normhead as _nh
from repro_torch.kernels import paged_attn as _pa
from repro_torch.kernels import rwkv_decay as _decay
from repro_torch.kernels import wkv6 as _wkv


class AlignedLayout(NamedTuple):
    """Where `_align_groups` puts each row, index arrays only: tile_group
    (M_pad / bm,) int32 group per bm-row tile, G for overflow tiles;
    row_map (M_pad,) source row per padded row, -1 for padding; dest (M,)
    padded row per source row, -1 for rows past sum(group_sizes)."""
    bm: int
    tile_group: torch.Tensor
    row_map: torch.Tensor
    dest: torch.Tensor


def align_layout(group_sizes, M: int, bm: int) -> AlignedLayout:
    """The row layout of `_align_groups` for M group-sorted rows: every
    group starts at a multiple of bm.  M_pad = M + G * (bm - 1), rounded
    up to bm, is fixed by the shapes, so nothing is read on the host."""
    G = group_sizes.shape[0]
    gs = group_sizes.long()
    padded = ((gs + bm - 1) // bm) * bm
    bounds = torch.cumsum(padded, 0)                     # aligned group ends
    out_starts = bounds - padded
    ends = torch.cumsum(gs, 0)
    in_starts = ends - gs
    M_pad = ((M + G * (bm - 1) + bm - 1) // bm) * bm
    rows = torch.arange(M_pad, device=gs.device)
    gid = torch.searchsorted(bounds, rows, right=True)
    gid_c = gid.clamp(0, G - 1)
    off = rows - out_starts[gid_c]
    valid = (gid < G) & (off < gs[gid_c])
    row_map = torch.where(valid, in_starts[gid_c] + off, -1)
    tile_group = torch.where(valid[::bm], gid_c[::bm], G).to(torch.int32)
    src = torch.arange(M, device=gs.device)
    sg = torch.searchsorted(ends, src, right=True)       # group of each row
    sg_c = sg.clamp(0, G - 1)
    dest = torch.where(sg < G, out_starts[sg_c] + src - in_starts[sg_c], -1)
    return AlignedLayout(bm, tile_group, row_map, dest)


def _take_rows(t, idx):
    """t[idx] with rows where idx < 0 set to 0, in t's dtype."""
    return torch.where((idx >= 0)[:, None], t[idx.clamp_min(0)], 0)


def _align_groups(lhs, group_sizes, bm: int):
    """Re-layout ragged rows so each group starts at a multiple of bm.
    Returns (lhs_aligned (M_pad, K), tile_group (M_pad/bm,), row_map
    (M_pad,) source row per padded row or -1) — the reference's
    `_align_groups`, op for op."""
    lay = align_layout(group_sizes, lhs.shape[0], bm)
    return _take_rows(lhs, lay.row_map), lay.tile_group, lay.row_map


def grouped_matmul(lhs, rhs, group_sizes, *, bm: int = 128,
                   layout: AlignedLayout | None = None,
                   trans_b: bool = False) -> torch.Tensor:
    """Drop-in for jax.lax.ragged_dot on K2: lhs (M, K) group-sorted rows,
    rhs (G, K, N) (or (G, N, K) used transposed when `trans_b`),
    group_sizes (G,).  Rows past sum(group_sizes) give 0.  Returns (M, N)
    fp32.  Callers that multiply one row grouping by several rhs pass the
    `align_layout` once as `layout`."""
    if layout is None:
        layout = align_layout(group_sizes, lhs.shape[0],
                              min(bm, max(8, lhs.shape[0])))
    out = _gm.grouped_matmul_aligned(
        _take_rows(lhs, layout.row_map), rhs, layout.tile_group,
        bm=layout.bm, trans_b=trans_b)
    return _take_rows(out, layout.dest)


def grouped_matmul_wgrad(lhs, rhs, group_sizes, *,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The weight gradient of `grouped_matmul`: lhs (M, K) and rhs (M, N)
    group-sorted rows -> (G, K, N), out[g] = lhs_g^T rhs_g (what jax.vjp
    of ragged_dot gives for its rhs) summed in fp32 and rounded once to
    `out_dtype`."""
    return _gm.grouped_matmul_wgrad(lhs.contiguous(), rhs.contiguous(),
                                    group_sizes, out_dtype=out_dtype)


def _fused_layout(tok, gate, group_sizes, n_tokens: int, bm: int):
    """Index-only expert-aligned layout for the fused MoE FFN.

    tok (cap,) source token per expert-sorted slot; gate (cap,) router
    weight per slot (0 where masked); group_sizes (G,) rows per expert
    among the first sum(group_sizes) slots.  Returns (row_idx (n_m, bm)
    int32 token per padded row, clamped to [0, T); gates (n_m, bm) fp32,
    0 for padding; tile_group (n_m,) int32 expert per tile, G for
    all-padding tiles) — the reference's `_fused_layout`, op for op."""
    cap = tok.shape[0]
    lay = align_layout(group_sizes, cap, bm)
    valid = lay.row_map >= 0
    src = lay.row_map.clamp(0, cap - 1)
    row_idx = torch.where(valid, tok[src].long(), 0)
    row_idx = row_idx.clamp(0, n_tokens - 1).to(torch.int32)
    gates = torch.where(valid, gate[src].float(), 0.0)
    return row_idx.reshape(-1, bm), gates.reshape(-1, bm), lay.tile_group


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


# ---------------------------------------------------------------------------
# EP token exchange: the expert-parallel MoE dispatch's all-to-all
# ---------------------------------------------------------------------------


class _EPAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        # out[dst][src] = in[src][dst] is an involution: each cotangent
        # block travels straight back to the rank that sent the row
        return ctx.group.all_to_all(g), None


def ep_all_to_all(x, *, group):
    """Expert-parallel token exchange over a mesh axis' group
    (`launch.mesh.Group`): x (tp, cap, ...), block j this rank's payload
    addressed to rank j -> (tp, cap, ...), block s the one rank s sent.
    An autograd Function over `all_to_all_single` whose backward is the
    same exchange, as the reference's custom-vjp pins it: gradient
    blocks retrace the forward routes.  A one-rank group passes x
    through."""
    if group.size == 1:
        return x
    return _EPAllToAll.apply(x, group)


def normhead_logits(x, w):
    """Fused NormHead (K5): x (T, d) @ normalize_rows(w (V, d)).T ->
    (T, V) fp32.  Inference only (raises where autograd would track x or
    w)."""
    return _nh.normhead_matmul(x, w)


def wkv6(r, k, v, w, u, state, *, out_state=None):
    """RWKV6 recurrence (K6).  r, k, v, w (B, T, H, hd); u (H, hd); state
    (B, H, hd, hd) fp32.  Returns (y (B, T, H, hd) in r's dtype, state').
    The kernel reads the (B, T, H, hd) layout in place and tiles T itself
    (the reference's `chunk`, a tiling that does not change the result,
    has no counterpart).  `out_state` receives state' (it may be `state`:
    an in-place update)."""
    return _wkv.wkv6(r, k, v, w, u, state, out_state=out_state)


def rwkv_decay(x, a, b, w0):
    """RWKV6's data-dependent decay exp(-exp(w0 + tanh(x a) b)): x (...,
    d), a (d, 32), b (32, n), w0 (n,) -> (..., n) fp32, each row's bits
    independent of the rows that share the call."""
    return _decay.rwkv_decay(x, a, b, w0)
