"""Fine-grained Mixture-of-Experts FFN at tp=1 (counterpart of
`repro.core.moe`).

At tp=1 the dispatch buffer holds all T*k slots (dropless).  Slots are
stably sorted by expert; two dispatch modes compute the routed experts:

  "fused"   kernel K1 (kernels/grouped_matmul.py) through
            `ops.moe_fused_ffn`: gather -> grouped FFN with an fp32
            hidden -> gated combine, one wrapper call per layer.  On CPU
            tensors the wrapper runs K1's plain version,
            `grouped_matmul.fused_moe_ffn_ref` (the counterpart of the
            reference's fp32 `_fused_ragged_ref`).
  "ragged"  the reference's bf16 `grouped_ffn` composition: per-expert
            products in the compute dtype, bf16 scatter-add.  An explicit
            plain mode, not K1's plain version (which keeps h in fp32).

"auto" resolves to "fused".  The always-on shared expert adds into the
same output in both modes.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import router as router_lib
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def init_moe(cfg, init: L.Init) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    cdt = L.dtype_of(cfg.compute_dtype)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    params: Dict = {"router": router_lib.init_router(cfg, init)}
    params["we1"] = init.normal((m.n_experts, d, m.expert_d_ff), cdt)
    params["we2"] = init.normal((m.n_experts, m.expert_d_ff, d), cdt,
                                out_scale)
    if cfg.mlp_act in L.GATED_ACTS:
        params["we3"] = init.normal((m.n_experts, d, m.expert_d_ff), cdt)
    if m.n_shared_experts > 0:
        params["shared"] = L.init_mlp(cfg, init, d_ff=m.shared_ff,
                                      scale_out=out_scale)
    return params


def grouped_ffn(act, xs, w1, w2, w3, group_sizes):
    """Grouped expert FFN over expert-sorted rows xs (cap, d), per expert
    in xs's dtype (the "ragged" mode runs it in the compute dtype); rows
    beyond sum(group_sizes) stay 0 (ragged_dot semantics)."""
    out = torch.zeros((xs.shape[0], w2.shape[-1]), dtype=xs.dtype,
                      device=xs.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            rows = xs[start:start + n]
            h = L._act(act, rows @ w1[e])
            if w3 is not None:
                h = h * (rows @ w3[e])
            out[start:start + n] = h @ w2[e]
        start += n
    return out


def fused_ffn(act, x, w1, w2, w3, tok, gate, group_sizes):
    """Fused MoE FFN dispatch: kernel K1 (plain version on CPU)."""
    return kops.moe_fused_ffn(x, w1, w2, w3, tok, gate, group_sizes,
                              act=act)


def resolve_dispatch(cfg, dispatch: str) -> str:
    if dispatch == "auto":
        dispatch = cfg.moe.dispatch
    if dispatch in ("auto", "ep"):      # ep buys nothing at tp=1
        dispatch = "fused"
    if dispatch not in ("fused", "ragged"):
        raise NotImplementedError(
            f"moe dispatch {dispatch!r} is not yet ported (tp=1 serving "
            f"supports fused and ragged)")
    return dispatch


def dispatch_slots(cfg, router_params, x: torch.Tensor):
    """Route x (T, d) and sort its T*k slots stably by expert (dropless
    at tp=1).  Returns (tok (cap,) token per slot, gates (cap,) router
    weight per slot in the compute dtype, group_sizes (E,) slots per
    expert, n_kept)."""
    m = cfg.moe
    E = m.n_experts
    cap = x.shape[0] * m.top_k
    top_w, top_i = router_lib.route(cfg, router_params, x)
    flat_i = top_i.reshape(-1)                     # (T*k,)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_i, stable=True)     # slots by expert
    sel = order[:cap]
    tok = sel // m.top_k                           # token per slot
    skey = flat_i[sel]
    valid = skey < E
    # scatter_add_ into a known length: bincount would read the max back
    # to the host on CUDA, a sync per layer
    key = torch.where(valid, skey, E)
    group_sizes = torch.zeros(E + 1, dtype=torch.long, device=x.device) \
        .scatter_add_(0, key, torch.ones_like(key))[:E]
    gates = (flat_w[sel] * valid).to(L.dtype_of(cfg.compute_dtype))
    return tok, gates, group_sizes, valid.sum()


def moe_ffn(cfg, params, x: torch.Tensor, *, dispatch: str = "auto"):
    """x (T, d) -> (y (T, d) in compute dtype, metrics)."""
    m = cfg.moe
    T, d = x.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    dispatch = resolve_dispatch(cfg, dispatch)

    w1 = params["we1"].to(cdt)
    w2 = params["we2"].to(cdt)
    w3 = params["we3"].to(cdt) if "we3" in params else None

    tok, gates, group_sizes, n_kept = dispatch_slots(cfg, params["router"],
                                                     x)
    if dispatch == "fused":
        y = fused_ffn(cfg.mlp_act, x.to(cdt), w1, w2, w3, tok, gates,
                      group_sizes).to(cdt)
    else:
        xs = x[tok].to(cdt)
        out = grouped_ffn(cfg.mlp_act, xs, w1, w2, w3, group_sizes)
        y = torch.zeros((T, d), dtype=cdt, device=x.device).index_add_(
            0, tok, out * gates[:, None])
    return _moe_tail(cfg, params, x, y, n_kept=n_kept,
                     n_local=T * m.top_k)


def _moe_tail(cfg, params, x, y, *, n_kept, n_local):
    """Dropped-slot telemetry (0 at tp=1: dropless) and the always-on
    shared expert added into the same output."""
    m = cfg.moe
    cdt = L.dtype_of(cfg.compute_dtype)
    dropped = (n_local - n_kept).clamp_min(0)
    metrics = {"moe/dropped_frac": dropped.float() / max(n_local, 1)}
    if m.n_shared_experts > 0:
        y = y + L.apply_mlp(cfg, params["shared"], x.to(cdt))
    return y, metrics
