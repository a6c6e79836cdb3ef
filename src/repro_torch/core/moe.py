"""Fine-grained Mixture-of-Experts FFN at tp=1 (counterpart of
`repro.core.moe`).

At tp=1 the dispatch buffer holds all T*k slots (dropless).  Slots are
stably sorted by expert; two dispatch modes compute the routed experts:

  "fused"   `FusedFFN`, the counterpart of the reference's `fused_ffn`
            custom-vjp.  Forward: kernel K1 through `ops.moe_fused_ffn`
            (gather -> grouped FFN with an fp32 hidden -> gated combine).
            Backward: the reference's recompute through the fp32 ragged
            composition, its six row-ragged products on kernel K2
            (`ops.grouped_matmul`, one aligned layout per backward) and
            its three weight gradients on `ops.grouped_matmul_wgrad`.  On
            CPU tensors every wrapper runs its kernel's plain version.
  "ragged"  the reference's bf16 `grouped_ffn` composition: per-expert
            products in the compute dtype, bf16 scatter-add.  An explicit
            plain mode (it reads group_sizes on the host), not K1's plain
            version (which keeps h in fp32).

"auto" resolves to "fused".  The always-on shared expert adds into the
same output in both modes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import router as router_lib
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def init_moe(cfg, init: L.Init) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    wdt = init.weight_dtype(cfg)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    params: Dict = {"router": router_lib.init_router(cfg, init)}
    params["we1"] = init.normal((m.n_experts, d, m.expert_d_ff), wdt)
    params["we2"] = init.normal((m.n_experts, m.expert_d_ff, d), wdt,
                                out_scale)
    if cfg.mlp_act in L.GATED_ACTS:
        params["we3"] = init.normal((m.n_experts, d, m.expert_d_ff), wdt)
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


def fused_ffn_backward(act, x, w1, w2, w3, tok, gate, group_sizes, g,
                       w_dtype=None):
    """The reference's `_fused_ffn_bwd`: the vjp of gather -> FFN -> gated
    combine recomputed in fp32 from the forward's inputs, for the
    cotangent g (T, d) of the combined output.  The weight gradients come
    out in `w_dtype` (the reference's `dw.astype(w.dtype)`, rounded once
    in the kernel's epilogue), fp32 when None; the rest stays fp32.

    Products on K2 (bf16 wgmma with fp32 accumulation, an fp32 operand
    cut exactly into three bf16 pieces, so fp32 products): a1 = xs W1, a3 = xs W3, out = h W2; dh = d_out W2^T, dxs = da1 W1^T +
    da3 W3^T.  Weight gradients on the grouped wgrad kernel: dW1 = xs^T
    da1, dW3 = xs^T da3, dW2 = h^T d_out.  The activation's vjp is
    elementwise autograd.  Returns (dxs (cap, d) the grad of each gathered
    row x[tok], dw1, dw2, dw3 or None, dgate)."""
    cap = tok.shape[0]
    lay = kops.align_layout(group_sizes, cap, min(128, max(8, cap)))

    def mm(lhs, rhs, trans_b=False):
        return kops.grouped_matmul(lhs, rhs, group_sizes, layout=lay,
                                   trans_b=trans_b)

    xs = x[tok]                              # K2 converts it to fp32
    a1 = mm(xs, w1).requires_grad_()
    a3 = mm(xs, w3).requires_grad_() if w3 is not None else None
    with torch.enable_grad():
        h = L._act(act, a1)
        if a3 is not None:
            h = h * a3
    out = mm(h.detach(), w2)                 # rows past sum() are 0
    gt = g.float()[tok]
    dgate = torch.sum(out * gt, dim=-1)
    d_out = gt * gate.float()[:, None]
    dh = mm(d_out, w2, trans_b=True)
    da = torch.autograd.grad(h, [a1] + ([a3] if a3 is not None else []),
                             dh)
    dxs = mm(da[0], w1, trans_b=True)
    wdt = torch.float32 if w_dtype is None else w_dtype
    dw1 = kops.grouped_matmul_wgrad(xs, da[0], group_sizes, out_dtype=wdt)
    dw3 = None
    if a3 is not None:
        dxs = dxs + mm(da[1], w3, trans_b=True)
        dw3 = kops.grouped_matmul_wgrad(xs, da[1], group_sizes,
                                        out_dtype=wdt)
    dw2 = kops.grouped_matmul_wgrad(h.detach(), d_out, group_sizes,
                                    out_dtype=wdt)
    return dxs, dw1, dw2, dw3, dgate


class FusedFFN(torch.autograd.Function):
    """Fused MoE FFN (counterpart of the reference's `fused_ffn`): forward
    on kernel K1, backward `fused_ffn_backward` with each gradient in its
    input's dtype, as the reference's custom vjp returns them (the
    weights' rounded by the weight-gradient kernel's epilogue; w1, w2 and
    w3 share one dtype).  The grad of x follows the reference's vjp of
    `take(x, tok).astype(f32)`:
    each gathered row's grad is cast to x's dtype, then the rows are
    scatter-added in that dtype.  The scatter is `index_put_` with
    accumulate: on the CPU it adds each token's rows in slot order,
    rounding after each add; on a card it sorts the rows by token first,
    so every run gives the same bits (`index_add_` adds by atomics in no
    fixed order there, and a resumed run would part from the unbroken
    one)."""

    @staticmethod
    def forward(ctx, act, x, w1, w2, w3, tok, gate, group_sizes):
        ctx.act = act
        ctx.save_for_backward(x, w1, w2, w3, tok, gate, group_sizes)
        return kops.moe_fused_ffn(x, w1, w2, w3, tok, gate, group_sizes,
                                  act=act)

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, w3, tok, gate, group_sizes = ctx.saved_tensors
        dxs, dw1, dw2, dw3, dgate = fused_ffn_backward(
            ctx.act, x, w1, w2, w3, tok, gate, group_sizes, g,
            w_dtype=w1.dtype)
        dx = torch.zeros_like(x).index_put_((tok,), dxs.to(x.dtype),
                                            accumulate=True)
        return (None, dx, dw1, dw2, dw3, None, dgate.to(gate.dtype), None)


def fused_ffn(act, x, w1, w2, w3, tok, gate, group_sizes):
    """Fused MoE FFN dispatch: K1 forward, K2 backward (plain versions on
    CPU tensors)."""
    return FusedFFN.apply(act, x, w1, w2, w3, tok, gate, group_sizes)


def resolve_dispatch(cfg, dispatch: str) -> str:
    if dispatch == "auto":
        dispatch = cfg.moe.dispatch
    if dispatch in ("auto", "ep"):      # ep buys nothing at tp=1
        dispatch = "fused"
    if dispatch not in ("fused", "ragged"):
        raise NotImplementedError(
            f"moe dispatch {dispatch!r} is not yet ported (tp=1 supports "
            f"fused and ragged)")
    return dispatch


def sort_slots(cfg, top_w, top_i):
    """Sort the T*k routed slots stably by expert (dropless at tp=1).
    Returns (tok (cap,) token per slot, gates (cap,) router weight per
    slot in the compute dtype, group_sizes (E,) slots per expert,
    n_kept)."""
    m = cfg.moe
    E = m.n_experts
    cap = top_i.shape[0] * m.top_k
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
    group_sizes = torch.zeros(E + 1, dtype=torch.long,
                              device=top_i.device) \
        .scatter_add_(0, key, torch.ones_like(key))[:E]
    gates = (flat_w[sel] * valid).to(L.dtype_of(cfg.compute_dtype))
    return tok, gates, group_sizes, valid.sum()


def moe_ffn(cfg, params, x: torch.Tensor, *, dispatch: str = "auto",
            train: bool = False, step: Optional[int] = None,
            eps: Optional[torch.Tensor] = None):
    """x (T, d) -> (y (T, d) in compute dtype, metrics); with `train`
    (y, aux, metrics) as the reference returns them: the router's aux
    losses, and its metrics beside `moe/dropped_frac`.  `step` and the
    warmup noise `eps` (T, E) feed the router's stochastic warmup."""
    m = cfg.moe
    T, d = x.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    dispatch = resolve_dispatch(cfg, dispatch)

    w1 = params["we1"].to(cdt)
    w2 = params["we2"].to(cdt)
    w3 = params["we3"].to(cdt) if "we3" in params else None

    routed = router_lib.route(cfg, params["router"], x, train=train,
                              step=step, eps=eps)
    tok, gates, group_sizes, n_kept = sort_slots(cfg, *routed[:2])
    if dispatch == "fused":
        y = fused_ffn(cfg.mlp_act, x.to(cdt), w1, w2, w3, tok, gates,
                      group_sizes).to(cdt)
    else:
        xs = x[tok].to(cdt)
        out = grouped_ffn(cfg.mlp_act, xs, w1, w2, w3, group_sizes)
        y = torch.zeros((T, d), dtype=cdt, device=x.device).index_add_(
            0, tok, out * gates[:, None])
    y, metrics = _moe_tail(cfg, params, x, y, n_kept=n_kept,
                           n_local=T * m.top_k)
    if not train:
        return y, metrics
    _, _, aux, router_metrics = routed
    return y, aux, {**router_metrics, **metrics}
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
