"""Fine-grained Mixture-of-Experts FFN (counterpart of `repro.core.moe`).

Routed experts are sharded over tp on their leading dim (`ep_spec`: rank
r owns experts [r*E_loc, (r+1)*E_loc)) and FSDP-sharded over dp on
another.  At tp=1 the dispatch buffer holds all T*k slots (dropless).
Slots are stably sorted by expert; three dispatch modes compute the routed
experts at tp=1 ("batched", below, is the third):

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

At tp > 1 four modes, as the reference's:

  "ep"      (`_ep_moe_ffn`): rank r routes its owned T/tp token slice,
            an all-to-all sends each routed slot to the shard owning its
            expert (at most `ep_capacity` slots a shard pair: the
            earliest win, the rest drop), the received rows run through
            `FusedFFN` with gate 1 (K1 forward, K2 and the weight
            gradient backward, as at tp=1), and a second all-to-all
            brings the outputs home, where the gates scale them into the
            owned slice.  Needs T % tp == 0.
  "fused", "ragged"  the Megatron layout: every rank routes all T tokens
            (x replicated over tp, the same warmup noise on every rank),
            sorts the T*k slots with the other ranks' experts last and
            keeps the first `capacity` of them; its E/tp local experts
            run over those rows (`FusedFFN` or the bf16 composition),
            the trailing non-local rows gated 0.
  "batched" the per-expert-capacity layout (E_loc, C_e, d) of
            `expert_capacity` rows an expert, plain einsums (no Pallas
            form in the reference, so no kernel); at tp=1 too.

"auto" resolves to "fused" at tp=1; at tp > 1 to "ep" when T % tp == 0
and "batched" otherwise (the reference's choice off the TPU); an
explicit "ep" with T % tp != 0 raises, as the reference's.  The
always-on shared expert (a tensor-parallel FFN) adds into the same
output in every mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.core import router as router_lib
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding import LOCAL, AxisEnv


def padded_experts(cfg, env: AxisEnv = LOCAL) -> Tuple[int, int]:
    """(E_padded, E_local): experts padded to a multiple of tp (the
    padding experts are never routed to: granite's 40 on tp = 16, or 5 on
    tp = 2, give the last rank dummy experts whose groups are empty in
    every dispatch mode)."""
    ep = sharding.pad_to_multiple(cfg.moe.n_experts, env.tp)
    return ep, ep // env.tp


def capacity(cfg, env: AxisEnv, n_tokens: int) -> int:
    """Static per-rank dispatch-buffer rows: all T*k slots at tp=1
    (dropless), else T*k*capacity_factor/tp rounded up to 8 (at most
    T*k)."""
    m = cfg.moe
    slots = n_tokens * m.top_k
    if env.tp == 1:
        return slots
    cap = int(slots * m.capacity_factor / env.tp)
    return min(sharding.pad_to_multiple(max(cap, 8), 8), slots)


def expert_capacity(cfg, env: AxisEnv, n_tokens: int) -> int:
    """Rows an expert of the "batched" mode: C_e = T*k*cf/E rounded up to
    8 (at most T*k), the reference's global semantics (the rows of all
    E_loc experts match the per-rank `capacity`)."""
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return min(sharding.pad_to_multiple(max(c, 8), 8), n_tokens * m.top_k)


def ep_capacity(cfg, env: AxisEnv, n_tokens_local: int) -> int:
    """Rows per (source, destination) shard pair of the EP exchange:
    `capacity` of the rank's owned token count."""
    return capacity(cfg, env, n_tokens_local)


def init_moe(cfg, init: L.Init) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    wdt = init.weight_dtype(cfg)
    env = init.env
    ep, _ = padded_experts(cfg, env)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    params: Dict = {"router": router_lib.init_router(cfg, init)}
    # (E_pad, ...) as the reference's: the padding experts' weights are
    # drawn, but the router never picks them, so their groups stay empty
    params["we1"] = init.normal((ep, d, m.expert_d_ff), wdt,
                                spec=sharding.ep_spec(env, 3, 1, 0))
    params["we2"] = init.normal((ep, m.expert_d_ff, d), wdt, out_scale,
                                spec=sharding.ep_spec(env, 3, 2, 0))
    if cfg.mlp_act in L.GATED_ACTS:
        params["we3"] = init.normal((ep, d, m.expert_d_ff), wdt,
                                    spec=sharding.ep_spec(env, 3, 1, 0))
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


DISPATCHES = ("fused", "ragged", "batched", "ep")


def resolve_dispatch(cfg, dispatch: str, env: AxisEnv = LOCAL,
                     n_tokens: Optional[int] = None) -> str:
    """RunFlags.moe_dispatch -> "fused" | "ragged" | "batched" | "ep", as
    the reference resolves it off the TPU: "auto" takes the config's
    knob, then "fused" at tp=1 ("ep" buys nothing there) and at tp > 1
    "ep" when the call's T (`n_tokens`) divides over tp, else "batched".
    An explicit "ep" with T % tp != 0 raises."""
    explicit = dispatch != "auto"
    if dispatch == "auto":
        dispatch = cfg.moe.dispatch
    if dispatch == "auto":
        dispatch = "ep" if env.tp > 1 else "fused"
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe dispatch mode: {dispatch!r}")
    if env.tp == 1:
        return "fused" if dispatch == "ep" else dispatch
    if dispatch == "ep" and n_tokens is not None and n_tokens % env.tp:
        if explicit:
            raise ValueError(f"dispatch='ep' needs T ({n_tokens}) "
                             f"divisible by tp ({env.tp})")
        dispatch = "batched"
    return dispatch


def _local_keys(cfg, env: AxisEnv, top_i):
    """Each of the T*k slots' expert among this rank's E_loc (E_loc for
    another rank's), and whether it is this rank's."""
    _, e_loc = padded_experts(cfg, env)
    local = top_i.reshape(-1) - env.tp_index() * e_loc
    is_local = (local >= 0) & (local < e_loc)
    return torch.where(is_local, local, e_loc), is_local


def _group_sizes(key, n: int):
    """Counts of the keys 0..n-1 (key n: none).  A scatter into a known
    length: bincount would read the max back to the host on CUDA."""
    return torch.zeros(n + 1, dtype=torch.long, device=key.device) \
        .scatter_add_(0, key, torch.ones_like(key))[:n]


def sort_slots(cfg, top_w, top_i, env: AxisEnv = LOCAL):
    """The "fused" / "ragged" layout: the T*k routed slots sorted stably by
    local expert, other ranks' experts last, the first `capacity` kept
    (all of them, dropless, at tp=1).  Returns (tok (cap,) token per
    slot, gates (cap,) router weight per slot in the compute dtype, 0 on
    a row of another rank's expert, group_sizes (E_loc,) rows per local
    expert, n_kept)."""
    m = cfg.moe
    _, e_loc = padded_experts(cfg, env)
    cap = capacity(cfg, env, top_i.shape[0])
    key, _ = _local_keys(cfg, env, top_i)
    sel = torch.argsort(key, stable=True)[:cap]
    tok = sel // m.top_k                           # token per slot
    skey = key[sel]
    valid = skey < e_loc
    gates = (top_w.reshape(-1)[sel] * valid).to(L.dtype_of(cfg.compute_dtype))
    return tok, gates, _group_sizes(skey, e_loc), valid.sum()


def batched_ffn(cfg, env: AxisEnv, x, w1, w2, w3, top_w, top_i):
    """The "batched" mode (the reference's per-expert-capacity dispatch):
    local expert e's slots, in sorted order, fill the first min(count_e,
    C_e) of its C_e = `expert_capacity` rows of an (E_loc, C_e, d)
    layout, the expert FFN is three batched einsums in the compute dtype
    and the gated outputs are scatter-added.  Returns (y (T, d), n_kept)."""
    m = cfg.moe
    T, d = x.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    _, e_loc = padded_experts(cfg, env)
    c_e = expert_capacity(cfg, env, T)
    key, _ = _local_keys(cfg, env, top_i)
    order = torch.argsort(key, stable=True)
    counts = _group_sizes(key, e_loc)
    offsets = torch.cumsum(counts, 0) - counts
    ar = torch.arange(c_e, device=x.device)
    slot = order[(offsets[:, None] + ar[None, :]).clamp(0, order.shape[0] - 1)]
    slot_valid = ar[None, :] < torch.clamp(counts, max=c_e)[:, None]
    tok_e = (slot // m.top_k).reshape(-1)
    xs = x[tok_e].to(cdt).reshape(e_loc, c_e, d)
    h = L._act(cfg.mlp_act, torch.einsum("ecd,edf->ecf", xs, w1))
    if w3 is not None:
        h = h * torch.einsum("ecd,edf->ecf", xs, w3)
    out = torch.einsum("ecf,efd->ecd", h, w2)
    gates = (top_w.reshape(-1)[slot.reshape(-1)].reshape(e_loc, c_e)
             * slot_valid).to(cdt)
    y = torch.zeros((T, d), dtype=cdt, device=x.device).index_add_(
        0, tok_e, (out * gates[..., None]).reshape(-1, d))
    return y, torch.clamp(counts, max=c_e).sum()


def ep_send_layout(cfg, env: AxisEnv, top_w, top_i):
    """The send side of the EP exchange for a rank's T_loc routed tokens:
    the T_loc*k slots bucketed by destination shard with a stable sort
    (token order), the earliest `ep_capacity` of each (source,
    destination) pair kept and the rest dropped.  Returns (tok_send
    (tp*cap,) the owned token of each row, key_send (tp, cap) int32 its
    expert at the destination (E_loc where the row is empty), gates
    (tp*cap,) fp32 its router weight (0 where empty), n_kept)."""
    m = cfg.moe
    tp = env.tp
    dev = top_i.device
    _, e_loc = padded_experts(cfg, env)
    S = top_i.numel()
    cap = ep_capacity(cfg, env, top_i.shape[0])
    flat_i = top_i.reshape(-1)
    dest = flat_i // e_loc
    lkey = flat_i - dest * e_loc
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    ids = torch.arange(tp, device=dev, dtype=sorted_dest.dtype)
    offsets = torch.searchsorted(sorted_dest, ids)
    counts = torch.searchsorted(sorted_dest, ids, right=True) - offsets
    ar = torch.arange(cap, device=dev)
    pos_valid = ar[None, :] < torch.clamp(counts, max=cap)[:, None]
    slot = order[(offsets[:, None] + ar[None, :]).clamp(0, S - 1)]
    key_send = torch.where(pos_valid, lkey[slot], e_loc).to(torch.int32)
    gates = torch.where(pos_valid, top_w.reshape(-1)[slot], 0.0)
    return ((slot // m.top_k).reshape(-1), key_send, gates.reshape(-1),
            pos_valid.sum())


def ep_recv_layout(keys, e_loc: int):
    """The receive side: keys (R,) each received row's local expert (E_loc
    for an empty row) -> (order (R,) the rows sorted stably by expert,
    empty rows last; group_sizes (E_loc,); valid (R,) bool in sorted
    order), `FusedFFN`'s tok, group sizes and gate 1."""
    keys = keys.long()
    order = torch.argsort(keys, stable=True)
    skey = keys[order]
    eids = torch.arange(e_loc, device=keys.device, dtype=skey.dtype)
    group_sizes = (torch.searchsorted(skey, eids, right=True)
                   - torch.searchsorted(skey, eids))
    return order, group_sizes, skey < e_loc


def _ep_moe_ffn(cfg, env: AxisEnv, params, x, w1, w2, w3, *, train: bool,
                step, eps):
    """The expert-parallel dispatch (the reference's `_ep_moe_ffn`).

    x (T, d) replicated over tp.  Rank r owns the r-th T/tp slice and
    routes only it (the statistics over dp and tp; `eps` is the slice's
    warmup noise, drawn under the layer key folded with r).  Its slots
    are bucketed by destination shard (`ep_send_layout`), the rows and
    their local-expert keys exchanged in one `ep_all_to_all` (each key an
    extra column of its row, exact in the compute dtype for up to 256
    local experts), the received rows sorted by local expert
    (`ep_recv_layout`) and run through
    `FusedFFN` with gate 1 (K1; K2 and the weight gradient in the
    backward), the outputs exchanged back and scatter-added with the
    gates into the owned slice (`index_put` with accumulate, the port's
    determinism contract).  Returns (y (T, d) zero outside the owned
    slice: the caller's combine over tp assembles it, routed, n_kept,
    n_slots)."""
    m = cfg.moe
    T, d = x.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    tp, r = env.tp, env.tp_index()
    _, e_loc = padded_experts(cfg, env)
    T_loc = T // tp
    x_loc = x[r * T_loc:(r + 1) * T_loc]
    routed = router_lib.route(cfg, params["router"], x_loc, train=train,
                              step=step, eps=eps, ep=True, env=env)
    tok_send, key_send, gates, n_kept = ep_send_layout(cfg, env, *routed[:2])
    cap = key_send.shape[1]
    if e_loc > 256:
        raise NotImplementedError(f"{e_loc} local experts: the EP keys ride "
                                  f"the rows in the compute dtype (<= 256)")

    # the exchange: each row in the compute dtype (differentiable), its key
    # beside it
    group = env.mesh.tp_group
    recv = kops.ep_all_to_all(torch.cat(
        [x_loc[tok_send].reshape(tp, cap, d).to(cdt),
         key_send[..., None].to(cdt)], dim=-1), group=group)
    R = tp * cap
    order, group_sizes, valid = ep_recv_layout(recv[..., d].reshape(R),
                                               e_loc)

    # the shard's experts over the received rows, gate 1
    y_r = fused_ffn(cfg.mlp_act, recv[..., :d].reshape(R, d).contiguous(),
                    w1, w2, w3, order, valid.to(cdt), group_sizes)

    # home again: the gates scale each slot's output into the owned slice
    y_back = kops.ep_all_to_all(y_r.to(cdt).reshape(tp, cap, d),
                                group=group)
    y_loc = torch.zeros((T_loc, d), dtype=cdt, device=x.device).index_put(
        (tok_send,), y_back.reshape(R, d) * gates.to(cdt)[:, None],
        accumulate=True)
    y = F.pad(y_loc, (0, 0, r * T_loc, T - (r + 1) * T_loc))
    return y, routed, n_kept, T_loc * m.top_k


def moe_ffn(cfg, params, x: torch.Tensor, *, dispatch: str = "auto",
            train: bool = False, step: Optional[int] = None,
            eps: Optional[torch.Tensor] = None, env: AxisEnv = LOCAL):
    """x (T, d) -> (y (T, d) in compute dtype, metrics); with `train`
    (y, aux, metrics) as the reference returns them: the router's aux
    losses, and its metrics beside `moe/dropped_frac`.  `step` and the
    warmup noise `eps` (T, E) feed the router's stochastic warmup (under
    "ep", (T / tp, E): the owned slice's).  Over tp, y is the rank's
    partial sum, combined by the caller."""
    m = cfg.moe
    T, d = x.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    dispatch = resolve_dispatch(cfg, dispatch, env, T)

    w1 = env.gather_fsdp(params["we1"], 1, dtype=cdt)
    w2 = env.gather_fsdp(params["we2"], 2, dtype=cdt)
    w3 = (env.gather_fsdp(params["we3"], 1, dtype=cdt)
          if "we3" in params else None)

    if dispatch == "ep":
        y, routed, n_kept, n_local = _ep_moe_ffn(
            cfg, env, params, x, w1, w2, w3, train=train, step=step, eps=eps)
        y, metrics = _moe_tail(cfg, params, x, y, n_kept=n_kept,
                               n_local=n_local, env=env, train=train)
        if not train:
            return y, metrics
        _, _, aux, router_metrics = routed
        return y, aux, {**router_metrics, **metrics}

    routed = router_lib.route(cfg, params["router"], x, train=train,
                              step=step, eps=eps, env=env)
    top_w, top_i = routed[:2]
    if dispatch == "batched":
        y, n_kept = batched_ffn(cfg, env, x, w1, w2, w3, top_w, top_i)
    else:
        tok, gates, group_sizes, n_kept = sort_slots(cfg, top_w, top_i, env)
        if dispatch == "fused":
            y = fused_ffn(cfg.mlp_act, x.to(cdt), w1, w2, w3, tok, gates,
                          group_sizes).to(cdt)
        else:
            xs = x[tok].to(cdt)
            out = grouped_ffn(cfg.mlp_act, xs, w1, w2, w3, group_sizes)
            y = torch.zeros((T, d), dtype=cdt, device=x.device).index_add_(
                0, tok, out * gates[:, None])
    n_local = _local_keys(cfg, env, top_i)[1].sum()
    y, metrics = _moe_tail(cfg, params, x, y, n_kept=n_kept,
                           n_local=n_local, env=env, train=train)
    if not train:
        return y, metrics
    _, _, aux, router_metrics = routed
    return y, aux, {**router_metrics, **metrics}


def _moe_tail(cfg, params, x, y, *, n_kept, n_local, env: AxisEnv = LOCAL,
              train: bool = True):
    """Dropped-slot telemetry (0 at tp=1: dropless; in training over tp
    the fraction of every rank's slots, averaged over dp; the serving
    steps, which drop the metric, get the rank's own fraction, as the
    reference's compiled steps drop those collectives as dead code) and
    the always-on shared expert added into the same output."""
    m = cfg.moe
    cdt = L.dtype_of(cfg.compute_dtype)
    n_local = torch.as_tensor(n_local, dtype=torch.float32,
                              device=x.device)
    dropped = (n_local - n_kept).clamp_min(0)
    if env.tp == 1 or not train:
        frac = dropped / n_local.clamp_min(1.0)
    else:
        d_all, n_all = env.psum_tp((dropped, n_local))
        frac = d_all / n_all.clamp_min(1.0)
    metrics = {"moe/dropped_frac": env.pmean_dp(frac) if train else frac}
    if m.n_shared_experts > 0:
        y = y + L.apply_mlp(cfg, params["shared"], x.to(cdt), env=env)
    return y, metrics
