"""RWKV6 ("Finch") time-mix and channel-mix blocks (counterpart of
`repro.models.rwkv6`) [arXiv:2404.05892].

Attention-free linear-recurrence block with a data-dependent decay: the
per-channel decay w_t comes from the token itself through a low-rank
(LoRA) projection.  The recurrence runs on K6 (`kernels.ops.wkv6`) in the
prefill (T = prompt) and in every decode tick (T = 1, state updated in
place).  The decay itself runs on its own kernel (`kernels.ops.rwkv_decay`),
which gives a token the same decay in the prefill and in a decode tick.

Sharding over a (dp, tp) mesh (`env`), as the reference's: the heads are
column-sharded over tp and padded to a multiple of it (`dims`; a padded
head is a real head, its projections, decay and bonus drawn like the
others'); r, k, v and g are column-parallel, `wo` row-parallel, the decay
LoRA's B, `w0` and `u` tp-local, and `mu` and the LoRA's A are FSDP-only.
The WKV state (hd x hd per head) is head-local, so K6 and the decay kernel
run per rank on its heads with no collective; each mix returns its
rank's partial output for the caller's combine over tp.  The channel mix
is column- (`wk`) then row-parallel (`wv`); its receptance gate is
applied after the combine, on the rank's sequence-parallel slice.

Training (`time_mix(train=True)`) runs no kernel: as the reference
differentiates its jnp forms, autograd runs through the plain decay
(`kernels.rwkv_decay.rwkv_decay_ref`, the reference's two fp32 products)
and the reference's two formulations of the recurrence, ported op for
op: the sequential scan (`wkv6_scan`) and the chunked-parallel form
(`wkv6_chunked`, `RunFlags.rwkv_chunk`).  K6 and the decay kernel have
no backward, and their wrappers raise on operands that require grad.

Serving storage (`Init.masters` False): the leaves the reference casts to
the compute dtype at use (`mu`, the r/k/v/g/o projections, the channel
mix) are stored in that dtype; the decay LoRA, `w0` and `u`, which the
reference casts to fp32, stay fp32.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.kernels import ops as kops
from repro_torch.kernels.rwkv_decay import rwkv_decay_ref
from repro_torch.models import layers as L
from repro_torch.sharding import LOCAL, AxisEnv, fsdp_spec

LORA_RANK = 32


def padded_heads(cfg, env: AxisEnv = LOCAL) -> Tuple[int, int]:
    """(heads, heads padded to a multiple of tp) of the time mix."""
    nh = cfg.d_model // cfg.rwkv_head_dim
    return nh, sharding.pad_to_multiple(nh, env.tp)


def dims(cfg, env: AxisEnv = LOCAL) -> Tuple[int, int]:
    """(this rank's heads, head_dim) of the time mix."""
    return padded_heads(cfg, env)[1] // env.tp, cfg.rwkv_head_dim


def init_time_mix(cfg, init: L.Init) -> L.Params:
    d = cfg.d_model
    env = init.env
    dp = padded_heads(cfg, env)[1] * cfg.rwkv_head_dim   # padded width
    wdt = init.weight_dtype(cfg)
    f32 = L.dtype_of(cfg.param_dtype)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    col, row = fsdp_spec(env, 2, 0, 1), fsdp_spec(env, 2, 1, 0)
    loc = fsdp_spec(env, 1, None, 0)
    return {
        # token-shift interpolation coefficients, r,k,v,w,g
        "mu": init.ones((5, d), wdt, fsdp_spec(env, 2, 1)).mul_(0.5),
        "wr": init.normal((d, dp), wdt, spec=col),
        "wk": init.normal((d, dp), wdt, spec=col),
        "wv": init.normal((d, dp), wdt, spec=col),
        "wg": init.normal((d, dp), wdt, spec=col),
        "wo": init.normal((dp, d), wdt, out_scale, spec=row),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w_lora_a": init.normal((d, LORA_RANK), f32,
                                spec=fsdp_spec(env, 2, 0)),
        "w_lora_b": init.normal((LORA_RANK, dp), f32, spec=col),
        "w0": init.ones((dp,), f32, loc).mul_(-6.0),
        "u": init.normal((dp,), f32, 0.5, spec=loc),  # bonus ("faaaa")
    }


def wkv6_scan(r, k, v, w, u, state):
    """The reference WKV6 recurrence, one step per timestep (plain
    PyTorch, differentiable).

    r, k, v, w: (B, T, H, hd) — w in (0, 1) per key-channel decay.
    u: (H, hd) bonus.  state: (B, H, hd, hd) carried KV matrix.
    Returns (y (B, T, H, hd), state').
      y_t = (S_{t-1} + diag(u*k_t) . v_t^T)^T r_t
      S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    S, ys = state, []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B, H, hd)
        kv = kt[..., :, None] * vt[..., None, :]              # (B,H,hd,hd)
        ys.append(torch.einsum("bhkv,bhk->bhv", S + u[..., None] * kv, rt))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv6_chunked(r, k, v, w, u, state, chunk: int):
    """The reference's chunked-parallel WKV6, term for term (plain
    PyTorch, differentiable).

    Within a chunk of length L the per-channel decay products are
    prefix-cumulated in log space; the sequential dependency collapses to
    one (L x hd)@(hd x hd) state contraction + one masked (L x L) intra-
    chunk matmul per head.

      Dc[t]   = prod_{s<=t} w_s
      inter   = (r_t ⊙ Dc[t-1]) @ S_prev
      P[t,s]  = sum_k r_tk (Dc[t-1]/Dc[s])_k k_sk      (s < t, strictly)
      bonus   = diag: r_t ⊙ u ⊙ k_t
      y_t     = inter + sum_{s<t} P[t,s] v_s + (r_t·(u k_t)) v_t
      S_next  = Dc[L-1] ⊙ S_prev + sum_s (Dc[L-1]/Dc[s] ⊙ k_s) v_s^T
    """
    B, T, H, hd = r.shape
    L_ = chunk
    n = T // L_
    rr = r.reshape(B, n, L_, H, hd)
    kk = k.reshape(B, n, L_, H, hd)
    vv = v.reshape(B, n, L_, H, hd)
    lw = torch.log(torch.clamp(w, min=1e-30)).reshape(B, n, L_, H, hd)
    mask = torch.tril(torch.ones((L_, L_), dtype=r.dtype, device=r.device),
                      -1)                                 # strictly lower
    S, ys = state, []
    for c in range(n):
        rc, kc, vc, lwc = rr[:, c], kk[:, c], vv[:, c], lw[:, c]
        cum = torch.cumsum(lwc, dim=1)           # log Dc[t]
        dc_prev = torch.exp(cum - lwc)           # Dc[t-1] = Dc[t]/w_t
        dc_tot = torch.exp(cum[:, -1])           # (B, H, hd)
        r_d = rc * dc_prev                       # exp(<=0): bounded
        inter = torch.einsum("blhk,bhkv->blhv", r_d, S)
        # midpoint-shifted pair for the intra-chunk matmul: exp(cum-shift)
        # stays within exp(+-range/2) instead of exp(range) (fp32 safety)
        shift = cum[:, L_ // 2][:, None]
        r_s = rc * torch.exp(cum - lwc - shift)
        k_s = kc * torch.exp(shift - cum)
        P = torch.einsum("blhk,bmhk->bhlm", r_s, k_s)
        intra = torch.einsum("bhlm,bmhv->blhv", P * mask, vc)
        bonus = torch.einsum("blhk,blhk->blh", rc, u[None, None] * kc)
        ys.append(inter + intra + bonus[..., None] * vc)
        k_tail = kc * torch.exp(cum[:, -1:] - cum)  # Dc[L-1]/Dc[s] ⊙ k_s
        S = dc_tot[..., None] * S + torch.einsum("blhk,blhv->bhkv", k_tail,
                                                 vc)
    return torch.stack(ys, dim=1).reshape(B, T, H, hd), S


def _projections(cfg, params: L.Params, x: torch.Tensor,
                 x_prev: torch.Tensor, train: bool = False,
                 env: AxisEnv = LOCAL):
    """Token-shift mix + r, k, v, w, g projections of the rank's heads.
    x, x_prev (..., d) in the compute dtype.  r, k, v, g (..., H_loc, hd)
    in the compute dtype; w (..., H_loc, hd) and u (H_loc, hd) fp32.
    `train` takes the plain decay (no backward exists for the kernel)."""
    nh, hd = dims(cfg, env)
    cdt = L.dtype_of(cfg.compute_dtype)
    mu = env.gather_fsdp(params["mu"], 1, dtype=cdt)
    dx = x_prev - x
    xr, xk, xv, xw, xg = (x + dx * mu[i] for i in range(5))

    def proj(name, inp):
        out = inp @ env.gather_fsdp(params[name], 0, dtype=cdt)
        return out.reshape(out.shape[:-1] + (nh, hd))

    r, k, v, g = (proj(n, t) for n, t in (("wr", xr), ("wk", xk),
                                          ("wv", xv), ("wg", xg)))
    # data-dependent decay (LoRA), fp32 for the exp-exp; the kernel gives
    # a token the same decay in the prefill and in a decode tick
    decay = rwkv_decay_ref if train else kops.rwkv_decay
    w = decay(xw, env.gather_fsdp(params["w_lora_a"], 0).float(),
              env.gather_fsdp(params["w_lora_b"], 0).float(),
              params["w0"].float())
    w = w.reshape(w.shape[:-1] + (nh, hd))
    u = params["u"].float().reshape(nh, hd)
    return r, k, v, w, g, u


def _output(cfg, params: L.Params, y, g, env: AxisEnv = LOCAL):
    """(y * silu(g)) @ wo, with y (..., H_loc, hd) in the compute dtype:
    the rank's partial sum over tp."""
    cdt = L.dtype_of(cfg.compute_dtype)
    y = (y * L._act("swiglu", g)).reshape(g.shape[:-2] + (-1,))
    return y @ env.gather_fsdp(params["wo"], 1, dtype=cdt)


def time_mix(cfg, params: L.Params, x: torch.Tensor, *, train: bool = False,
             chunk: int = 0, env: AxisEnv = LOCAL):
    """Train or prefill forward.  x (B, S, d), whole over tp.  Returns
    (partial (B, S, d), a partial sum over tp, {"wkv": (B, H_loc, hd, hd)
    fp32, "last_x": (B, d)}).  The prefill runs K6; training the
    reference's fp32 forms under autograd, the chunked one when `chunk`
    tiles S in more than one chunk."""
    B, S = x.shape[:2]
    nh, hd = dims(cfg, env)
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, g, u = _projections(cfg, params, x, x_prev, train=train,
                                    env=env)
    S0 = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device)
    if not train:
        y, S1 = kops.wkv6(r, k, v, w, u, S0)
    else:
        form = (functools.partial(wkv6_chunked, chunk=chunk)
                if chunk and S % chunk == 0 and S > chunk else wkv6_scan)
        y, S1 = form(r.float(), k.float(), v.float(), w, u, S0)
        y = y.to(r.dtype)
    return _output(cfg, params, y, g, env), {"wkv": S1, "last_x": x[:, -1]}


def time_mix_decode(cfg, params: L.Params, x: torch.Tensor,
                    state: Dict[str, torch.Tensor], env: AxisEnv = LOCAL):
    """One token: x (B, d); state {"wkv": (B, H_loc, hd, hd) fp32,
    "last_x": (B, d)}, both updated in place.  Returns (partial (B, d), a
    partial sum over tp, state)."""
    r, k, v, w, g, u = _projections(cfg, params, x, state["last_x"],
                                    env=env)
    y, _ = kops.wkv6(r[:, None], k[:, None], v[:, None], w[:, None], u,
                     state["wkv"], out_state=state["wkv"])
    state["last_x"].copy_(x)
    return _output(cfg, params, y[:, 0], g, env), state


def init_decode_state(cfg, batch: int, device,
                      env: AxisEnv = LOCAL) -> Dict[str, torch.Tensor]:
    """Zeroed state: the rank's heads' wkv (batch, H_loc, hd, hd) fp32 and
    the last input (batch, d)."""
    nh, hd = dims(cfg, env)
    return {"wkv": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                               device=device),
            "last_x": torch.zeros((batch, cfg.d_model),
                                  dtype=L.dtype_of(cfg.compute_dtype),
                                  device=device)}


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------


def init_channel_mix(cfg, init: L.Init) -> L.Params:
    d, ff = cfg.d_model, cfg.d_ff
    env = init.env
    wdt = init.weight_dtype(cfg)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    return {"mu": init.ones((2, d), wdt,                 # k, r mixes
                            fsdp_spec(env, 2, 1)).mul_(0.5),
            "wk": init.normal((d, ff), wdt, spec=fsdp_spec(env, 2, 0, 1)),
            "wv": init.normal((ff, d), wdt, out_scale,
                              spec=fsdp_spec(env, 2, 1, 0)),
            "wr": init.normal((d, d), wdt, spec=fsdp_spec(env, 2, 0,
                                                          None))}


def channel_mix(cfg, params: L.Params, x: torch.Tensor,
                x_prev: torch.Tensor, env: AxisEnv = LOCAL):
    """out = sigmoid(xr Wr) * ((relu(xk Wk))^2 Wv).  x, x_prev (T, d),
    whole over tp.  Returns (partial (T, d), the rank's ff slice's
    partial sum over tp, gate): the caller adds gate * (the partials
    combined), as the reference applies the gate after its tp combine.
    Under sequence parallelism at tp > 1 the gate is the rank's SP slice
    of the tokens, (T / tp, d), beside the reduce-scattered partials."""
    cdt = L.dtype_of(cfg.compute_dtype)
    mu = env.gather_fsdp(params["mu"], 1, dtype=cdt)
    dx = x_prev - x
    xk = x + dx * mu[0]
    xr = x + dx * mu[1]
    h = torch.relu(xk @ env.gather_fsdp(params["wk"], 0, dtype=cdt))
    partial = (h * h) @ env.gather_fsdp(params["wv"], 1, dtype=cdt)
    if env.seq_parallel and env.tp > 1:
        t_sp = x.shape[0] // env.tp
        xr = xr[env.tp_index() * t_sp:(env.tp_index() + 1) * t_sp]
    gate = torch.sigmoid(xr @ env.gather_fsdp(params["wr"], 0, dtype=cdt))
    return partial, gate
