"""RWKV6 ("Finch") time-mix and channel-mix blocks at tp=1 (counterpart
of `repro.models.rwkv6`) [arXiv:2404.05892].

Attention-free linear-recurrence block with a data-dependent decay: the
per-channel decay w_t comes from the token itself through a low-rank
(LoRA) projection.  The recurrence runs on K6 (`kernels.ops.wkv6`) in the
prefill (T = prompt) and in every decode tick (T = 1, state updated in
place); the reference's chunked jnp formulation (`wkv6_chunked`) belongs
to the rwkv6 training slice.  The decay itself runs on its own kernel
(`kernels.ops.rwkv_decay`), which gives a token the same decay in the
prefill and in a decode tick.

Serving storage (`Init.masters` False): the leaves the reference casts to
the compute dtype at use (`mu`, the r/k/v/g/o projections, the channel
mix) are stored in that dtype; the decay LoRA, `w0` and `u`, which the
reference casts to fp32, stay fp32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

LORA_RANK = 32


def dims(cfg) -> Tuple[int, int]:
    """(heads, head_dim) of the time mix (no tp padding at tp=1)."""
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_time_mix(cfg, init: L.Init) -> L.Params:
    d = cfg.d_model
    nh, hd = dims(cfg)
    dp = nh * hd
    wdt = init.weight_dtype(cfg)
    f32 = L.dtype_of(cfg.param_dtype)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    return {
        # token-shift interpolation coefficients, r,k,v,w,g
        "mu": 0.5 * init.ones((5, d), wdt),
        "wr": init.normal((d, dp), wdt),
        "wk": init.normal((d, dp), wdt),
        "wv": init.normal((d, dp), wdt),
        "wg": init.normal((d, dp), wdt),
        "wo": init.normal((dp, d), wdt, out_scale),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w_lora_a": init.normal((d, LORA_RANK), f32),
        "w_lora_b": init.normal((LORA_RANK, dp), f32),
        "w0": -6.0 * init.ones((dp,), f32),
        "u": init.normal((dp,), f32, 0.5),           # bonus ("faaaa")
    }


def _projections(cfg, params: L.Params, x: torch.Tensor,
                 x_prev: torch.Tensor):
    """Token-shift mix + r, k, v, w, g projections.  x, x_prev (..., d) in
    the compute dtype.  r, k, v, g (..., H, hd) in the compute dtype; w
    (..., H, hd) and u (H, hd) fp32."""
    nh, hd = dims(cfg)
    cdt = L.dtype_of(cfg.compute_dtype)
    mu = params["mu"].to(cdt)
    dx = x_prev - x
    xr, xk, xv, xw, xg = (x + dx * mu[i] for i in range(5))

    def proj(name, inp):
        out = inp @ params[name].to(cdt)
        return out.reshape(out.shape[:-1] + (nh, hd))

    r, k, v, g = (proj(n, t) for n, t in (("wr", xr), ("wk", xk),
                                          ("wv", xv), ("wg", xg)))
    # data-dependent decay (LoRA), fp32 for the exp-exp; the kernel gives
    # a token the same decay in the prefill and in a decode tick
    w = kops.rwkv_decay(xw, params["w_lora_a"].float(),
                        params["w_lora_b"].float(), params["w0"].float())
    w = w.reshape(w.shape[:-1] + (nh, hd))
    u = params["u"].float().reshape(nh, hd)
    return r, k, v, w, g, u


def _output(cfg, params: L.Params, y, g):
    """(y * silu(g)) @ wo, with y (..., H, hd) in the compute dtype."""
    cdt = L.dtype_of(cfg.compute_dtype)
    y = (y * L._act("swiglu", g)).reshape(g.shape[:-2] + (-1,))
    return y @ params["wo"].to(cdt)


def time_mix(cfg, params: L.Params, x: torch.Tensor):
    """Prefill forward.  x (B, S, d).  Returns (partial (B, S, d),
    {"wkv": (B, H, hd, hd) fp32, "last_x": (B, d)})."""
    B = x.shape[0]
    nh, hd = dims(cfg)
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, g, u = _projections(cfg, params, x, x_prev)
    S0 = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device)
    y, S1 = kops.wkv6(r, k, v, w, u, S0)
    return _output(cfg, params, y, g), {"wkv": S1, "last_x": x[:, -1]}


def time_mix_decode(cfg, params: L.Params, x: torch.Tensor,
                    state: Dict[str, torch.Tensor]):
    """One token: x (B, d); state {"wkv": (B, H, hd, hd) fp32, "last_x":
    (B, d)}, both updated in place.  Returns (partial (B, d), state)."""
    r, k, v, w, g, u = _projections(cfg, params, x, state["last_x"])
    y, _ = kops.wkv6(r[:, None], k[:, None], v[:, None], w[:, None], u,
                     state["wkv"], out_state=state["wkv"])
    state["last_x"].copy_(x)
    return _output(cfg, params, y[:, 0], g), state


def init_decode_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    nh, hd = dims(cfg)
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
    wdt = init.weight_dtype(cfg)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    return {"mu": 0.5 * init.ones((2, d), wdt),       # k, r mixes
            "wk": init.normal((d, ff), wdt),
            "wv": init.normal((ff, d), wdt, out_scale),
            "wr": init.normal((d, d), wdt)}


def channel_mix(cfg, params: L.Params, x: torch.Tensor,
                x_prev: torch.Tensor):
    """out = sigmoid(xr Wr) * ((relu(xk Wk))^2 Wv).  x, x_prev (T, d).
    Returns (partial (T, d), gate (T, d)); the caller adds gate * partial
    (the reference applies the gate after its tp combine)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    mu = params["mu"].to(cdt)
    dx = x_prev - x
    xk = x + dx * mu[0]
    xr = x + dx * mu[1]
    h = torch.relu(xk @ params["wk"].to(cdt))
    partial = (h * h) @ params["wv"].to(cdt)
    gate = torch.sigmoid(xr @ params["wr"].to(cdt))
    return partial, gate
