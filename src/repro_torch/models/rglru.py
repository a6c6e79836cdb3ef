"""RG-LRU recurrent block (RecurrentGemma / Griffin) (counterpart of
`repro.models.rglru`) [arXiv:2402.19427].

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(blockdiag(W_a) x_t + b_a)        (recurrence gate)
    i_t = sigmoid(blockdiag(W_x) x_t + b_x)        (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped in the Griffin recurrent block:
    u  = W_in x           (width d_rnn = d_model)
    u' = causal_conv1d_4(u)
    h  = RGLRU(u')
    y  = W_out (h * gelu(W_gate x))

The reference's scan is a `lax.scan` in jnp, not a Pallas kernel, so no
kernel is owed: it runs here as plain PyTorch, under autograd in
training.  `rglru_scan` loops over positions and computes each step as
`decode_step` does (a_t * h + s_t in fp32, s_t = sqrt(max(1 - a_t^2,
1e-12)) * sigmoid(gx_t) * u_t, every term elementwise), so a prefill
leaves the same h bits as the same tokens fed tick by tick wherever the
block's projections give the same rows.  `jax.nn.softplus` is
logaddexp(x, 0) with no threshold, and `jax.nn.gelu` the tanh form
(`grouped_matmul.apply_act`).

Over a (dp, tp) mesh (`env`) the channels are sharded over tp, as the
reference's: `w_in` and `w_gate` column-sharded, `w_out` row-sharded,
the conv, the gate biases and Lambda cut on their channel dim and the
block-diagonal gates on their block dim (N_BLOCKS % tp == 0), so every
gate block lies on one rank and the recurrence needs no collective;
`w_in`, `w_gate` and `w_out` are FSDP-sharded over dp and gathered at
use.  The block returns the rank's partial output, which the caller
combines over tp.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import sharding
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.models import layers as L
from repro_torch.sharding import LOCAL, AxisEnv

N_BLOCKS = 32
CONV_WIDTH = 4
C_SCALE = 8.0


def dims(cfg, env: AxisEnv = LOCAL):
    """(dr, the rank's dr / tp channels, its N_BLOCKS / tp gate blocks, the
    block width dr / N_BLOCKS)."""
    dr = cfg.d_model
    if dr % N_BLOCKS:
        raise ValueError(f"rglru width {dr} is no multiple of {N_BLOCKS}")
    blocks = sharding.divide(N_BLOCKS, env.tp, "rglru gate blocks over tp")
    return dr, dr // env.tp, blocks, dr // N_BLOCKS


def init_rglru(cfg, init: L.Init) -> Dict[str, torch.Tensor]:
    """The reference's leaves, shapes, scales and specs: block-diagonal
    gates of N_BLOCKS blocks, the conv and the gate biases at 0, Lambda a
    linspace(2, 5) (fp32: the reference casts it to fp32 at use; the
    other leaves are cast to the compute dtype at use)."""
    d = cfg.d_model
    dr, _, _, bd = dims(cfg, init.env)
    env = init.env
    wdt = init.weight_dtype(cfg)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    col = sharding.fsdp_spec(env, 2, 0, 1)
    chan = sharding.fsdp_spec(env, 1, None, 0)
    blocks = sharding.fsdp_spec(env, 3, None, 0)
    return {
        "w_in": init.normal((d, dr), wdt, spec=col),
        "w_gate": init.normal((d, dr), wdt, spec=col),
        "w_out": init.normal((dr, d), wdt, out_scale,
                             spec=sharding.fsdp_spec(env, 2, 1, 0)),
        "conv_w": init.normal((CONV_WIDTH, dr), wdt, 0.1,
                              spec=sharding.fsdp_spec(env, 2, None, 1)),
        "conv_b": init.zeros((dr,), wdt, chan),
        "wa": init.normal((N_BLOCKS, bd, bd), wdt, spec=blocks),
        "wx": init.normal((N_BLOCKS, bd, bd), wdt, spec=blocks),
        "ba": init.zeros((dr,), wdt, chan),
        "bx": init.zeros((dr,), wdt, chan),
        "lam": init.const(torch.linspace(2.0, 5.0, dr),
                          L.dtype_of(cfg.param_dtype), chan),
    }


def _gates(params, u: torch.Tensor):
    """u (..., dr_loc) -> the gate logits (a, x) through the rank's
    blocks of the block-diagonal projections, in u's dtype."""
    cdt = u.dtype
    n, bd = params["wa"].shape[-3:-1]
    ub = u.reshape(u.shape[:-1] + (n, bd))
    ga = torch.einsum("...nb,nbc->...nc", ub, params["wa"].to(cdt)) \
        .reshape(u.shape) + params["ba"].to(cdt)
    gx = torch.einsum("...nb,nbc->...nc", ub, params["wx"].to(cdt)) \
        .reshape(u.shape) + params["bx"].to(cdt)
    return ga, gx


def _log_a(params, r: torch.Tensor) -> torch.Tensor:
    lam = params["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    return -C_SCALE * softplus * r


def causal_conv(params, u: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Per-channel causal conv of width 4 over u (B, S, dr_loc), after
    the `state` (B, 3, dr_loc) of the previous inputs (zeros when None).
    Returns (out, the last 3 inputs)."""
    w = params["conv_w"].to(u.dtype)
    b = params["conv_b"].to(u.dtype)
    pad = (torch.zeros(u.shape[:1] + (CONV_WIDTH - 1,) + u.shape[2:],
                       dtype=u.dtype, device=u.device)
           if state is None else state)
    up = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = sum(w[j] * up[:, j:j + S] for j in range(CONV_WIDTH)) + b
    return out, up[:, -(CONV_WIDTH - 1):]


def _step_terms(a_log: torch.Tensor, gx: torch.Tensor, u: torch.Tensor):
    """The recurrence's decay a and input s (fp32), elementwise: h_t =
    a_t * h_{t-1} + s_t."""
    a = torch.exp(a_log)
    x_in = torch.sigmoid(gx) * u
    return a, torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * x_in


def rglru_scan(a_log, gx, u, h0):
    """The linear recurrence over positions: a_log, gx, u (B, S, dr) fp32,
    h0 (B, dr) -> (h (B, S, dr), h at the last position)."""
    a, s = _step_terms(a_log, gx, u)
    h, hs = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + s[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _weights(cfg, params, env: AxisEnv):
    """w_in, w_gate and w_out gathered over dp (FSDP), in the compute
    dtype."""
    cdt = L.dtype_of(cfg.compute_dtype)
    return (env.gather_fsdp(params["w_in"], 0, dtype=cdt),
            env.gather_fsdp(params["w_gate"], 0, dtype=cdt),
            env.gather_fsdp(params["w_out"], 1, dtype=cdt))


def recurrent_block(cfg, params, x: torch.Tensor,
                    state: Optional[Dict[str, torch.Tensor]] = None,
                    env: AxisEnv = LOCAL):
    """Training and prefill: x (B, S, d) -> (out (B, S, d) in the compute
    dtype, the rank's partial sum over tp, and the state {"h" (B, dr_loc)
    fp32, "conv" (B, 3, dr_loc)} after the last position)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    w_in, w_gate, w_out = _weights(cfg, params, env)
    u = x @ w_in
    u, conv_state = causal_conv(params, u,
                                state["conv"] if state else None)
    ga, gx = _gates(params, u)
    a_log = _log_a(params, torch.sigmoid(ga.float()))
    h0 = (state["h"] if state else
          torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                      device=x.device))
    h, h_last = rglru_scan(a_log, gx.float(), u.float(), h0)
    y = h.to(cdt) * _gm.apply_act("gelu", x @ w_gate)
    return y @ w_out, {"h": h_last, "conv": conv_state}


def decode_step(cfg, params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                env: AxisEnv = LOCAL):
    """One token: x (B, d) -> out (B, d), the rank's partial sum over tp;
    `state` {"h", "conv"} (the rank's channels) is updated in place."""
    cdt = L.dtype_of(cfg.compute_dtype)
    w_in, w_gate, w_out = _weights(cfg, params, env)
    u = (x @ w_in)[:, None]
    u, conv_state = causal_conv(params, u, state["conv"])
    u = u[:, 0]
    ga, gx = _gates(params, u)
    a_log = _log_a(params, torch.sigmoid(ga.float()))
    a, s = _step_terms(a_log, gx.float(), u.float())
    h = a * state["h"] + s
    y = h.to(cdt) * _gm.apply_act("gelu", x @ w_gate)
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return y @ w_out


def init_decode_state(cfg, batch: int, device,
                      env: AxisEnv = LOCAL) -> Dict[str, torch.Tensor]:
    """Zeroed state of the rank's dr / tp channels: h (batch, dr_loc)
    fp32 and the conv's last inputs (batch, 3, dr_loc)."""
    _, dr_loc, _, _ = dims(cfg, env)
    return {"h": torch.zeros((batch, dr_loc), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, dr_loc),
                                dtype=L.dtype_of(cfg.compute_dtype),
                                device=device)}
