"""RG-LRU recurrent block (RecurrentGemma / Griffin) at tp=1
(counterpart of `repro.models.rglru`) [arXiv:2402.19427].

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
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.models import layers as L

N_BLOCKS = 32
CONV_WIDTH = 4
C_SCALE = 8.0


def init_rglru(cfg, init: L.Init) -> Dict[str, torch.Tensor]:
    """The reference's leaves, shapes and scales: block-diagonal gates of
    N_BLOCKS blocks, the conv and the gate biases at 0, Lambda a
    linspace(2, 5) (fp32: the reference casts it to fp32 at use; the
    other leaves are cast to the compute dtype at use)."""
    d = dr = cfg.d_model
    bd = dr // N_BLOCKS
    if dr % N_BLOCKS:
        raise ValueError(f"rglru width {dr} is no multiple of {N_BLOCKS}")
    wdt = init.weight_dtype(cfg)
    out_scale = 0.02 / max(cfg.n_layers, 1) ** 0.5
    return {
        "w_in": init.normal((d, dr), wdt),
        "w_gate": init.normal((d, dr), wdt),
        "w_out": init.normal((dr, d), wdt, out_scale),
        "conv_w": init.normal((CONV_WIDTH, dr), wdt, 0.1),
        "conv_b": init.zeros((dr,), wdt),
        "wa": init.normal((N_BLOCKS, bd, bd), wdt),
        "wx": init.normal((N_BLOCKS, bd, bd), wdt),
        "ba": init.zeros((dr,), wdt),
        "bx": init.zeros((dr,), wdt),
        "lam": init.const(torch.linspace(2.0, 5.0, dr),
                          L.dtype_of(cfg.param_dtype)),
    }


def _gates(params, u: torch.Tensor):
    """u (..., dr) -> the gate logits (a, x) through the block-diagonal
    projections, in u's dtype."""
    cdt = u.dtype
    bd = u.shape[-1] // N_BLOCKS
    ub = u.reshape(u.shape[:-1] + (N_BLOCKS, bd))
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
    """Per-channel causal conv of width 4 over u (B, S, dr), after the
    `state` (B, 3, dr) of the previous inputs (zeros when None).  Returns
    (out, the last 3 inputs)."""
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


def recurrent_block(cfg, params, x: torch.Tensor,
                    state: Optional[Dict[str, torch.Tensor]] = None):
    """Training and prefill: x (B, S, d) -> (out (B, S, d) in the compute
    dtype, the state {"h" (B, dr) fp32, "conv" (B, 3, dr)} after the last
    position)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    u = x @ params["w_in"].to(cdt)
    u, conv_state = causal_conv(params, u,
                                state["conv"] if state else None)
    ga, gx = _gates(params, u)
    a_log = _log_a(params, torch.sigmoid(ga.float()))
    h0 = (state["h"] if state else
          torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                      device=x.device))
    h, h_last = rglru_scan(a_log, gx.float(), u.float(), h0)
    y = h.to(cdt) * _gm.apply_act("gelu", x @ params["w_gate"].to(cdt))
    return y @ params["w_out"].to(cdt), {"h": h_last, "conv": conv_state}


def decode_step(cfg, params, x: torch.Tensor, state: Dict[str, torch.Tensor]):
    """One token: x (B, d) -> out (B, d); `state` {"h", "conv"} is updated
    in place."""
    cdt = L.dtype_of(cfg.compute_dtype)
    u = (x @ params["w_in"].to(cdt))[:, None]
    u, conv_state = causal_conv(params, u, state["conv"])
    u = u[:, 0]
    ga, gx = _gates(params, u)
    a_log = _log_a(params, torch.sigmoid(ga.float()))
    a, s = _step_terms(a_log, gx.float(), u.float())
    h = a * state["h"] + s
    y = h.to(cdt) * _gm.apply_act("gelu", x @ params["w_gate"].to(cdt))
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return y @ params["w_out"].to(cdt)


def init_decode_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    dr = cfg.d_model
    return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, dr),
                                dtype=L.dtype_of(cfg.compute_dtype),
                                device=device)}
