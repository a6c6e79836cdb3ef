"""Expert router (paper §3.2.2; counterpart of `repro.core.router`) at
tp=1: fp32 softmax gating with top-k selection and no renormalization,
Eq. (1); for training also the Switch balance loss, the router z-loss
(§3.4.1 coefficients) and the Stochastic Routing Warmup, Eq. (3).

The warmup is split in two: `stochastic_warmup_logits` is the pure mix of
the learned logits with synthesized ones, given the noise `eps`, and
`warmup_noise` draws `eps` from a threefry key as the reference's
`jax.random.normal` does (`models.prng.normal`: JAX's keys and uniforms
bit for bit, its `erf_inv` within a few ulps), so a seeded run routes as
the reference's does except at near-exact ties of the noised logits.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import prng


def init_router(cfg, init) -> Dict[str, torch.Tensor]:
    return {"wr": init.normal((cfg.d_model, cfg.moe.n_experts),
                              getattr(torch, cfg.param_dtype))}


def warmup_noise(keys: torch.Tensor, shape) -> torch.Tensor:
    """eps ~ N(0, 1) fp32 for `stochastic_warmup_logits`: keys (..., 2)
    threefry keys -> (..., *shape), one draw per key, on the keys'
    device."""
    return prng.normal(keys, shape)


def stochastic_warmup_logits(logits: torch.Tensor, step: int,
                             warmup_steps: int,
                             eps: torch.Tensor) -> torch.Tensor:
    """Eq. (3): s_hat = alpha*s + (1-alpha)*(mu_s + sigma_s * eps), with
    mu_s / sigma_s scalar statistics of the logits (no gradient) and
    alpha = min(step / W, 1) in fp32."""
    mu = torch.mean(logits)
    var = torch.mean((logits - mu) ** 2)
    mu = mu.detach()
    sigma = torch.sqrt(var + 1e-6).detach()
    alpha = float(min(np.float32(step) / np.float32(max(warmup_steps, 1)),
                      np.float32(1.0)))
    return alpha * logits + (1.0 - alpha) * (mu + sigma * eps)


def route(cfg, params, x: torch.Tensor, *, train: bool = False,
          step: Optional[int] = None, eps: Optional[torch.Tensor] = None):
    """x (T, d) -> (top_w (T, k) fp32, top_i (T, k)), Eq. (1).

    With `train` it returns (top_w, top_i, aux, metrics): aux is the
    weighted balance + z loss (a 0-d fp32 tensor) and metrics the four
    `router/*` values, all on x's device.  The warmup mix applies when
    `eps` (T, E) is given and the config has warmup steps, as the
    reference applies it when given an rng."""
    m = cfg.moe
    if train:
        logits = x.float() @ params["wr"].float()         # (T, E)
    else:
        # serving: the fp64 sum rounded once to fp32, so a row's logits do
        # not depend on how many rows the call has (an fp32 cuBLAS product
        # picks its summation order by the row count)
        logits = (x.double() @ params["wr"].double()).float()
    if train and eps is not None and m.router_warmup_steps > 0:
        logits = stochastic_warmup_logits(logits, step,
                                          m.router_warmup_steps, eps)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, m.top_k, dim=-1)
    if not train:
        return top_w, top_i
    E = m.n_experts
    hits = torch.zeros_like(probs).scatter_(1, top_i, 1.0)   # (T, E)
    f = torch.mean(hits, dim=0) / m.top_k                 # fraction routed
    p_mean = torch.mean(probs, dim=0)
    balance = E * torch.sum(f * p_mean)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = m.balance_loss_coef * balance + m.z_loss_coef * z
    metrics = {"router/balance_loss": balance,
               "router/z_loss": z,
               "router/max_expert_frac": torch.max(f),
               "router/min_expert_frac": torch.min(f)}
    return top_w, top_i, aux, metrics
