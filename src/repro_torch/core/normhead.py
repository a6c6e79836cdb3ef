"""NormHead (paper §3.2.3, Eq. 4): LM-head rows L2-normalized before the
logit product, in fp32 (counterpart of `repro.core.normhead`).  The row
norm is over d_model, whole on every rank of a vocab-sharded head, so it
costs no communication; an FSDP-sharded head is gathered over dp (its
d dim) first."""
from __future__ import annotations

import torch

from repro_torch.sharding import LOCAL, AxisEnv


def normalize_rows(w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L2-normalize rows (vocab entries) of a (V, d) head weight, fp32."""
    wf = w.float()
    norm = torch.sqrt(torch.sum(wf * wf, dim=-1, keepdim=True))
    return wf / norm.clamp_min(eps)


def normhead_logits(cfg, w: torch.Tensor, x: torch.Tensor,
                    env: AxisEnv = LOCAL) -> torch.Tensor:
    """x (T, d) -> the rank's vocab rows' logits (T, V / tp) fp32 (a plain
    fp32 head when cfg.norm_head is False)."""
    w = env.gather_fsdp(w, 1)
    wn = normalize_rows(w) if cfg.norm_head else w.float()
    return x.float() @ wn.T
