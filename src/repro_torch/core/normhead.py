"""NormHead (paper §3.2.3, Eq. 4): LM-head rows L2-normalized before the
logit product, in fp32 (counterpart of `repro.core.normhead`)."""
from __future__ import annotations

import torch


def normalize_rows(w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L2-normalize rows (vocab entries) of a (V, d) head weight, fp32."""
    wf = w.float()
    norm = torch.sqrt(torch.sum(wf * wf, dim=-1, keepdim=True))
    return wf / norm.clamp_min(eps)


def normhead_logits(cfg, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (T, d) -> logits (T, V) fp32 (a plain fp32 head when
    cfg.norm_head is False)."""
    wn = normalize_rows(w) if cfg.norm_head else w.float()
    return x.float() @ wn.T
