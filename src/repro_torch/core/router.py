"""Expert router (paper §3.2.2), inference path (counterpart of
`repro.core.router`): fp32 softmax gating with top-k selection and no
renormalization.  The aux losses and the stochastic routing warmup belong
to training and arrive with the training slice."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def init_router(cfg, init) -> Dict[str, torch.Tensor]:
    return {"wr": init.normal((cfg.d_model, cfg.moe.n_experts),
                              getattr(torch, cfg.param_dtype))}


def route(cfg, params, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (top_w (T, k) fp32, top_i (T, k)), Eq. (1)."""
    logits = x.float() @ params["wr"].float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    return torch.topk(probs, cfg.moe.top_k, dim=-1)
