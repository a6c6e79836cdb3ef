"""AdamW at tp=1 (counterpart of `repro.optim.adamw`).

Paper recipe (§3.4.1): beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
global-norm gradient clipping at 1.0.  Parameters and moments are fp32
tensors in the reference's nested-dict layout; `apply_updates` runs
under `torch.no_grad()` and writes them in place (the reference returns
new arrays and donates the old buffers).  At tp=1 no leaf is replicated,
so the global norm counts every leaf once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

# elements per slice of a leaf in `apply_updates`: bounds the update's
# temporaries to a few times 256 MB whatever the leaf's size
_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree) -> List[torch.Tensor]:
    """Leaves in the reference's pytree order (`jax.tree.leaves`: sorted
    dict keys, list entries in index order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, list):
        return [t for node in tree for t in leaves(node)]
    return [tree]


def init_opt_state(params) -> Dict[str, Any]:
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zeros(v) for v in tree]
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    device = leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every leaf, fp32, summed leaf by leaf in order."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        g = g.reshape(-1)
        for s in g.split(_SLICE):
            s = s.float()
            total = total + torch.dot(s, s)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads: List[torch.Tensor], state,
                  lr: float, cfg: AdamWConfig = AdamWConfig(), *,
                  grad_scale: Optional[torch.Tensor] = None,
                  commit: Optional[torch.Tensor] = None):
    """One AdamW step, in place.  `grads` follow `leaves(params)` order;
    `grad_scale` multiplies them (the clip factor).  `commit` (a 0-d bool
    tensor) gates the whole update on the device: where it is False every
    parameter, moment and the count keep their old values, with no read
    on the host.  Returns (params, state)."""
    count = state["count"] + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for p, g, m, v in zip(leaves(params), grads, leaves(state["m"]),
                          leaves(state["v"])):
        for ps, gs, ms, vs in zip(*(t.view(-1).split(_SLICE)
                                    for t in (p, g, m, v))):
            gs = gs.float()
            if grad_scale is not None:
                gs = gs * grad_scale
            new_m = b1 * ms + (1 - b1) * gs
            new_v = b2 * vs + (1 - b2) * gs * gs
            step = (new_m / c1) / (torch.sqrt(new_v / c2) + cfg.eps)
            pf = ps.float()
            new_p = (pf - lr * (step + cfg.weight_decay * pf)).to(p.dtype)
            if commit is not None:
                new_p = torch.where(commit, new_p, ps)
                new_m = torch.where(commit, new_m, ms)
                new_v = torch.where(commit, new_v, vs)
            ps.copy_(new_p)
            ms.copy_(new_m)
            vs.copy_(new_v)
    if commit is not None:
        count = torch.where(commit, count, state["count"])
    state["count"].copy_(count)
    return params, state
