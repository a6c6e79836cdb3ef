"""AdamW (counterpart of `repro.optim.adamw`).

Paper recipe (§3.4.1): beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
global-norm gradient clipping at 1.0.  Parameters and moments are fp32
tensors in the reference's nested-dict layout; `apply_updates` runs
under `torch.no_grad()` and writes them in place (the reference returns
new arrays and donates the old buffers).  Moments take the parameters'
sharding, so the update is local; over a mesh the raw gradients are
reduced first (`reduce_replicated_grads`) and the global norm counts a
replicated leaf once (`global_grad_norm` with the spec tree).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import sharding
from repro_torch.sharding import LOCAL, AxisEnv, P

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


def opt_state_specs(param_specs) -> Dict[str, Any]:
    """The moments take the parameters' specs; the count is
    replicated."""
    return {"m": param_specs, "v": param_specs, "count": P()}


@torch.no_grad()
def reduce_replicated_grads(grads: List[torch.Tensor],
                            specs: Sequence[P], env: AxisEnv = LOCAL):
    """In place: each raw gradient (in `leaves` order, beside its spec)
    divided by N = dp * tp, then summed over every mesh axis its spec
    leaves out.  Every rank seeds the cotangent of its own copy of the
    loss, so the collectives' transposes give N times the true gradient;
    a leaf replicated over an axis then receives the sum of its copies'
    partials (the DP all-reduce, generalized), while a dim sharded over
    an axis is exact after the division.  A no-op at one rank."""
    n = env.dp * env.tp
    if n == 1:
        return grads
    groups = {"dp": env.mesh.dp_group, "tp": env.mesh.tp_group}
    for g, spec in zip(grads, specs):
        g.div_(float(n))
        missing = [a for a in ("dp", "tp") if a not in spec
                   and groups[a].size > 1]
        if len(missing) == 2:
            g.copy_(env.mesh.world.all_reduce(g))
        elif missing:
            g.copy_(groups[missing[0]].all_reduce(g))
    return grads


def global_grad_norm(grads: List[torch.Tensor],
                     specs: Optional[Sequence[P]] = None,
                     env: AxisEnv = LOCAL) -> torch.Tensor:
    """L2 norm over every leaf, fp32, summed leaf by leaf in order.  Over
    a mesh (with the leaves' `specs`) a leaf held by several ranks counts
    once: its sum of squares is divided by its replication, and the
    ranks' sums are added over the mesh."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for i, g in enumerate(grads):
        rep = (sharding.replication(specs[i], env) if specs is not None
               else 1)
        part = total if rep == 1 else torch.zeros_like(total)
        for s in g.reshape(-1).split(_SLICE):
            s = s.float()
            part = part + torch.dot(s, s)
        total = part if rep == 1 else total + part / rep
    return torch.sqrt(env.psum_all(total))


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
