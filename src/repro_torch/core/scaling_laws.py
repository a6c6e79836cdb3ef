"""Scaling-law machinery (paper §3.3, C7): the port's own copy of
`repro.core.scaling_laws` (numpy only, no framework).

Three pieces, as in the paper:

  1. **Hyper-parameter scaling** (§3.3.1): power-law fits of optimal batch
     size B(C) and learning rate eta(C) against compute budget C from grid
     -search results — `fit_power_law` + `HyperParamLaw`.
  2. **Loss scaling** (§3.3.2): the "logarithmic inverse" FLOPs-to-loss
     curve  L(C) = a * C^(-b) + L_inf  fitted per architecture family.
  3. **Efficiency lever**: the ratio of compute budgets at which MoE and
     dense reach the SAME loss; the paper reports ~3x, growing with C.

`run_grid` actually trains small models (via a caller-supplied train
function) so the benchmark regenerates Figure 12/13-shaped data on CPU;
the fitting code is exact and unit-tested on synthetic power laws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------


def fit_power_law(x: Sequence[float], y: Sequence[float]
                  ) -> Tuple[float, float]:
    """y = A * x^alpha  ->  (A, alpha), least squares in log space."""
    lx, ly = np.log(np.asarray(x, float)), np.log(np.asarray(y, float))
    alpha, loga = np.polyfit(lx, ly, 1)
    return float(np.exp(loga)), float(alpha)


@dataclasses.dataclass
class HyperParamLaw:
    """B(C) = Ab * C^ab ;  eta(C) = Ae * C^ae   (Figure 12)."""
    batch_coef: float
    batch_exp: float
    lr_coef: float
    lr_exp: float

    @classmethod
    def fit(cls, compute: Sequence[float], best_batch: Sequence[float],
            best_lr: Sequence[float]) -> "HyperParamLaw":
        ab, eb = fit_power_law(compute, best_batch)
        al, el = fit_power_law(compute, best_lr)
        return cls(ab, eb, al, el)

    def batch(self, c: float) -> float:
        return self.batch_coef * c ** self.batch_exp

    def lr(self, c: float) -> float:
        return self.lr_coef * c ** self.lr_exp


@dataclasses.dataclass
class LossLaw:
    """L(C) = a * C^(-b) + L_inf (saturating power law)."""
    a: float
    b: float
    l_inf: float

    def __call__(self, c):
        return self.a * np.asarray(c, float) ** (-self.b) + self.l_inf

    def inverse(self, loss: float) -> float:
        """Compute budget needed to reach `loss`."""
        if loss <= self.l_inf:
            return math.inf
        return ((loss - self.l_inf) / self.a) ** (-1.0 / self.b)

    @classmethod
    def fit(cls, compute: Sequence[float], loss: Sequence[float],
            l_inf_grid: Optional[Sequence[float]] = None) -> "LossLaw":
        c = np.asarray(compute, float)
        y = np.asarray(loss, float)
        best = None
        grid = (np.asarray(l_inf_grid) if l_inf_grid is not None
                else np.linspace(0.0, y.min() * 0.999, 40))
        for _refine in range(3):
            for l_inf in grid:
                resid = y - l_inf
                if (resid <= 0).any():
                    continue
                A, alpha = fit_power_law(c, resid)
                pred = A * c ** alpha + l_inf
                err = float(np.mean((pred - y) ** 2))
                if best is None or err < best[0]:
                    best = (err, A, -alpha, l_inf)
            if best is None:
                break
            step = (grid[1] - grid[0]) if len(grid) > 1 else 0.01
            lo = max(best[3] - step, 0.0)
            grid = np.linspace(lo, min(best[3] + step, y.min() * 0.999), 40)
        assert best is not None, "loss-law fit failed"
        _, A, b, l_inf = best
        return cls(A, b, l_inf)


def efficiency_lever(moe: LossLaw, dense: LossLaw, compute: float) -> float:
    """Compute ratio dense/MoE to reach the loss the MoE reaches at
    `compute` (the paper's ~3x lever, Figure 13)."""
    target = float(moe(compute))
    dense_needed = dense.inverse(target)
    return dense_needed / compute


# ---------------------------------------------------------------------------
# grid runner (used by the scaling-law benchmark to produce real data)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GridResult:
    compute: float
    batch: int
    lr: float
    final_loss: float


def run_grid(train_once: Callable[[int, float, float], float],
             compute_budgets: Sequence[float],
             batches: Sequence[int], lrs: Sequence[float]
             ) -> List[GridResult]:
    """train_once(batch, lr, compute) -> final loss."""
    out = []
    for c in compute_budgets:
        for b in batches:
            for lr in lrs:
                out.append(GridResult(c, b, lr, train_once(b, lr, c)))
    return out


def best_per_budget(results: Sequence[GridResult]
                    ) -> Tuple[List[float], List[float], List[float],
                               List[float]]:
    by_c: Dict[float, GridResult] = {}
    for r in results:
        if r.compute not in by_c or r.final_loss < by_c[r.compute].final_loss:
            by_c[r.compute] = r
    cs = sorted(by_c)
    return (cs, [by_c[c].batch for c in cs], [by_c[c].lr for c in cs],
            [by_c[c].final_loss for c in cs])
