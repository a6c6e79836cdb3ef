"""The port's framework-free paper modules against the JAX package's, on
the same inputs: the scaling-law fits (§3.3: power laws, the saturating
loss law, the MoE/dense efficiency lever, the grid helpers), the
heterogeneous-device cost model (Table 1, §1.3's ~20 % saving) and the
inverse-square-root annealing (§3.4.3).  Both sides run the same numpy
or stdlib arithmetic, so results are held equal (the annealing within
one fp32 rounding: the reference's `__call__` evaluates in fp32)."""
import dataclasses

import numpy as np
import pytest

from repro.core import hetero as JH
from repro.core import scaling_laws as JSL
from repro.optim import schedule as JSCH
from repro_torch.core import hetero as TH
from repro_torch.core import scaling_laws as TSL
from repro_torch.optim import schedule as TSCH


def _law_fields(law):
    return dataclasses.astuple(law)


def test_power_law_and_hyperparameter_law_fits():
    rs = np.random.RandomState(0)
    c = np.logspace(18, 21, 8)
    b = 0.42 * c ** 0.33 * np.exp(0.05 * rs.randn(8))
    lr = 3e-2 * c ** -0.12 * np.exp(0.05 * rs.randn(8))
    assert TSL.fit_power_law(c, b) == JSL.fit_power_law(c, b)
    jl, tl = JSL.HyperParamLaw.fit(c, b, lr), TSL.HyperParamLaw.fit(c, b, lr)
    assert _law_fields(tl) == _law_fields(jl)
    for x in (1e18, 3e19, 1e22):
        assert tl.batch(x) == jl.batch(x) and tl.lr(x) == jl.lr(x)


@pytest.mark.parametrize("grid", [None, [0.0, 0.5, 1.0, 1.4]])
def test_loss_law_fit_inverse_and_lever(grid):
    rs = np.random.RandomState(1)
    c = np.logspace(18, 21, 10)
    y = JSL.LossLaw(a=2e3, b=0.2, l_inf=1.5)(c) * (1 + 1e-3 * rs.randn(10))
    jl, tl = JSL.LossLaw.fit(c, y, grid), TSL.LossLaw.fit(c, y, grid)
    assert _law_fields(tl) == _law_fields(jl)
    np.testing.assert_array_equal(tl(c), jl(c))
    for loss in (1.2, 1.6, 2.5):
        assert tl.inverse(loss) == jl.inverse(loss)
    dense = dict(a=2e3 * 3 ** 0.2, b=0.2, l_inf=1.5)
    for x in (1e19, 1e20, 1e21):
        assert TSL.efficiency_lever(tl, TSL.LossLaw(**dense), x) == \
            JSL.efficiency_lever(jl, JSL.LossLaw(**dense), x)


def test_grid_runner_and_best_per_budget():
    def train_once(batch, lr, compute):
        return 2.0 + abs(np.log(lr / 1e-3)) + abs(batch - 64) / 64 \
            - 0.1 * np.log10(compute)

    args = ([1e18, 1e19], [32, 64, 128], [3e-4, 1e-3, 3e-3])
    jr, tr = JSL.run_grid(train_once, *args), TSL.run_grid(train_once, *args)
    assert [dataclasses.astuple(r) for r in tr] == \
        [dataclasses.astuple(r) for r in jr]
    assert TSL.best_per_budget(tr) == JSL.best_per_budget(jr)


def test_hetero_cost_model_matches_reference():
    assert {k: dataclasses.astuple(v) for k, v in TH.DEVICES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JH.DEVICES.items()}
    for tokens in (1e11, TH.TOKENS_1T):
        assert TH.savings_report(tokens) == JH.savings_report(tokens)
        for name in TH.DEVICES:
            assert TH.cost_rmb(TH.DEVICES[name], tokens) == \
                JH.cost_rmb(JH.DEVICES[name], tokens)
    sched = {"A": 0.5, "C": 0.3, "E": 0.2}
    assert TH.MixedSchedule(sched).cost() == JH.MixedSchedule(sched).cost()
    assert TH.MixedSchedule(sched).hours_by_device() == \
        JH.MixedSchedule(sched).hours_by_device()
    for kw in ({}, {"need_fp8": True}, {"memory_needed_gb": 90}):
        assert TH.best_single_device(**kw).name == \
            JH.best_single_device(**kw).name
    rep = TH.savings_report()
    assert rep["high_perf_cost_mrmb"] == pytest.approx(6.35, rel=0.05)
    assert 0.15 <= rep["savings_frac"] <= 0.35


def test_inv_sqrt_annealing_matches_reference():
    kw = dict(lr_start=1.2e-4, lr_end=1.2e-8, steps=1000)
    js, ts = JSCH.InvSqrtAnnealing(**kw), TSCH.InvSqrtAnnealing(**kw)
    steps = list(range(0, 1001, 37)) + [1000, 5000]
    # host evaluation: the same float64 arithmetic
    assert [ts(t) for t in steps] == [js.host(t) for t in steps]
    assert [ts.host(t) for t in steps] == [js.host(t) for t in steps]
    # the reference's __call__ evaluates in fp32
    np.testing.assert_allclose([ts(t) for t in steps],
                               [float(js(t)) for t in steps], rtol=2e-7)
    lrs = [ts(t) for t in range(0, 1001, 100)]
    assert lrs[0] == pytest.approx(1.2e-4)
    assert lrs[-1] == pytest.approx(1.2e-8, rel=0.01)
    assert all(a >= b for a, b in zip(lrs, lrs[1:]))
