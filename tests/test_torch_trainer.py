"""The port's training engine against the JAX package: AdamW with and
without the commit gate, the device spike guard, the schedules, the data
pipeline's batches, and the trajectory gate — six optimizer steps of the
port's `Trainer` against the reference's `Trainer` from the same
`init_params(0)`, with the batch-size warmup taking accum 1 -> 2 -> 4 and
the spike guard on.  Also the launcher at smoke size on the CPU and the
telemetry's host-only contract.

Tolerances: fp32 compute throughout, so the two packages differ in fp32
summation order only.  The losses are held to 1e-5 relative and the grad
norms to 1e-4.  AdamW divides each gradient element by its own running
magnitude (m / sqrt(v)), which turns a rounding difference of an element
whose gradient is within rounding of 0 (a rarely seen token's embedding
row) into an update difference of a fraction of the learning rate.  So
the final parameters are held to 1e-6 absolute for all but 1e-4 of each
leaf's elements, and every element to 1e-5 (1% of the run's largest
learning rate, 1e-3).  The trajectory runs with the router warmup off
and with it active for 4 of the 6 steps: the port draws the warmup's
noise under the reference's threefry key schedule (keys bit for bit,
normals within a few ulps), so both route alike."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.core import spikes as JS
from repro.data.pipeline import DataPipeline as JPipe
from repro.data.pipeline import PipelineConfig as JPipeCfg
from repro.launch.mesh import make_local_mesh
from repro.optim import adamw as JA
from repro.optim import schedule as JSCH
from repro.training.trainer import TrainConfig as JTrainConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.core import spikes as TS
from repro_torch.data.pipeline import DataPipeline as TPipe
from repro_torch.data.pipeline import PipelineConfig as TPipeCfg
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedule as TSCH
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.xputimer import XPUTimer
from repro_torch.training.trainer import TrainConfig as TTrainConfig
from repro_torch.training.trainer import Trainer as TTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rs):
    return {"a": rs.randn(3, 5).astype(np.float32),
            "b": {"c": rs.randn(7).astype(np.float32)}}


@pytest.mark.parametrize("commit", [None, True, False])
def test_apply_updates_matches_reference(commit):
    """Two AdamW steps (count 1 and 2, clip scale 0.5) on the same
    params, grads and lr."""
    rs = np.random.RandomState(0)
    params, g1, g2 = _tree(rs), _tree(rs), _tree(rs)
    jp = jax.tree.map(jnp.asarray, params)
    js = JA.init_opt_state(jp)
    tp = jax.tree.map(torch.tensor, params)
    ts = TA.init_opt_state(tp)
    jc = None if commit is None else jnp.asarray(commit)
    tc = None if commit is None else torch.tensor(commit)
    for g in (g1, g2):
        jp, js = JA.apply_updates(jp, jax.tree.map(jnp.asarray, g), js,
                                  jnp.float32(1e-2), grad_scale=0.5,
                                  commit=jc)
        TA.apply_updates(tp, [torch.tensor(x) for x in TA.leaves(g)], ts,
                         1e-2, grad_scale=torch.tensor(0.5), commit=tc)
    for a, b in zip(jax.tree.leaves(jp) + jax.tree.leaves(js["m"])
                    + jax.tree.leaves(js["v"]),
                    TA.leaves(tp) + TA.leaves(ts["m"]) + TA.leaves(ts["v"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-9)
    assert int(ts["count"]) == int(js["count"])
    if commit is False:
        np.testing.assert_array_equal(TA.leaves(tp)[0].numpy(), params["a"])


@pytest.mark.parametrize("gnorm_sigma", [None, 2.0])
def test_guard_commit_sequence_matches_reference(gnorm_sigma):
    """A loss stream with a spike, a non-finite loss and a grad-norm
    spike, through both guards: the same commits and states."""
    cfg_j = JS.SpikeConfig(warmup_steps=3, gnorm_sigma_threshold=gnorm_sigma)
    cfg_t = TS.SpikeConfig(warmup_steps=3, gnorm_sigma_threshold=gnorm_sigma)
    js, ts = JS.init_guard_state(cfg_j), TS.init_guard_state(cfg_t)
    assert set(js) == set(ts)
    losses = [5.0, 4.9, 4.8, 4.7, 9.0, 4.6, float("nan"), 4.5, 4.45]
    gnorms = [1.0, 1.1, 0.9, 1.0, 1.0, 1.0, 1.0, 50.0, 1.0]
    for loss, gn in zip(losses, gnorms):
        jcommit, js = JS.guard_commit(cfg_j, js, jnp.float32(loss),
                                      gnorm=jnp.float32(gn))
        tcommit, ts = TS.guard_commit(cfg_t, ts, torch.tensor(loss),
                                      gnorm=torch.tensor(gn))
        assert bool(tcommit) == bool(jcommit), (loss, gn)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, err_msg=k)


def test_schedules_match_reference():
    wj = JSCH.WSDSchedule(max_lr=1e-3, warmup_steps=50, total_steps=60)
    wt = TSCH.WSDSchedule(max_lr=1e-3, warmup_steps=50, total_steps=60)
    assert [wt(i) for i in range(70)] == [wj.host(i) for i in range(70)]
    aj = JSCH.AccumWarmup(microbatch=2, start=2, end=8, warmup_steps=4,
                          increments=2)
    at = TSCH.AccumWarmup(microbatch=2, start=2, end=8, warmup_steps=4,
                          increments=2)
    assert at.stages() == aj.stages() == (1, 2, 4)
    assert [at.accum_for(i) for i in range(8)] == \
        [aj.accum_for(i) for i in range(8)]
    bj = JSCH.BatchSizeWarmup(start=6, end=24, warmup_steps=6, increments=3)
    bt = TSCH.BatchSizeWarmup(start=6, end=24, warmup_steps=6, increments=3)
    assert [bt(i) for i in range(8)] == [bj(i) for i in range(8)]
    with pytest.raises(ValueError, match="multiple"):
        TSCH.AccumWarmup(microbatch=4, start=6, end=8)


def test_pipeline_batches_identical_to_reference():
    """Same seed, same batches: plain, macrobatches, and a retried
    macrobatch regranulated across a stage change."""
    mk = lambda Pipe, Cfg: Pipe(Cfg(vocab_size=512, seq_len=24,
                                    batch_size=2, seed=3,
                                    retry_injection_prob=1.0))
    j, t = mk(JPipe, JPipeCfg), mk(TPipe, TPipeCfg)
    seq = [1, 2, 1, 4]
    for i, a in enumerate(seq):
        bj, bt = j.next_macrobatch(a), t.next_macrobatch(a)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(bt[k], bj[k])
        if i == 1:                     # a skipped accum-2 batch, retried
            j.push_retry(bj, 2)
            t.push_retry(bt, 2)
    assert t.stats == j.stats


def _trainers(steps=6, warmup=0):
    """The reference's Trainer and the port's, same config and weights,
    the router warmup over `warmup` steps."""
    jc = jcfg("ling-lite")
    jc = dataclasses.replace(jc, compute_dtype="float32", moe=dataclasses
                             .replace(jc.moe, router_warmup_steps=warmup))
    tc = tcfg("ling-lite")
    tc = dataclasses.replace(tc, compute_dtype="float32", moe=dataclasses
                             .replace(tc.moe, router_warmup_steps=warmup))
    jrun = japi.Runner(jc, make_local_mesh(1, 1), max_seq=32)
    ref = jax.tree.map(np.asarray, jrun.init_params(0))

    def tcfg_(Cfg, Sched, Warm):
        return Cfg(n_steps=steps,
                   lr_schedule=Sched.WSDSchedule(max_lr=1e-3, warmup_steps=4,
                                                 total_steps=100),
                   bs_warmup=Warm(microbatch=2, start=2, end=8,
                                  warmup_steps=4, increments=2),
                   log_every=2, seed=0)
    jt = JTrainer(jrun, JPipe(JPipeCfg(vocab_size=jc.vocab_size, seq_len=32,
                                       batch_size=2, seed=0)),
                  tcfg_(JTrainConfig, JSCH, JSCH.AccumWarmup))
    tt = TTrainer(tapi.Runner(tc, device="cpu"),
                  TPipe(TPipeCfg(vocab_size=tc.vocab_size, seq_len=32,
                                 batch_size=2, seed=0)),
                  tcfg_(TTrainConfig, TSCH, TSCH.AccumWarmup))
    # the reference's initial weights (the moments start at 0 either way)
    tt.params = interop.params_from_numpy(ref, tc, device="cpu",
                                          masters=True)
    return jt, tt


@pytest.mark.parametrize("warmup", [0, 4])
def test_trajectory_matches_reference_trainer(warmup):
    jt, tt = _trainers(warmup=warmup)
    try:
        jh, th = jt.train(), tt.train()
    finally:
        jt.close()
        tt.close()
    assert [r["step"] for r in th] == list(range(6))
    assert not any(r["skipped"] for r in th + jh)
    assert set(th[0]) == set(jh[0])
    for rj, rt in zip(jh, th):
        assert rt["lr"] == rj["lr"]
        np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=1e-5)
        np.testing.assert_allclose(rt["grad_norm"], rj["grad_norm"],
                                   rtol=1e-4)
    jp = {k: np.asarray(v) for k, v in _flat(jt.params).items()}
    tp = {k: v.detach().numpy() for k, v in _flat(tt.params).items()}
    assert set(jp) == set(tp)
    for k in jp:
        d = np.abs(tp[k] - jp[k])
        assert d.max() <= 1e-5, (k, float(d.max()))
        assert (d > 1e-6).mean() <= 1e-4, (k, int((d > 1e-6).sum()))
    # the run moved the params: the gate compares trajectories, not inits
    assert np.abs(tp["/blocks/moe/we1"]
                  - jax.tree.map(np.asarray, jt.runner.init_params(0))
                  ["blocks"]["moe"]["we1"]).max() > 1e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_train_launcher_on_the_cpu(capsys):
    tlaunch.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch",
                  "2", "--seq", "16", "--accum", "2"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "nan" not in out.split("final loss:")[1]


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--edit-workers", "2"],
                                  ["--trace-out", "x"]])
def test_train_launcher_refuses_paths_not_yet_ported(flag):
    with pytest.raises(SystemExit):
        tlaunch.main(["--smoke", "--device", "cpu"] + flag)


def test_telemetry_takes_host_values_only():
    reg = MetricsRegistry()
    with pytest.raises(TypeError, match="host-side"):
        reg.gauge("g").set(torch.tensor(1.0))
    timer = XPUTimer(registry=reg)
    with timer.span("step"), timer.device_span("step", torch.device("cpu")):
        pass
    timer.collect_device()             # a CPU device records no span
    assert set(timer.diagnose()["spans"]) == {"step"}
    assert reg.snapshot()["xputimer_span_ms"]["values"]
