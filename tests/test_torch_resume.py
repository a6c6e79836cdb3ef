"""Exact resume of the port's Trainer: a run checkpointed mid-warmup and
restored into a fresh Trainer gives the unbroken run's losses, params,
moments and guard state bit for bit (both warmups active: the router's
noise and the batch-size warmup's accum stages); a checkpoint written by
the JAX package's Trainer continues in the port and matches the JAX
Trainer's unbroken tail; the launcher saves and resumes on the CPU.

Tolerances: a resume within the port is bitwise (the CPU step is
deterministic).  The JAX-written checkpoint's tail is held to the bars of
`test_torch_trainer.py::test_trajectory_matches_reference_trainer`:
losses 1e-5 relative, grad norms 1e-4, params within 1e-5 everywhere and
1e-6 for all but 1e-4 of each leaf's elements."""
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.data.pipeline import DataPipeline as JPipe
from repro.data.pipeline import PipelineConfig as JPipeCfg
from repro.launch.mesh import make_local_mesh
from repro.optim import schedule as JSCH
from repro.training.trainer import TrainConfig as JTrainConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch import api as tapi
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.core import spikes as TS
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw
from repro_torch.optim.schedule import AccumWarmup, WSDSchedule
from repro_torch.training.trainer import TrainConfig, Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bw(Warm):
    return Warm(microbatch=2, start=2, end=8, warmup_steps=4, increments=2)


def _trainer(ck, steps, every, bs_warmup=True, cfg=None):
    cfg = cfg or tcfg("ling-lite")
    return Trainer(tapi.Runner(cfg, device="cpu"),
                   DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                               seq_len=16, batch_size=2)),
                   TrainConfig(n_steps=steps,
                               lr_schedule=WSDSchedule(max_lr=1e-3,
                                                       warmup_steps=2,
                                                       total_steps=100),
                               bs_warmup=_bw(AccumWarmup) if bs_warmup
                               else None,
                               accum_steps=2, log_every=2, seed=0,
                               checkpoint_dir=str(ck),
                               checkpoint_every=every))


def _state(tr):
    return (adamw.leaves(tr.params) + adamw.leaves(tr.opt_state)
            + adamw.leaves(tr.guard_state))


@pytest.mark.parametrize("bs_warmup,steps,every",
                         [(True, 6, 3), (False, 8, 4)])
def test_mid_warmup_resume_is_bitwise(tmp_path, bs_warmup, steps, every):
    cfg = tcfg("ling-lite")
    assert cfg.moe.router_warmup_steps == 4    # noise active before step 4
    ck = tmp_path / "ck"
    a = _trainer(ck, steps, every, bs_warmup)
    hist_a = a.train()
    a.close()
    b = _trainer(ck, steps, every, bs_warmup)
    assert b.restore(f"step_{every}") == f"step_{every}"
    assert b.step == every
    if bs_warmup:
        assert b._accum == _bw(AccumWarmup).accum_for(every) == 2
    hist_b = b.train(steps)
    b.close()
    assert [h["step"] for h in hist_b] == list(range(every, steps))
    tail_a = [(h["loss"], h["grad_norm"]) for h in hist_a
              if h["step"] >= every]
    assert [(h["loss"], h["grad_norm"]) for h in hist_b] == tail_a
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)
    # restore("latest") picks the newest complete checkpoint
    c = _trainer(ck, steps, every, bs_warmup)
    assert c.restore("latest") == f"step_{steps}"
    assert c.step == steps
    c.close()


def test_restore_without_a_checkpoint_raises(tmp_path):
    tr = _trainer(tmp_path / "none", 2, 0)
    with pytest.raises(FileNotFoundError):
        tr.restore()
    tr.close()
    cfg = tcfg("ling-lite")
    bare = Trainer(tapi.Runner(cfg, device="cpu"),
                   DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                               seq_len=8, batch_size=1)),
                   TrainConfig(n_steps=0))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        bare.save("x")


def _convert_host_state(jstate):
    """The JAX Trainer's sidecar for the port: the same step, stage,
    pipeline state and packed batches; the detector's events become the
    port's SpikeEvent."""
    det = dict(jstate["detector"])
    det["events"] = [TS.SpikeEvent(e.step, e.loss, e.kind, e.action)
                     for e in det["events"]]
    return dict(jstate, detector=det)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """The JAX Trainer runs 6 steps (both warmups, fp32), saving at 3; the
    port restores its step_3 (array leaves through the port's PCache.load)
    and runs 3..5: the JAX Trainer's tail within the trajectory bars."""
    steps, every = 6, 3
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype="float32")
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype="float32")
    ck = tmp_path / "ck"
    sched = dict(max_lr=1e-3, warmup_steps=4, total_steps=100)
    jt = JTrainer(japi.Runner(jc, make_local_mesh(1, 1), max_seq=32),
                  JPipe(JPipeCfg(vocab_size=jc.vocab_size, seq_len=32,
                                 batch_size=2, seed=0)),
                  JTrainConfig(n_steps=steps,
                               lr_schedule=JSCH.WSDSchedule(**sched),
                               bs_warmup=_bw(JSCH.AccumWarmup), log_every=2,
                               seed=0, checkpoint_dir=str(ck),
                               checkpoint_every=every))
    try:
        jh = jt.train()
    finally:
        jt.close()
    # the sidecar in the port's classes, next to the JAX-written leaves
    with open(ck / f"step_{every}" / "host_state.pkl", "rb") as f:
        host = _convert_host_state(pickle.load(f))
    with open(ck / f"step_{every}" / "host_state.pkl", "wb") as f:
        pickle.dump(host, f)
    tt = Trainer(tapi.Runner(tc, device="cpu"),
                 DataPipeline(PipelineConfig(vocab_size=tc.vocab_size,
                                             seq_len=32, batch_size=2)),
                 TrainConfig(n_steps=steps,
                             lr_schedule=WSDSchedule(**sched),
                             bs_warmup=_bw(AccumWarmup), log_every=2,
                             seed=0, checkpoint_dir=str(ck)))
    try:
        assert tt.restore(f"step_{every}") == f"step_{every}"
        th = tt.train()
    finally:
        tt.close()
    tail = [r for r in jh if r["step"] >= every]
    assert [r["step"] for r in th] == [r["step"] for r in tail]
    assert not any(r["skipped"] for r in th + tail)
    for rj, rt in zip(tail, th):
        assert rt["lr"] == rj["lr"]
        np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=1e-5)
        np.testing.assert_allclose(rt["grad_norm"], rj["grad_norm"],
                                   rtol=1e-4)
    jp = [np.asarray(x) for x in jax.tree.leaves(jt.params)]
    tp = [x.detach().numpy() for x in adamw.leaves(tt.params)]
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        d = np.abs(b - a)
        assert d.max() <= 1e-5, float(d.max())
        assert (d > 1e-6).mean() <= 1e-4, int((d > 1e-6).sum())
    assert int(tt.opt_state["count"]) == int(jt.opt_state["count"]) == steps


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--checkpoint-dir", ck, "--checkpoint-every", "2"]
    tlaunch.main(args + ["--steps", "2"])
    assert os.path.exists(os.path.join(ck, "step_2", "manifest.json"))
    capsys.readouterr()
    tlaunch.main(args + ["--steps", "4", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step_2 at step 2" in out
    assert "final loss:" in out and "nan" not in out.split("final loss:")[1]
    assert os.path.exists(os.path.join(ck, "step_4", "manifest.json"))
    with pytest.raises(SystemExit):
        tlaunch.main(["--smoke", "--device", "cpu", "--resume"])
