"""The port's debug sync guards (`analysis.contracts`, the counterpart of
the part of `repro.analysis.contracts` that PyTorch has a use for)
against the reference's: `env_debug_guards` on the same environment,
case for case with tests/test_contracts.py, the engines' `debug_guards`
defaults, `transfer_guard` as a no-op without a card, and an online
engine under churn (preemption, the radix cache) whose streams are the
same with the guards on as off.

On a CUDA card only: `transfer_guard` raises on a device->host sync and
lets an announced drain pass, and the engine's ticks, plain and
speculative, run under it at smoke size with the streams unchanged.
The card-only tests import no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch.analysis import contracts
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.serving.draft import SelfDrafter
from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                        OnlineRequest)
from repro_torch.training.trainer import TrainConfig, Trainer

CHURN = dict(max_slots=4, max_context=32, page_size=8, n_pages=7,
             prefill_chunk=4)


def _reference():
    """The reference's contracts module, imported here so the card-only
    tests need no JAX."""
    from repro.analysis import contracts as jcontracts
    return jcontracts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("raw,default", [
    (None, False), (None, True), ("1", False), ("off", False),
    ("true", False), (" YES ", False), ("on", False), ("0", True),
    ("", True)])
def test_env_debug_guards(monkeypatch, raw, default):
    """The reference's cases (unset, default True, "1", "off") and the
    other spellings, the port's answer equal to the reference's."""
    if raw is None:
        monkeypatch.delenv("REPRO_DEBUG_GUARDS", raising=False)
    else:
        monkeypatch.setenv("REPRO_DEBUG_GUARDS", raw)
    got = contracts.env_debug_guards(default=default)
    assert got == _reference().env_debug_guards(default=default)
    want = (default if raw is None
            else raw.strip().lower() in ("1", "true", "yes", "on"))
    assert got is want


def test_trainer_and_engine_expose_debug_guards(monkeypatch):
    """Config plumbing: None defers to the env var when the engine or
    trainer is built; an explicit value wins."""
    from repro.serving.online import OnlineConfig as JOnlineConfig
    from repro.training.trainer import TrainConfig as JTrainConfig
    assert OnlineConfig(max_slots=2, max_context=32).debug_guards is None
    assert TrainConfig().debug_guards is None
    assert JOnlineConfig(max_slots=2, max_context=32).debug_guards is None
    assert JTrainConfig().debug_guards is None
    runner = tapi.Runner(tcfg("ling-lite"), device="cpu")
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    pipe = DataPipeline(PipelineConfig(vocab_size=512, seq_len=8,
                                       batch_size=1))
    for raw, want in (("1", True), ("0", False)):
        monkeypatch.setenv("REPRO_DEBUG_GUARDS", raw)
        eng = OnlineEngine(runner, None, OnlineConfig(**CHURN))
        assert eng.debug_guards is want
        assert Trainer(runner, pipe, TrainConfig(n_steps=0)).debug_guards \
            is want
        eng = OnlineEngine(runner, None, OnlineConfig(
            **CHURN, debug_guards=not want))
        assert eng.debug_guards is (not want)


def test_transfer_guard_is_a_no_op_without_a_card(monkeypatch):
    """Without CUDA, as on JAX's CPU backend, every level lets host
    reads through; an unknown level raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.arange(4.0) * 3
    for level in ("allow", "log", "disallow", "disallow_explicit"):
        with contracts.transfer_guard(level):
            assert x.sum().item() == 18.0
            assert x.cpu().numpy().tolist() == [0.0, 3.0, 6.0, 9.0]
            with contracts.announced_drain():
                assert bool(x[1] == 3.0)
    with pytest.raises(ValueError, match="level"):
        with contracts.transfer_guard("forbid"):
            pass
    assert set(contracts.LEVELS) == {"allow", "log", "disallow",
                                     "disallow_explicit"}


def _requests(vocab):
    rs = np.random.RandomState(1)
    return [OnlineRequest(rid=i, prompt=rs.randint(0, vocab, 4 + (i % 5))
                          .astype(np.int32), max_new=8 + (i % 9))
            for i in range(13)]


def _streams(runner, params, guards, **kw):
    eng = OnlineEngine(runner, params, OnlineConfig(
        **{**CHURN, **kw}, debug_guards=guards),
        drafter=SelfDrafter(1) if kw.get("spec_k") else None)
    reqs = _requests(runner.cfg.vocab_size)
    eng.submit_many(reqs)
    eng.run(max_ticks=3000)
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs], eng


def test_engine_under_churn_same_streams_with_guards():
    """13 ragged requests through a 4-slot pool that preempts: the
    guarded engine emits the streams of the unguarded one."""
    runner = tapi.Runner(tcfg("ling-lite"), device="cpu")
    params = runner.init_params(0)
    off, _ = _streams(runner, params, False)
    on, eng = _streams(runner, params, True)
    assert eng.debug_guards and eng.n_preemptions > 0
    assert on == off


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_transfer_guard_raises_on_a_sync_on_the_card():
    """Armed, a device->host read raises and an announced drain passes;
    the previous mode comes back on exit, also after an error."""
    _need_cuda()
    x = torch.arange(4.0, device="cuda") * 3
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with contracts.transfer_guard("disallow"):
        assert torch.cuda.get_sync_debug_mode() == 2
        for read in (lambda: x.cpu(), lambda: x.sum().item(),
                     lambda: bool(x[0] == 0),
                     lambda: torch.from_numpy(np.ones(3)).to("cuda")):
            with pytest.raises(RuntimeError):
                read()
        with contracts.announced_drain():
            assert x.cpu().tolist() == [0.0, 3.0, 6.0, 9.0]
        assert torch.cuda.get_sync_debug_mode() == 2
        y = (x * 2).sum()                     # device work stays legal
    assert torch.cuda.get_sync_debug_mode() == prev
    assert y.item() == 36.0
    with contracts.transfer_guard("log"):
        assert torch.cuda.get_sync_debug_mode() == 1
    with pytest.raises(RuntimeError):
        with contracts.transfer_guard("disallow"):
            x.cpu()
    assert torch.cuda.get_sync_debug_mode() == prev


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_ticks_run_under_the_guard_on_the_card(spec_k):
    """Smoke Ling-Lite on the kernels, the churn workload with and
    without speculation: every tick under the guard (a sync other than
    the announced drains raises), the streams unchanged."""
    _need_cuda()
    cfg = dataclasses.replace(tcfg("ling-lite"), n_layers=2)
    runner = tapi.Runner(cfg, device="cuda")
    params = runner.init_params(0)
    off, _ = _streams(runner, params, False, spec_k=spec_k)
    on, eng = _streams(runner, params, True, spec_k=spec_k)
    assert eng.debug_guards and eng.n_preemptions > 0
    assert on == off
