"""The port's scheduler policies against the JAX package's, on converted
smoke Ling-Lite weights (fp32 compute, where streams are bit for bit):
decode-priority never starves in-flight decoders, prefill-priority bounds
the head request's TTFT, tenant budgets gate admission, the bounded queue
sheds or defers exactly at its limit, and switching policies at run time
changes no stream.  Where the reference counts compiles, these tests
hold the admission logs and streams to the JAX engine's instead."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.launch.mesh import make_local_mesh
from repro.serving.online import OnlineConfig as JConfig
from repro.serving.online import OnlineEngine as JEngine
from repro.serving.online import OnlineRequest as JRequest
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.serving.online import OnlineConfig, OnlineEngine, \
    OnlineRequest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX runner, its params), (port runner, converted params)."""
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype="float32")
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype="float32")
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=64)
    jparams = runner.init_params(0)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tc, device="cpu")
    return ((runner, jparams, JEngine, JConfig, JRequest),
            (tapi.Runner(tc, device="cpu"), tparams, OnlineEngine,
             OnlineConfig, OnlineRequest))


def _prompt(seed, n, vocab):
    return np.random.RandomState(seed).randint(0, vocab, n).astype(np.int32)


def _starvation_run(side, policy):
    """A decoding long request against an arriving page-hungry prompt in a
    pool too small for both to grow freely."""
    runner, params, Engine, Config, Request = side
    v = runner.cfg.vocab_size
    eng = Engine(runner, params, Config(max_slots=2, max_context=32,
                                        page_size=8, n_pages=5,
                                        prefill_chunk=4, policy=policy))
    a = Request(rid=0, prompt=_prompt(0, 6, v), max_new=16)
    eng.submit(a)
    while a.state != "decode":
        eng.tick()
    b = Request(rid=1, prompt=_prompt(1, 23, v), max_new=1)
    eng.submit(b)
    eng.run(max_ticks=500)
    assert a.done and b.done and len(a.out) == 16 and len(b.out) == 1
    return a, b, eng


def test_decode_priority_never_starves_decoders(pair):
    ref, port = pair
    a_f, b_f, e_f = _starvation_run(port, "fcfs")
    assert a_f.n_preempted > 0
    a_d, b_d, eng = _starvation_run(port, "decode-priority")
    assert a_d.n_preempted == 0
    assert eng.n_preemptions == b_d.n_preempted
    assert a_d.out == a_f.out
    for policy, (a, b, e) in (("fcfs", (a_f, b_f, e_f)),
                              ("decode-priority", (a_d, b_d, eng))):
        ja, jb, je = _starvation_run(ref, policy)
        assert (a.out, b.out) == (ja.out, jb.out)
        assert e.admission_log == je.admission_log
        assert (a.n_preempted, b.n_preempted) == (ja.n_preempted,
                                                  jb.n_preempted)


def _ttft_ticks(side, policy):
    """Ticks from a long-prompt head request's submission to its first
    token, with every other slot decoding."""
    runner, params, Engine, Config, Request = side
    v = runner.cfg.vocab_size
    eng = Engine(runner, params, Config(max_slots=4, max_context=64,
                                        page_size=8, prefill_chunk=4,
                                        policy=policy))
    decoders = [Request(rid=i, prompt=_prompt(i, 2, v), max_new=40)
                for i in range(3)]
    eng.submit_many(decoders)
    while not all(d.state == "decode" for d in decoders):
        eng.tick()
    head = Request(rid=10, prompt=_prompt(10, 16, v), max_new=2)
    eng.submit(head)
    ticks = 0
    while not head.out:
        eng.tick()
        ticks += 1
        assert ticks < 100
    eng.run(max_ticks=1000)
    return ticks, [d.out for d in decoders] + [head.out]


def test_prefill_priority_bounds_head_of_queue_ttft(pair):
    ref, port = pair
    fcfs, out_f = _ttft_ticks(port, "fcfs")
    pp, out_p = _ttft_ticks(port, "prefill-priority")
    assert pp <= 2 and fcfs >= 4 and pp < fcfs
    assert out_p == out_f                  # the policy moves time, not tokens
    assert (fcfs, out_f) == _ttft_ticks(ref, "fcfs")
    assert (pp, out_p) == _ttft_ticks(ref, "prefill-priority")


def _budget_run(side):
    runner, params, Engine, Config, Request = side
    v = runner.cfg.vocab_size
    eng = Engine(runner, params, Config(max_slots=4, max_context=32,
                                        page_size=8, prefill_chunk=4,
                                        tenant_budgets={"t1": 24}))
    reqs = [Request(rid=i, prompt=_prompt(i, 4, v), max_new=4, tenant="t1")
            for i in range(4)]
    reqs.append(Request(rid=9, prompt=_prompt(9, 4, v), max_new=4,
                        tenant="t2"))
    eng.submit_many(reqs)
    eng.tick()
    first = (list(eng.admission_log), eng.n_budget_skips, reqs[3].state)
    eng.run(max_ticks=500)
    assert all(r.done for r in reqs)
    return first, list(eng.admission_log), [r.out for r in reqs]


def test_tenant_budgets_enforced_at_admission(pair):
    ref, port = pair
    (log1, skips, state3), log, outs = _budget_run(port)
    assert log1 == [0, 1, 2, 9]
    assert skips >= 1 and state3 == "queued"
    assert log.index(3) > log.index(9)
    (jlog1, jskips, _), jlog, jouts = _budget_run(ref)
    assert (log1, skips, log, outs) == (jlog1, jskips, jlog, jouts)


def test_saturation_gate_sheds_exactly_at_max_queue(pair):
    _, port = pair
    runner, params, *_ = port
    v = runner.cfg.vocab_size
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=2, max_context=32, page_size=8, prefill_chunk=4,
        max_queue=2, overload="shed"))
    oks = [eng.submit(OnlineRequest(rid=i, prompt=_prompt(i, 4, v),
                                    max_new=2)) for i in range(3)]
    assert oks == [True, True, False]
    assert eng.n_shed == 1
    shed = OnlineRequest(rid=99, prompt=_prompt(99, 4, v), max_new=2)
    assert not eng.submit(shed)
    assert shed.state == "shed" and eng.n_shed == 2
    assert 99 not in eng.reqs
    eng.run(max_ticks=200)
    assert eng.reqs[0].done and eng.reqs[1].done
    with pytest.raises(RuntimeError, match="saturation gate"):
        eng.submit_many([OnlineRequest(rid=i, prompt=_prompt(i, 4, v),
                                       max_new=2) for i in range(20, 24)])


def test_saturation_gate_defer_allows_retry(pair):
    _, port = pair
    runner, params, *_ = port
    v = runner.cfg.vocab_size
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=2, max_context=32, page_size=8, prefill_chunk=4,
        max_queue=1, overload="defer"))
    assert eng.submit(OnlineRequest(rid=0, prompt=_prompt(0, 4, v),
                                    max_new=2))
    late = OnlineRequest(rid=1, prompt=_prompt(1, 4, v), max_new=2)
    assert not eng.submit(late)
    assert late.state == "queued" and eng.n_shed == 0
    while not eng.submit(late):
        eng.tick()
    eng.run(max_ticks=200)
    assert late.done


def _switch_run(side):
    runner, params, Engine, Config, Request = side
    v = runner.cfg.vocab_size
    eng = Engine(runner, params, Config(max_slots=4, max_context=32,
                                        page_size=8, n_pages=7,
                                        prefill_chunk=4))
    rid, outs = 0, []
    for policy in ("fcfs", "decode-priority", "prefill-priority", "fcfs"):
        eng.set_policy(policy)
        reqs = [Request(rid=rid + i, prompt=_prompt(rid + i, 4 + i % 5, v),
                        max_new=4 + i % 5) for i in range(6)]
        rid += 6
        eng.submit_many(reqs)
        eng.run(max_ticks=2000)
        assert all(r.done for r in reqs)
        outs += [r.out for r in reqs]
    eng.alloc.check_invariants()
    return eng, outs


def test_policy_switch_matches_reference(pair):
    """One engine cycles through every policy under churn (admission,
    preemption, radix eviction, completion): the port's admissions,
    preemptions and streams are the JAX engine's."""
    ref, port = pair
    eng, outs = _switch_run(port)
    jeng, jouts = _switch_run(ref)
    assert eng.n_preemptions == jeng.n_preemptions > 0
    assert eng.admission_log == jeng.admission_log
    assert outs == jouts
    with pytest.raises(ValueError, match="policy"):
        eng.set_policy("sjf")


def test_invalid_policy_and_gate_config_rejected(pair):
    _, port = pair
    runner, params, *_ = port
    bad = (dict(policy="round-robin"), dict(overload="drop"),
           dict(max_queue=0))
    for kw, word in zip(bad, ("policy", "overload", "max_queue")):
        with pytest.raises(ValueError, match=word):
            OnlineEngine(runner, params,
                         OnlineConfig(max_slots=2, max_context=32, **kw))


def test_poisson_load_with_tenants_and_shedding(pair):
    _, port = pair
    runner, params, *_ = port
    from repro_torch.serving.online import run_poisson_load
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=2, max_context=32, page_size=8, prefill_chunk=4,
        max_queue=1, overload="shed", tenant_budgets={"a": 12}))
    rep = run_poisson_load(eng, rate=1e6, n_requests=6, prompt_len=4,
                           max_new=3, vocab_size=runner.cfg.vocab_size,
                           seed=1, tenants=["a", "b"])
    assert rep["shed"] >= 1
    assert rep["tokens_out"] == 3 * (6 - rep["shed"])
    assert rep["policy"] == "fcfs" and eng.idle
