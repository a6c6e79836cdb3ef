"""The port's serving telemetry (own copies of `repro.telemetry`'s
metrics registry, request log, SLO tracker and trace export, and the
OnlineEngine's instrumentation): the reference's tests/test_telemetry.py
case by case against the port, where a device-value rejection takes a
torch.Tensor for the jax value and the engine's compile and transfer
guards (XLA contracts) have no counterpart; and against the reference
itself: the Prometheus text on the same observations, the SLOTracker's
decisions on the same observation sequence, and the engine's request log
((event, rid, slot, tick, arg) records) on the same workload with
converted fp32 weights."""
import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import telemetry as JT
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
from repro_torch.telemetry import (MetricsRegistry, MetricsServer,
                                   RequestLog, SLOConfig, SLOTracker,
                                   XPUTimer, chrome_trace,
                                   write_chrome_trace)
from repro_torch.telemetry.metrics import Histogram, Series
from repro_torch.telemetry.xputimer import FULL_RECORD_BYTES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runner_params():
    runner = tapi.Runner(tcfg("ling-lite"), device="cpu")
    return runner, runner.init_params(0)


def _churn_reqs(make, vocab):
    rs = np.random.RandomState(1)
    return [make(rid=i, prompt=rs.randint(0, vocab, 4 + (i % 5))
                 .astype(np.int32), max_new=8 + (i % 9))
            for i in range(13)]


CHURN = dict(max_slots=4, max_context=32, page_size=8, n_pages=7,
             prefill_chunk=4)


def churn_engine(runner, params, **cfg_kw):
    """13-request ragged run through a 4-slot pool sized to preempt."""
    eng = OnlineEngine(runner, params, OnlineConfig(**CHURN, **cfg_kw))
    reqs = _churn_reqs(OnlineRequest, runner.cfg.vocab_size)
    eng.submit_many(reqs)
    eng.run(max_ticks=3000)
    return eng, reqs


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------


def test_counter_gauge_basics_and_labels():
    reg = MetricsRegistry()
    c = reg.counter("serve_shed_total", "sheds", reason="slo")
    c.inc()
    c.inc(2)
    assert reg.counter("serve_shed_total", reason="slo") is c
    other = reg.counter("serve_shed_total", reason="queue")
    assert other is not c and other.value == 0
    assert c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("queue_depth")
    g.set(4)
    g.add(-1)
    assert g.value == 3
    with pytest.raises(ValueError):
        reg.gauge("serve_shed_total")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_registry_rejects_tensors(device):
    """The zero-host-sync contract is structural: a tensor (on any
    device) raises before any float() could wait for the device."""
    reg = MetricsRegistry()
    x = torch.tensor(1.5, device=device)
    with pytest.raises(TypeError, match="host-side scalars only"):
        reg.counter("c").inc(x)
    with pytest.raises(TypeError, match="host-side scalars only"):
        reg.gauge("g").set(x)
    with pytest.raises(TypeError, match="host-side scalars only"):
        reg.histogram("h").observe(x)
    with pytest.raises(TypeError, match="host-side scalars only"):
        reg.series("s").sample(x, t_us=0)
    reg.counter("c").inc(np.float64(2.0))
    assert reg.counter("c").value == 2.0


def test_histogram_buckets_and_windowed_percentiles():
    h = Histogram(buckets=(1.0, 10.0, 100.0), window=4)
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    assert h.cumulative() == [(1.0, 1), (10.0, 2), (100.0, 3),
                              (float("inf"), 4)]
    assert h.count == 4 and h.sum == pytest.approx(555.5)
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    assert h.window_count() == 4
    assert h.percentile(0) == 1.0
    assert h.percentile(100) == 4.0
    assert h.percentile(50) == pytest.approx(2.5)
    assert h.cumulative()[-1] == (float("inf"), 8)


def test_series_ring_wraps_chronologically():
    s = Series("queue_depth", capacity=4)
    for i in range(6):
        s.sample(float(i), t_us=100 + i)
    assert len(s) == 4
    assert s.points() == [(102, 2.0), (103, 3.0), (104, 4.0), (105, 5.0)]


def test_prometheus_exposition_format():
    reg = MetricsRegistry()
    reg.counter("serve_enqueued_total", "requests accepted").inc(7)
    reg.histogram("serve_ttft_ms", "ttft", buckets=(1.0, 10.0)).observe(5.0)
    reg.series("page_pool_occupancy").sample(3, t_us=1)
    text = reg.render_prometheus()
    assert "# TYPE serve_enqueued_total counter" in text
    assert "serve_enqueued_total 7" in text
    assert "# HELP serve_enqueued_total requests accepted" in text
    assert 'serve_ttft_ms_bucket{le="1"} 0' in text
    assert 'serve_ttft_ms_bucket{le="10"} 1' in text
    assert 'serve_ttft_ms_bucket{le="+Inf"} 1' in text
    assert "serve_ttft_ms_sum 5" in text
    assert "serve_ttft_ms_count 1" in text
    assert "page_pool_occupancy" not in text
    reg.histogram("serve_ttft_ms", buckets=(1.0, 10.0)).observe(0.5)
    cum = reg.histogram("serve_ttft_ms", buckets=(1.0, 10.0)).cumulative()
    assert [c for _, c in cum] == sorted(c for _, c in cum)


def _observe_all(mod_registry):
    """One scripted sequence of observations on a fresh registry."""
    reg = mod_registry()
    rs = np.random.RandomState(0)
    for i in range(40):
        reg.counter("serve_tokens_total", "tokens").inc(int(rs.randint(4)))
        reg.counter("serve_shed_total", "sheds",
                    reason=("slo", "queue")[i % 2]).inc()
        reg.gauge("serve_queue_depth", "depth").set(float(rs.randint(9)))
        reg.gauge("loss").add(float(rs.rand()) - 0.5)
        reg.histogram("serve_ttft_ms", "ttft").observe(
            float(rs.exponential(200.0)))
        reg.histogram("xputimer_span_ms", "span", span=f"s{i % 3}",
                      buckets=(0.5, 3.0)).observe(float(rs.rand() * 5))
        reg.series("queue_depth").sample(float(i), t_us=i)
    return reg


def test_prometheus_text_equals_the_references():
    got, want = _observe_all(MetricsRegistry), _observe_all(
        JT.MetricsRegistry)
    assert got.render_prometheus() == want.render_prometheus()
    assert got.snapshot() == want.snapshot()


# ---------------------------------------------------------------------------
# RequestLog
# ---------------------------------------------------------------------------


def test_request_log_lifecycle_and_per_rid_query():
    rlog = RequestLog(ring_size=64)
    rlog.record("enqueue", rid=7, tick=0, t_us=10)
    rlog.record("admit", rid=7, slot=2, tick=1, arg=5, t_us=20)
    rlog.record("enqueue", rid=8, tick=1, t_us=25)
    rlog.record("complete", rid=7, slot=2, tick=9, arg=4, t_us=90)
    assert rlog.counts() == {"enqueue": 2, "admit": 1, "complete": 1}
    evs = rlog.events_for(7)
    assert [e["event"] for e in evs] == ["enqueue", "admit", "complete"]
    assert evs[1]["slot"] == 2 and evs[1]["arg"] == 5
    assert rlog.events_for(99) == []
    with pytest.raises(KeyError):
        rlog.record("not_an_event", rid=0)


def test_request_log_ring_wraps_chronologically():
    rlog = RequestLog(ring_size=8)
    for i in range(20):
        rlog.record("decode", rid=i, t_us=1000 + i)
    assert rlog.n_records == 8
    recs = rlog.records()
    assert list(recs["rid"]) == list(range(12, 20))
    assert list(recs["t_us"]) == [1012 + i for i in range(8)]
    assert rlog.memory_bytes() == 8 * recs.itemsize


# ---------------------------------------------------------------------------
# XPUTimer
# ---------------------------------------------------------------------------


def test_xputimer_span_two_thread_hammer():
    timer = XPUTimer(ring_size=1 << 14)
    N = 2000
    errs = []

    def hammer(name):
        try:
            for _ in range(N):
                with timer.span(name):
                    pass
                with timer.span("shared"):
                    pass
        except Exception as e:       # pragma: no cover - failure path
            errs.append(e)

    ts = [threading.Thread(target=hammer, args=(f"t{i}",)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert timer.stats["shared"].count == 2 * N
    assert timer.stats["t0"].count == N and timer.stats["t1"].count == N
    assert timer.n_records == 4 * N
    names = timer.span_names()
    assert len(names) == len(set(names)) == 3


def test_xputimer_memory_accounting_shares_record_count():
    timer = XPUTimer(ring_size=16)
    for _ in range(40):
        with timer.span("s"):
            pass
    assert timer.n_records == 16
    assert timer.full_tracing_bytes() == 16 * FULL_RECORD_BYTES
    assert timer.memory_bytes() == 16 * timer.ring.itemsize + 64
    assert timer.full_tracing_bytes() / timer.memory_bytes() > 5.0
    recs = timer.records()
    assert len(recs) == 16 and list(recs["t0"]) == sorted(recs["t0"])


def test_xputimer_publishes_into_registry():
    reg = MetricsRegistry()
    timer = XPUTimer(registry=reg)
    with timer.span("tick"):
        pass
    timer.count("commits", 3)
    timer.gauge("commit_frac", 0.5)
    h = reg.get("xputimer_span_ms", span="tick")
    assert h is not None and h.count == 1
    assert reg.get("xputimer_counter_total", counter="commits").value == 3
    assert reg.get("xputimer_gauge", gauge="commit_frac").value == 0.5


# ---------------------------------------------------------------------------
# SLOTracker
# ---------------------------------------------------------------------------


def test_slo_config_validation():
    with pytest.raises(ValueError):
        SLOConfig(ttft_p99_ms=0)
    with pytest.raises(ValueError):
        SLOConfig(ttft_p99_ms=10, itl_p99_ms=-1)
    with pytest.raises(ValueError):
        SLOConfig(ttft_p99_ms=10, headroom=0)


def test_slo_tracker_gate_arms_after_min_observations():
    reg = MetricsRegistry()
    slo = SLOTracker(SLOConfig(ttft_p99_ms=100.0, min_observations=4,
                               window=16), reg)
    assert slo.should_shed(queued_prompt_tokens=10_000,
                           prefill_chunk=8) is None
    for _ in range(4):
        slo.observe_tick(10.0)
    assert slo.should_shed(80, 8) is None
    reason = slo.should_shed(800, 8)
    assert reason is not None and "ttft_estimate" in reason
    for _ in range(4):
        slo.observe_ttft(500.0)
    reason = slo.should_shed(8, 8)
    assert reason is not None and "ttft_p99" in reason
    slo.on_shed()
    snap = slo.snapshot()
    assert snap["shed"] == 1 and snap["ttft_deadline_ms"] == 100.0


def test_slo_tracker_itl_deadline():
    reg = MetricsRegistry()
    slo = SLOTracker(SLOConfig(ttft_p99_ms=1e6, itl_p99_ms=5.0,
                               min_observations=2, window=8), reg)
    for _ in range(2):
        slo.observe_tick(0.1)
        slo.observe_itl(50.0)
    reason = slo.should_shed(1, 8)
    assert reason is not None and "itl_p99" in reason


def test_slo_tracker_makes_the_references_decisions():
    """The same observation sequence through both trackers: every
    should_shed answer (reason text included) and the snapshots agree."""
    kw = dict(ttft_p99_ms=120.0, itl_p99_ms=30.0, window=32,
              min_observations=5, headroom=1.25)
    trackers = (SLOTracker(SLOConfig(**kw), MetricsRegistry()),
                JT.SLOTracker(JT.SLOConfig(**kw), JT.MetricsRegistry()))
    rs = np.random.RandomState(3)
    answers = ([], [])
    for _ in range(300):
        op = rs.randint(4)
        v = float(rs.exponential(25.0))
        q, chunk = int(rs.randint(1, 400)), int(rs.choice([4, 8, 64]))
        count_shed = rs.rand() < 0.5
        for t, out in zip(trackers, answers):
            if op == 0:
                t.observe_tick(v)
            elif op == 1:
                t.observe_ttft(4 * v)
            elif op == 2:
                t.observe_itl(v)
            out.append(t.should_shed(q, chunk))
            if out[-1] is not None and count_shed:
                t.on_shed()
    assert answers[0] == answers[1]
    assert any(a is None for a in answers[0])
    assert {a.split()[0] for a in answers[0] if a} == {
        "ttft_estimate", "ttft_p99", "itl_p99"}
    assert trackers[0].snapshot() == trackers[1].snapshot()


# ---------------------------------------------------------------------------
# the engine: metrics, lifecycle log, SLO gate
# ---------------------------------------------------------------------------


def test_engine_telemetry_under_churn_keeps_contracts(runner_params):
    """The fully instrumented engine: the lifecycle log is complete and
    the registry mirrors it (the reference's compile and transfer guards
    have no counterpart: nothing here is traced, and the telemetry reads
    only host values, which the registry enforces)."""
    runner, params = runner_params
    eng, reqs = churn_engine(runner, params)
    assert all(r.done for r in reqs)
    assert eng.n_preemptions > 0
    counts = eng.rlog.counts()
    assert counts["enqueue"] == 13
    assert counts["complete"] == 13
    assert counts["first_token"] == 13
    assert 13 <= counts["prefill_done"] <= counts["admit"]
    assert counts["admit"] == 13 + counts["requeue"]
    assert counts["preempt"] == counts["requeue"] == eng.n_preemptions
    assert counts.get("evict", 0) == eng.alloc.stats["evictions"]
    for rid in (0, 7, 12):
        evs = [e["event"] for e in eng.rlog.events_for(rid)]
        assert evs[0] == "enqueue" and evs[-1] == "complete"
        assert "first_token" in evs
    reg = eng.registry
    assert reg.get("serve_enqueued_total").value == 13
    assert reg.get("serve_completed_total").value == 13
    assert reg.get("serve_preemptions_total").value == eng.n_preemptions
    assert reg.get("serve_cache_evictions_total").value \
        == eng.alloc.stats["evictions"]
    assert reg.get("serve_tokens_total").value \
        == sum(len(r.out) for r in reqs)
    assert reg.get("serve_ttft_ms").count == 13
    assert reg.get("serve_ttft_ms").percentile(99) > 0
    assert reg.get("serve_tick_ms").count == eng.ticks
    assert reg.get("serve_itl_ms").count > 0
    assert reg.get("xputimer_span_ms", span="tick").count == eng.ticks
    assert len(reg.series("queue_depth")) == eng.ticks
    assert len(reg.series("page_pool_occupancy")) == eng.ticks
    occ = [v for _, v in reg.series("page_pool_occupancy").points()]
    assert max(occ) <= eng.alloc.n_pages
    assert all(r.admit_t is not None and r.finish_t >= r.admit_t
               for r in reqs)


def test_engine_request_log_equals_the_references():
    """The churn workload (preemption, radix hits) through the port's and
    the reference's engines on converted fp32 weights: the same
    (event, rid, slot, tick, arg) records in the same order, and the
    same counters."""
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype="float32")
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype="float32")
    jrunner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                          seq_parallel=False, max_seq=64)
    jparams = jrunner.init_params(0)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tc, device="cpu")
    logs, regs = [], []
    for eng, make in (
            (JEngine(jrunner, jparams, JConfig(**CHURN)), JRequest),
            (OnlineEngine(tapi.Runner(tc, device="cpu"), tparams,
                          OnlineConfig(**CHURN)), OnlineRequest)):
        reqs = _churn_reqs(make, tc.vocab_size)
        eng.submit_many(reqs)
        eng.run(max_ticks=3000)
        recs = eng.rlog.records()
        logs.append([tuple(int(r[k]) for k in ("ev", "rid", "slot", "tick",
                                               "arg")) for r in recs])
        regs.append(eng.registry)
    assert logs[0] == logs[1]
    assert len(logs[0]) > 100
    for name in ("serve_enqueued_total", "serve_admitted_total",
                 "serve_completed_total", "serve_preemptions_total",
                 "serve_tokens_total", "serve_cache_evictions_total",
                 "serve_shed_total", "serve_pages_in_use",
                 "serve_queue_depth", "serve_slots_active"):
        assert regs[0].get(name).value == regs[1].get(name).value, name


def test_engine_slo_gate_sheds_under_pressure(runner_params):
    runner, params = runner_params
    slo = SLOConfig(ttft_p99_ms=0.05, min_observations=2, window=16)
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=2, max_context=32, page_size=8, prefill_chunk=4,
        overload="slo", slo=slo))
    rs = np.random.RandomState(0)

    def req(rid):
        return OnlineRequest(rid=rid,
                             prompt=rs.randint(0, runner.cfg.vocab_size,
                                               8).astype(np.int32),
                             max_new=4)

    warm = [req(i) for i in range(2)]
    for r in warm:
        assert eng.submit(r)
    eng.run(max_ticks=500)
    flood = [req(100 + i) for i in range(4)]
    admitted = [eng.submit(r) for r in flood]
    assert not any(admitted), "armed gate must shed past the knee"
    assert all(r.state == "shed" for r in flood)
    assert eng.n_shed == 4
    assert eng.registry.get("serve_shed_total").value == 4
    assert eng.registry.get("serve_slo_shed_total").value == 4
    assert eng.rlog.counts()["shed"] == 4
    assert all(r.done for r in warm)


def test_engine_rejects_slo_overload_without_config(runner_params):
    runner, params = runner_params
    with pytest.raises(ValueError, match="slo"):
        OnlineEngine(runner, params,
                     OnlineConfig(max_slots=2, max_context=32,
                                  overload="slo"))


# ---------------------------------------------------------------------------
# trace export and the Prometheus endpoint
# ---------------------------------------------------------------------------


def test_chrome_trace_from_real_run(runner_params, tmp_path):
    runner, params = runner_params
    eng, reqs = churn_engine(runner, params)
    path = tmp_path / "trace.json"
    n = write_chrome_trace(path, timer=eng.timer, request_log=eng.rlog,
                           registry=eng.registry)
    trace = json.loads(path.read_text())
    assert trace["displayTimeUnit"] == "ms"
    events = trace["traceEvents"]
    assert len(events) == n > 0
    for e in events:
        assert e["ph"] in ("X", "i", "C", "M")
        assert isinstance(e["ts"], int) and e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 1
        if e["ph"] != "M":
            assert e["pid"] in (1, 2, 3)
    names = {e["name"] for e in events}
    meta_names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"tick", "prefill", "decode", "admit"} <= meta_names
    x_names = {e["name"] for e in events if e["ph"] == "X" and e["pid"] == 2}
    assert any(s.startswith("prefill r") for s in x_names)
    assert any(s.startswith("decode r") for s in x_names)
    assert any(e["ph"] == "i" and e["name"].startswith("preempt r")
               for e in events)
    assert any(e["ph"] == "i" and e["name"].startswith("first_token r")
               for e in events)
    c_names = {e["name"] for e in events if e["ph"] == "C"}
    assert {"page_pool_occupancy", "queue_depth", "radix_hit_rate"} \
        <= c_names
    assert "engine slots" in meta_names, names
    assert min(e["ts"] for e in events if e["ph"] != "M") == 0


def test_chrome_trace_sources_optional():
    reg = MetricsRegistry()
    reg.series("queue_depth").sample(1, t_us=5)
    trace = chrome_trace(registry=reg)
    assert any(e["ph"] == "C" for e in trace["traceEvents"])
    assert chrome_trace()["traceEvents"] == []


def test_metrics_server_serves_prometheus_text():
    reg = MetricsRegistry()
    reg.counter("serve_enqueued_total", "requests").inc(5)
    reg.histogram("serve_ttft_ms", "ttft").observe(12.0)
    with MetricsServer(reg, port=0) as srv:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "serve_enqueued_total 5" in body
        assert "serve_ttft_ms_count 1" in body
        reg.counter("serve_enqueued_total").inc()
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "serve_enqueued_total 6" in body
        with pytest.raises(Exception):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nope", timeout=10)


def test_serve_launcher_telemetry_flags(tmp_path, capsys):
    """--overload slo with --slo-ttft-ms, --metrics-port and --trace-out
    through the launcher on the CPU; --overload slo without a deadline
    is refused."""
    from repro_torch.launch import serve as tserve
    path = tmp_path / "serve_trace.json"
    reps = tserve.main(["--online", "--smoke", "--device", "cpu", "--rates",
                        "1000", "--requests", "4", "--max-new", "2",
                        "--overload", "slo", "--slo-ttft-ms", "1e6",
                        "--metrics-port", "0", "--trace-out", str(path)])
    out = capsys.readouterr().out
    assert "/metrics" in out and "[online] trace (" in out
    assert reps[0]["slo"]["ttft_deadline_ms"] == 1e6
    assert reps[0]["tokens_out"] == 8
    assert json.loads(path.read_text())["traceEvents"]
    with pytest.raises(SystemExit):
        tserve.main(["--online", "--smoke", "--device", "cpu",
                     "--overload", "slo"])
