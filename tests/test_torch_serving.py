"""The port's serving path against the JAX package's on converted smoke
Ling-Lite weights: teacher-forced paged prefill / decode logits, and the
port's OnlineEngine against the JAX OnlineEngine under the same scripted
requests (a plain run, a pool small enough to force preemption, and a
shared prompt prefix that hits the radix cache) — greedy streams and
admission logs must be identical.  Plus the port's own contracts: the
fused and gathered attention modes and the radix cache on/off give
identical streams, and the engine's knobs serve.

Tolerances on logits (fp32, from the final fp32 NormHead): with fp32
compute the packages differ by fp32 summation order only, 1e-4 of the
largest logit after two layers.  With bf16 compute every matmul output
is rounded to bf16 and an element may round one ulp (2^-8) the other
way; those flips move the logits by up to 2^-6 of the largest logit.

Streams: identity is required in both dtypes.  In bf16 one exception is
allowed: XLA and torch may sum a bf16 product in different orders, so a
stream may diverge where the reference's top two logits are closer than
the bf16 tolerance.  A divergence is accepted only when the teacher-forced
reference logits show such a near-tie at its first divergent step."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import api as japi
from repro import sharding
from repro.configs.base import get_smoke_config as jcfg
from repro.launch.mesh import make_local_mesh
from repro.models import embedding as JE
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.online import OnlineConfig as JConfig
from repro.serving.online import OnlineEngine as JEngine
from repro.serving.online import OnlineRequest as JRequest
from repro.sharding import make_axis_env
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serving.online import OnlineConfig, OnlineEngine, \
    OnlineRequest
from repro_torch.telemetry import SLOConfig

PS, C = 8, 8                       # page size and teacher-forcing chunk
GEO = dict(max_slots=4, max_context=32, page_size=PS, n_pages=9,
           prefill_chunk=4)
TIE_TOL = {"float32": 0.0, "bfloat16": 2.0 ** -6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one intra-op thread, and the suite's
    parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logit_tol(dt, ref):
    rel = 1e-4 if dt == "float32" else 2.0 ** -6
    return rel * float(np.abs(ref).max())


def _reference_fns(jc):
    """Jitted JAX teacher-forcing steps: the reference's paged prefill
    (logits at the last valid row) and paged decode logits."""
    mesh = make_local_mesh(1, 1)
    env = dataclasses.replace(make_axis_env(mesh), seq_parallel=False)
    pool_spec = {"self": {"k": P(), "v": P()}}

    def prefill(params, pools, tokens, base, n_valid, table_row):
        x = JE.embed_tokens(jc, env, params["embed"], tokens)
        valid = JL.paged_valid_mask(
            table_row[None], (base + jnp.arange(tokens.shape[0]))[None],
            page_size=PS, ps_loc=PS, env=env)

        def body(x, inp):
            lp, pool = inp
            return JM.block_prefill_paged(jc, env, lp, x, pool, base,
                                          n_valid, table_row, page_size=PS,
                                          ffn="moe", valid=valid)

        x, pools = jax.lax.scan(body, x, (params["blocks"], pools))
        x = JL.apply_norm(jc, env, params["final_norm"], x)
        last = jax.lax.dynamic_slice_in_dim(x, n_valid - 1, 1, axis=0)
        return JE.lm_logits(jc, env, params["embed"], last), pools

    def decode(params, pools, token, pos, table, active):
        return JM._paged_decode_logits(jc, env, params, pools, token, pos,
                                       table, active, page_size=PS)

    def wrap(fn, n_args):
        return jax.jit(sharding.shard_map(
            fn, mesh=mesh, in_specs=(P(),) * n_args,
            out_specs=(P(), pool_spec)))

    pools = lambda n: JM.init_paged_caches(jc, env, n, PS)
    return wrap(prefill, 6), wrap(decode, 6), pools


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype=dt)
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype=dt)
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=64)
    jparams = runner.init_params(0)
    ref = jax.tree.map(np.asarray, jparams)
    tparams = interop.params_from_numpy(ref, tc, device="cpu")
    prefill, decode, pools = _reference_fns(jc)
    return dict(dt=dt, jc=jc, tc=tc, runner=runner, jparams=jparams,
                jplain=jax.tree.map(jnp.asarray, ref), tparams=tparams,
                trunner=tapi.Runner(tc, device="cpu"), prefill=prefill,
                decode=decode, pools=pools)


def _ref_next_logits(m, seq):
    """Reference logits for the token after `seq`, teacher-forced through
    the reference's paged prefill in chunks of C."""
    n = len(seq)
    table = np.arange(1, 1 + GEO["max_context"] // PS, dtype=np.int32)
    pools = m["pools"](1 + len(table))
    for base in range(0, n, C):
        chunk = np.zeros((C,), np.int32)
        nv = min(C, n - base)
        chunk[:nv] = seq[base:base + nv]
        logits, pools = m["prefill"](m["jplain"], pools, jnp.asarray(chunk),
                                     jnp.int32(base), jnp.int32(nv),
                                     jnp.asarray(table))
    return np.asarray(logits)[0]


def test_teacher_forced_prefill_and_decode_logits(models):
    """Two prefill chunks (8 + 5 valid rows) then 4 decode steps for slot
    0 of 2 (slot 1 inactive), the same tokens fed to both packages."""
    m = models
    dt, tc = m["dt"], m["tc"]
    rs = np.random.RandomState(4)
    seq = rs.randint(0, tc.vocab_size, 17).astype(np.int32)
    n_lp = 4
    table = np.zeros((2, n_lp), np.int32)
    table[0] = [3, 1, 4, 2]
    jpools = m["pools"](5)
    tpools = TM.init_paged_caches(tc, 5, PS, "cpu")
    steps = []
    for base, nv in ((0, 8), (8, 5)):
        chunk = np.zeros((C,), np.int32)
        chunk[:nv] = seq[base:base + nv]
        ref, jpools = m["prefill"](m["jplain"], jpools, jnp.asarray(chunk),
                                   jnp.int32(base), jnp.int32(nv),
                                   jnp.asarray(table[0]))
        with torch.no_grad():
            out, _ = TM._paged_prefill_logits(
                tc, m["tparams"], tpools, torch.tensor(chunk), base, nv,
                torch.tensor(table[0]), page_size=PS)
        steps.append((np.asarray(ref)[0], out[0].numpy()))
    active = np.array([True, False])
    for p in range(13, 17):
        tok = np.array([seq[p], 0], np.int32)
        pos = np.array([p, 0], np.int32)
        ref, jpools = m["decode"](m["jplain"], jpools, jnp.asarray(tok),
                                  jnp.asarray(pos), jnp.asarray(table),
                                  jnp.asarray(active))
        with torch.no_grad():
            out, _ = TM._paged_decode_logits(
                tc, m["tparams"], tpools, torch.tensor(tok),
                torch.tensor(pos), torch.tensor(table), torch.tensor(active),
                page_size=PS)
        steps.append((np.asarray(ref)[0], out[0].numpy()))
    for i, (ref, out) in enumerate(steps):
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=_logit_tol(dt, ref),
                                   err_msg=f"step {i}")
    # the greedy step outputs agree too
    with torch.no_grad():
        nxt, _ = TM.paged_prefill_chunk(
            tc, m["tparams"], TM.init_paged_caches(tc, 5, PS, "cpu"),
            torch.tensor(seq[:8]), 0, 8, torch.tensor(table[0]),
            page_size=PS)
    assert int(nxt) == int(np.argmax(steps[0][0]))


# ---------------------------------------------------------------------------
# engine parity under scripted requests
# ---------------------------------------------------------------------------


def _plain_reqs(vocab):
    rs = np.random.RandomState(2)
    return [(i, rs.randint(0, vocab, 4 + i).astype(np.int32), 7 - i)
            for i in range(4)]


def _preempt_reqs(vocab):
    rs = np.random.RandomState(1)
    return [(100 + i, rs.randint(0, vocab, 4 + (i % 5)).astype(np.int32),
             8 + (i % 9)) for i in range(13)]


def _radix_reqs(vocab):
    rs = np.random.RandomState(5)
    shared = rs.randint(0, vocab, PS).astype(np.int32)
    return [(200 + i, np.concatenate(
        [shared, rs.randint(0, vocab, 1 + (i % 4)).astype(np.int32)]), 4)
        for i in range(6)]


SCENARIOS = {"plain": _plain_reqs, "preempt": _preempt_reqs,
             "radix": _radix_reqs}


def _drive(eng, make_req, reqs):
    """Run one scripted workload; report streams, admissions and stats."""
    log0, pre0 = len(eng.admission_log), eng.n_preemptions
    hits0 = eng.alloc.stats["prefix_hits"]
    rr = [make_req(rid=rid, prompt=p, max_new=n) for rid, p, n in reqs]
    eng.submit_many(rr)
    eng.run(max_ticks=3000)
    assert all(r.done for r in rr)
    eng.alloc.check_invariants()
    eng.alloc.flush_radix()            # next workload starts cache-cold
    return dict(out={r.rid: list(r.out) for r in rr},
                prompts={r.rid: r.prompt for r in rr},
                admissions=eng.admission_log[log0:],
                preemptions=eng.n_preemptions - pre0,
                hits=eng.alloc.stats["prefix_hits"] - hits0)


@pytest.fixture(scope="module")
def engine_runs(models):
    m = models
    jeng = JEngine(m["runner"], m["jparams"], JConfig(**GEO))
    teng = OnlineEngine(m["trunner"], m["tparams"], OnlineConfig(**GEO))
    vocab = m["tc"].vocab_size
    runs = {}
    for name, reqs in SCENARIOS.items():
        runs[name] = (_drive(jeng, JRequest, reqs(vocab)),
                      _drive(teng, OnlineRequest, reqs(vocab)))
    return runs


def _assert_streams_match(m, ref, out):
    """Identical streams; in bf16 a divergence is allowed only at a
    reference near-tie (top-2 gap below the bf16 tolerance)."""
    for rid, r in ref["out"].items():
        o = out["out"][rid]
        if o == r:
            continue
        s = next(i for i, (a, b) in enumerate(zip(r, o)) if a != b)
        seq = np.concatenate([ref["prompts"][rid],
                              np.asarray(r[:s], np.int32)])
        logits = _ref_next_logits(m, seq)
        top2 = np.sort(logits)[-2:]
        gap = float(top2[1] - top2[0])
        assert gap < TIE_TOL[m["dt"]] * float(np.abs(logits).max()), (
            f"rid {rid} diverges at step {s} ({r[s]} vs {o[s]}) with a "
            f"top-2 gap of {gap}: not a near-tie")
        assert {r[s], o[s]} <= set(np.argsort(logits)[-2:].tolist())


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_reference(models, engine_runs, scenario):
    ref, out = engine_runs[scenario]
    _assert_streams_match(models, ref, out)
    assert out["admissions"] == ref["admissions"]
    assert out["preemptions"] == ref["preemptions"]
    assert out["hits"] == ref["hits"]
    if scenario == "plain":
        assert ref["preemptions"] == 0
    if scenario == "preempt":
        assert ref["preemptions"] > 0, "the pool was sized to force it"
    if scenario == "radix":
        assert ref["hits"] >= 1, "the shared prefix must hit the cache"


# ---------------------------------------------------------------------------
# the port's own contracts (no reference needed)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    tc = tcfg("ling-lite")
    runner = tapi.Runner(tc, device="cpu")
    return tc, runner.init_params(0)


def _port_streams(tc, params, reqs, flags=TM.DEFAULT_FLAGS, **geo):
    eng = OnlineEngine(tapi.Runner(tc, flags=flags, device="cpu"), params,
                       OnlineConfig(**dict(GEO, **geo)))
    return _drive(eng, OnlineRequest, reqs)


@pytest.mark.parametrize("variant", [
    dict(flags=TM.RunFlags(paged_attn="gathered")),
    dict(radix_cache=False),
    dict(n_pages=None)], ids=["gathered", "radix_off", "big_pool"])
def test_port_streams_are_invariant(smoke, variant):
    """Fused vs gathered attention, radix cache on/off, and a pool big
    enough to never preempt all give the same greedy streams."""
    tc, params = smoke
    reqs = _preempt_reqs(tc.vocab_size) + _radix_reqs(tc.vocab_size)
    base = _port_streams(tc, params, reqs)
    assert base["preemptions"] > 0
    other = _port_streams(tc, params, reqs, **variant)
    assert other["out"] == base["out"]


def test_poisson_load_and_cli_on_cpu(smoke, capsys):
    tc, params = smoke
    eng = OnlineEngine(tapi.Runner(tc, device="cpu"), params,
                       OnlineConfig(**GEO))
    rep = tserve.run_poisson_load(eng, rate=1e6, n_requests=5,
                                  prompt_len=(4, 12), max_new=3,
                                  vocab_size=tc.vocab_size, seed=3)
    assert rep["tokens_out"] == 15 and len(rep["prompt_len"]) == 5
    assert all(4 <= n <= 12 for n in rep["prompt_len"])
    assert eng.idle and not eng.reqs
    tserve.main(["--online", "--smoke", "--device", "cpu", "--rates", "50",
                 "--requests", "2", "--max-new", "2"])
    assert "[online] rate=50/s tok/s=" in capsys.readouterr().out


def test_shared_prefix_load_on_and_off_the_radix_cache(smoke):
    """run_poisson_load's shared system prompt: the radix cache attaches
    it by content, and with the cache off the keyed prefix registry
    carries it (dropped after the load); the streams are the same."""
    tc, params = smoke
    outs = {}
    for radix in (True, False):
        eng = OnlineEngine(tapi.Runner(tc, device="cpu"), params,
                           OnlineConfig(**dict(GEO, radix_cache=radix)))
        rep = tserve.run_poisson_load(eng, rate=1e6, n_requests=6,
                                      prompt_len=12, max_new=3,
                                      vocab_size=tc.vocab_size, seed=4,
                                      shared_prefix_len=PS)
        assert rep["prefix_hits"] >= 1 and rep["shared_prefix_len"] == PS
        assert len({tuple(p[:PS]) for p in rep["prompts"]}) == 1
        assert not eng.alloc.prefix_index
        eng.alloc.check_invariants()
        outs[radix] = rep["outputs"]
    assert outs[True] == outs[False]


def test_launcher_takes_the_references_serving_flags(tmp_path, capsys):
    """--shared-prefix-len, --report, --moe-dispatch and --paged-attn (the
    reference's flags; --tp is multi-device, not yet ported)."""
    path = tmp_path / "report.json"
    tserve.main(["--online", "--smoke", "--device", "cpu", "--rates", "1e6",
                 "--requests", "3", "--max-new", "2", "--prompt-len", "10",
                 "--shared-prefix-len", "8", "--report", str(path),
                 "--moe-dispatch", "ragged", "--paged-attn", "gathered"])
    rep = json.loads(path.read_text())
    assert rep["engine"]["moe_dispatch"] == "ragged"
    assert rep["rates"][0]["paged_attn"] == "gathered"
    assert rep["rates"][0]["shared_prefix_len"] == 8
    assert "[online] report ->" in capsys.readouterr().out


def test_unported_knobs_raise(smoke):
    """SLO shedding (queue 1 item 7) now serves, and refuses to run
    without deadlines as the reference's engine does; the sampling,
    speculation and policy knobs of items 5 and 6 serve too."""
    tc, params = smoke
    runner = tapi.Runner(tc, device="cpu")
    with pytest.raises(ValueError, match="SLOConfig"):
        OnlineEngine(runner, params,
                     OnlineConfig(**dict(GEO, overload="slo")))
    for kw in (dict(temperature=0.7), dict(policy="decode-priority"),
               dict(max_queue=2), dict(tenant_budgets={"a": 64}),
               dict(overload="slo", slo=SLOConfig(ttft_p99_ms=1e6))):
        eng = OnlineEngine(runner, params, OnlineConfig(**dict(GEO, **kw)))
        assert eng.submit(OnlineRequest(rid=0, prompt=np.ones(3, np.int32),
                                        max_new=2, tenant="a"))
        eng.run(max_ticks=50)
        assert len(eng.reqs[0].out) == 2
    with pytest.raises(ValueError, match="drafter"):
        OnlineEngine(runner, params, OnlineConfig(**dict(GEO, spec_k=2)))
    eng = OnlineEngine(runner, params, OnlineConfig(**GEO))
    eng.submit(OnlineRequest(rid=0, prompt=np.ones(3, np.int32), max_new=2,
                             temperature=1.0, seed=3))
    eng.run(max_ticks=50)
    assert all(0 <= t < tc.vocab_size for t in eng.reqs[0].out)


def test_cuda_entry_points_need_a_card():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.Runner(tcfg("ling-lite"))
