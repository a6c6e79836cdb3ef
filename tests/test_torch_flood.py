"""The port's offline Flood engine against the JAX package's on converted
smoke rwkv6-3b weights: `launch.serve.build_model_engine` driving the
`FloodEngine` (2 stages, micro-batch 2, 6 requests) and the synchronous
`baseline_step_engine` must emit the reference's token lists at
temperature 0, where the reference's sampled decode step is the argmax.
Both engines reproduce the reference's quirks as written (each request
feeds its last token; one cache and one position counter are shared by
every in-flight micro-batch), so the lists match request for request.
Plus the launcher's offline mode on the CPU and what it refuses, and the
port's copy of the SegmentCache.

Streams: identity is required in fp32.  In bf16 one exception is
allowed, as in tests/test_torch_serving.py: XLA and torch may round a
bf16 product differently, so the two runs may part at a head call where
the port's logits put the reference's token within 2^-6 of the largest
logit of the top one.  Nothing after that call is compared: the shared
cache carries the difference into every later micro-batch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.launch import serve as jserve
from repro.launch.mesh import make_local_mesh
from repro.serving import flood as jflood
from repro.serving.segment_cache import SegmentCache as JSegmentCache
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serving import flood as tflood
from repro_torch.serving.segment_cache import SegmentCache

STAGES, MICRO, N_REQ, PROMPT, MAX_NEW, SEQ = 2, 2, 6, 8, 6, 64
TIE_TOL = {"float32": 0.0, "bfloat16": 2.0 ** -6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(mod, vocab):
    rs = np.random.RandomState(0)
    return [mod.GenRequest(rid=i, prompt=rs.randint(0, vocab, PROMPT)
                           .astype(np.int32), max_new=MAX_NEW)
            for i in range(N_REQ)]


def _run(mod, cache_cls, engine_fns, vocab, baseline):
    """Run one engine; returns (tokens per request, stats, the tokens of
    every head call)."""
    embed_fn, stage_fns, head_fn = engine_fns
    calls = []

    def head(x, reqs):
        toks = head_fn(x, reqs)
        calls.append(np.asarray(toks).tolist())
        return toks

    reqs = _requests(mod, vocab)
    if baseline:
        stats = mod.baseline_step_engine(head, embed_fn, reqs)
    else:
        eng = mod.FloodEngine(stage_fns, head, embed_fn,
                              cache=cache_cls(max_tokens=1 << 16,
                                              initial_segment=32,
                                              extend_chunk=32),
                              microbatch=MICRO)
        eng.submit(reqs)
        stats = eng.run()
    return [r.out for r in reqs], stats, calls


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("baseline", [False, True],
                         ids=["flood", "baseline"])
def test_engine_emits_the_references_tokens(baseline, dt, monkeypatch):
    jc = dataclasses.replace(jcfg("rwkv6-3b"), compute_dtype=dt)
    tc = dataclasses.replace(tcfg("rwkv6-3b"), compute_dtype=dt)
    mesh = make_local_mesh(1, 1)
    want, jstats, jcalls = _run(jflood, JSegmentCache,
                                jserve.build_model_engine(
                                    jc, mesh, STAGES, SEQ, MICRO),
                                jc.vocab_size, baseline)
    # the reference engine draws its weights from Runner.init_params(0)
    runner = japi.Runner(jc, mesh, fsdp=False, seq_parallel=False,
                         max_seq=SEQ)
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, runner.init_params(0)), tc, device="cpu")
    logits = []
    decode_logits = TM.decode_logits

    def recording(*args, **kw):
        lg, caches = decode_logits(*args, **kw)
        logits.append(lg)
        return lg, caches

    monkeypatch.setattr(TM, "decode_logits", recording)
    got, tstats, tcalls = _run(tflood, SegmentCache,
                               tserve.build_model_engine(
                                   tapi.Runner(tc, device="cpu"), params,
                                   STAGES, MICRO),
                               tc.vocab_size, baseline)
    assert tstats.tokens_out == jstats.tokens_out
    assert len(tcalls) == len(jcalls) == len(logits)
    assert all(len(o) == MAX_NEW for o in got)
    for i, (t, j) in enumerate(zip(tcalls, jcalls)):
        if t == j:
            continue
        lg = logits[i]
        tol = TIE_TOL[dt] * float(lg.abs().max())
        for row, (a, b) in enumerate(zip(t, j)):
            if a != b:
                gap = float(lg[row, a] - lg[row, b])
                assert gap <= tol, (i, row, a, b, gap, tol)
        break
    else:
        assert got == want


def test_offline_launcher_on_cpu():
    stats = tserve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                         "--requests", "4", "--max-new", "3",
                         "--microbatch", "2"])
    assert stats.tokens_out == 4 * 3
    # sampled offline serving (queue 1 item 5) runs
    hot = tserve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                       "--requests", "4", "--max-new", "3",
                       "--microbatch", "2", "--temperature", "0.7",
                       "--top-p", "0.9", "--top-k", "16", "--seed", "5"])
    assert hot.tokens_out == 4 * 3
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tserve.main(["--arch", "ling-lite", "--smoke", "--device", "cpu"])


def test_segment_cache_copy_matches_reference():
    """The port's SegmentCache (own copy) makes the reference's decisions
    on a churn of admissions, token writes and releases that overflows
    its segments (extend, append, wait)."""
    rs = np.random.RandomState(1)
    caches = [JSegmentCache(max_tokens=64, initial_segment=2,
                            extend_chunk=4),
              SegmentCache(max_tokens=64, initial_segment=2,
                           extend_chunk=4)]
    logs = [[], []]
    for step in range(600):
        op, rid, n = rs.randint(8), rs.randint(8), rs.randint(1, 9)
        for c, log in zip(caches, logs):
            if op == 0 and rid not in c.requests:
                log.append(("admit", c.admit(rid, n, 20)))
            elif 0 < op < 7 and rid in c.requests:
                log.append(("write", c.write_token(rid)))
            elif op == 7 and rid in c.requests:
                log.append(("release", c.release(rid)))
            c.check_invariants()
        assert logs[0] == logs[1], step
    assert caches[0].stats == caches[1].stats
    assert all(caches[0].stats[k] for k in ("extends", "appends", "waits"))
    assert caches[0].free == caches[1].free
