"""The port's speculative decoding against the JAX package's, on converted
smoke Ling-Lite weights: the draft proposal (drafts and their
distributions), the verify step's accept/reject (`n_acc`, `out`), and the
engine's greedy and sampled spec streams; plus the reference's own spec
contracts (tests/test_spec_decode.py, minus its compile counts): greedy
spec streams equal the non-speculative ones for any drafter, a
full-depth self-draft accepts every draft, the config drafter, the
guards, and `PageAllocator.trim`.

Tolerances: tokens and `n_acc` equal; the draft distributions within
1e-6 absolute in fp32 (probabilities <= 1, fp32 summation order) and
2^-6 of the largest in bf16 (the logits' bf16 rounding).  Greedy spec
streams as in tests/test_torch_sampling.py; sampled spec streams bit for
bit in fp32, and in bf16 only their lengths and the admissions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.launch.mesh import make_local_mesh
from repro.serving.draft import SelfDrafter as JSelfDrafter
from repro.serving.online import OnlineConfig as JConfig
from repro.serving.online import OnlineEngine as JEngine
from repro.serving.online import OnlineRequest as JRequest
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.serving.draft import (ConfigDrafter, SelfDrafter,
                                       adapt_drafter_config)
from repro_torch.serving.online import OnlineConfig, OnlineEngine, \
    OnlineRequest
from repro_torch.serving.segment_cache import PageAllocator
from test_torch_sampling import assert_sampled_streams_match

PS = 8
PROB_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype=dt)
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype=dt)
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=64)
    jparams = runner.init_params(0)
    ref = jax.tree.map(np.asarray, jparams)
    return dict(dt=dt, jc=jc, tc=tc, runner=runner, jparams=jparams,
                ref=ref,
                tparams=interop.params_from_numpy(ref, tc, device="cpu"),
                trunner=tapi.Runner(tc, device="cpu"))


def _prefilled(m, prompts, table):
    """Both packages' pools with each prompt prefilled (greedy chunks)."""
    jpre = jax.jit(m["runner"].make_paged_prefill(PS))
    tpre = m["trunner"].make_paged_prefill(PS)
    jp = m["runner"].init_paged_pools(13, PS)
    tp = m["trunner"].init_paged_pools(13, PS)
    for b, p in enumerate(prompts):
        for base in range(0, len(p), PS):
            chunk = np.zeros((PS,), np.int32)
            nv = min(PS, len(p) - base)
            chunk[:nv] = p[base:base + nv]
            _, jp = jpre(m["jparams"], jp, jnp.asarray(chunk),
                         jnp.int32(base), jnp.int32(nv),
                         jnp.asarray(table[b]))
            _, tp = tpre(m["tparams"], tp, torch.tensor(chunk), base, nv,
                         torch.tensor(table[b]))
    return jp, tp


def test_draft_and_verify_steps_match_reference(models):
    """A 1-layer self-draft proposes k = 3 tokens for 3 slots (one
    inactive) from both packages' pools; the target verifies them.
    Greedy and sampled slots side by side."""
    m = models
    K, B = 3, 3
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, m["tc"].vocab_size, n).astype(np.int32)
               for n in (9, 5)]
    table = np.zeros((B, 4), np.int32)
    table[0], table[1] = [1, 2, 3, 4], [5, 6, 7, 8]
    jpools, tpools = _prefilled(m, prompts, table)
    jd_runner, jd_params = JSelfDrafter(1).build(m["runner"], m["jparams"])
    td_runner, td_params = SelfDrafter(1).build(m["trunner"], m["tparams"])
    jdp, tdp = _prefilled(dict(m, runner=jd_runner, jparams=jd_params,
                               trunner=td_runner, tparams=td_params),
                          prompts, table)
    tok = np.array([prompts[0][-1], prompts[1][-1], 0], np.int32)
    pos0 = np.array([8, 4, 0], np.int32)          # the last prompt row again
    active = np.array([True, True, False])
    seeds = np.array([5, 2 ** 31 - 2, 0], np.int32)
    temp = np.array([0.9, 0.0, 0.0], np.float32)
    top_p = np.array([0.9, 1.0, 1.0], np.float32)
    top_k = np.array([0, 0, 0], np.int32)
    knobs_j = tuple(map(jnp.asarray, (seeds, temp, top_p, top_k)))
    knobs_t = tuple(map(torch.tensor, (seeds, temp, top_p, top_k)))
    jdraft = jax.jit(jd_runner.make_paged_draft_propose(PS, K))
    tdraft = td_runner.make_paged_draft_propose(PS, K)
    jd, jq, _ = jdraft(jd_params, jdp, jnp.asarray(tok), jnp.asarray(pos0),
                       jnp.asarray(table), jnp.asarray(active), *knobs_j)
    td, tq, _ = tdraft(td_params, tdp, torch.tensor(tok),
                       torch.tensor(pos0), torch.tensor(table),
                       torch.tensor(active), *knobs_t)
    np.testing.assert_array_equal(td.numpy()[:2], np.asarray(jd)[:2])
    jq = np.asarray(jq)
    np.testing.assert_allclose(tq.numpy()[:2], jq[:2], rtol=0,
                               atol=PROB_TOL[m["dt"]] * np.abs(jq).max())
    # verify the reference's drafts and distributions in both packages
    tokens = np.concatenate([tok[:, None], np.asarray(jd)], 1)
    jver = jax.jit(m["runner"].make_paged_verify_step(PS, K))
    tver = m["trunner"].make_paged_verify_step(PS, K)
    jn, jo, _ = jver(m["jparams"], jpools, jnp.asarray(tokens),
                     jnp.asarray(pos0), jnp.asarray(table),
                     jnp.asarray(active), jnp.asarray(jq), *knobs_j)
    tn, to, _ = tver(m["tparams"], tpools, torch.tensor(tokens),
                     torch.tensor(pos0), torch.tensor(table),
                     torch.tensor(active), torch.tensor(jq), *knobs_t)
    assert tn.dtype == torch.int32 and to.dtype == torch.int32
    jn_h, jo_h = jax.device_get((jn, jo))
    np.testing.assert_array_equal(tn.numpy(), jn_h)
    for b in range(2):
        na = int(jn_h[b])
        np.testing.assert_array_equal(to.numpy()[b, :na + 1],
                                      jo_h[b, :na + 1])


def _spec_reqs(vocab, n=6, temperature=None):
    rs = np.random.RandomState(12)
    kw = ({} if temperature is None else
          dict(temperature=temperature, top_p=0.95, top_k=0))
    return [(i, rs.randint(0, vocab, 4 + (i % 4)).astype(np.int32),
             6 + (i % 5), dict(kw, **({"seed": 100 + i} if kw else {})))
            for i in range(n)]


def _drive(eng, make_req, reqs):
    rr = [make_req(rid=rid, prompt=p, max_new=n, **kw)
          for rid, p, n, kw in reqs]
    eng.submit_many(rr)
    eng.run(max_ticks=3000)
    assert all(r.done for r in rr)
    eng.alloc.check_invariants()
    return {r.rid: list(r.out) for r in rr}


SPEC_GEO = dict(max_slots=4, max_context=32, page_size=PS, n_pages=13,
                prefill_chunk=4, spec_k=2)


@pytest.mark.parametrize("temperature", [None, 1.2], ids=["greedy",
                                                          "sampled"])
def test_spec_engine_matches_reference(models, temperature):
    """The port's spec engine (1-layer self-draft, k = 2, a pool that
    preempts) gives the JAX spec engine's streams, acceptance and
    admissions."""
    m = models
    reqs = _spec_reqs(m["tc"].vocab_size, temperature=temperature)
    jeng = JEngine(m["runner"], m["jparams"], JConfig(**SPEC_GEO),
                   drafter=JSelfDrafter(1))
    teng = OnlineEngine(m["trunner"], m["tparams"], OnlineConfig(**SPEC_GEO),
                        drafter=SelfDrafter(1))
    jout = _drive(jeng, JRequest, reqs)
    tout = _drive(teng, OnlineRequest, reqs)
    assert teng.admission_log == jeng.admission_log
    assert teng.step_calls["decode"] == 0 and teng.step_calls["verify"] > 0
    if temperature is not None and m["dt"] == "bfloat16":
        # a bf16 flip of a logit moves a draft, an accept decision or a
        # residual draw, which the engines' outputs cannot attribute to a
        # near tie: sampled spec streams are held bit for bit in fp32
        assert all(len(tout[r]) == len(jout[r]) for r in jout)
        return
    assert_sampled_streams_match(m, reqs, jout, tout)
    if tout == jout:
        assert teng.spec_proposed == jeng.spec_proposed
        assert teng.spec_accepted == jeng.spec_accepted


# ---------------------------------------------------------------------------
# the reference's spec contracts, on the port alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    tc = tcfg("ling-lite")
    runner = tapi.Runner(tc, device="cpu")
    return runner, runner.init_params(0)


def _greedy_ref(runner, params, prompts, max_new, **geo):
    eng = OnlineEngine(runner, params, OnlineConfig(**dict(
        dict(max_slots=len(prompts), max_context=64, page_size=16,
             prefill_chunk=4), **geo)))
    eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i], max_new=max_new)
                     for i in range(len(prompts))])
    eng.run(max_ticks=1000)
    return [list(eng.reqs[i].out) for i in range(len(prompts))]


def _spec_engine(runner, params, *, spec_k=2, draft_layers=1, **kw):
    ocfg = OnlineConfig(max_slots=kw.pop("max_slots", 4),
                        max_context=kw.pop("max_context", 64),
                        page_size=kw.pop("page_size", 16),
                        prefill_chunk=kw.pop("prefill_chunk", 4),
                        spec_k=spec_k, **kw)
    return OnlineEngine(runner, params, ocfg,
                        drafter=SelfDrafter(draft_layers=draft_layers))


def test_spec_greedy_token_exact(smoke):
    runner, params = smoke
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, runner.cfg.vocab_size, 6).astype(np.int32)
               for _ in range(4)]
    ref = _greedy_ref(runner, params, prompts, 6)
    eng = _spec_engine(runner, params, spec_k=2, draft_layers=1)
    eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i], max_new=6)
                     for i in range(4)])
    eng.run(max_ticks=1000)
    assert [list(eng.reqs[i].out) for i in range(4)] == ref
    assert eng.step_calls["decode"] == 0
    assert eng.step_calls["draft"] == eng.step_calls["verify"] > 0
    assert eng.spec_proposed > 0


def test_spec_full_depth_accepts_everything(smoke):
    runner, params = smoke
    K, B, NEW = 2, 4, 9
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, runner.cfg.vocab_size, 6).astype(np.int32)
               for _ in range(B)]
    ref = _greedy_ref(runner, params, prompts, NEW)
    eng = _spec_engine(runner, params, spec_k=K,
                       draft_layers=runner.cfg.n_layers)
    eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i], max_new=NEW)
                     for i in range(B)])
    eng.run(max_ticks=1000)
    assert [list(eng.reqs[i].out) for i in range(B)] == ref
    assert eng.spec_accepted == eng.spec_proposed
    ticks = sum(eng.reqs[i].n_decode_ticks for i in range(B))
    decoded = sum(len(eng.reqs[i].out) - 1 for i in range(B))
    assert ticks / decoded < 0.7, (ticks, decoded)


def test_spec_under_churn_is_deterministic_and_greedy_exact(smoke):
    """13 ragged requests through a pool that forces preemption: every
    request completes, trims happen, pages never leak, reruns repeat, and
    the streams are the non-speculative ones."""
    runner, params = smoke

    def reqs():
        rs = np.random.RandomState(2)
        return [OnlineRequest(
            rid=i, prompt=rs.randint(0, runner.cfg.vocab_size,
                                     4 + (i % 5)).astype(np.int32),
            max_new=8 + (i % 9)) for i in range(13)]

    def drive():
        eng = _spec_engine(runner, params, spec_k=2, draft_layers=1,
                           max_slots=4, max_context=32, page_size=8,
                           n_pages=9, prefill_chunk=4)
        rr = reqs()
        eng.submit_many(rr)
        eng.run(max_ticks=3000)
        return eng, rr

    eng, rr = drive()
    assert eng.n_preemptions > 0
    assert eng.alloc.stats["trims"] > 0
    for r in rr:
        assert r.done and len(r.out) == r.max_new, (r.rid, r.state)
    eng.alloc.check_invariants()
    eng.alloc.flush_radix()
    eng.alloc.check_invariants()
    assert eng.alloc.n_free == eng.alloc.n_pages - eng.alloc.reserved
    eng2, rr2 = drive()
    assert eng2.admission_log == eng.admission_log
    assert eng2.n_preemptions == eng.n_preemptions
    assert [r.out for r in rr2] == [r.out for r in rr]
    ref = OnlineEngine(runner, params, OnlineConfig(
        max_slots=4, max_context=32, page_size=8, prefill_chunk=4))
    refs = reqs()
    ref.submit_many(refs)
    ref.run(max_ticks=3000)
    assert [r.out for r in rr] == [r.out for r in refs]


def test_spec_nonzero_temperature(smoke):
    runner, params = smoke
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, runner.cfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]

    def drive(draft_layers):
        eng = _spec_engine(runner, params, spec_k=2,
                           draft_layers=draft_layers, max_slots=2,
                           temperature=1.2, seed=42)
        eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i], max_new=8)
                         for i in range(2)])
        eng.run(max_ticks=1000)
        return [list(eng.reqs[i].out) for i in range(2)], eng

    out, eng = drive(runner.cfg.n_layers)
    assert eng.spec_accepted == eng.spec_proposed
    assert all(0 <= t < runner.cfg.vocab_size for o in out for t in o)
    assert drive(runner.cfg.n_layers)[0] == out
    out3, _ = drive(1)
    assert all(len(o) == 8 for o in out3)


def test_config_drafter_pluggable(smoke):
    runner, params = smoke
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, runner.cfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]
    ref = _greedy_ref(runner, params, prompts, 6)
    dcfg = adapt_drafter_config(tcfg("h2o-danube-1.8b"), runner.cfg)
    assert dcfg.vocab_size == runner.cfg.vocab_size
    assert set(dcfg.block_pattern) == {"attn"} and dcfg.attn_window is None
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=2, max_context=64, page_size=16, prefill_chunk=4,
        spec_k=2), drafter=ConfigDrafter(dcfg))
    eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i], max_new=6)
                     for i in range(2)])
    eng.run(max_ticks=1000)
    assert [list(eng.reqs[i].out) for i in range(2)] == ref


def test_self_drafter_params_are_views(smoke):
    runner, params = smoke
    _, dparams = SelfDrafter(1).build(runner, params)
    w, dw = params["blocks"]["moe"]["we1"], dparams["blocks"]["moe"]["we1"]
    assert dw.shape[0] == 1 and dw.data_ptr() == w.data_ptr()
    assert dparams["embed"] is params["embed"]


def test_spec_requires_drafter(smoke):
    runner, params = smoke
    with pytest.raises(ValueError, match="drafter"):
        OnlineEngine(runner, params,
                     OnlineConfig(max_slots=2, max_context=32, spec_k=2))


def test_drafter_layer_bounds(smoke):
    runner, params = smoke
    for n in (0, runner.cfg.n_layers + 1):
        with pytest.raises(ValueError, match="draft_layers"):
            SelfDrafter(draft_layers=n).build(runner, params)


def test_config_drafter_vocab_guard(smoke):
    runner, params = smoke
    bad = dataclasses.replace(runner.cfg,
                              vocab_size=runner.cfg.vocab_size + 64)
    with pytest.raises(ValueError, match="vocab_size"):
        ConfigDrafter(bad).build(runner, params)


def test_swa_config_is_not_built_as_a_model():
    with pytest.raises(NotImplementedError, match="item 10"):
        tapi.Runner(tcfg("h2o-danube-1.8b"), device="cpu")


def test_page_allocator_trim():
    alloc = PageAllocator(n_pages=10, page_size=4)
    alloc.admit(0)
    assert alloc.ensure_capacity(0, 16)
    held = list(alloc.pages[0])
    alloc.trim(0, 6)
    assert alloc.pages[0] == held[:2]
    assert alloc.stats["trims"] == 2
    assert alloc.ensure_capacity(0, 16)
    assert alloc.pages[0] == held
    alloc.check_invariants()
    alloc.register_prefix(0, "sys", 8)
    alloc.trim(0, 0)
    assert alloc.pages[0] == held[:2]
    alloc.release(0)
    alloc.drop_prefix("sys")
    alloc.check_invariants()
    assert alloc.n_free == alloc.n_pages - alloc.reserved


# ---------------------------------------------------------------------------
# on the card: a row's bits do not depend on the other rows of its call
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_verify_pass_and_prefill_give_the_ticks_bits_on_the_card():
    """Ling-Lite's paged steps on the kernels, bf16, 8 slots: one verify
    pass over k+1 = 5 positions gives the logits of the 5 decode ticks it
    stands for bit for bit, and one prefill chunk of the same tokens
    writes the ticks' KV bit for bit (what the greedy spec contract and
    preemption replay rest on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(tcfg("ling-lite"), n_layers=4, d_model=512,
                              n_heads=4, n_kv_heads=2)
    params = tapi.Runner(cfg, device="cuda").init_params(0)
    B, P, K1, ps, C = 8, 40, 5, 16, 64
    npp = -(-(P + C) // ps)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                            device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, K1), generator=g,
                         device="cuda")
    table = (1 + torch.arange(B * npp, device="cuda",
                              dtype=torch.int32)).reshape(B, npp)
    active = torch.ones((B,), dtype=torch.bool, device="cuda")
    pools = TM.init_paged_caches(cfg, 1 + B * npp, ps, "cuda")
    clone = lambda pl: {"self": {n: t.clone() for n, t in pl["self"].items()}}
    with torch.no_grad():
        for b in range(B):
            TM._paged_prefill_logits(cfg, params, pools, prompts[b], 0, P,
                                     table[b], page_size=ps)
        start = clone(pools)
        ticks = torch.stack([TM._paged_decode_logits(
            cfg, params, pools, toks[:, j],
            torch.full((B,), P + j, device="cuda"), table, active,
            page_size=ps)[0] for j in range(K1)], 1)
        pos = P + torch.arange(K1, device="cuda")[None].expand(B, -1)
        ver, _ = TM._paged_verify_logits(cfg, params, clone(start), toks,
                                         pos, table, active, page_size=ps)
        pre = clone(start)
        for b in range(B):
            chunk = torch.zeros((C,), dtype=toks.dtype, device="cuda")
            chunk[:K1] = toks[b]
            TM._paged_prefill_logits(cfg, params, pre, chunk, P, K1,
                                     table[b], page_size=ps)
    assert torch.equal(ver, ticks.reshape(B * K1, -1))
    for n in ("k", "v"):                  # page 0: the chunk's padding
        assert torch.equal(pre["self"][n][:, 1:], pools["self"][n][:, 1:])
