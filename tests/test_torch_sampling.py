"""The port's sampling against the JAX package's: JAX's threefry key
schedule in torch integer ops (`models.prng`), the sampling transforms
(`models.embedding`), the sampled serving steps, and the online engine
at mixed temperatures.

Tolerances: keys, random bits and uniforms equal JAX's bit for bit.  The
gumbel noise takes two logs, whose last bit differs between XLA's and
torch's CPU `log`: it is held to 2 ulps of max(1, |g|) (the largest
reading over 64 rows of 126464 is 2).  Tokens are then equal except at
an exact fp32 tie of noise plus log-probability, which these inputs do
not hit.  `transform_logits` sums in another order than XLA: its
probabilities are held to 1e-6 absolute (fp32 rounding of values <= 1)
with the same support, ties included.  Streams: as in
tests/test_torch_serving.py, identical in fp32; in bf16 a stream may part
from the reference's only where the reference's sampled scores (noise +
log p) of the two tokens are within the bf16 logit tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from util import smap_env
from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.launch.mesh import make_local_mesh
from repro.models import embedding as JE
from repro.models import model as JM
from repro.serving.online import OnlineConfig as JConfig
from repro.serving.online import OnlineEngine as JEngine
from repro.serving.online import OnlineRequest as JRequest
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.models import embedding as TE
from repro_torch.models import model as TM
from repro_torch.models import prng
from repro_torch.serving.online import OnlineConfig, OnlineEngine, \
    OnlineRequest

PS = 8
SEEDS = np.array([0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.int64)
POS = np.array([0, 3, 2 ** 20, 511, 2 ** 20 - 1, 77], np.int64)
GUMBEL_ULPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_keys(seeds, pos, stream):
    return np.asarray(JE.sample_keys(jnp.asarray(seeds.astype(np.uint32)),
                                     jnp.asarray(pos.astype(np.uint32)),
                                     stream)).astype(np.int64)


# ---------------------------------------------------------------------------
# the key schedule and the samplers, bit for bit
# ---------------------------------------------------------------------------


def test_prng_key_matches_jax():
    for seed in (0, 1, 42, 2 ** 31 - 1):
        want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
        assert prng.prng_key(seed).tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("stream", [TE.STREAM_SAMPLE, TE.STREAM_DRAFT,
                                    TE.STREAM_ACCEPT, TE.STREAM_RESID])
def test_sample_keys_match_jax(stream):
    got = TE.sample_keys(torch.tensor(SEEDS), torch.tensor(POS), stream)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _jax_keys(SEEDS, POS, stream))


@pytest.mark.parametrize("width", [1, 511, 512, 126464])
def test_random_bits_and_uniform_match_jax(width):
    rows = 2 if width > 512 else len(SEEDS)
    keys = _jax_keys(SEEDS[:rows], POS[:rows], TE.STREAM_SAMPLE)
    jk = jnp.asarray(keys.astype(np.uint32))
    bits = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (width,), jnp.uint32))(jk))
    uni = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (width,)))(jk))
    tk = torch.tensor(keys)
    np.testing.assert_array_equal(prng.random_bits(tk, (width,)).numpy(),
                                  bits.astype(np.int64))
    u = prng.uniform(tk, (width,)).numpy()
    np.testing.assert_array_equal(u.view(np.int32), uni.view(np.int32))
    # a scalar uniform per key (spec decoding's accept draws)
    one = np.asarray(jax.vmap(jax.random.uniform)(jk))
    np.testing.assert_array_equal(prng.uniform(tk).numpy(), one)


def test_gumbel_within_ulps_and_categorical_tokens():
    rs = np.random.RandomState(0)
    keys = rs.randint(0, 2 ** 32, size=(256, 2), dtype=np.uint64) \
        .astype(np.int64)
    jk = jnp.asarray(keys.astype(np.uint32))
    V = 4096
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jk[:16]))
    tg = prng.gumbel(torch.tensor(keys[:16]), (V,)).numpy()
    ulp = np.spacing(np.maximum(1.0, np.abs(g)).astype(np.float32))
    assert (np.abs(tg.astype(np.float64) - g) <= GUMBEL_ULPS * ulp).all()
    logits = (2.0 * rs.randn(256, V)).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(jk,
                                                        jnp.asarray(logits)))
    got = prng.categorical(torch.tensor(keys), torch.tensor(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def _knobs(T, rs):
    temp = rs.choice([0.0, 0.5, 0.8, 1.5], T).astype(np.float32)
    top_p = rs.choice([1.0, 0.3, 0.9, 0.95], T).astype(np.float32)
    top_k = rs.choice([0, 1, 5, 64], T).astype(np.int32)
    return temp, top_p, top_k


def test_transform_logits_matches_jax_with_ties():
    rs = np.random.RandomState(1)
    T, V = 64, 512
    # logits on a coarse grid: many exact ties at the top-k / top-p cuts
    logits = np.round(2.0 * rs.randn(T, V)).astype(np.float32)
    temp, top_p, top_k = _knobs(T, rs)
    temp = np.maximum(temp, 0.5)
    want = np.asarray(JE.transform_logits(*map(jnp.asarray,
                                               (logits, temp, top_p, top_k))))
    got = TE.transform_logits(*map(torch.tensor,
                                   (logits, temp, top_p, top_k))).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def smoke_cfgs():
    return jcfg("ling-lite"), tcfg("ling-lite")


def _jax_sample(jc, logits, seeds, pos, temp, top_p, top_k, stream):
    call, _ = smap_env(lambda env, *a: JE.sharded_sample(
        jc, env, a[0], seeds=a[1], pos=a[2], temperature=a[3], top_p=a[4],
        top_k=a[5], stream=stream), out_specs=(P(), P()))
    tok, probs = call(*map(jnp.asarray,
                           (logits, seeds, pos, temp, top_p, top_k)))
    return np.asarray(tok), np.asarray(probs)


@pytest.mark.parametrize("stream", [TE.STREAM_SAMPLE, TE.STREAM_DRAFT])
def test_sharded_sample_and_sampled_probs_match_jax(smoke_cfgs, stream):
    jc, tc = smoke_cfgs
    rs = np.random.RandomState(2)
    T, V = 256, 512
    logits = (3.0 * rs.randn(T, V)).astype(np.float32)
    seeds = rs.randint(0, 2 ** 31, T).astype(np.int32)
    pos = rs.randint(0, 4096, T).astype(np.int32)
    temp, top_p, top_k = _knobs(T, rs)
    want_tok, want_p = _jax_sample(jc, logits, seeds, pos, temp, top_p,
                                   top_k, stream)
    args = [torch.tensor(a) for a in (seeds, pos, temp, top_p, top_k)]
    tok, probs = TE.sharded_sample(tc, torch.tensor(logits), seeds=args[0],
                                   pos=args[1], temperature=args[2],
                                   top_p=args[3], top_k=args[4],
                                   stream=stream)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_allclose(probs.numpy(), want_p, rtol=0, atol=1e-6)
    greedy, p2 = TE.sampled_probs(tc, torch.tensor(logits), args[2], args[3],
                                  args[4])
    assert torch.equal(p2, probs)
    cold = temp <= 0
    np.testing.assert_array_equal(tok.numpy()[cold], greedy.numpy()[cold])
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


# -- the reference's contracts of the transforms (tests/test_sampling.py) ----

def test_top_k_truncates_support():
    rs = np.random.RandomState(0)
    logits = torch.tensor(rs.randn(3, 32).astype(np.float32))
    for k in (1, 4, 9):
        probs = TE.transform_logits(logits, torch.ones(3), torch.ones(3),
                                    torch.full((3,), k)).numpy()
        assert (np.sum(probs > 0, axis=-1) == k).all()
        np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
        for r in range(3):
            top = np.argsort(logits.numpy()[r])[-k:]
            assert set(np.flatnonzero(probs[r])) == set(top)


def test_top_p_mass_truncation():
    rs = np.random.RandomState(1)
    logits = torch.tensor(rs.randn(4, 64).astype(np.float32))
    full = torch.softmax(logits, -1).numpy()
    for p in (0.3, 0.7, 0.95):
        probs = TE.transform_logits(logits, torch.ones(4),
                                    torch.full((4,), p),
                                    torch.zeros(4, dtype=torch.int32)).numpy()
        np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
        for r in range(4):
            kept = probs[r] > 0
            mass = full[r][kept].sum()
            assert mass >= p - 1e-6, (p, mass)
            assert mass - full[r][kept].min() < p + 1e-6, (p, mass)
            assert full[r][kept].min() >= full[r][~kept].max()


def test_top_p_one_and_top_k_zero_are_identity():
    rs = np.random.RandomState(2)
    logits = torch.tensor(rs.randn(2, 16).astype(np.float32))
    probs = TE.transform_logits(logits, torch.ones(2), torch.ones(2),
                                torch.zeros(2, dtype=torch.int32))
    np.testing.assert_allclose(probs.numpy(),
                               torch.softmax(logits, -1).numpy(), rtol=1e-5)


def test_temperature_sharpens():
    logits = torch.tensor([[0.0, 1.0, 2.0]])
    one = lambda t: TE.transform_logits(logits, torch.tensor([t]),
                                        torch.ones(1),
                                        torch.zeros(1, dtype=torch.int32))
    hot, cold = one(2.0), one(0.5)
    assert cold[0, 2] > hot[0, 2] and cold[0, 0] < hot[0, 0]


def test_sample_keys_distinct_per_position_and_stream():
    seeds, pos = torch.tensor([7, 7, 8]), torch.tensor([3, 4, 3])
    ks = TE.sample_keys(seeds, pos, TE.STREAM_SAMPLE)
    kd = TE.sample_keys(seeds, pos, TE.STREAM_DRAFT)
    assert not torch.equal(ks[0], ks[1])
    assert not torch.equal(ks[0], ks[2])
    assert not (ks == kd).any(-1).all()


# ---------------------------------------------------------------------------
# the sampled serving steps against the reference's
# ---------------------------------------------------------------------------


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
                tparams=interop.params_from_numpy(ref, tc, device="cpu"),
                trunner=tapi.Runner(tc, device="cpu"))


def test_sampled_paged_steps_match_reference(models):
    """Two requests prefilled in chunks of 8 with the sampled prefill, then
    4 sampled decode ticks over 4 slots (2 inactive), the same tokens fed
    to both packages: every sampled token equal."""
    m = models
    jc, tc, runner = m["jc"], m["tc"], m["runner"]
    B, n_lp = 4, 4
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, tc.vocab_size, n).astype(np.int32)
               for n in (11, 6)]
    table = np.zeros((B, n_lp), np.int32)
    table[0], table[1] = [3, 1, 4, 2], [5, 6, 7, 8]
    seeds = np.array([12, 2 ** 31 - 5, 0, 0], np.int32)
    temp = np.array([0.9, 0.0, 0.0, 0.0], np.float32)
    top_p = np.array([0.95, 1.0, 1.0, 1.0], np.float32)
    top_k = np.array([16, 0, 0, 0], np.int32)
    jpre = jax.jit(runner.make_paged_prefill(PS, sample=True))
    jdec = jax.jit(runner.make_paged_decode_step(PS, sample=True))
    jpools = runner.init_paged_pools(9, PS)
    tpre = m["trunner"].make_paged_prefill(PS, sample=True)
    tdec = m["trunner"].make_paged_decode_step(PS, sample=True)
    tpools = m["trunner"].init_paged_pools(9, PS)
    toks = np.zeros((B,), np.int32)
    for b, p in enumerate(prompts):
        for base in range(0, len(p), PS):
            chunk = np.zeros((PS,), np.int32)
            nv = min(PS, len(p) - base)
            chunk[:nv] = p[base:base + nv]
            knobs = (int(seeds[b]), float(temp[b]), float(top_p[b]),
                     int(top_k[b]))
            jt, jpools = jpre(m["jparams"], jpools, jnp.asarray(chunk),
                              jnp.int32(base), jnp.int32(nv),
                              jnp.asarray(table[b]), jnp.uint32(knobs[0]),
                              jnp.float32(knobs[1]), jnp.float32(knobs[2]),
                              jnp.int32(knobs[3]))
            tt, tpools = tpre(m["tparams"], tpools, torch.tensor(chunk),
                              base, nv, torch.tensor(table[b]), *knobs)
            jt_h = jax.device_get(jt)
            if base + nv == len(p):
                assert int(tt) == int(jt_h), (b, base)
                toks[b] = int(jt_h)
    active = np.array([True, True, False, False])
    lens = np.array([len(p) for p in prompts] + [0, 0], np.int32)
    for _ in range(4):
        jt, jpools = jdec(m["jparams"], jpools, jnp.asarray(toks),
                          jnp.asarray(lens), jnp.asarray(table),
                          jnp.asarray(active), jnp.asarray(seeds),
                          jnp.asarray(temp), jnp.asarray(top_p),
                          jnp.asarray(top_k))
        tt, tpools = tdec(m["tparams"], tpools, torch.tensor(toks),
                          torch.tensor(lens), torch.tensor(table),
                          torch.tensor(active),
                          *map(torch.tensor, (seeds, temp, top_p, top_k)))
        jt_h = jax.device_get(jt)
        np.testing.assert_array_equal(tt.numpy()[:2], jt_h[:2])
        toks = jt_h.astype(np.int32)
        lens = lens + active


def _drive(eng, make_req, reqs):
    rr = [make_req(rid=rid, prompt=p, max_new=n, **kw)
          for rid, p, n, kw in reqs]
    eng.submit_many(rr)
    eng.run(max_ticks=3000)
    assert all(r.done for r in rr)
    eng.alloc.check_invariants()
    return {r.rid: list(r.out) for r in rr}, list(eng.admission_log)


def _mixed_reqs(vocab):
    rs = np.random.RandomState(6)
    out = []
    for i in range(12):
        kw = ({} if i % 2 == 0 else
              dict(temperature=0.8, top_p=0.95, top_k=64, seed=1000 + i))
        out.append((i, rs.randint(0, vocab, 4 + (i % 5)).astype(np.int32),
                    8 + (i % 9), kw))
    return out


GEO = dict(max_slots=4, max_context=32, page_size=PS, n_pages=9,
           prefill_chunk=4)


def test_engine_mixed_temperature_matches_reference(models):
    """Greedy and sampled requests in one batch, through a pool small
    enough to preempt: the port's streams and admissions are the JAX
    engine's."""
    m = models
    reqs = _mixed_reqs(m["tc"].vocab_size)
    jout, jlog = _drive(JEngine(m["runner"], m["jparams"], JConfig(**GEO)),
                        JRequest, reqs)
    teng = OnlineEngine(m["trunner"], m["tparams"], OnlineConfig(**GEO))
    tout, tlog = _drive(teng, OnlineRequest, reqs)
    assert teng.n_preemptions > 0
    assert tlog == jlog
    assert_sampled_streams_match(m, reqs, jout, tout)


def assert_sampled_streams_match(m, reqs, ref, out):
    """Identical streams; in bf16 a stream may part from the reference's
    only where the reference's scores of the two tokens — logits for a
    greedy request, gumbel noise + log p for a sampled one — are within
    the bf16 logit tolerance (2^-6 of the largest logit, over the
    temperature)."""
    tol_rel = {"float32": 0.0, "bfloat16": 2.0 ** -6}[m["dt"]]
    fns = None
    for rid, prompt, _, kw in reqs:
        r, o = ref[rid], out[rid]
        if o == r:
            continue
        assert tol_rel > 0, (rid, r, o)
        s = next(i for i, (a, b) in enumerate(zip(r, o)) if a != b)
        seq = np.concatenate([prompt, np.asarray(r[:s], np.int32)])
        if fns is None:
            import test_torch_serving as ts
            fns = dict(m, **dict(zip(("prefill", "decode", "pools"),
                                     ts._reference_fns(m["jc"]))),
                       jplain=jax.tree.map(jnp.asarray, m["jparams"]))
            next_logits = ts._ref_next_logits
        logits = next_logits(fns, seq)
        tol = tol_rel * float(np.abs(logits).max())
        if kw.get("temperature", 0.0) > 0:
            t = kw["temperature"]
            probs = np.asarray(JE.transform_logits(
                jnp.asarray(logits[None]), jnp.asarray([t], jnp.float32),
                jnp.asarray([kw["top_p"]], jnp.float32),
                jnp.asarray([kw["top_k"]], jnp.int32)))[0]
            key = _jax_keys(np.array([kw["seed"]]), np.array([len(seq) - 1]),
                            TE.STREAM_SAMPLE)
            g = np.asarray(jax.random.gumbel(
                jnp.asarray(key[0].astype(np.uint32)), probs.shape))
            score = g + np.log(probs)
            tol = tol / t
        else:
            score = logits
        gap = abs(float(score[r[s]] - score[o[s]]))
        assert gap <= tol, (f"rid {rid} parts at step {s} ({r[s]} vs "
                            f"{o[s]}) with a score gap of {gap} > {tol}")


# ---------------------------------------------------------------------------
# the engine's own sampling contracts (tests/test_sampling.py's)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    tc = tcfg("ling-lite")
    runner = tapi.Runner(tc, device="cpu")
    return runner, runner.init_params(0)


def _run_engine(runner, params, prompts, max_new, *, ocfg=None, **knobs):
    eng = OnlineEngine(runner, params, ocfg or OnlineConfig(
        max_slots=len(prompts), max_context=64, page_size=16,
        prefill_chunk=4))
    eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i],
                                   max_new=max_new, **knobs)
                     for i in range(len(prompts))])
    eng.run(max_ticks=1000)
    return [list(eng.reqs[i].out) for i in range(len(prompts))], eng


def test_explicit_temp0_is_default_greedy(smoke):
    runner, params = smoke
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, runner.cfg.vocab_size, 6).astype(np.int32)
               for _ in range(4)]
    ref, _ = _run_engine(runner, params, prompts, 5)
    out, _ = _run_engine(runner, params, prompts, 5, temperature=0.0,
                         top_p=0.9, top_k=5, seed=123)
    assert out == ref


def test_per_slot_key_independence(smoke):
    runner, params = smoke
    rs = np.random.RandomState(4)
    prompt = rs.randint(0, runner.cfg.vocab_size, 6).astype(np.int32)
    prompts = [prompt.copy() for _ in range(4)]
    seeds = [11, 11, 97, 500]
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=4, max_context=64, page_size=16, prefill_chunk=4))
    eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i], max_new=8,
                                   temperature=1.5, seed=seeds[i])
                     for i in range(4)])
    eng.run(max_ticks=1000)
    outs = [list(eng.reqs[i].out) for i in range(4)]
    assert outs[0] == outs[1]
    assert outs[0] != outs[2] or outs[0] != outs[3]
    out2, _ = _run_engine(runner, params, prompts, 8, temperature=1.5,
                          seed=11)
    assert out2[0] == outs[0]


def test_engine_defaults_apply_from_config(smoke):
    runner, params = smoke
    rs = np.random.RandomState(6)
    prompt = rs.randint(0, runner.cfg.vocab_size, 6).astype(np.int32)
    ocfg = OnlineConfig(max_slots=2, max_context=64, page_size=16,
                        prefill_chunk=4, temperature=1.5, seed=77)
    eng = OnlineEngine(runner, params, ocfg)
    eng.submit_many([OnlineRequest(rid=0, prompt=prompt.copy(), max_new=6),
                     OnlineRequest(rid=1, prompt=prompt.copy(), max_new=6,
                                   temperature=0.0)])
    eng.run(max_ticks=500)
    hot = list(eng.reqs[0].out)
    ref, _ = _run_engine(runner, params, [prompt.copy()], 6)
    assert list(eng.reqs[1].out) == ref[0]
    eng2 = OnlineEngine(runner, params, ocfg)
    eng2.submit(OnlineRequest(rid=5, prompt=prompt.copy(), max_new=6,
                              temperature=1.5, seed=77))
    eng2.run(max_ticks=500)
    assert list(eng2.reqs[5].out) == hot


def test_sampled_streams_survive_preemption_and_radix_off(smoke):
    """The (seed, pos, stream) keys make a sampled stream a function of
    its prefix: a pool that forces preemption and the radix cache off
    both give the big pool's streams."""
    runner, params = smoke
    reqs = _mixed_reqs(runner.cfg.vocab_size)
    base, _ = _drive(OnlineEngine(runner, params,
                                  OnlineConfig(**dict(GEO, n_pages=None))),
                     OnlineRequest, reqs)
    small = OnlineEngine(runner, params, OnlineConfig(**GEO))
    out, _ = _drive(small, OnlineRequest, reqs)
    assert small.n_preemptions > 0 and out == base
    off, _ = _drive(OnlineEngine(runner, params, OnlineConfig(
        **dict(GEO, radix_cache=False))), OnlineRequest, reqs)
    assert off == base


# ---------------------------------------------------------------------------
# rwkv6's sampled dense decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rwkv6_sampled_decode_step_matches_reference(dt):
    jc = dataclasses.replace(jcfg("rwkv6-3b"), compute_dtype=dt)
    tc = dataclasses.replace(tcfg("rwkv6-3b"), compute_dtype=dt)
    B, S = 4, 16
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=S)
    jparams = runner.init_params(0)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tc, device="cpu")
    jdec, _ = runner.make_decode_step(global_batch=B, seq_len=S,
                                      sample=True)
    jdec = jax.jit(jdec)
    jcaches = JM.init_caches(jc, runner.env, B, S, cross_len=0)
    tdec = tapi.Runner(tc, device="cpu").make_decode_step(sample=True)
    tcaches = TM.init_caches(tc, B, "cpu")
    rs = np.random.RandomState(7)
    tok = rs.randint(0, tc.vocab_size, B).astype(np.int32)
    seeds = np.array([3, 14, 15, 92], np.int32)
    temp = np.array([0.9, 0.0, 1.3, 0.7], np.float32)
    top_p = np.array([0.95, 1.0, 1.0, 0.5], np.float32)
    top_k = np.array([0, 0, 8, 0], np.int32)
    for pos in range(6):
        jt, jcaches = jdec(jparams, jcaches, jnp.asarray(tok),
                           jnp.int32(pos), *map(jnp.asarray,
                                                (seeds, temp, top_p, top_k)))
        tt, tcaches = tdec(tparams, tcaches, torch.tensor(tok), pos,
                           *map(torch.tensor, (seeds, temp, top_p, top_k)))
        jt_h = jax.device_get(jt)
        np.testing.assert_array_equal(tt.numpy(), jt_h)
        tok = jt_h.astype(np.int32)


def test_sampled_flood_engine_matches_reference():
    """The offline Flood engine on the sampled rwkv6 decode step (fp32):
    the reference's `build_model_engine` with the same knobs and seed
    base emits the same tokens, request for request."""
    from repro.launch import serve as jserve
    from repro.serving import flood as jflood
    from repro.serving.segment_cache import SegmentCache as JCache
    from repro_torch.launch import serve as tserve
    from repro_torch.serving import flood as tflood
    from repro_torch.serving.segment_cache import SegmentCache
    jc = dataclasses.replace(jcfg("rwkv6-3b"), compute_dtype="float32")
    tc = dataclasses.replace(tcfg("rwkv6-3b"), compute_dtype="float32")
    knobs = dict(temperature=0.9, top_p=0.95, top_k=32, seed=21)
    mesh = make_local_mesh(1, 1)

    def run(mod, cache_cls, fns):
        embed_fn, stage_fns, head_fn = fns
        rs = np.random.RandomState(0)
        reqs = [mod.GenRequest(rid=i, prompt=rs.randint(
            0, tc.vocab_size, 8).astype(np.int32), max_new=6)
            for i in range(6)]
        eng = mod.FloodEngine(stage_fns, head_fn, embed_fn,
                              cache=cache_cls(max_tokens=1 << 16,
                                              initial_segment=32,
                                              extend_chunk=32),
                              microbatch=2)
        eng.submit(reqs)
        eng.run()
        return [r.out for r in reqs]

    want = run(jflood, JCache, jserve.build_model_engine(
        jc, mesh, 2, 64, 2, **knobs))
    runner = japi.Runner(jc, mesh, fsdp=False, seq_parallel=False,
                         max_seq=64)
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, runner.init_params(0)), tc, device="cpu")
    got = run(tflood, SegmentCache, tserve.build_model_engine(
        tapi.Runner(tc, device="cpu"), params, 2, 2, **knobs))
    assert got == want


# ---------------------------------------------------------------------------
# on the card: the key schedule gives the CPU's bits
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_key_schedule_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seeds, pos = torch.tensor(SEEDS), torch.tensor(POS)
    for stream in range(4):
        cpu = TE.sample_keys(seeds, pos, stream)
        dev = TE.sample_keys(seeds.cuda(), pos.cuda(), stream)
        assert torch.equal(dev.cpu(), cpu)
    keys = TE.sample_keys(seeds, pos, 0)
    for width in (1, 511, 126464):
        assert torch.equal(prng.random_bits(keys.cuda(), (width,)).cpu(),
                           prng.random_bits(keys, (width,)))
        assert torch.equal(prng.uniform(keys.cuda(), (width,)).cpu(),
                           prng.uniform(keys, (width,)))
    assert torch.equal(prng.uniform(keys.cuda()).cpu(), prng.uniform(keys))
