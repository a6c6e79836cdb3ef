"""The port's dense (non-paged) KV-cache decode of attention blocks against
the JAX package's, on converted smoke Ling-Lite weights: `make_prefill`
into caches grown to the decode length, then `make_decode_step` (the
reference's tests/test_prefill_decode.py for the ported arch, and its
caches and logits), the overflow branch once the position passes the
cache's length, and the port's own contracts: prefill-then-decode equals
token-by-token decode, the online engine equals dense decode bit for bit
(greedy and sampled: the port's versions of the reference's
`test_online_matches_fixed_batch_decode` and
`test_offline_online_parity_at_nonzero_temp`), the fused and gathered
attention modes give the same streams, and what the dense cache refuses.

Tolerances: in fp32 the packages differ by fp32 summation order only,
so caches and logits agree within 1e-5 and 1e-4 of their largest values
and the greedy streams are identical.  In bf16 XLA and torch may round a
bf16 product one ulp apart (29 % of the prefill's cache elements here),
so logits agree within 2^-6 of the largest and a stream may part only at
the reference's near-tie (its top two logits closer than that), after
which nothing is compared, as in tests/test_torch_serving.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.launch.mesh import make_local_mesh
from repro.models import embedding as JE
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.online import OnlineConfig, OnlineEngine, \
    OnlineRequest

B, P_LEN, S, NEW = 2, 12, 32, 6
TIE_TOL = {"float32": 0.0, "bfloat16": 2.0 ** -6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(dt):
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype=dt)
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype=dt)
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=S)
    jparams = runner.init_params(0)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tc, device="cpu")
    return dict(jc=jc, tc=tc, runner=runner, jparams=jparams,
                tparams=tparams, trunner=tapi.Runner(tc, device="cpu"),
                dt=dt)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    return _models(request.param)


def _jax_logits_step(m):
    """A jitted reference decode tick that returns the logits: the
    reference's `decode_step` up to its argmax."""
    jc, runner = m["jc"], m["runner"]
    env = dataclasses.replace(runner.env, seq_parallel=False)

    def fn(params, caches, token, pos):
        x = JE.embed_tokens(jc, env, params["embed"], token)

        def body(x, inp):
            lp, cache = inp
            return JM.block_decode(jc, env, lp, x, cache, pos, kind="attn",
                                   ffn="moe")

        x, caches = jax.lax.scan(body, x, (params["blocks"], caches))
        x = JL.apply_norm(jc, env, params["final_norm"], x)
        return JE.lm_logits(jc, env, params["embed"], x), caches

    cspec = {"self": {"k": P(), "v": P()}}
    return jax.jit(jax.shard_map(
        fn, mesh=runner.mesh, in_specs=(runner.specs, cspec, P(), P()),
        out_specs=(P(), cspec), check_vma=False))


def _jax_prefill(m, prompt, seq_len):
    """The reference's prefill, its caches padded to seq_len as its
    tests/test_prefill_decode.py pads them."""
    runner, jc = m["runner"], m["jc"]
    first, caches = jax.jit(runner.make_prefill(global_batch=B))(
        m["jparams"], {"tokens": jnp.asarray(prompt)})
    ref = JM.init_caches(jc, runner.env, B, seq_len)
    caches = jax.tree.map(
        lambda a, r: jnp.pad(a, [(0, y - x) for x, y in zip(a.shape,
                                                            r.shape)]),
        caches, ref)
    return first, caches


def _prompt(vocab, seed=0, n=P_LEN):
    return np.random.RandomState(seed).randint(0, vocab, (B, n)) \
        .astype(np.int32)


def _cache_np(c):
    return {k: np.asarray(v, np.float32) for k, v in c["self"].items()}


def test_prefill_then_decode_matches_reference(models):
    """Greedy prefill + decode against the reference: the prefill's first
    token and caches, then each tick's logits teacher-forced on the
    reference's tokens, and the greedy streams."""
    m = models
    dt, tc = m["dt"], m["tc"]
    prompt = _prompt(tc.vocab_size)
    jfirst, jcaches = _jax_prefill(m, prompt, S)
    tfirst, tcaches = m["trunner"].make_prefill(seq_len=S)(
        m["tparams"], {"tokens": torch.from_numpy(prompt).long()})
    assert tcaches["self"]["k"].shape == (tc.n_layers, B, S, tc.n_kv_heads,
                                          tc.head_dim)
    jc_np = _cache_np(jax.tree.map(lambda a: a.astype(jnp.float32),
                                   jcaches))
    for name in ("k", "v"):
        got = tcaches["self"][name].float().numpy()
        want = jc_np[name]
        assert not got[:, :, P_LEN:].any()          # rows past the prompt
        tol = (1e-5 if dt == "float32" else 2.0 ** -6) * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)

    jstep = _jax_logits_step(m)
    tok = np.asarray(jfirst)
    want_stream, got_stream = [tok], [tfirst.numpy()]
    parted = False
    for pos in range(P_LEN, P_LEN + NEW):
        jl, jcaches = jstep(m["jparams"], jcaches, jnp.asarray(tok),
                            jnp.int32(pos))
        with torch.no_grad():
            tl, tcaches = TM.decode_logits(
                tc, m["tparams"], tcaches, torch.from_numpy(tok.copy()).long(),
                pos)
        jl, tl = np.asarray(jl), tl.numpy()
        rel = 1e-4 if dt == "float32" else 2.0 ** -6
        np.testing.assert_allclose(tl, jl, atol=rel * np.abs(jl).max(),
                                   rtol=0, err_msg=f"pos {pos}")
        if not parted and not np.array_equal(tl.argmax(-1), jl.argmax(-1)):
            top2 = np.sort(jl, -1)[:, -2:]
            gap = (top2[:, 1] - top2[:, 0]).min()
            assert gap < TIE_TOL[dt] * np.abs(jl).max(), (pos, gap)
            parted = True
        tok = jl.argmax(-1).astype(np.int32)
        want_stream.append(tok)
        got_stream.append(tl.argmax(-1))
    if dt == "float32":
        assert not parted
        np.testing.assert_array_equal(np.stack(got_stream),
                                      np.stack(want_stream))
    # the updated caches agree too, teacher-forced on the same tokens
    jc_np = _cache_np(jax.tree.map(lambda a: a.astype(jnp.float32),
                                   jcaches))
    tol = (1e-5 if dt == "float32" else 2.0 ** -6) * np.abs(jc_np["k"]).max()
    np.testing.assert_allclose(tcaches["self"]["k"].float().numpy(),
                               jc_np["k"], atol=tol, rtol=0)


def test_greedy_streams_match_reference(models):
    """The port's own greedy loop (prefill, then ticks on its own tokens)
    emits the reference's stream; in bf16 it may part only at a
    reference near-tie."""
    m = models
    tc, dt = m["tc"], m["dt"]
    prompt = _prompt(tc.vocab_size, seed=1)
    jfirst, jcaches = _jax_prefill(m, prompt, S)
    jdec, _ = m["runner"].make_decode_step(global_batch=B, seq_len=S)
    jdec = jax.jit(jdec)
    jstep = _jax_logits_step(m)
    tok, jt = jfirst, [jfirst]
    logits = []
    for pos in range(P_LEN, P_LEN + NEW):
        logits.append(jstep(m["jparams"], jcaches, tok, jnp.int32(pos))[0])
        tok, jcaches = jdec(m["jparams"], jcaches, tok, jnp.int32(pos))
        jt.append(tok)      # device until the loop ends (FC-HOSTSYNC)
    jt, logits = jax.device_get((jt, logits))
    tfirst, tcaches = m["trunner"].make_prefill(seq_len=S)(
        m["tparams"], {"tokens": torch.from_numpy(prompt).long()})
    tdec = m["trunner"].make_decode_step()
    tok, tt = tfirst, [tfirst.numpy()]
    for pos in range(P_LEN, P_LEN + NEW):
        tok, tcaches = tdec(m["tparams"], tcaches, tok, pos)
        tt.append(tok.numpy())
    jt, tt = np.stack(jt, 1), np.stack(tt, 1)
    for b in range(B):
        if np.array_equal(jt[b], tt[b]):
            continue
        assert dt == "bfloat16", (jt[b], tt[b])
        s = int(np.argmax(jt[b] != tt[b]))
        assert s > 0, "the prefill's first tokens differ"
        lg = logits[s - 1][b]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < TIE_TOL[dt] * np.abs(lg).max(), (b, s)


def test_overflow_past_the_cache_matches_reference():
    """Past seq_len nothing is written and every cached position is
    attended (the reference's `owns` / `valid` rule), in fp32: a cache
    of 16 positions decoded to position 27."""
    m = _models("float32")
    tc, seq = m["tc"], 16
    prompt = _prompt(tc.vocab_size, seed=2, n=8)
    jfirst, jcaches = _jax_prefill(m, prompt, seq)
    tfirst, tcaches = m["trunner"].make_prefill(seq_len=seq)(
        m["tparams"], {"tokens": torch.from_numpy(prompt).long()})
    jstep = _jax_logits_step(m)
    tok = np.asarray(jfirst)
    np.testing.assert_array_equal(tfirst.numpy(), tok)
    for pos in range(8, 28):
        jl, jcaches = jstep(m["jparams"], jcaches, jnp.asarray(tok),
                            jnp.int32(pos))
        with torch.no_grad():
            tl, tcaches = TM.decode_logits(
                tc, m["tparams"], tcaches, torch.from_numpy(tok.copy()).long(),
                pos)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl,
                                   atol=1e-4 * np.abs(jl).max(), rtol=0,
                                   err_msg=f"pos {pos}")
        np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))
        tok = jl.argmax(-1).astype(np.int32)
    # nothing past the end is written
    before = tcaches["self"]["k"].clone()
    with torch.no_grad():
        lt, _ = TM.decode_logits(tc, m["tparams"], tcaches,
                                 torch.from_numpy(tok).long(), 40)
    assert torch.equal(tcaches["self"]["k"], before)
    np.testing.assert_allclose(lt.numpy(), np.asarray(jstep(
        m["jparams"], jcaches, jnp.asarray(tok), jnp.int32(40))[0]),
        atol=1e-4 * float(lt.abs().max()), rtol=0)


@pytest.mark.parametrize("seq,n_prompt,last", [(100, 12, 18), (20, 8, 28)])
def test_cache_of_any_length_matches_reference(seq, n_prompt, last):
    """Dense caches whose length is no multiple of the view's page (16),
    in fp32: the prefill's caches in the reference's (L, B, seq, KV, hd)
    shape, then each tick's logits and greedy token teacher-forced on the
    reference's tokens, past the cache's end for seq 20 (the overflow
    branch: the padding rows of the page view are never attended)."""
    m = _models("float32")
    tc = m["tc"]
    prompt = _prompt(tc.vocab_size, seed=4, n=n_prompt)
    jfirst, jcaches = _jax_prefill(m, prompt, seq)
    tfirst, tcaches = m["trunner"].make_prefill(seq_len=seq)(
        m["tparams"], {"tokens": torch.from_numpy(prompt).long()})
    assert tcaches["self"]["k"].shape == (tc.n_layers, B, seq,
                                          tc.n_kv_heads, tc.head_dim)
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    jstep = _jax_logits_step(m)
    tok = np.asarray(jfirst)
    for pos in range(n_prompt, last):
        jl, jcaches = jstep(m["jparams"], jcaches, jnp.asarray(tok),
                            jnp.int32(pos))
        with torch.no_grad():
            tl, tcaches = TM.decode_logits(
                tc, m["tparams"], tcaches, torch.from_numpy(tok.copy()).long(),
                pos)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl,
                                   atol=1e-4 * np.abs(jl).max(), rtol=0,
                                   err_msg=f"pos {pos}")
        np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))
        tok = jl.argmax(-1).astype(np.int32)
    jc_np = _cache_np(jcaches)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcaches["self"][name].numpy(),
                                   jc_np[name], rtol=0,
                                   atol=1e-5 * np.abs(jc_np[name]).max())


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    tc = tcfg("ling-lite")
    runner = tapi.Runner(tc, device="cpu")
    return runner, runner.init_params(0)


def _stepwise(runner, params, prompts, n_new, seq_len, sample=None):
    """Feed the prompts token by token through the dense ticks, then
    generate: (B, n_new) tokens."""
    b, p = prompts.shape
    decode = runner.make_decode_step(sample=sample is not None)
    caches = runner.init_caches(b, seq_len)
    knobs = () if sample is None else sample
    tok = None
    for pos in range(p):
        tok, caches = decode(params, caches,
                             torch.from_numpy(prompts[:, pos]).long(), pos,
                             *knobs)
    out = [tok]
    for pos in range(p, p + n_new - 1):
        tok, caches = decode(params, caches, tok, pos, *knobs)
        out.append(tok)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("arch", ["ling-lite"])
def test_prefill_then_decode_matches_stepwise(smoke, arch):
    """The reference's tests/test_prefill_decode.py for the ported arch:
    prefilling the prompt and decoding from its caches gives the tokens
    of feeding the prompt through the ticks one at a time."""
    runner, params = smoke
    prompt = _prompt(runner.cfg.vocab_size, seed=3, n=16)
    want = _stepwise(runner, params, prompt, 5, 64)
    first, caches = runner.make_prefill(seq_len=64)(
        params, {"tokens": torch.from_numpy(prompt).long()})
    decode = runner.make_decode_step()
    got, tok = [first], first
    for pos in range(16, 20):
        tok, caches = decode(params, caches, tok, pos)
        got.append(tok)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), want)


def _online(runner, params, prompts, n_new, seq_len, **knobs):
    b = prompts.shape[0]
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=b, max_context=seq_len, page_size=16, prefill_chunk=4))
    eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i], max_new=n_new,
                                   **{k: (v[i] if isinstance(v, list) else v)
                                      for k, v in knobs.items()})
                     for i in range(b)])
    eng.run(max_ticks=500)
    return np.stack([np.asarray(eng.reqs[i].out) for i in range(b)])


def test_online_matches_fixed_batch_decode(smoke):
    """Greedy online serving (chunked prefill + paged decode) emits what
    the dense fixed-batch ticks emit, at the same context capacity."""
    runner, params = smoke
    prompts = np.random.RandomState(0).randint(
        0, runner.cfg.vocab_size, (4, 6)).astype(np.int32)
    np.testing.assert_array_equal(_online(runner, params, prompts, 5, 64),
                                  _stepwise(runner, params, prompts, 5, 64))


def test_offline_online_parity_at_nonzero_temp(smoke):
    """The sampled dense step reproduces the online engine's sampled
    streams for the same seeds (both draw under the (seed, position,
    STREAM_SAMPLE) keys)."""
    runner, params = smoke
    b, seeds = 4, [3, 14, 15, 92]
    prompts = np.random.RandomState(5).randint(
        0, runner.cfg.vocab_size, (b, 6)).astype(np.int32)
    knobs = (torch.tensor(seeds), torch.full((b,), 0.9),
             torch.full((b,), 0.95), torch.zeros((b,), dtype=torch.long))
    want = _stepwise(runner, params, prompts, 5, 64, sample=knobs)
    got = _online(runner, params, prompts, 5, 64, temperature=0.9,
                  top_p=0.95, top_k=0, seed=seeds)
    np.testing.assert_array_equal(got, want)


def test_fused_and_gathered_dense_ticks_agree(smoke):
    """The page view through K3/K4 ("fused", their plain versions on the
    CPU) and through the gathered combine give the same greedy streams,
    past the cache's end too."""
    runner, params = smoke
    prompts = np.random.RandomState(6).randint(
        0, runner.cfg.vocab_size, (2, 10)).astype(np.int32)
    gathered = tapi.Runner(runner.cfg, device="cpu",
                           flags=TM.RunFlags(paged_attn="gathered"))
    np.testing.assert_array_equal(
        _stepwise(runner, params, prompts, 12, 16),
        _stepwise(gathered, params, prompts, 12, 16))


def test_dense_cache_refusals(smoke):
    runner, params = smoke
    with pytest.raises(ValueError, match="seq_len"):
        runner.init_caches(2)
    with pytest.raises(ValueError, match="seq_len >= 1"):
        runner.init_caches(2, 0)
    # any length is taken: the reference's shape over storage of whole
    # pages, whose padding rows a copy of the cache would lose
    odd = runner.init_caches(2, 24)["self"]["k"]
    cfg = runner.cfg
    assert odd.shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    assert TL.dense_pages(odd[0]).shape == (4, 16, cfg.n_kv_heads,
                                            cfg.head_dim)
    with pytest.raises(ValueError, match="storage of 32 rows"):
        TL.dense_pages(odd[0].clone())
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        TL.init_decode_cache(runner.cfg, 2, 32, "cpu", window=8)
    caches = runner.init_caches(2, 32)
    x = torch.zeros((2, runner.cfg.d_model))
    lp = TM.layer_params(params["blocks"], 0)["attn"]
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        TL.decode_attention(runner.cfg, lp, x,
                            TM.layer_params(caches, 0)["self"], 0,
                            cross=True)
    with pytest.raises(ValueError, match="exceeds"):
        runner.make_prefill(seq_len=16)(
            params, {"tokens": torch.zeros((1, 20), dtype=torch.long)})
