"""Sequence scoring and the eval harness: the port's
`Runner.make_score_fn` against the reference's on converted smoke
Ling-Lite weights, and the port's copy of `evals/harness.py` against the
original (its datasets item for item, its reports on the same score and
decode functions, and on the two packages' own functions).

Tolerances on a sequence's score (a sum of n log-probabilities): each
log p moves by at most twice its logits' largest error.  In fp32 the
packages differ by fp32 summation order, 1e-4 of the largest logit (as
tests/test_torch_serving.py holds the logits), so a score is held to
n * 2e-4 * the largest logit; in bf16 the logits' bar is 2^-6 of the
largest, so n * 2^-5 * the largest logit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.evals import harness as JH
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.evals import harness as TH
from repro_torch.models import embedding as TE
from repro_torch.models import model as TM

B, S = 3, 24
SCORE_BAR = {"float32": 2e-4, "bfloat16": 2.0 ** -5}


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
                         seq_parallel=False, max_seq=64)
    jparams = runner.init_params(0)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tc, device="cpu")
    return dict(jc=jc, tc=tc, runner=runner, jparams=jparams,
                tparams=tparams, trunner=tapi.Runner(tc, device="cpu"))


@pytest.fixture(scope="module")
def fp32():
    return _models("float32")


def _largest_logit(tc, params, tokens):
    with torch.no_grad():
        x, _, _, _ = TM.forward(tc, params,
                                {"tokens": torch.from_numpy(tokens).long()},
                                train=False)
        return float(TE.serve_logits(tc, params["embed"], x).abs().max())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_score_fn_matches_reference(dt, fp32):
    m = fp32 if dt == "float32" else _models(dt)
    tc = m["tc"]
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, tc.vocab_size, (B, S)).astype(np.int32)
    mask = (rs.rand(B, S) < 0.7).astype(np.float32)
    want = np.asarray(jax.jit(m["runner"].make_score_fn(B, S))(
        m["jparams"], jnp.asarray(tokens), jnp.asarray(mask)))
    got = m["trunner"].make_score_fn()(m["tparams"], tokens, mask)
    assert got.dtype == torch.float32 and got.shape == (B,)
    n = mask[:, 1:].sum(axis=1)
    tol = n * SCORE_BAR[dt] * _largest_logit(tc, m["tparams"],
                                             tokens[:, :-1])
    err = np.abs(got.numpy() - want)
    assert (err <= tol).all(), (got, want, tol)
    assert (got.numpy() < 0).all()


def test_fewer_positions_give_higher_totals(fp32):
    """Every log p is negative, so scoring a subset of the positions
    gives a higher total, and an empty mask gives 0."""
    tc = fp32["tc"]
    score = fp32["trunner"].make_score_fn()
    tokens = np.random.RandomState(1).randint(0, tc.vocab_size, (2, S))
    full = np.ones((2, S), np.float32)
    half = full.copy()
    half[:, S // 2:] = 0
    a = score(fp32["tparams"], tokens, full)
    b = score(fp32["tparams"], tokens, half)
    assert (b > a).all()
    assert (score(fp32["tparams"], tokens, np.zeros_like(full)) == 0).all()


def test_harness_copy_gives_the_references_datasets_and_reports():
    """Datasets item for item, and every report on the same (numpy) score
    and decode functions."""
    for n, vocab, seed in ((12, 512, 0), (7, 126464, 3)):
        for ja, ta in zip(JH.make_mc_dataset(n, vocab, seed),
                          TH.make_mc_dataset(n, vocab, seed)):
            assert np.array_equal(ja.context, ta.context)
            assert all(np.array_equal(x, y)
                       for x, y in zip(ja.options, ta.options))
            assert (ja.answer, ja.ability) == (ta.answer, ta.ability)
        for ja, ta in zip(JH.make_gen_dataset(n, vocab, seed),
                          TH.make_gen_dataset(n, vocab, seed)):
            assert np.array_equal(ja.prompt, ta.prompt)
            assert np.array_equal(ja.answer, ta.answer)
            assert ja.ability == ta.ability

    def score(tokens, mask):             # a pattern-follower's likelihood
        d = np.diff(tokens.astype(np.int64)) % 512
        return float(-np.sum(mask[1:] * (d != np.roll(d, 1))))

    def decode(prompt, max_new):
        stride = int(prompt[-1]) - int(prompt[-2])
        return (prompt[-1] + stride * np.arange(1, max_new + 1)) % 512

    items, gens = TH.make_mc_dataset(12, 512), TH.make_gen_dataset(8, 512)
    jitems, jgens = JH.make_mc_dataset(12, 512), JH.make_gen_dataset(8, 512)
    assert (TH.ppl_eval_content(items, score)
            == JH.ppl_eval_content(jitems, score))
    assert (TH.ppl_eval_label(items, score, [1, 2, 3, 4])
            == JH.ppl_eval_label(jitems, score, [1, 2, 3, 4]))
    for kw in ({}, {"task_prefix": np.arange(3), "stop_token": 7}):
        assert (TH.gen_eval(gens, decode, **kw)
                == JH.gen_eval(jgens, decode, **kw))
    a, b = {"accuracy": 0.5, "ability/math": 0.7}, {"accuracy": 0.52,
                                                     "ability/math": 0.4}
    assert TH.consistency(a, b) == JH.consistency(a, b)
    assert (dataclasses.asdict(TH.attribute_regression(a, b))
            == dataclasses.asdict(JH.attribute_regression(a, b)))


def _jax_decode_fn(m):
    """The reference's greedy decode for the harness: prefill, caches
    padded to 32 positions, then dense decode ticks."""
    runner, jc = m["runner"], m["jc"]
    jdec, _ = runner.make_decode_step(global_batch=1, seq_len=32)
    jdec = jax.jit(jdec)
    jpre = jax.jit(runner.make_prefill(global_batch=1))

    def fn(prompt, max_new):
        tok, caches = jpre(m["jparams"],
                           {"tokens": jnp.asarray(prompt[None])})
        ref = JM.init_caches(jc, runner.env, 1, 32)
        caches = jax.tree.map(
            lambda a, r: jnp.pad(a, [(0, y - x)
                                     for x, y in zip(a.shape, r.shape)]),
            caches, ref)
        out = [tok]
        for pos in range(len(prompt), len(prompt) + max_new - 1):
            tok, caches = jdec(m["jparams"], caches, tok, jnp.int32(pos))
            out.append(tok)
        return np.concatenate(jax.device_get(out))
    return fn


def _torch_decode_fn(m):
    runner = m["trunner"]
    decode = runner.make_decode_step()

    def fn(prompt, max_new):
        tok, caches = runner.make_prefill(seq_len=32)(
            m["tparams"], {"tokens": torch.from_numpy(prompt[None]).long()})
        out = [tok]
        for pos in range(len(prompt), len(prompt) + max_new - 1):
            tok, caches = decode(m["tparams"], caches, tok, pos)
            out.append(tok)
        return torch.cat(out).numpy()
    return fn


def test_harness_reports_on_each_packages_functions(fp32):
    """fp32: the harness gives the same reports on the port's score and
    decode functions as on the reference's, and the same continuations."""
    m = fp32
    vocab = m["tc"].vocab_size
    jscore = jax.jit(m["runner"].make_score_fn(1, 16))
    tscore = m["trunner"].make_score_fn()

    def jfn(t, mk):
        return float(jscore(m["jparams"], jnp.asarray(t[None]),
                            jnp.asarray(mk[None]))[0])

    def tfn(t, mk):
        return float(tscore(m["tparams"], t[None], mk[None])[0])

    items = TH.make_mc_dataset(4, vocab)
    assert TH.ppl_eval_content(items, tfn) == JH.ppl_eval_content(items, jfn)
    assert (TH.ppl_eval_label(items, tfn, [1, 2, 3, 4])
            == JH.ppl_eval_label(items, jfn, [1, 2, 3, 4]))
    gens = TH.make_gen_dataset(3, vocab)
    jdec, tdec = _jax_decode_fn(m), _torch_decode_fn(m)
    for it in gens:
        np.testing.assert_array_equal(tdec(it.prompt, 6),
                                      jdec(it.prompt, 6))
    assert (TH.gen_eval(gens, tdec, max_new=6)
            == JH.gen_eval(gens, jdec, max_new=6))
