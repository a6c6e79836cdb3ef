"""The port's DPO with packing (`training/dpo.py`, paper §4.2) against
the JAX package's: the padded and packed layouts array for array,
`packing_speedup`, `sequence_logps` and `dpo_loss` (with its NLL term) on
the same log-probs, and `segment_pooled_logps` on random logits and on
the smoke Ling-Lite model's logits of packed rows (the port's forward
against the reference's, on the same weights).

Tolerances: `sequence_logps` and `dpo_loss` run the same fp32 operations
in another summation order: 1e-6 relative.  A pooled sum adds a
segment's token log-probs in another order: within 1e-6 of the sum of
their magnitudes.  On the model's logits, fp32 compute: the logits agree
within 1e-4 of their largest (as tests/test_torch_serving.py holds
them), and a token's log p moves by at most twice that, so a segment of
n tokens within n * 2e-4 of the largest logit; token counts exactly."""
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
from repro.models import model as JM
from repro.training import dpo as JD
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.models import embedding as TE
from repro_torch.models import model as TM
from repro_torch.training import dpo as TD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(mod, n, seed, vocab=99, prompt=(5, 40), resp=(10, 60)):
    rs = np.random.RandomState(seed)
    return [mod.PairExample(
        prompt=rs.randint(0, vocab, rs.randint(*prompt)).astype(np.int32),
        chosen=rs.randint(0, vocab, rs.randint(*resp)).astype(np.int32),
        rejected=rs.randint(0, vocab, rs.randint(*resp)).astype(np.int32))
        for _ in range(n)]


@pytest.mark.parametrize("n,max_len", [(64, 1024), (9, 128)])
def test_layouts_and_speedup_match_reference(n, max_len):
    """Array for array; at max_len 128 rows hold one or two pairs.  The
    padded layout cuts at max_len (32 here, shorter than most prompt +
    response), and a pair longer than a packed row raises in both."""
    kw = dict(prompt=(5, 20), resp=(10, 40))
    jp, tp = _pairs(JD, n, seed=n, **kw), _pairs(TD, n, seed=n, **kw)
    for build, length in (("pad_pairs", max_len), ("pack_pairs", max_len),
                          ("pad_pairs", 32)):
        want = getattr(JD, build)(jp, length)
        got = getattr(TD, build)(tp, length)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    assert TD.packing_speedup(tp, max_len) == JD.packing_speedup(jp, max_len)
    for mod, pairs in ((JD, jp), (TD, tp)):
        with pytest.raises(ValueError):
            mod.pack_pairs(pairs, 32)


def test_sequence_logps_and_dpo_loss_match_reference():
    rs = np.random.RandomState(0)
    logits = (3 * rs.randn(6, 20, 50)).astype(np.float32)
    labels = rs.randint(0, 50, (6, 20)).astype(np.int32)
    mask = (rs.rand(6, 20) < 0.6).astype(np.float32)
    want = np.asarray(JD.sequence_logps(jnp.asarray(logits),
                                        jnp.asarray(labels),
                                        jnp.asarray(mask)))
    got = TD.sequence_logps(torch.from_numpy(logits),
                            torch.from_numpy(labels), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    lp = [-(20 + 10 * rs.rand(8)).astype(np.float32) for _ in range(4)]
    counts = rs.randint(0, 30, 8).astype(np.float32)     # 0 clamps to 1
    for cfg_kw in ({}, {"beta": 0.5, "nll_weight": 0.0}):
        for cnt in (None, counts):
            jl, jm = JD.dpo_loss(*map(jnp.asarray, lp), JD.DPOConfig(**cfg_kw),
                                 None if cnt is None else jnp.asarray(cnt))
            tl, tm = TD.dpo_loss(*map(torch.from_numpy, lp),
                                 TD.DPOConfig(**cfg_kw),
                                 None if cnt is None else torch.from_numpy(cnt))
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
            assert set(tm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-6, err_msg=k)
    # the same model as policy and reference: the DPO term is log 2
    same = torch.from_numpy(lp[0])
    loss, mets = TD.dpo_loss(same, same, same, same)
    assert float(mets["dpo"]) == pytest.approx(np.log(2.0), rel=1e-7)
    assert float(mets["preference_acc"]) == 0.0


def _pooled(mod, logits, packed, conv):
    (c, r), n = mod.segment_pooled_logps(
        conv(logits), conv(packed["tokens"]), conv(packed["resp_mask"]),
        conv(packed["segment_ids"]), packed["n_pairs"])
    return np.asarray(c), np.asarray(r), np.asarray(n)


def _term_mass(logits, packed):
    """Per segment, the sum of |token log p| over its response tokens:
    the scale of a pooled sum's summation-order error."""
    lp = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True))
                         .sum(-1, keepdims=True)) - logits.max(-1,
                                                               keepdims=True)
    tok = np.take_along_axis(lp, packed["tokens"][..., None], -1)[..., 0]
    tok = np.abs(tok * packed["resp_mask"])
    seg = packed["segment_ids"]
    mass = np.array([tok[seg == s].sum() for s in range(2 * packed["n_pairs"])])
    return mass[0::2], mass[1::2]


def test_segment_pooled_logps_on_random_logits():
    rs = np.random.RandomState(3)
    packed = TD.pack_pairs(_pairs(TD, 6, seed=3), max_len=160)
    logits = (2 * rs.randn(*packed["tokens"].shape, 100)).astype(np.float32)
    jc, jr, jn = _pooled(JD, logits, packed, jnp.asarray)
    tc, tr, tn = _pooled(TD, logits, packed, torch.from_numpy)
    mc, mr = _term_mass(logits, packed)
    np.testing.assert_array_equal(tn, jn)
    assert np.all(np.abs(tc - jc) <= 1e-6 * mc)
    assert np.all(np.abs(tr - jr) <= 1e-6 * mr)
    # pooled over a padded layout (one segment a row), the sums are each
    # row's `sequence_logps`
    padded = TD.pad_pairs(_pairs(TD, 4, seed=4), max_len=96)
    seg = np.repeat(np.arange(8, dtype=np.int32)[:, None], 96, 1)
    lg = torch.from_numpy((2 * rs.randn(8, 96, 100)).astype(np.float32))
    toks, mask = (torch.from_numpy(padded["tokens"]),
                  torch.from_numpy(padded["resp_mask"]))
    (c, r), n = TD.segment_pooled_logps(lg, toks, mask, torch.from_numpy(seg),
                                        4)
    seq = TD.sequence_logps(lg, toks, mask)
    np.testing.assert_allclose(torch.stack([c, r], 1).reshape(-1).numpy(),
                               seq.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(n.numpy(), mask.sum(-1)[0::2].numpy())


def test_segment_pooled_logps_on_the_models_logits():
    """Packed rows of pairs through the smoke Ling-Lite forward (fp32),
    the port's and the reference's on the same weights, each package
    pooling its own logits."""
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype="float32")
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype="float32")
    max_len = 64
    packed = TD.pack_pairs(_pairs(TD, 5, seed=5, vocab=tc.vocab_size,
                                  prompt=(3, 8), resp=(3, 10)), max_len)
    seg = packed["segment_ids"]
    assert packed["tokens"].shape[0] >= 2
    assert max(len(set(row[row >= 0])) for row in seg) >= 4, \
        "a row should hold more than one pair"
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=max_len)
    jparams = runner.init_params(0)

    def fn(params, tokens):
        x, _, _, _ = JM.forward(jc, runner.env, params, {"tokens": tokens},
                                train=False)
        return JE.lm_logits(jc, runner.env, params["embed"], x)

    jlogits = np.asarray(jax.jit(jax.shard_map(
        fn, mesh=runner.mesh, in_specs=(runner.specs, P()), out_specs=P(),
        check_vma=False))(jparams, jnp.asarray(packed["tokens"])))
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tc, device="cpu")
    with torch.no_grad():
        x, _, _, _ = TM.forward(
            tc, tparams, {"tokens": torch.from_numpy(packed["tokens"]).long()},
            train=False)
        tlogits = TE.serve_logits(tc, tparams["embed"], x)
    R = packed["tokens"].shape[0]
    jlogits = jlogits.reshape(R, max_len, -1)
    tlogits = tlogits.reshape(R, max_len, -1).numpy()
    big = np.abs(jlogits).max()
    np.testing.assert_allclose(tlogits, jlogits, rtol=0, atol=1e-4 * big)
    jcs, jrs, jn = _pooled(JD, jlogits, packed, jnp.asarray)
    tcs, trs, tn = _pooled(TD, tlogits, packed, torch.from_numpy)
    np.testing.assert_array_equal(tn, jn)
    n_tok = np.array([(packed["resp_mask"] * (packed["segment_ids"] == s))
                      .sum() for s in range(2 * packed["n_pairs"])])
    bar = n_tok * 2e-4 * big
    assert np.all(np.abs(tcs - jcs) <= bar[0::2]), (tcs, jcs)
    assert np.all(np.abs(trs - jrs) <= bar[1::2]), (trs, jrs)
