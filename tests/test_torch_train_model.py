"""The port's training model against the JAX package on converted smoke
Ling-Lite weights and the same numpy-made inputs: the router in training
(aux losses, metrics, the stochastic-warmup mix with the reference's own
noise), training attention, the MoE FFN in training, and `loss_fn`'s
value and gradients; within the port, fp32 master storage and remat
on/off giving the same gradients while the router warmup is active.

Tolerances: with fp32 compute the two packages differ only in fp32
summation order: 1e-5 of the largest value (and of each gradient leaf's
largest value).  With bf16 compute every matmul output is rounded to
bf16 in both, and another fp32 summation order can round an element one
bf16 ulp (2^-8 relative) the other way; a few such ulps compound through
a block, so bf16 outputs are held to 2^-6 of the largest value."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from util import smap_env as _smap_env

from repro import api
from repro.configs.base import get_smoke_config as jcfg
from repro.core import moe as JMOE
from repro.core import router as JR
from repro.launch.mesh import make_local_mesh
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.core import moe as TMOE
from repro_torch.core import router as TR
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import prng
from repro_torch.optim import adamw as TA

DTYPES = ["float32", "bfloat16"]
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one intra-op thread, and the suite's
    parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smap_env(fn, **kw):
    call, env = _smap_env(fn, **kw)
    return jax.jit(call), env


def _tol(dt, ref):
    rel = 1e-5 if dt == "float32" else 2.0 ** -6
    return rel * float(np.abs(ref).max())


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module", params=DTYPES)
def models(request):
    dt = request.param
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype=dt)
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype=dt)
    runner = api.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                        seq_parallel=False, max_seq=S)
    ref = jax.tree.map(np.asarray, runner.init_params(0))
    tp = interop.params_from_numpy(ref, tc, device="cpu", masters=True)
    return dt, jc, tc, ref, tp


def _inputs(dt, *shape, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dt)),
            torch.tensor(x).to(getattr(torch, dt)))


def _jlayer(ref):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), ref["blocks"])


def test_master_storage_keeps_every_leaf_fp32(models):
    """Training storage is the reference's (every leaf in param_dtype);
    serving storage keeps the compute dtype for the leaves cast at use."""
    dt, _, tc, ref, tp = models
    assert {t.dtype for t in TA.leaves(tp)} == {torch.float32}
    fresh = TM.init_model(tc, device="cpu", masters=True,
                          generator=torch.Generator().manual_seed(0))
    assert {t.dtype for t in TA.leaves(fresh)} == {torch.float32}
    serve = interop.params_from_numpy(ref, tc, device="cpu")
    assert serve["blocks"]["moe"]["we1"].dtype == getattr(torch, dt)
    assert serve["blocks"]["moe"]["router"]["wr"].dtype == torch.float32
    # the masters are the reference's fp32 values, exactly
    np.testing.assert_array_equal(tp["blocks"]["moe"]["we1"].numpy(),
                                  ref["blocks"]["moe"]["we1"])


def test_route_train_aux_and_metrics(models):
    dt, jc, tc, ref, tp = models
    jx, tx = _inputs(dt, 12, jc.d_model, seed=3)
    jl = _jlayer(ref)
    call, _ = smap_env(
        lambda env, x: JR.route(jc, env, jl["moe"]["router"], x,
                                train=True),
        out_specs=(P(),) * 4)
    jw, ji, jaux, jmet = call(jx)
    tw, ti, taux, tmet = TR.route(tc, TM.layer_params(
        tp["blocks"], 0)["moe"]["router"], tx, train=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(_np(taux), float(jaux), rtol=1e-5)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("step", [0, 3, 4])
def test_warmup_mix_with_the_references_noise(step):
    """Eq. (3) with the reference's own eps (its threefry draw): step 0
    is pure noise statistics, 3 of W=4 a mix, 4 the learned logits."""
    rs = np.random.RandomState(step)
    logits = (2.0 * rs.randn(10, 4) + 0.5).astype(np.float32)
    key = jax.random.PRNGKey(11)
    call, env = smap_env(lambda env, lg: JR.stochastic_warmup_logits(
        lg, jnp.int32(step), 4, key, env))
    ref = np.asarray(call(jnp.asarray(logits)))
    eps = np.asarray(jax.random.normal(key, logits.shape, jnp.float32))
    out = TR.stochastic_warmup_logits(torch.tensor(logits), step, 4,
                                      torch.tensor(eps))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def test_training_attention(models):
    """Against the reference's `apply_attention` (its pure-JAX flash
    attention with a custom vjp), value and input grad."""
    dt, jc, tc, ref, tp = models
    jl = _jlayer(ref)
    tl = TM.layer_params(tp["blocks"], 0)
    jx, tx = _inputs(dt, B, S, jc.d_model, seed=4)
    g = np.random.RandomState(5).randn(B, S, jc.d_model).astype(np.float32)

    def f(env, x, g):
        out, pull = jax.vjp(lambda x_: JL.apply_attention(
            jc, env, jl["attn"], x_, block_target=8)[0], x)
        return out, pull(g.astype(out.dtype))[0]
    call, _ = smap_env(f, out_specs=(P(), P()))
    jout, jdx = call(jx, jnp.asarray(g))
    tx.requires_grad_()
    out = TL.apply_attention(tc, tl["attn"], tx)
    out.backward(torch.tensor(g).to(out.dtype))
    for o, r in ((out, jout), (tx.grad, jdx)):
        r = _np(r)
        np.testing.assert_allclose(_np(o), r, rtol=0, atol=_tol(dt, r))


def test_attention_core_matches_reference():
    """fp32, kv expanded to every head, causal, two flash blocks."""
    rs = np.random.RandomState(6)
    q, k, v = (rs.randn(2, 16, 4, 32).astype(np.float32) for _ in range(3))
    ref = np.asarray(JL.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=None, block_target=8))
    out = TL.attention_core(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_moe_ffn_train(models):
    """`moe_ffn(train=True)` (fused: K1 forward) against the reference's:
    output, aux loss and metrics."""
    dt, jc, tc, ref, tp = models
    jl = _jlayer(ref)
    jx, tx = _inputs(dt, 12, jc.d_model, seed=8)
    call, _ = smap_env(lambda env, x: JMOE.moe_ffn(
        jc, env, jl["moe"], x, train=True, dispatch="fused"),
        out_specs=(P(), P(), P()))
    jy, jaux, jmet = call(jx)
    y, aux, met = TMOE.moe_ffn(tc, TM.layer_params(tp["blocks"], 0)["moe"],
                               tx, train=True)
    assert y.dtype == tx.dtype
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=_tol(dt, _np(jy)))
    np.testing.assert_allclose(_np(aux), float(jaux), rtol=1e-5)
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(_np(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _batch(seed=9, V=512):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, V, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1                    # ignored positions
    return toks[:, :-1].copy(), labels


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_loss_fn_value_and_grads(models):
    """`loss_fn` (remat on, fused MoE: K1 forward, K2 backward) against
    jax.value_and_grad of the reference's: the loss and its metrics in
    both dtypes, and every parameter's gradient with fp32 compute (with
    bf16 compute the gradients pass through many more bf16 roundings in
    another order than the reference's, and are not compared)."""
    dt, jc, tc, ref, tp = models
    toks, labels = _batch()

    def f(env, params, t, lb):
        def lf(p):
            return JM.loss_fn(jc, env, p, {"tokens": t, "labels": lb},
                              step=jnp.int32(0), rng=None)
        (loss, mets), g = jax.value_and_grad(lf, has_aux=True)(params)
        return loss, mets, g
    call, _ = smap_env(f, out_specs=(P(), P(), P()))
    jloss, jmets, jgrads = call(jax.tree.map(jnp.asarray, ref),
                                jnp.asarray(toks), jnp.asarray(labels))
    params = interop.params_from_numpy(ref, tc, device="cpu", masters=True)
    for p in TA.leaves(params):
        p.requires_grad_()
    loss, mets = TM.loss_fn(tc, params, {"tokens": torch.tensor(toks).long(),
                                         "labels": torch.tensor(labels).long()},
                            step=0)
    loss.backward()
    rel = 1e-5 if dt == "float32" else 2.0 ** -6
    np.testing.assert_allclose(_np(loss), float(jloss), rtol=rel)
    assert set(mets) == set(jmets)
    for k in jmets:
        np.testing.assert_allclose(_np(mets[k]), float(jmets[k]), rtol=rel,
                                   atol=1e-7, err_msg=k)
    if dt != "float32":
        return
    jg = _flat(jax.tree.map(np.asarray, jgrads))
    tg = _flat(jax.tree.map(lambda p: p.grad.numpy(), params,
                            is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert set(jg) == set(tg)
    for k, r in jg.items():
        np.testing.assert_allclose(tg[k], r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=k)


def test_remat_on_off_same_grads_while_warmup_is_active():
    """Step 1 of a W=4 router warmup: the noise is drawn outside the
    checkpointed blocks, so recomputing them in the backward routes as
    the forward did and the gradients are the same, bit for bit."""
    cfg = tcfg("ling-lite")
    assert cfg.moe.router_warmup_steps == 4
    toks, labels = _batch(seed=10)
    batch = {"tokens": torch.tensor(toks).long(),
             "labels": torch.tensor(labels).long()}
    grads = []
    for remat in (True, False):
        params = TM.init_model(cfg, device="cpu", masters=True,
                               generator=torch.Generator().manual_seed(1))
        for p in TA.leaves(params):
            p.requires_grad_()
        loss, _ = TM.loss_fn(cfg, params, batch, step=1,
                             rng=prng.prng_key(123),
                             flags=TM.RunFlags(remat=remat))
        loss.backward()
        grads.append([p.grad for p in TA.leaves(params)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # and the warmup is really active: another noise key routes otherwise
    params = TM.init_model(cfg, device="cpu", masters=True,
                           generator=torch.Generator().manual_seed(1))
    l1, _ = TM.loss_fn(cfg, params, batch, step=1, rng=prng.prng_key(123))
    l2, _ = TM.loss_fn(cfg, params, batch, step=1, rng=prng.prng_key(124))
    assert float(l1) != float(l2)
