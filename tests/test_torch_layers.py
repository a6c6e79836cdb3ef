"""The port's layers against the JAX package's on converted smoke
Ling-Lite weights and the same numpy-made inputs: RMSNorm, RoPE, the
router, the fused-dispatch MoE FFN, and paged decode / prefill attention
(including the KV rows they write into the pool).

Tolerances: with fp32 compute the two packages differ only in fp32
summation order (1e-5 relative to the largest value; RoPE angles 1e-6).
With bf16 compute every matmul output is rounded to bf16 in both, and
a different fp32 summation order can round an element one bf16 ulp
(2^-8 relative) the other way; a few such ulps compound through the
projections, so bf16 outputs are held to 2^-6 of the largest value."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util import smap_env as _smap_env

from repro import api
from repro.configs.base import get_smoke_config as jcfg
from repro.core import moe as JMOE
from repro.core import router as JR
from repro.launch.mesh import make_local_mesh
from repro.models import layers as JL
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.core import moe as TMOE
from repro_torch.core import router as TR
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one intra-op thread, and the suite's
    parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smap_env(fn, **kw):
    """tests/util.smap_env under one jit: the shard_map body compiles as
    one program instead of dispatching op by op."""
    call, env = _smap_env(fn, **kw)
    return jax.jit(call), env


def _tol(dt, ref):
    rel = 1e-5 if dt == "float32" else 2.0 ** -6
    return rel * float(np.abs(ref).max())


@pytest.fixture(scope="module", params=DTYPES)
def models(request):
    dt = request.param
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype=dt)
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype=dt)
    runner = api.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                        seq_parallel=False, max_seq=64)
    ref = jax.tree.map(np.asarray, runner.init_params(0))
    tp = interop.params_from_numpy(ref, tc, device="cpu")
    # plain (unsharded) arrays: shard_map bodies close over them
    jlayer = jax.tree.map(lambda a: jnp.asarray(a[0]), ref["blocks"])
    tlayer = TM.layer_params(tp["blocks"], 0)
    return dt, jc, tc, jlayer, tlayer


def _inputs(dt, *shape, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dt)),
            torch.tensor(x).to(getattr(torch, dt)))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def test_apply_norm(models):
    dt, jc, tc, jl, tl = models
    jx, tx = _inputs(dt, 6, jc.d_model)
    call, _ = smap_env(lambda env, x: JL.apply_norm(jc, env, jl["norm1"], x))
    ref = _np(call(jx))
    out = TL.apply_norm(tc, tl["norm1"], tx)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=_tol(dt, ref))


def test_rope(models):
    dt, jc, _, _, _ = models
    pos = np.random.RandomState(1).randint(0, 512, 10).astype(np.int32)
    jc_, js = JL.rope_angles(jnp.asarray(pos), 32, 10_000.0)
    tc_, ts = TL.rope_angles(torch.tensor(pos), 32, 10_000.0)
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc_), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    jx, tx = _inputs(dt, 10, 4, 32, seed=2)
    ref = _np(JL.apply_rope(jx[:, None], jc_[:, None], js[:, None]))
    out = TL.apply_rope(tx[:, None], tc_[:, None], ts[:, None])
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=_tol(dt, ref))


def test_route(models):
    dt, jc, tc, jl, tl = models
    jx, tx = _inputs(dt, 9, jc.d_model, seed=3)
    call, _ = smap_env(
        lambda env, x: JR.route(jc, env, jl["moe"]["router"], x,
                                train=False)[:2],
        out_specs=(jax.sharding.PartitionSpec(),) * 2)
    jw, ji = call(jx)
    tw, ti = TR.route(tc, tl["moe"]["router"], tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("T", [8, 13])
def test_moe_ffn_fused(models, T):
    """T=8 (a decode batch) and T=13 (cap=26 slots, no tile multiple)."""
    dt, jc, tc, jl, tl = models
    jx, tx = _inputs(dt, T, jc.d_model, seed=T)
    call, _ = smap_env(lambda env, x: JMOE.moe_ffn(
        jc, env, jl["moe"], x, train=False, dispatch="fused")[0])
    ref = _np(call(jx))
    out, metrics = TMOE.moe_ffn(tc, tl["moe"], tx, dispatch="fused")
    assert out.dtype == tx.dtype
    assert float(metrics["moe/dropped_frac"]) == 0.0     # dropless at tp=1
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=_tol(dt, ref))


def _paged_state(jc, B, n_pages=9, ps=8, n_lp=4, seed=5):
    rs = np.random.RandomState(seed)
    hd = jc.head_dim
    k = (0.5 * rs.randn(n_pages, ps, jc.n_kv_heads, hd)).astype(np.float32)
    v = (0.5 * rs.randn(n_pages, ps, jc.n_kv_heads, hd)).astype(np.float32)
    table = np.zeros((B, n_lp), np.int32)
    perm = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table.flat[:n_pages - 1] = perm
    table[1] = 0                               # an unallocated slot
    return k, v, table


def _pools(dt, k, v):
    jp = {"k": jnp.asarray(k, jnp.dtype(dt)), "v": jnp.asarray(v, jnp.dtype(dt))}
    tp = {"k": torch.tensor(k).to(getattr(torch, dt)),
          "v": torch.tensor(v).to(getattr(torch, dt))}
    return jp, tp


def test_paged_decode_attention(models):
    """Against the reference's fused path (its Pallas kernels in
    interpret mode): the port's fused (K3/K4 plain versions on CPU) and
    gathered modes must both agree with it."""
    dt, jc, tc, jl, tl = models
    B = 3
    k, v, table = _paged_state(jc, B)
    pos = np.array([13, 0, 20], np.int32)
    active = np.array([True, False, True])
    jx, tx = _inputs(dt, B, jc.d_model, seed=7)
    jpool, tpool = _pools(dt, k, v)
    call, _ = smap_env(
        lambda env, x, pool: JL.paged_decode_attention(
            jc, env, jl["attn"], x, pool, jnp.asarray(pos),
            jnp.asarray(table), jnp.asarray(active), page_size=8,
            paged_attn="fused"),
        out_specs=(jax.sharding.PartitionSpec(),
                   {"k": jax.sharding.PartitionSpec(),
                    "v": jax.sharding.PartitionSpec()}))
    ref, jpool = call(jx, jpool)
    ref = _np(ref)
    for mode in ("fused", "gathered"):
        _, tpool = _pools(dt, k, v)
        out, tpool = TL.paged_decode_attention(
            tc, tl["attn"], tx, tpool, torch.tensor(pos),
            torch.tensor(table), torch.tensor(active), page_size=8,
            paged_attn=mode)
        np.testing.assert_allclose(_np(out), ref, rtol=0,
                                   atol=_tol(dt, ref), err_msg=mode)
        # the written KV rows (page 0 is scratch: masked lanes land there)
        for name in ("k", "v"):
            r = _np(jpool[name])[1:]
            np.testing.assert_allclose(_np(tpool[name])[1:], r, rtol=0,
                                       atol=_tol(dt, r), err_msg=mode)


def test_paged_prefill_attention(models):
    """A partial chunk (6 of 8 rows valid) at base 5: causal over the
    request's pages, both port modes against the reference's fused."""
    dt, jc, tc, jl, tl = models
    k, v, table = _paged_state(jc, 2)
    row = table[0]
    C, base, n_valid = 8, 5, 6
    jx, tx = _inputs(dt, C, jc.d_model, seed=8)
    jpool, tpool = _pools(dt, k, v)
    call, _ = smap_env(
        lambda env, x, pool: JL.paged_prefill_attention(
            jc, env, jl["attn"], x, pool, jnp.int32(base),
            jnp.int32(n_valid), jnp.asarray(row), page_size=8,
            paged_attn="fused"),
        out_specs=(jax.sharding.PartitionSpec(),
                   {"k": jax.sharding.PartitionSpec(),
                    "v": jax.sharding.PartitionSpec()}))
    ref, jpool = call(jx, jpool)
    ref = _np(ref)
    for mode in ("fused", "gathered"):
        _, tpool = _pools(dt, k, v)
        out, tpool = TL.paged_prefill_attention(
            tc, tl["attn"], tx, tpool, base, n_valid, torch.tensor(row),
            page_size=8, paged_attn=mode)
        np.testing.assert_allclose(_np(out), ref, rtol=0,
                                   atol=_tol(dt, ref), err_msg=mode)
        for name in ("k", "v"):
            r = _np(jpool[name])[1:]
            np.testing.assert_allclose(_np(tpool[name])[1:], r, rtol=0,
                                       atol=_tol(dt, r), err_msg=mode)


def test_paged_valid_mask_matches_reference():
    table = np.array([[3, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([[9, 10, 11], [0, 1, 2]], np.int32)
    call, env = smap_env(lambda env, t, p: JL.paged_valid_mask(
        t, p, page_size=8, ps_loc=8, env=env))
    ref = np.asarray(call(jnp.asarray(table), jnp.asarray(pos)))
    out = TL.paged_valid_mask(torch.tensor(table), torch.tensor(pos),
                              page_size=8)
    np.testing.assert_array_equal(out.numpy(), ref)
