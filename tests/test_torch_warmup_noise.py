"""The router warmup's noise in the port against the JAX package: threefry
`split` bit for bit, `normal` (and its `erf_inv`) within a few ulps, the
train step's layer keys bit for bit under the reference's key schedule
(fold_in(PRNGKey(seed), step), then the dp index, then microbatch k only
when accum > 1, then split over the layers) at accum 1 and at accum 2
and 4, and the router's warmup routing given the same layer key.

Tolerances: keys and uniforms are integer hashes and must be equal.
`normal` is sqrt(2) * erf_inv(u) with XLA's fp32 polynomial written in
torch ops; its `log1p` is not XLA's, so a value may differ by a few
ulps: held to 4 ulps, and the share that is not bitwise is printed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util import smap_env

from repro.configs.base import get_smoke_config as jcfg
from repro.core import router as JR
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.core import router as TR
from repro_torch import api as tapi
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.models import prng
from repro_torch.optim.schedule import AccumWarmup
from repro_torch.training.trainer import TrainConfig, Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 7, 2**31 + 5, 2**32 - 1]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in ulps of fp32 arrays of one sign pattern (ordered ints)."""
    def ordered(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 28])
def test_split_is_jax_split(seed, n):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.split(key, n)).astype(np.int64)
    got = prng.split(prng.prng_key(seed), n).numpy()
    np.testing.assert_array_equal(got, want)
    # batched keys: each row split on its own
    keys = prng.split(prng.prng_key(seed), 3)
    got = prng.split(keys, n).numpy()
    for r in range(3):
        np.testing.assert_array_equal(
            got[r], np.asarray(jax.random.split(
                jax.random.fold_in(key, r), n)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5,), (256, 64), (1024, 1024)])
def test_normal_within_4_ulps_of_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = prng.normal(prng.prng_key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    u = _ulps(got.numpy(), want)
    print(f"normal seed={seed} shape={shape}: max {u.max()} ulps, "
          f"{(u > 0).mean():.4%} not bitwise")
    assert u.max() <= 4
    assert np.all(np.sign(got.numpy()) == np.sign(want))


def test_erf_inv_and_uniform_against_xla():
    """normal's two halves: the uniforms in [nextafter(-1, 0), 1) bit for
    bit, XLA's erf_inv within 2 ulps (and inf at +-1)."""
    key = jax.random.PRNGKey(3)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    ju = np.asarray(jax.random.uniform(key, (512, 512), jnp.float32, lo,
                                       1.0))
    tu = prng.uniform(prng.prng_key(3), (512, 512), float(lo), 1.0)
    np.testing.assert_array_equal(tu.numpy(), ju)
    x = np.concatenate([ju.ravel(), np.float32([-1.0, 1.0, 0.0])])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erf_inv(torch.tensor(x)).numpy()
    assert np.isinf(got[-3]) and got[-3] < 0 and np.isinf(got[-2])
    u = _ulps(got[:-3], want[:-3])
    print(f"erf_inv: max {u.max()} ulps, {(u > 0).mean():.4%} not bitwise")
    assert u.max() <= 2 and got[-1] == 0.0


def _reference_layer_keys(seed, step, accum, n_layers):
    """The reference's chain: trainer.py `fold_in(self.rng, i)`, api.py's
    fold_in of the dp index (0 on one device), fold_in(rng, k) per
    microbatch only when accum > 1, model.py's split over the layers."""
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), 0)
    micro = ([jax.random.fold_in(rng, k) for k in range(accum)]
             if accum > 1 else [rng])
    return [np.asarray(jax.random.split(r, n_layers)).astype(np.int64)
            for r in micro]


@pytest.mark.parametrize("seed", [0, 11])
def test_train_step_layer_keys_are_the_references(seed, monkeypatch):
    """Four steps of the port's Trainer through the batch-size warmup
    (accum 1, 1, 2, 4 ... ) with the router warmup active: every layer key
    the step drew from equals the reference's chain, and so does each
    eps up to normal's ulps."""
    cfg = tcfg("ling-lite")
    assert cfg.moe.router_warmup_steps == 4 and cfg.n_layers >= 2
    drawn = []

    def record(keys, shape):
        eps = prng.normal(keys, shape)
        drawn.extend(zip(keys.numpy().copy(), [shape] * len(keys),
                         eps.numpy().copy()))
        return eps
    monkeypatch.setattr(TR, "warmup_noise", record)
    bw = AccumWarmup(microbatch=2, start=2, end=8, warmup_steps=4,
                     increments=2)
    steps = 4
    tr = Trainer(tapi.Runner(cfg, device="cpu"),
                 DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                             seq_len=8, batch_size=2)),
                 TrainConfig(n_steps=steps, bs_warmup=bw, log_every=0,
                             seed=seed))
    try:
        tr.train()
    finally:
        tr.close()
    accums = [bw.accum_for(i) for i in range(steps)]
    assert 1 in accums and max(accums) > 1
    want = []
    for i, a in enumerate(accums):
        for keys in _reference_layer_keys(seed, i, a, cfg.n_layers):
            want.extend(keys)
    # each microbatch's forward draws once for all its layers (the remat
    # recompute reuses the same eps)
    assert len(drawn) == len(want)
    for (key, shape, eps), ref in zip(drawn, want):
        np.testing.assert_array_equal(key, ref)
        assert shape == (16, cfg.moe.n_experts)
        jeps = np.asarray(jax.random.normal(
            jnp.asarray(ref.astype(np.uint32)), shape, jnp.float32))
        assert _ulps(eps, jeps).max() <= 4


@pytest.mark.parametrize("step", [0, 2])
def test_warmup_routing_matches_reference_given_a_key(step):
    """`route(train=True)` with the warmup mix: the port's eps from a layer
    key through `warmup_noise`, the reference's from the same key inside
    its router.  The same experts, weights and aux loss (fp32)."""
    jc = dataclasses.replace(jcfg("ling-lite"), compute_dtype="float32")
    tc = dataclasses.replace(tcfg("ling-lite"), compute_dtype="float32")
    rs = np.random.RandomState(step)
    wr = (0.5 * rs.randn(jc.d_model, jc.moe.n_experts)).astype(np.float32)
    x = rs.randn(64, jc.d_model).astype(np.float32)
    key = jax.random.split(jax.random.PRNGKey(5), 2)[1]
    call, _ = smap_env(lambda env, x_: JR.route(
        jc, env, {"wr": jnp.asarray(wr)}, x_, step=jnp.int32(step),
        rng=key, train=True))
    jw, ji, jaux, _ = call(jnp.asarray(x))
    tkey = prng.split(prng.prng_key(5), 2)[1]
    eps = TR.warmup_noise(tkey, (64, tc.moe.n_experts))
    tw, ti, taux, _ = TR.route(tc, {"wr": torch.tensor(wr)},
                               torch.tensor(x), train=True, step=step,
                               eps=eps)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # the warmup really mixed noise in: the learned logits alone route
    # otherwise
    _, ti0, _, _ = TR.route(tc, {"wr": torch.tensor(wr)}, torch.tensor(x),
                            train=True, step=step)
    assert not torch.equal(ti0, ti)
