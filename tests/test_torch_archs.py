"""The reference's other uniform-attention architectures in the port
(RMSNorm, attention, SwiGLU; MoE or dense): ling-plus, deepseek-moe-16b,
granite-moe-3b-a800m, moonshot-v1-16b-a3b, phi3-mini-3.8b and
chameleon-34b.  Their config copies equal the reference's, the port's
init at full size has the reference's parameter shapes, and at smoke
size, on converted weights with fp32 compute, each one's greedy token
stream (prefill, then dense decode ticks) equals the reference's token
for token and one train step's loss and grad norm agree.  Beside them a
smoke variant with two shared experts (deepseek's and moonshot's, whose
smoke configs keep one).

Tolerances: fp32 compute, so the packages differ in fp32 summation order
only: the losses within 1e-5 relative and the grad norms within 1e-4,
as tests/test_torch_trainer.py holds the trajectory; token streams
identical.  Configs whose smoke copies differ only in their name
(deepseek's and moonshot's) share one reference run."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import api as japi
from repro.configs import base as jbase
from repro.launch.mesh import make_local_mesh
from repro.models import embedding as JE
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.sharding import make_axis_env
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.models import embedding as TE
from repro_torch.models import model as TM
from repro_torch.models import prng
from repro_torch.optim import adamw as TA
from util import smap_env

ARCHS = ["ling-plus", "deepseek-moe-16b", "granite-moe-3b-a800m",
         "moonshot-v1-16b-a3b", "phi3-mini-3.8b", "chameleon-34b"]
B, P_LEN, S, NEW = 2, 8, 32, 6
STEP = 10          # past the smoke router warmup (4 steps): no noise drawn
_REFERENCE = {}    # config (name aside) -> the reference's results


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ours = dataclasses.asdict(getattr(tbase, get)(arch))
        theirs = dataclasses.asdict(getattr(jbase, get)(arch))
        assert ours == theirs, get


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_init_shapes_match_reference_specs(arch):
    """The port's init at full size (meta device: nothing allocated) has
    exactly the reference's parameter shapes."""
    env = make_axis_env(make_local_mesh(1, 1))
    _, shapes = JM.param_specs(jbase.get_config(arch), env, 4096)
    port = TM.init_model(tbase.get_config(arch), device="meta")
    assert _shapes(port) == _shapes(shapes)


def _shapes(tree, path=""):
    if not isinstance(tree, dict):
        return {path: tuple(tree.shape)}
    return {k: v for name in sorted(tree)
            for k, v in _shapes(tree[name], f"{path}/{name}").items()}


def _two_shared(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_shared_experts=2))


def _batch():
    rs = np.random.RandomState(9)
    toks = rs.randint(0, 512, (B, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _reference(jc):
    """The reference's greedy stream and one train step's metrics."""
    key = dataclasses.replace(jc, arch_id="", source="")
    if key in _REFERENCE:
        return _REFERENCE[key]
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=S)
    jp = runner.init_params(0)
    prompt = np.random.RandomState(0).randint(0, jc.vocab_size, (B, P_LEN)) \
        .astype(np.int32)
    first, caches = jax.jit(runner.make_prefill(global_batch=B))(
        jp, {"tokens": jnp.asarray(prompt)})
    full = JM.init_caches(jc, runner.env, B, S)
    caches = jax.tree.map(
        lambda a, r: jnp.pad(a, [(0, y - x) for x, y in zip(a.shape,
                                                            r.shape)]),
        caches, full)
    dec, _ = runner.make_decode_step(global_batch=B, seq_len=S)
    dec = jax.jit(dec)
    tok, stream = first, [first]
    for pos in range(P_LEN, P_LEN + NEW):
        tok, caches = dec(jp, caches, tok, jnp.int32(pos))
        stream.append(tok)        # device until the loop ends (FC-HOSTSYNC)
    step = jax.jit(runner.make_train_step(B))
    _, _, mets = step(jp, JA.init_opt_state(jp),
                      jax.tree.map(jnp.asarray, _batch()), jnp.int32(STEP),
                      jax.random.PRNGKey(0), jnp.float32(1e-3))
    stream, mets = jax.device_get((stream, mets))
    out = dict(prompt=prompt, stream=np.stack(stream, 1),
               loss=float(mets["loss"]), grad_norm=float(mets["grad_norm"]),
               params=jax.tree.map(np.asarray, jp))
    _REFERENCE[key] = out
    return out


@pytest.fixture(scope="module",
                params=ARCHS + ["deepseek-moe-16b+2-shared"])
def runs(request):
    arch = request.param.split("+")[0]
    jc = dataclasses.replace(jbase.get_smoke_config(arch),
                             compute_dtype="float32")
    tc = dataclasses.replace(tbase.get_smoke_config(arch),
                             compute_dtype="float32")
    if request.param.endswith("2-shared"):
        jc, tc = _two_shared(jc), _two_shared(tc)
    ref = _reference(jc)
    runner = tapi.Runner(tc, device="cpu")
    params = interop.params_from_numpy(ref["params"], tc, device="cpu")
    first, caches = runner.make_prefill(seq_len=S)(
        params, {"tokens": torch.from_numpy(ref["prompt"]).long()})
    dec = runner.make_decode_step()
    tok, stream = first, [first.numpy()]
    for pos in range(P_LEN, P_LEN + NEW):
        tok, caches = dec(params, caches, tok, pos)
        stream.append(tok.numpy())
    masters = interop.params_from_numpy(ref["params"], tc, device="cpu",
                                        masters=True)
    _, _, _, mets = runner.make_train_step()(
        masters, TA.init_opt_state(masters), None,
        {k: torch.from_numpy(v).long() for k, v in _batch().items()}, STEP,
        prng.prng_key(0), 1e-3)
    return ref, dict(stream=np.stack(stream, 1), loss=float(mets["loss"]),
                     grad_norm=float(mets["grad_norm"]))


def test_smoke_greedy_stream_matches_reference(runs):
    ref, got = runs
    np.testing.assert_array_equal(got["stream"], ref["stream"])


def test_smoke_train_step_matches_reference(runs):
    ref, got = runs
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)


def test_sampling_over_granites_odd_vocabulary():
    """granite's vocabulary (49155) is no multiple of 8: its logits are
    padded to 49280 columns, and sampling (temperature, top-k, top-p
    under the threefry keys) must give the reference's tokens and
    probabilities with the padding columns exactly 0."""
    jc, tc = jbase.get_config("granite-moe-3b-a800m"), \
        tbase.get_config("granite-moe-3b-a800m")
    vp = TE.padded_vocab(tc)
    assert (tc.vocab_size, vp) == (49155, 49280)
    rs = np.random.RandomState(7)
    T = 8
    logits = (3.0 * rs.randn(T, vp)).astype(np.float32)
    seeds = rs.randint(0, 2 ** 31, T).astype(np.int32)
    pos = rs.randint(0, 4096, T).astype(np.int32)
    temp = rs.choice([0.0, 0.7, 1.5], T).astype(np.float32)
    top_p = rs.choice([1.0, 0.9], T).astype(np.float32)
    top_k = rs.choice([0, 50], T).astype(np.int32)
    call, _ = smap_env(lambda env, *a: JE.sharded_sample(
        jc, env, a[0], seeds=a[1], pos=a[2], temperature=a[3], top_p=a[4],
        top_k=a[5]), out_specs=(P(), P()))
    want_tok, want_p = map(np.asarray, call(*map(
        jnp.asarray, (logits, seeds, pos, temp, top_p, top_k))))
    tok, probs = TE.sharded_sample(
        tc, torch.tensor(logits), seeds=torch.tensor(seeds),
        pos=torch.tensor(pos), temperature=torch.tensor(temp),
        top_p=torch.tensor(top_p), top_k=torch.tensor(top_k))
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_allclose(probs.numpy(), want_p, rtol=0, atol=1e-6)
    assert not probs[:, tc.vocab_size:].any()
    assert int(tok[temp > 0].max()) < tc.vocab_size
