"""The block families that need more than the Ling blocks, in the port
against the JAX package: nemotron-4-15b (LayerNorm, squared ReLU),
h2o-danube-1.8b (sliding windows), recurrentgemma-2b (RG-LRU blocks with
windowed attention, a list of per-layer blocks) and whisper-tiny (the
encoder-decoder: learned positions, a non-causal encoder, cross
attention).  Their config copies equal the reference's, the port's init
at full size has the reference's parameter shapes, and at smoke size, on
converted weights with fp32 compute, each one's greedy token stream
(prefill, then dense decode ticks, past the smoke window of 64 into a
rolling cache for "swa") equals the reference's token for token, and one
train step's loss and grad norm agree.  Within the port, the
reference's own contract (tests/test_prefill_decode.py) holds: feeding
the prompt tick by tick gives the prefill's tokens, and the RG-LRU state
h after the prefill equals the ticks' bit for bit.

Tolerances: fp32 compute, so the packages differ in fp32 summation order
only: the losses within 1e-5 relative and the grad norms within 1e-4,
as tests/test_torch_archs.py holds them; token streams identical.  One
reference run per arch serves every test of it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import base as jbase
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.sharding import make_axis_env
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.models import model as TM
from repro_torch.models import prng
from repro_torch.optim import adamw as TA

ARCHS = ["nemotron-4-15b", "h2o-danube-1.8b", "recurrentgemma-2b",
         "whisper-tiny"]
# prompts of 8, caches of 80 positions: the ticks write positions 8..71,
# past the smoke window of 64 (the rolling cache wraps at 64)
B, P_LEN, S, NEW = 2, 8, 80, 64
STEP = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(pkg, arch):
    return dataclasses.replace(pkg.get_smoke_config(arch),
                               compute_dtype="float32")


def _inputs(cfg):
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, cfg.vocab_size, (B, P_LEN)).astype(np.int32)
    toks = rs.randint(0, cfg.vocab_size, (B, 33)).astype(np.int32)
    train = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    frames = None
    if cfg.is_encoder_decoder:
        frames = rs.randn(B, cfg.encoder_seq_len, cfg.d_model) \
            .astype(np.float32)
        train["enc_frames"] = frames
    return prompt, frames, train


def _numpy_params(arch):
    """Seeded fp32 parameters in the reference's layout, drawn by the
    port's init (eager: no compile of the reference's init)."""
    tree = TM.init_model(_smoke(tbase, arch), device="cpu", masters=True,
                         generator=torch.Generator().manual_seed(0),
                         max_seq=S)

    def to_numpy(node):
        if isinstance(node, dict):
            return {k: to_numpy(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_numpy(v) for v in node]
        return node.float().numpy()
    return to_numpy(tree)


def _reference(arch):
    """The reference's greedy stream, one train step's metrics and its
    parameters (numpy)."""
    jc = _smoke(jbase, arch)
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=S)
    params = _numpy_params(arch)
    jp = jax.tree.map(jnp.asarray, params)
    prompt, frames, train = _inputs(jc)
    batch = {"tokens": jnp.asarray(prompt)}
    if frames is not None:
        batch["enc_frames"] = jnp.asarray(frames)
    first, caches = jax.jit(runner.make_prefill(global_batch=B))(jp, batch)
    full = JM.init_caches(jc, runner.env, B, S,
                          cross_len=jc.encoder_seq_len)
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
                      jax.tree.map(jnp.asarray, train), jnp.int32(STEP),
                      jax.random.PRNGKey(0), jnp.float32(1e-3))
    stream, mets = jax.device_get((stream, mets))
    return dict(stream=np.stack(stream, 1), loss=float(mets["loss"]),
                grad_norm=float(mets["grad_norm"]),
                params=params)


def _port_stream(runner, params, prompt, frames):
    """The port's greedy stream from a prefill, and its caches right after
    the prefill (cloned)."""
    batch = {"tokens": torch.from_numpy(prompt).long()}
    if frames is not None:
        batch["enc_frames"] = torch.from_numpy(frames)
    first, caches = runner.make_prefill(seq_len=S)(params, batch)
    after = _clone(caches)
    dec = runner.make_decode_step()
    tok, stream = first, [first.numpy()]
    for pos in range(P_LEN, P_LEN + NEW):
        tok, caches = dec(params, caches, tok, pos)
        stream.append(tok.numpy())
    return np.stack(stream, 1), after


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    arch = request.param
    ref = _reference(arch)
    tc = _smoke(tbase, arch)
    runner = tapi.Runner(tc, device="cpu", max_seq=S)
    params = interop.params_from_numpy(ref["params"], tc, device="cpu")
    prompt, frames, train = _inputs(tc)
    stream, after = _port_stream(runner, params, prompt, frames)
    masters = interop.params_from_numpy(ref["params"], tc, device="cpu",
                                        masters=True)
    _, _, _, mets = runner.make_train_step()(
        masters, TA.init_opt_state(masters), None,
        {k: torch.from_numpy(v) if v.dtype == np.float32
         else torch.from_numpy(v).long() for k, v in train.items()},
        STEP, prng.prng_key(0), 1e-3)
    got = dict(stream=stream, loss=float(mets["loss"]),
               grad_norm=float(mets["grad_norm"]), after=after)
    return arch, runner, params, ref, got


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ours = dataclasses.asdict(getattr(tbase, get)(arch))
        theirs = dataclasses.asdict(getattr(jbase, get)(arch))
        assert ours == theirs, get


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for name in sorted(tree)
                for k, v in _shapes(tree[name], f"{path}/{name}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, node in enumerate(tree)
                for k, v in _shapes(node, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_init_shapes_match_reference_specs(arch):
    """The port's init at full size (meta device: nothing allocated) has
    exactly the reference's parameter shapes, lists included."""
    env = make_axis_env(make_local_mesh(1, 1))
    _, shapes = JM.param_specs(jbase.get_config(arch), env, 4096)
    port = TM.init_model(tbase.get_config(arch), device="meta")
    assert _shapes(port) == _shapes(shapes)
    assert isinstance(port["blocks"], list) == (
        arch in ("recurrentgemma-2b", "whisper-tiny"))


def test_smoke_greedy_stream_matches_reference(runs):
    _, _, _, ref, got = runs
    np.testing.assert_array_equal(got["stream"], ref["stream"])


def test_smoke_train_step_matches_reference(runs):
    _, _, _, ref, got = runs
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=1e-4)


def test_prefill_then_decode_matches_stepwise(runs):
    """The reference's serving contract within the port: the prompt fed
    tick by tick gives the prefill's first token and the same stream
    after it (whisper's cross caches come from the prefill: no tick
    writes them), and an RG-LRU layer's state after the prompt is the
    prefill's bit for bit."""
    arch, runner, params, _, got = runs
    cfg = runner.cfg
    prompt, _, _ = _inputs(cfg)
    caches = runner.init_caches(B, S)
    if cfg.is_encoder_decoder:
        for c, p in zip(caches, got["after"]):
            c["cross"]["k"].copy_(p["cross"]["k"])
            c["cross"]["v"].copy_(p["cross"]["v"])
    dec = runner.make_decode_step()
    toks = torch.from_numpy(prompt).long()
    for pos in range(P_LEN):
        tok, caches = dec(params, caches, toks[:, pos], pos)
    stream = [tok.numpy()]
    if arch == "recurrentgemma-2b":
        for i in range(cfg.n_layers):
            if cfg.block_kind(i) == "rglru":
                for name in ("h", "conv"):
                    assert torch.equal(caches[i]["rglru"][name],
                                       got["after"][i]["rglru"][name]), name
    for pos in range(P_LEN, P_LEN + NEW):
        tok, caches = dec(params, caches, tok, pos)
        stream.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(stream, 1), got["stream"])
