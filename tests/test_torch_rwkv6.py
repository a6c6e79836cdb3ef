"""The port's rwkv6 serving slice against the JAX package's, on converted
smoke rwkv6-3b weights (2 layers, d 256, 4 heads of 64, vocab 512) and
the same numpy-made inputs: parameter conversion, the time mix (prefill
and decode) and the channel mix, then the slice as a whole — a prefill
of 2 prompts of 16 tokens and 8 greedy decode steps through
`Runner.make_prefill` / `make_decode_step` in both packages — and the
port's own prefill-then-decode contract.

Tolerances: with fp32 compute the packages differ only in fp32 summation
order (1e-5 of the largest value for one module, 1e-4 after two
layers).  With bf16 compute every matmul output is rounded to bf16 in
both, and a different fp32 summation order can round an element one
bf16 ulp (2^-8) the other way; a few such ulps compound, so bf16
outputs are held to 2^-6 of the largest value.  Token streams must be
identical in both dtypes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util import smap_env as _smap_env

from repro import api as japi
from repro.configs.base import get_config as jfull
from repro.configs.base import get_smoke_config as jcfg
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.models import rwkv6 as JR6
from repro.serving.online import OnlineConfig as JConfig
from repro.serving.online import OnlineEngine as JEngine
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_config as tfull
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.kernels import build
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as TR6
from repro_torch.serving.online import OnlineConfig, OnlineEngine

DTYPES = ["float32", "bfloat16"]
B, S_PROMPT, S_MAX, N_GEN = 2, 16, 64, 8


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


def _close(got, want, dt, rel32=1e-5):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    rel = rel32 if dt == "float32" else 2.0 ** -6
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.fixture(scope="module", params=DTYPES)
def models(request):
    dt = request.param
    jc = dataclasses.replace(jcfg("rwkv6-3b"), compute_dtype=dt)
    tc = dataclasses.replace(tcfg("rwkv6-3b"), compute_dtype=dt)
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=S_MAX)
    jparams = runner.init_params(0)
    ref = jax.tree.map(np.asarray, jparams)
    tparams = interop.params_from_numpy(ref, tc, device="cpu")
    return dict(dt=dt, jc=jc, tc=tc, runner=runner, jparams=jparams,
                ref=ref, tparams=tparams,
                trunner=tapi.Runner(tc, device="cpu"))


def _x(dt, *shape, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dt)), torch.tensor(x).to(getattr(torch,
                                                                     dt))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_conversion_dtypes(models):
    """Leaves the reference casts to the compute dtype at use are stored in
    it (bf16: the master rounded once); the decay LoRA, w0, u, the norms
    and the LM head stay fp32 and come through bitwise."""
    fp32 = {"/blocks/tmix/w_lora_a", "/blocks/tmix/w_lora_b",
            "/blocks/tmix/w0", "/blocks/tmix/u", "/blocks/norm1/scale",
            "/blocks/norm2/scale", "/final_norm/scale", "/embed/lm_head"}
    port = dict(_leaves(models["tparams"]))
    ref = dict(_leaves(models["ref"]))
    assert set(port) == set(ref) and "/blocks/cmix/wr" in port
    cdt = getattr(torch, models["dt"])
    for path, r in ref.items():
        t = port[path]
        assert tuple(t.shape) == r.shape, path
        want = torch.float32 if path in fp32 else cdt
        assert t.dtype == want, path
        assert torch.equal(t, torch.tensor(r).to(want)), path


def test_full_size_init_shapes_match_reference_specs():
    """rwkv6-3b at full width: the port's init has the reference's
    parameter shapes (meta device, nothing allocated)."""
    from repro.sharding import make_axis_env
    env = make_axis_env(make_local_mesh(1, 1))
    _, shapes = JM.param_specs(jfull("rwkv6-3b"), env, 4096)
    port = TM.init_model(tfull("rwkv6-3b"), device="meta")
    ref_leaves = {p: tuple(s.shape) for p, s in _leaves(shapes)}
    port_leaves = {p: tuple(t.shape) for p, t in _leaves(port)}
    assert port_leaves == ref_leaves
    assert port_leaves["/blocks/tmix/wr"] == (32, 2560, 2560)
    assert port_leaves["/embed/lm_head"] == (65536, 2560)


def _layer(models):
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), models["ref"]["blocks"])
    return jl, TM.layer_params(models["tparams"]["blocks"], 0)


def test_time_mix_matches_reference(models):
    dt, jc, tc = models["dt"], models["jc"], models["tc"]
    jl, tl = _layer(models)
    jx, tx = _x(dt, B, 11, jc.d_model)
    call, _ = smap_env(lambda env, p, x: JR6.time_mix(jc, env, p, x))
    want, jstate = call(jl["tmix"], jx)
    got, tstate = TR6.time_mix(tc, tl["tmix"], tx)
    _close(got, want, dt)
    _close(tstate["wkv"], jstate["wkv"], dt)
    _close(tstate["last_x"], jstate["last_x"], dt)


def test_time_mix_decode_matches_reference(models):
    """One decode step from a non-zero carried state; the port updates
    its state in place."""
    dt, jc, tc = models["dt"], models["jc"], models["tc"]
    jl, tl = _layer(models)
    H, hd = TR6.dims(tc)
    jx, tx = _x(dt, B, jc.d_model, seed=1)
    jlast, tlast = _x(dt, B, jc.d_model, seed=2)
    s0 = 0.1 * np.random.RandomState(3).randn(B, H, hd, hd)
    s0 = s0.astype(np.float32)
    call, _ = smap_env(lambda env, p, x, st: JR6.time_mix_decode(
        jc, env, p, x, st))
    want, jstate = call(jl["tmix"], jx, {"wkv": jnp.asarray(s0),
                                         "last_x": jlast})
    state = {"wkv": torch.tensor(s0), "last_x": tlast.clone()}
    wkv = state["wkv"]
    got, tstate = TR6.time_mix_decode(tc, tl["tmix"], tx, state)
    assert tstate["wkv"] is wkv
    _close(got, want, dt)
    _close(tstate["wkv"], jstate["wkv"], dt)
    assert torch.equal(tstate["last_x"], tx)


def test_channel_mix_matches_reference(models):
    dt, jc, tc = models["dt"], models["jc"], models["tc"]
    jl, tl = _layer(models)
    jx, tx = _x(dt, 12, jc.d_model, seed=4)
    jp, tp = _x(dt, 12, jc.d_model, seed=5)
    call, _ = smap_env(lambda env, p, x, xp: JR6.channel_mix(jc, env, p, x,
                                                             xp))
    want_p, want_g = call(jl["cmix"], jx, jp)
    got_p, got_g = TR6.channel_mix(tc, tl["cmix"], tx, tp)
    _close(got_p, want_p, dt)
    _close(got_g, want_g, dt)


@pytest.fixture(scope="module")
def streams(models):
    """Prefill B prompts of S_PROMPT tokens, then N_GEN greedy decode
    steps, in both packages: (reference first, caches, tokens), same for
    the port."""
    runner, trunner = models["runner"], models["trunner"]
    cfg = models["jc"]
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              (B, S_PROMPT)).astype(np.int32)
    jprefill = jax.jit(runner.make_prefill(global_batch=B))
    jdecode = jax.jit(runner.make_decode_step(global_batch=B,
                                              seq_len=S_MAX)[0])
    jfirst, jcaches = jprefill(models["jparams"], {"tokens":
                                                   jnp.asarray(prompt)})
    jcaches0 = jax.tree.map(np.asarray, jcaches)
    tok, jtoks = jfirst, []
    for pos in range(S_PROMPT, S_PROMPT + N_GEN):
        tok, jcaches = jdecode(models["jparams"], jcaches, tok,
                               jnp.int32(pos))
        jtoks.append(tok)
    jtoks = [np.asarray(t) for t in jax.device_get(jtoks)]

    build.reset_launches()
    tfirst, tcaches = trunner.make_prefill()(
        models["tparams"], {"tokens": torch.tensor(prompt)})
    tcaches0 = jax.tree.map(lambda t: t.clone(), tcaches)
    tdecode = trunner.make_decode_step()
    tok, ttoks = tfirst, []
    for pos in range(S_PROMPT, S_PROMPT + N_GEN):
        tok, tcaches = tdecode(models["tparams"], tcaches, tok, pos)
        ttoks.append(tok.numpy())
    launches = dict(build.LAUNCHES)
    return dict(prompt=prompt, jfirst=np.asarray(jfirst), jcaches=jcaches0,
                jtoks=jtoks, tfirst=tfirst.numpy(), tcaches=tcaches0,
                ttoks=ttoks, launches=launches)


def test_prefill_matches_reference(models, streams):
    """The first token is identical and the caches close: wkv state,
    last_x and cmix_prev of every layer."""
    dt = models["dt"]
    np.testing.assert_array_equal(streams["tfirst"], streams["jfirst"])
    jc, tc = streams["jcaches"], streams["tcaches"]
    assert set(tc) == set(jc) == {"rwkv", "cmix_prev"}
    _close(tc["rwkv"]["wkv"], jc["rwkv"]["wkv"], dt, rel32=1e-4)
    _close(tc["rwkv"]["last_x"], jc["rwkv"]["last_x"], dt, rel32=1e-4)
    _close(tc["cmix_prev"], jc["cmix_prev"], dt, rel32=1e-4)
    assert tc["rwkv"]["wkv"].dtype == torch.float32
    assert tc["cmix_prev"].dtype == getattr(torch, dt)


def test_greedy_stream_matches_reference(streams):
    np.testing.assert_array_equal(np.stack(streams["ttoks"]),
                                  np.stack(streams["jtoks"]))


def test_cpu_tensors_launch_no_kernel(streams):
    assert streams["launches"]["wkv6"] == 0
    assert streams["launches"]["normhead_matmul"] == 0
    assert streams["launches"]["rwkv_decay"] == 0


def test_prefill_then_decode_matches_stepwise(models, streams):
    """The port's own contract (tests/test_prefill_decode.py): feeding
    the prompt token by token through decode_step gives the prefill's
    first token and then the same stream."""
    trunner, params = models["trunner"], models["tparams"]
    decode = trunner.make_decode_step()
    caches = trunner.init_caches(B)
    prompt = torch.tensor(streams["prompt"])
    for pos in range(S_PROMPT):
        tok, caches = decode(params, caches, prompt[:, pos], pos)
    gen = [tok.numpy()]
    for pos in range(S_PROMPT, S_PROMPT + N_GEN):
        tok, caches = decode(params, caches, tok, pos)
        gen.append(tok.numpy())
    np.testing.assert_array_equal(gen[0], streams["tfirst"])
    np.testing.assert_array_equal(np.stack(gen[1:]),
                                  np.stack(streams["ttoks"]))


def test_online_engine_rejects_rwkv_as_the_reference_does():
    """Paged online serving stays all-attn: the port's OnlineEngine raises
    the reference's error, while the Runner itself now builds rwkv6."""
    jc, tc = jcfg("rwkv6-3b"), tcfg("rwkv6-3b")
    jrunner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                          seq_parallel=False, max_seq=S_MAX)
    with pytest.raises(ValueError) as want:
        JEngine(jrunner, None, JConfig(max_slots=2, max_context=32,
                                       page_size=8))
    trunner = tapi.Runner(tc, device="cpu")
    with pytest.raises(ValueError) as got:
        OnlineEngine(trunner, None, OnlineConfig(max_slots=2,
                                                 max_context=32,
                                                 page_size=8))
    assert str(got.value) == str(want.value)
    assert "all-'attn'" in str(got.value)
    with pytest.raises(ValueError, match="all-'attn'"):
        trunner.init_paged_pools(9, 8)


def test_unported_paths_raise_naming_their_roadmap_item():
    rwkv = tapi.Runner(tcfg("rwkv6-3b"), device="cpu")
    params = rwkv.init_params(0)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "labels": torch.zeros((1, 4), dtype=torch.long)}
    # rwkv6 training (queue 1 item 11) is ported: the loss runs
    loss, _ = TM.loss_fn(rwkv.cfg, params, batch)
    assert torch.isfinite(loss)
    # Ling's dense decode (queue 1 item 8) is ported: its caches need a
    # length, and the prefill leaves one row per prompt position; since
    # item 10, sliding windows (a rolling cache) and mixed patterns (a
    # list of per-layer blocks) are too
    ling = tapi.Runner(tcfg("ling-lite"), device="cpu")
    with pytest.raises(ValueError, match="seq_len"):
        ling.init_caches(1)
    _, caches = ling.make_prefill()(ling.init_params(0),
                                    {"tokens": batch["tokens"]})
    assert caches["self"]["k"].shape[1:3] == (1, 4)
    win = TL.init_decode_cache(ling.cfg, 1, 16, "cpu", window=8)
    assert win["k"].shape[:2] == (1, 8)
    mixed = dataclasses.replace(tcfg("ling-lite"),
                                block_pattern=("attn", "rwkv"))
    blocks = TM.init_model(mixed, device="meta")["blocks"]
    assert isinstance(blocks, list) and len(blocks) == mixed.n_layers
    assert "attn" in blocks[0] and "tmix" in blocks[1]
    caches = TM.init_caches(mixed, 1, "cpu", 16)
    assert "self" in caches[0] and "rwkv" in caches[1]
