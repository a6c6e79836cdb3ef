"""The new blocks of the port's block families against the JAX package's
functions, on converted smoke weights and the same numpy-made inputs:
LayerNorm, windowed and non-causal training attention, the RG-LRU block
(training/prefill and one decode tick, from a zero and from a carried
state), and whisper's encoder with the cross caches its decoder keeps.
Then the list trees that mixed patterns and the encoder-decoder bring:
the port's `adamw.leaves`, `pcache._treedef` and `tree_unflatten` on
recurrentgemma's and whisper's parameters follow `jax.tree.leaves` and
`jax.tree.structure`, and a PCache save and restore of a recurrentgemma
train state (fp32 masters, AdamW moments, the spike guard) is exact.

Tolerances: fp32 compute, so the packages differ in fp32 summation order
only: every output within 1e-5 of its largest value."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util import smap_env as _smap_env

from repro import api as japi
from repro.configs import base as jbase
from repro.launch.mesh import make_local_mesh
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import rglru as JRG
from repro_torch import interop
from repro_torch.checkpoint import pcache as PC
from repro_torch.configs import base as tbase
from repro_torch.core import spikes as spikes_lib
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import rglru as TRG
from repro_torch.optim import adamw as TA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smap_env(fn, **kw):
    call, env = _smap_env(fn, **kw)
    return jax.jit(call), env


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)


def _smoke(pkg, arch):
    return dataclasses.replace(pkg.get_smoke_config(arch),
                               compute_dtype="float32")


_MODELS = {}


def _model(arch):
    """(arch, reference params as jax arrays, numpy, the port's), one
    reference init per arch for the module."""
    if arch not in _MODELS:
        jc, tc = _smoke(jbase, arch), _smoke(tbase, arch)
        runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                             seq_parallel=False, max_seq=32)
        jp = jax.device_get(runner.init_params(0))
        ref = jax.tree.map(np.asarray, jp)
        _MODELS[arch] = (arch, jc, tc, jp, ref,
                         interop.params_from_numpy(ref, tc, device="cpu"))
    return _MODELS[arch]


# -- LayerNorm and training attention -----------------------------------------


def test_layernorm_matches_reference():
    jc, tc = _smoke(jbase, "nemotron-4-15b"), _smoke(tbase, "nemotron-4-15b")
    d = jc.d_model
    x = _rand(24, d, scale=3.0) + 0.5
    p = {"scale": _rand(d, seed=1), "bias": _rand(d, seed=2)}
    call, _ = smap_env(lambda env, x, s, b: JL.apply_norm(
        jc, env, {"scale": s, "bias": b}, x))
    want = call(*map(jnp.asarray, (x, p["scale"], p["bias"])))
    got = TL.apply_norm(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    _close(got.numpy(), want)
    assert set(TL.init_norm(tc, TL.Init(torch.device("meta")))) == \
        {"scale", "bias"}


@pytest.mark.parametrize("causal,window", [(True, 24), (True, 7),
                                           (False, None)])
def test_training_attention_matches_reference(causal, window):
    """The window as an explicit boolean mask against the reference's
    flash attention on its "window" schedule (blocks of 16, so the band
    skips whole tiles), and the encoder's non-causal attention."""
    B, Sq, H, hd = 2, 64, 4, 32
    q, k, v = (_rand(B, Sq, H, hd, seed=s) for s in (0, 1, 2))
    want = JL.attention_core(*map(jnp.asarray, (q, k, v)), causal=causal,
                             window=window,
                             schedule="window" if window else "causal",
                             block_target=16)
    got = TL.attention_core(*map(torch.from_numpy, (q, k, v)),
                            causal=causal, window=window)
    _close(got.numpy(), want)


# -- RG-LRU -------------------------------------------------------------------


def test_rglru_block_and_tick_match_reference():
    _, jc, tc, jp, _, tp = _model("recurrentgemma-2b")
    jrec = jax.tree.map(jnp.asarray, jp["blocks"][0]["rec"])
    trec = tp["blocks"][0]["rec"]
    B, S, d = 2, 12, jc.d_model
    x = _rand(B, S, d)
    call, _ = smap_env(lambda env, p, x: JRG.recurrent_block(jc, env, p, x))
    want_y, want_st = call(jrec, jnp.asarray(x))
    y, st = TRG.recurrent_block(tc, trec, torch.from_numpy(x))
    _close(y.numpy(), want_y)
    _close(st["h"].numpy(), want_st["h"])
    _close(st["conv"].numpy(), want_st["conv"])
    # a tick from the block's state, and the block carried on from it
    xt = _rand(B, d, seed=5)
    tick, _ = smap_env(lambda env, p, x, s: JRG.decode_step(jc, env, p, x, s))
    want_t, want_ts = tick(jrec, jnp.asarray(xt), want_st)
    state = {k: v.clone() for k, v in st.items()}
    y_t = TRG.decode_step(tc, trec, torch.from_numpy(xt), state)
    _close(y_t.numpy(), want_t)
    _close(state["h"].numpy(), want_ts["h"])
    _close(state["conv"].numpy(), want_ts["conv"])
    carry, _ = smap_env(lambda env, p, x, s: JRG.recurrent_block(
        jc, env, p, x, s))
    want_c, want_cs = carry(jrec, jnp.asarray(x), want_st)
    y_c, st_c = TRG.recurrent_block(tc, trec, torch.from_numpy(x), st)
    _close(y_c.numpy(), want_c)
    _close(st_c["h"].numpy(), want_cs["h"])


# -- whisper's encoder and cross caches ---------------------------------------


def test_whisper_encoder_and_cross_caches_match_reference():
    _, jc, tc, jp, _, tp = _model("whisper-tiny")
    B, S = 2, 8
    frames = _rand(B, jc.encoder_seq_len, jc.d_model, seed=3)
    toks = np.random.RandomState(4).randint(0, jc.vocab_size, (B, S))
    call, _ = smap_env(lambda env, p, f: JM._encode(jc, env, p, f,
                                                    JM.DEFAULT_FLAGS))
    want = call(jp, jnp.asarray(frames))
    got = TM.encode(tc, tp, torch.from_numpy(frames))
    _close(got.numpy(), want)
    fwd, _ = smap_env(lambda env, p, t, f: JM.forward(
        jc, env, p, {"tokens": t, "enc_frames": f}, train=False,
        want_cache=True)[3])
    want_c = fwd(jp, jnp.asarray(toks, jnp.int32), jnp.asarray(frames))
    _, _, _, got_c = TM.forward(tc, tp, {"tokens": torch.from_numpy(toks),
                                         "enc_frames":
                                             torch.from_numpy(frames)},
                                train=False, want_cache=True)
    assert len(got_c) == len(want_c) == jc.n_layers
    for g, w in zip(got_c, want_c):
        for kind in ("self", "cross"):
            for name in ("k", "v"):
                _close(g[kind][name].numpy(), w[kind][name])
        assert g["cross"]["k"].shape[1] == jc.encoder_seq_len


# -- list trees ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-tiny"])
def test_list_trees_flatten_and_spell_as_jax(arch):
    _, _, _, _, ref, tp = _model(arch)
    want = jax.tree.leaves(ref)
    got = TA.leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(), w)
    assert PC._treedef(tp) == str(jax.tree.structure(ref))
    back = PC.tree_unflatten(tp, [t + 1 for t in got])
    assert isinstance(back["blocks"], list)
    for g, w in zip(TA.leaves(back), got):
        assert torch.equal(g, w + 1)
    opt = TA.init_opt_state(tp)
    assert PC._treedef(opt["m"]) == PC._treedef(tp)


def test_pcache_round_trip_of_a_list_train_state(tmp_path):
    """A recurrentgemma train state (its blocks a list) saved and restored
    exactly, its manifest spelling the reference's tree."""
    tc = _smoke(tbase, "recurrentgemma-2b")
    gen = torch.Generator().manual_seed(0)
    params = TM.init_model(tc, device="cpu", generator=gen, masters=True)
    opt = TA.init_opt_state(params)
    for m in TA.leaves(opt["m"]):
        m.normal_(generator=gen)
    guard = spikes_lib.init_guard_state(spikes_lib.SpikeConfig(), "cpu")
    state = {"params": params, "opt": opt, "guard": guard}
    pc = PC.PCache(str(tmp_path))
    pc.save("step_3", state)
    zero = PC.tree_unflatten(state, [torch.zeros_like(t)
                                     for t in TA.leaves(state)])
    got = pc.load("step_3", zero)
    assert isinstance(got["params"]["blocks"], list)
    for a, b in zip(TA.leaves(state), TA.leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    to_np = lambda t: (
        {k: to_np(v) for k, v in t.items()} if isinstance(t, dict)
        else [to_np(v) for v in t] if isinstance(t, list)
        else t.numpy())
    assert pc.manifest("step_3")["treedef"] == str(
        jax.tree.structure(to_np(state)))
