"""The port's EDiT (`core.edit`, paper §2.2) against the JAX package's:
`edit_sync` on the same numpy-made base, worker, EMA and momentum trees
through three syncs (an anomaly after two syncs of history, every worker
anomalous, an active clip); `simulate_sync_timeline` exactly; two
`EDiTTrainer` rounds of two workers with the port's train step against
the reference's `jit_train_step` on converted smoke Ling-Lite weights,
step- and time-based; the port's replicas (no aliasing of the base, the
workers' optimizer state carried across rounds); and the launcher's
`--edit-workers 2` against the reference launcher on the same weights.

Tolerances: fp32 throughout, so the packages differ in fp32 summation
order only (the port sums each worker's squared pseudo-gradient leaf by
leaf, another order than XLA's).  `edit_sync`'s norms, EMA, weights and
averaged norm are held to 1e-5 relative, its new params and momentum to
1e-6 of their largest magnitude.  The rounds take
tests/test_torch_trainer.py's bars: mean losses 1e-5 relative, the
averaged pseudo-gradient norm (a norm, as the grad norm there) 1e-4;
`kept` is equal and the weights, which both round to 4 decimals, within
1e-4.  The smoke config's router warmup (4 steps) is active, so the
port's threefry noise is on the path."""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.core import edit as JE
from repro.core import spikes as JS
from repro.data.pipeline import DataPipeline as JPipe
from repro.data.pipeline import PipelineConfig as JPipeCfg
from repro.launch import train as jlaunch
from repro.launch.mesh import make_local_mesh
from repro.optim import adamw as JA
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.core import edit as TE
from repro_torch.core import spikes as TS
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw as TA

K, B, S = 3, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape_tree(rs, scale=1.0):
    return {"a": (scale * rs.randn(16, 8)).astype(np.float32),
            "b": {"c": (scale * rs.randn(33)).astype(np.float32),
                  "d": (scale * rs.randn(4, 4, 2)).astype(np.float32)}}


def _leaves(tree):
    return ([t for k in sorted(tree) for t in _leaves(tree[k])]
            if isinstance(tree, dict) else [tree])


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _close_tree(got, want, rel=1e-6):
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()))


# worker pseudo-gradient scales per sync: three syncs, the third crafted
SYNC_SCALES = {
    # two syncs of history, then worker 2 jumps by ~200x
    "anomaly": [(0.01, 0.012, 0.011), (0.01, 0.009, 0.012),
                (0.01, 0.011, 2.0)],
    # every worker jumps at once: nobody may be eliminated
    "everyone": [(0.01, 0.012, 0.011), (0.01, 0.009, 0.012),
                 (2.0, 2.5, 3.0)],
    # clip_norm below every averaged norm
    "clip": [(0.05, 0.06, 0.04), (0.05, 0.04, 0.06), (0.05, 0.05, 0.05)],
}


@pytest.mark.parametrize("case", list(SYNC_SCALES))
def test_edit_sync_matches_reference(case):
    rs = np.random.RandomState(0)
    clip = 0.01 if case == "clip" else 1.0
    jc = JE.EDiTConfig(clip_norm=clip)
    tc = TE.EDiTConfig(clip_norm=clip)
    base = _shape_tree(rs)
    jbase = jax.tree.map(jnp.asarray, base)
    tbase = TE.tree_map(torch.tensor, base)
    jema, tema = JE.init_ema(K), TE.init_ema(K)
    jm, tm = JE.init_outer_momentum(jbase), TE.init_outer_momentum(tbase)
    for s, scales in enumerate(SYNC_SCALES[case]):
        prev = {k: _np(v) for k, v in tema.items()}
        workers = [jax.tree.map(lambda b, g: b - g, _np_tree(jbase),
                                _shape_tree(rs, sc)) for sc in scales]
        jbase, jema, jm, jinfo = JE.edit_sync(
            jbase, [jax.tree.map(jnp.asarray, w) for w in workers], jema,
            jm, jc)
        tbase, tema, tm, tinfo = TE.edit_sync(
            tbase, [TE.tree_map(torch.tensor, w) for w in workers], tema,
            tm, tc)
        assert _np(tinfo["kept"]).tolist() == np.asarray(
            jinfo["kept"]).tolist(), s
        for k in ("pg_norms", "weights", "pg_avg_norm"):
            np.testing.assert_allclose(_np(tinfo[k]), np.asarray(jinfo[k]),
                                       rtol=1e-5, err_msg=f"{k} sync {s}")
        for k in ("mean", "var"):
            np.testing.assert_allclose(_np(tema[k]), np.asarray(jema[k]),
                                       rtol=1e-5, err_msg=f"{k} sync {s}")
        assert int(tema["count"]) == int(jema["count"]) == s + 1
        assert tema["count"].dtype == torch.int32
        _close_tree(tbase, jax.tree.map(np.asarray, jbase))
        _close_tree(tm, jax.tree.map(np.asarray, jm))
        assert all(t.dtype == torch.float32 for t in _leaves(tm))
    # the last sync's z-scores against the history before it
    z = (np.abs(_np(tinfo["pg_norms"]) - prev["mean"])
         / np.maximum(np.sqrt(prev["var"] + 1e-12), 1e-6))
    kept = _np(tinfo["kept"]).tolist()
    if case == "anomaly":
        assert (z > 2.0).tolist() == [False, False, True]
        assert kept == [True, True, False]
        assert float(tinfo["weights"][2]) == 0.0
    elif case == "everyone":
        assert (z > 2.0).all()          # each alone would be eliminated
        assert kept == [True, True, True]
    else:                               # the average is clipped
        assert kept == [True, True, True]
        assert float(tinfo["pg_avg_norm"]) > clip


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def test_edit_sync_never_eliminates_everyone_and_casts_back():
    """A bf16 leaf comes back bf16 (computed in fp32, cast once), and a
    history that rejects every worker keeps them all."""
    rs = np.random.RandomState(3)
    base = {"w": torch.tensor(rs.randn(64).astype(np.float32)).bfloat16()}
    ema = {"mean": torch.zeros(2), "var": torch.full((2,), 1e-6),
           "count": torch.tensor(5, dtype=torch.int32)}
    workers = [{"w": base["w"] + 1.0}, {"w": base["w"] - 2.0}]
    new, new_ema, m, info = TE.edit_sync(base, workers, ema,
                                         TE.init_outer_momentum(base),
                                         TE.EDiTConfig())
    assert info["kept"].tolist() == [True, True]
    assert new["w"].dtype == torch.bfloat16 and m["w"].dtype == torch.float32
    jnew, _, _, jinfo = JE.edit_sync(
        {"w": jnp.asarray(base["w"].float().numpy(), jnp.bfloat16)},
        [{"w": jnp.asarray(w["w"].float().numpy(), jnp.bfloat16)}
         for w in workers],
        {k: jnp.asarray(v.numpy()) for k, v in ema.items()},
        {"w": jnp.zeros(64, jnp.float32)}, JE.EDiTConfig())
    assert np.asarray(jinfo["kept"]).tolist() == [True, True]
    # one bf16 rounding of fp32 values that differ in summation order
    np.testing.assert_allclose(new["w"].float().numpy(),
                               np.asarray(jnew["w"].astype(jnp.float32)),
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("kw", [
    {}, dict(n_workers=8, n_steps=100, sync_every=4, seed=3),
    dict(n_workers=2, n_steps=7, straggler_frac=0.5, layer_sync_overlap=0.0,
         sync_cost_s=2.0, seed=1)])
def test_simulate_sync_timeline_is_the_reference(kw):
    kw = {"n_workers": 4, "n_steps": 64, **kw}
    assert TE.simulate_sync_timeline(**kw) == JE.simulate_sync_timeline(**kw)


def test_layer_names_and_tree_helpers():
    rs = np.random.RandomState(4)
    a, b = _shape_tree(rs), _shape_tree(rs)
    ta, tb = TE.tree_map(torch.tensor, a), TE.tree_map(torch.tensor, b)
    assert TE.layer_names({"embed": 0, "blocks": 1, "final_norm": 2}) == \
        JE.layer_names({"embed": 0, "blocks": 1, "final_norm": 2})
    _close_tree(TE.tree_sub(ta, tb), jax.tree.map(np.asarray, JE.tree_sub(
        a, b)))
    np.testing.assert_allclose(float(TE.tree_norm(ta)),
                               float(JE.tree_norm(a)), rtol=1e-6)


# ---------------------------------------------------------------------------
# EDiTTrainer rounds and the launcher against the reference's
# ---------------------------------------------------------------------------


def _fp32(get):
    return lambda arch: dataclasses.replace(get(arch),
                                            compute_dtype="float32")


@pytest.fixture(scope="module")
def trainers():
    """The reference's jitted step and the port's, on the same converted
    fp32 smoke Ling-Lite weights; 2 rounds x 2 workers x 2 batches."""
    jc, tc = _fp32(jcfg)("ling-lite"), _fp32(tcfg)("ling-lite")
    jrun = japi.Runner(jc, make_local_mesh(1, 1), max_seq=S)
    ref = jax.tree.map(np.asarray, jrun.init_params(0))
    spike = JS.SpikeConfig()
    jstep = jrun.jit_train_step(B, spike_guard=spike, donate=False)

    def jworker_step(w, opt, batch, i, lr):
        if opt is None:
            opt = (JA.init_opt_state(w), JS.init_guard_state(spike))
        o, g = opt
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        w, o, g, m = jstep(w, o, g, jb, jnp.int32(i), jax.random.PRNGKey(i),
                           jnp.float32(lr))
        return w, (o, g), m["loss"]

    trun = tapi.Runner(tc, device="cpu")
    tstep = tlaunch.edit_worker_step(trun, TS.SpikeConfig())
    pipe = JPipe(JPipeCfg(vocab_size=jc.vocab_size, seq_len=S, batch_size=B,
                          seed=0))
    batches = [[[pipe.next_batch() for _ in range(2)] for _ in range(2)]
               for _ in range(2)]
    return dict(tc=tc, ref=ref, jstep=jworker_step, tstep=tstep,
                batches=batches)


@pytest.mark.parametrize("timed", [False, True])
def test_edit_rounds_match_reference(trainers, timed):
    t = trainers
    kw = dict(time_threshold_s=1.0) if timed else {}
    speeds = [1.0, 0.5] if timed else None
    je = JE.EDiTTrainer(jax.tree.map(jnp.asarray, t["ref"]), t["jstep"],
                        JE.EDiTConfig(sync_every=2, **kw), 2, speeds)
    te = TE.EDiTTrainer(interop.params_from_numpy(t["ref"], t["tc"],
                                                  device="cpu",
                                                  masters=True),
                        t["tstep"], TE.EDiTConfig(sync_every=2, **kw), 2,
                        speeds)
    for r in range(2):
        jr = je.round(t["batches"][r], lr=1e-3)
        tr = te.round(t["batches"][r], lr=1e-3)
        assert set(tr) == set(jr)
        assert tr["step"] == jr["step"] == 2 * (r + 1)
        assert tr["kept"] == jr["kept"] == [True, True]
        np.testing.assert_allclose(tr["mean_loss"], jr["mean_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(tr["pg_avg_norm"], jr["pg_avg_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(tr["weights"], jr["weights"], atol=1e-4)
    # time-based: worker 1 at half speed took one local step a round
    n_local = [2, 1] if timed else [2, 2]
    assert [int(o[0]["count"]) for o in te.opt_states] == \
        [2 * n for n in n_local]
    assert [int(o[0]["count"]) for o in je.opt_states] == \
        [2 * n for n in n_local]


def test_edit_replicas_do_not_alias_the_base(trainers, monkeypatch):
    """After a round the base is `edit_sync`'s output, not a worker's
    last local params; every worker restarts from it in storage of its
    own; a worker's optimizer state carries over to the next round."""
    t = trainers
    params = interop.params_from_numpy(t["ref"], t["tc"], device="cpu",
                                       masters=True)
    init = [p.clone() for p in TA.leaves(params)]
    te = TE.EDiTTrainer(params, t["tstep"], TE.EDiTConfig(sync_every=2), 2)
    seen = {}
    real = TE.edit_sync

    def spy(base, workers, *a):
        seen["local"] = [[p.detach().clone() for p in TA.leaves(w)]
                         for w in workers]
        seen["out"] = out = real(base, workers, *a)
        return out
    monkeypatch.setattr(TE, "edit_sync", spy)
    te.round(t["batches"][0], lr=1e-3)
    opt0 = te.opt_states[0]
    base = TA.leaves(te.base)
    for b, o in zip(base, TA.leaves(seen["out"][0])):
        assert b is o
    # the caller's initial tensors were never written
    for p, p0 in zip(TA.leaves(params), init):
        assert torch.equal(p, p0)
    ptrs = {p.data_ptr() for p in base}
    for i, w in enumerate(te.workers):
        wl = TA.leaves(w)
        assert not ptrs & {p.data_ptr() for p in wl}
        for p, b in zip(wl, base):
            assert torch.equal(p, b)
        # the base is not the worker's last local params
        assert any(not torch.equal(b, loc)
                   for b, loc in zip(base, seen["local"][i]))
    with torch.no_grad():
        TA.leaves(te.workers[0])[0].add_(1.0)
    assert not torch.equal(TA.leaves(te.workers[0])[0], base[0])
    assert torch.equal(TA.leaves(te.workers[1])[0], base[0])
    te.round(t["batches"][1], lr=1e-3)
    assert te.opt_states[0][0] is opt0[0] and int(opt0[0]["count"]) == 4


def test_launcher_edit_workers_matches_reference_launcher(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """`--smoke --edit-workers 2 --steps 8` (two rounds of 4 local steps)
    in both launchers from the same fp32 weights: the same records."""
    monkeypatch.setattr(jlaunch, "get_smoke_config", _fp32(jcfg))
    monkeypatch.setattr(tlaunch, "get_smoke_config", _fp32(tcfg))
    ref = {}
    real_init = japi.Runner.init_params

    def keep_init(self, seed=0):
        out = real_init(self, seed)
        ref["params"] = jax.tree.map(np.asarray, out)
        return out
    monkeypatch.setattr(japi.Runner, "init_params", keep_init)
    monkeypatch.setattr(
        tapi.Runner, "init_train_params",
        lambda self, seed=0: interop.params_from_numpy(
            ref["params"], self.cfg, device=self.device, masters=True))
    args = ["--smoke", "--edit-workers", "2", "--steps", "8", "--batch",
            str(B), "--seq", str(S)]
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--report", str(tmp_path / "j.json")])
    jlaunch.main()
    tlaunch.main(args + ["--device", "cpu", "--report",
                         str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    assert "[edit] round=1 " in out and "nan" not in out
    jh = json.loads((tmp_path / "j.json").read_text())
    th = json.loads((tmp_path / "t.json").read_text())
    assert len(th) == len(jh) == 2
    for rj, rt in zip(jh, th):
        assert set(rt) == set(rj)
        assert rt["step"] == rj["step"] and rt["kept"] == rj["kept"]
        np.testing.assert_allclose(rt["mean_loss"], rj["mean_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(rt["pg_avg_norm"], rj["pg_avg_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(rt["weights"], rj["weights"], atol=1e-4)


def test_launcher_refuses_bs_warmup_with_edit_workers(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["--smoke", "--device", "cpu", "--edit-workers", "2",
                      "--bs-warmup", "2:8:4"])
    assert "--bs-warmup is not supported with --edit-workers" in \
        capsys.readouterr().err
