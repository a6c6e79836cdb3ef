"""The port on a (dp, tp) mesh against the JAX package on the same mesh,
at Ling-Lite's smoke config with fp32 compute, from the same global
parameters (the port's (1, 1) `init_train_params(0)`, handed to the
reference whole and cut into each rank's shards by the port's spec
tree) and the same numpy-made batch and prompts:

  * `init_params` on every mesh gives each rank its slice of the (1, 1)
    parameters, for serving and training storage;
  * the train step at (2, 1), (1, 2) and (2, 2) (FSDP over dp, TP and SP
    over tp, the "ep" MoE dispatch at tp = 2, the router warmup active):
    the reduced gradients (the port's `make_loss_and_grad`; the
    reference's read back from its first AdamW moment, m = (1 - beta1)
    g * clip scale, exact to a few fp32 ulps), the loss and metrics, the
    grad norm of two optimizer steps, and the parameters after them;
  * at (1, 2): greedy dense decode fed token by token, the dense prefill
    into caches sharded over tp and its ticks, the paged OnlineEngine
    (page 8, so each rank holds 4 in-page offsets) greedy, and a sampled
    burst through the engine: every stream equal to the reference's;
  * at (2, 1): greedy dense decode token by token and after the dense
    prefill, each rank on its half of the rows (`api.local_rows`, its
    caches its rows), every rank returning every row's token, with the
    parameters FSDP over dp and whole on each dp rank (`fsdp=False`):
    the reference's streams at (2, 1);
  * the dry run (`launch.dryrun`): each rank's collectives in one train
    step at (2, 2), (2, 1) and (1, 2), and in one (2, 1) decode tick of
    each parameter storage, calls and bytes per op, equal to the
    parent's dry run of that rank.
  (The other architectures on a mesh: test_torch_mesh_archs and
  test_torch_mesh_families.)

The reference runs once for the file, in subprocesses with 4 host
devices forced before JAX starts (the pattern of test_sharded_parity and
test_online_serving): one per train mesh and one for serving, side by
side, its train steps without remat (the same values; a shorter
compile).  The port's ranks are 4 gloo processes on the CPU, spawned
once beside them, with remat on: (2, 2) on all four, then (2, 1) on
ranks 0-1 beside (1, 2) training and serving on ranks 2-3, each mesh
over a fresh file store under the test's tmp_path, with a 120 s group
timeout and a join limit, so a hung rank fails the test in its own
time.

Tolerances, as the port's tp = 1 tests against the reference with fp32
compute (test_torch_train_model, test_torch_trainer): the loss and the
metrics 1e-5 relative, each gradient leaf 1e-5 of its largest value,
the grad norms 1e-4 relative, and the parameters after two AdamW steps
1e-6 absolute for all but 1e-4 of each leaf's elements and 1e-5 for
every element.  AdamW's m / sqrt(v) turns a rounding difference of a
near-zero gradient into a fraction of the learning rate, so the steps
run at 1e-4, the learning rate of test_torch_trainer's first warmup
steps, which that rule was set for (at 1e-3 the one-rank port misses
it against the one-rank reference by the same margin as the meshes:
about 1.5e-4 of the elements past 1e-6, up to 2.4e-5).  Token streams
must be identical.  The dropped-slot fractions of the EP
dispatch are printed beside the reference's."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import api as tapi
from repro_torch import interop, sharding
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.models import prng
from repro_torch.optim import adamw
from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                        OnlineRequest)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120.0
TRAIN_MESHES = ((2, 2), (2, 1), (1, 2))
B, S, LR = 4, 16, 1e-4                  # training batch
SB, P, NEW, SEQ = 4, 6, 5, 32           # serving: slots, prompt, new, context
ENGINE = dict(max_slots=SB, max_context=SEQ, page_size=8, prefill_chunk=4)
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=16)


def _cfg():
    return dataclasses.replace(get_smoke_config("ling-lite"),
                               compute_dtype="float32")


def _data():
    rs = np.random.RandomState(0)
    V = _cfg().vocab_size
    return {"tokens": rs.randint(0, V, (B, S)).astype(np.int32),
            "labels": rs.randint(0, V, (B, S)).astype(np.int32),
            "prompts": rs.randint(0, V, (SB, P)).astype(np.int32)}


REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from repro import api
    from repro.configs.base import get_smoke_config
    from repro.launch.mesh import make_local_mesh
    from repro.models import model as M
    from repro.optim import adamw
    from repro.serving.online import OnlineConfig, OnlineEngine, OnlineRequest

    data, B, S, LR, SB, P, NEW, SEQ, ENGINE, SAMPLED = pickle.load(
        open(sys.argv[1], "rb"))
    part = sys.argv[3]               # "DPxTP" (a train mesh) or "serve"
    cfg = dataclasses.replace(get_smoke_config("ling-lite"),
                              compute_dtype="float32")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k in sorted(tree)
                    for k2, v2 in flat(tree[k], f"{prefix}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, t in enumerate(tree)
                    for k2, v2 in flat(t, f"{prefix}/{i}").items()}
        return {prefix: np.asarray(jax.device_get(tree), np.float32)}

    def train(dp, tp):
        # two steps at (dp, tp); the gradients read back from the first
        # moment: m = (1 - b1) * g * clip scale
        batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
        r = api.Runner(cfg, make_local_mesh(dp, tp), max_seq=S,
                       flags=M.RunFlags(remat=False))
        params = jax.tree.map(jnp.asarray, data["params"])
        step = jax.jit(r.make_train_step(B))
        opt = adamw.init_opt_state(params)
        steps, grads, ocfg = [], None, adamw.AdamWConfig()
        for i in (1, 2):
            params, opt, m = step(params, opt, batch, jnp.int32(i),
                                  jax.random.PRNGKey(i), jnp.float32(LR))
            steps.append({k: float(v) for k, v in m.items()})
            if grads is None:
                scale = jnp.minimum(1.0, ocfg.clip_norm
                                    / jnp.maximum(m["grad_norm"], 1e-12))
                grads = jax.tree.map(
                    lambda v: v / (1 - ocfg.beta1) / scale, opt["m"])
        return {"loss": steps[0]["loss"], "grads": flat(grads),
                "metrics": {k: v for k, v in steps[0].items()
                            if k not in ("loss", "grad_norm")},
                "steps": steps, "params2": flat(params)}

    if part != "serve":
        dp, tp = map(int, part.split("x"))
        pickle.dump({"train": {(dp, tp): train(dp, tp)}},
                    open(sys.argv[2], "wb"))
        sys.exit(0)

    # serving on (1, 2), as tests/test_online_serving.py's tp=2 script
    r = api.Runner(cfg, make_local_mesh(1, 2), fsdp=False,
                   seq_parallel=False, max_seq=SEQ)
    params = jax.tree.map(jnp.asarray, data["params"])
    prompts = data["prompts"]
    decode, _ = r.make_decode_step(global_batch=SB, seq_len=SEQ)
    decode = jax.jit(decode)
    caches = M.init_caches(cfg, r.env, SB, SEQ,
                           cross_len=cfg.encoder_seq_len)
    tok, dense = None, []
    for pos in range(P):
        tok, caches = decode(params, caches, jnp.asarray(prompts[:, pos]),
                             jnp.int32(pos))
    dense.append(np.asarray(tok))
    for pos in range(P, P + NEW - 1):
        tok, caches = decode(params, caches, tok, jnp.int32(pos))
        dense.append(np.asarray(tok))

    eng = OnlineEngine(r, params, OnlineConfig(**ENGINE))

    def engine_streams(knobs, base):
        eng.alloc.flush_radix()
        eng.submit_many([OnlineRequest(rid=base + i, prompt=prompts[i],
                                       max_new=NEW, seed=i, **knobs)
                         for i in range(SB)])
        eng.run(max_ticks=500)
        return np.stack([np.asarray(eng.reqs[base + i].out)
                         for i in range(SB)])

    # greedy dense decode at (2, 1): the rows over dp, caches zeros at
    # the global shapes the shard_mapped step takes
    r21 = api.Runner(cfg, make_local_mesh(2, 1), fsdp=False,
                     seq_parallel=False, max_seq=SEQ)
    decode21, _ = r21.make_decode_step(global_batch=SB, seq_len=SEQ)
    decode21 = jax.jit(decode21)
    caches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          r21.init_cache_shapes(SB, SEQ)[0])
    for pos in range(P):
        tok, caches = decode21(params, caches, jnp.asarray(prompts[:, pos]),
                               jnp.int32(pos))
    dense21 = [np.asarray(tok)]
    for pos in range(P, P + NEW - 1):
        tok, caches = decode21(params, caches, tok, jnp.int32(pos))
        dense21.append(np.asarray(tok))

    pickle.dump({"train": {}, "serve": {
        "dense": np.stack(dense, 1), "paged": engine_streams({}, 0),
        "sampled": engine_streams(SAMPLED, SB),
        "dense21": np.stack(dense21, 1)}}, open(sys.argv[2], "wb"))
""")


def _named(tree, prefix=""):
    """(path, leaf) pairs in `adamw.leaves` order (sorted dict keys, list
    entries in order), paths as the reference script's `flat` writes
    them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k],
                                                          f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree)
                for kv in _named(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _np(tree):
    return {k: v.detach().float().numpy() for k, v in _named(tree)}


def _train_phase(mesh, params_np, data):
    """One rank's train-step run at `mesh`."""
    cfg = _cfg()
    runner = tapi.Runner(cfg, device="cpu", max_seq=S, mesh=mesh)
    out = {"init": _np(runner.init_train_params(0)),
           "serve_init": _np(runner.init_params(0))}
    params = interop.params_from_numpy(params_np, cfg, device="cpu",
                                       masters=True, env=runner.env)
    batch = {k: torch.from_numpy(data[k]).long()
             for k in ("tokens", "labels")}
    loss, grads, mets = runner.make_loss_and_grad()(params, batch, 1,
                                                    prng.prng_key(1))
    names = [k for k, _ in _named(params)]
    out.update(loss=float(loss), metrics={k: float(v) for k, v in
                                          mets.items()},
               grads={k: g.numpy() for k, g in zip(names, grads)})
    step = runner.make_train_step()
    opt = adamw.init_opt_state(params)
    out["steps"] = []
    for i in (1, 2):
        mesh.stats.clear()
        params, opt, _, m = step(params, opt, None, batch, i,
                                 prng.prng_key(i), LR)
        out["steps"].append({k: float(v) for k, v in m.items()})
        if i == dryrun.TRAIN_STEP:
            out["stats"] = _calls_and_bytes(mesh)
    out["params2"] = _np(params)
    return out


def _serve_phase(mesh, params_np, data):
    """One rank's serving runs at (1, 2)."""
    cfg = _cfg()
    runner = tapi.Runner(cfg, device="cpu", max_seq=SEQ, mesh=mesh)
    params = interop.params_from_numpy(params_np, cfg, device="cpu",
                                       env=runner.env)
    prompts = torch.from_numpy(data["prompts"]).long()
    decode = runner.make_decode_step()
    caches = runner.init_caches(SB, SEQ)
    for pos in range(P):
        tok, caches = decode(params, caches, prompts[:, pos], pos)
    dense = [tok]
    for pos in range(P, P + NEW - 1):
        tok, caches = decode(params, caches, tok, pos)
        dense.append(tok)
    tok, caches = runner.make_prefill(seq_len=SEQ)(params,
                                                   {"tokens": prompts})
    prefilled = [tok]
    for pos in range(P, P + NEW - 1):
        tok, caches = decode(params, caches, tok, pos)
        prefilled.append(tok)

    eng = OnlineEngine(runner, params, OnlineConfig(**ENGINE))

    def engine_streams(knobs, base):
        eng.alloc.flush_radix()
        eng.submit_many([OnlineRequest(rid=base + i,
                                       prompt=data["prompts"][i],
                                       max_new=NEW, seed=i, **knobs)
                         for i in range(SB)])
        eng.run(max_ticks=500)
        return np.stack([np.asarray(eng.reqs[base + i].out)
                         for i in range(SB)])

    return {"dense": torch.stack(dense, 1).numpy(),
            "prefilled": torch.stack(prefilled, 1).numpy(),
            "paged": engine_streams({}, 0),
            "sampled": engine_streams(SAMPLED, SB),
            # the in-page offsets a rank's pools hold at page 8
            "pool_rows": runner.init_paged_pools(2, 8)["self"]["k"].shape[2]}


def _serve21_phase(mesh, params_np, data):
    """One rank's dense decode at (2, 1): token by token, then after the
    dense prefill; and one tick's collectives."""
    cfg = _cfg()
    runner = tapi.Runner(cfg, device="cpu", max_seq=SEQ, mesh=mesh)
    params = interop.params_from_numpy(params_np, cfg, device="cpu",
                                       env=runner.env)
    prompts = torch.from_numpy(data["prompts"]).long()
    decode = runner.make_decode_step()
    caches = runner.init_caches(SB, SEQ)
    rows = caches["self"]["k"].shape[1]
    for pos in range(P):
        tok, caches = decode(params, caches, prompts[:, pos], pos)
    dense = [tok]
    for pos in range(P, P + NEW - 1):
        mesh.stats.clear()
        tok, caches = decode(params, caches, tok, pos)
        dense.append(tok)
    stats = _calls_and_bytes(mesh)
    tok, caches = runner.make_prefill(seq_len=SEQ)(params,
                                                   {"tokens": prompts})
    prefilled = [tok]
    for pos in range(P, P + NEW - 1):
        tok, caches = decode(params, caches, tok, pos)
        prefilled.append(tok)
    # the parameters whole on each dp rank (`fsdp=False`)
    wrunner = tapi.Runner(cfg, device="cpu", max_seq=SEQ, mesh=mesh,
                          fsdp=False)
    wparams = interop.params_from_numpy(params_np, cfg, device="cpu",
                                        env=wrunner.env)
    tok, caches = wrunner.make_prefill(seq_len=SEQ)(wparams,
                                                    {"tokens": prompts})
    whole, wdecode = [tok], wrunner.make_decode_step()
    for pos in range(P, P + NEW - 1):
        mesh.stats.clear()
        tok, caches = wdecode(wparams, caches, tok, pos)
        whole.append(tok)
    return {"dense": torch.stack(dense, 1).numpy(),
            "prefilled": torch.stack(prefilled, 1).numpy(),
            "whole": torch.stack(whole, 1).numpy(),
            "cache_rows": rows, "stats": stats,
            "whole_stats": _calls_and_bytes(mesh)}


def _calls_and_bytes(mesh):
    return {op: {"calls": s["calls"], "bytes": s["bytes"]}
            for op, s in mesh.stats.items()}


# each phase: (store, mesh, function, the global ranks that run it)
PHASES = (("all", (2, 2), "_train_phase", (0, 1, 2, 3)),
          ("lo", (2, 1), "_train_phase", (0, 1)),
          ("hi", (1, 2), "_train_phase", (2, 3)),
          ("hi-serve", (1, 2), "_serve_phase", (2, 3)),
          ("lo-serve", (2, 1), "_serve21_phase", (0, 1)))


def _worker(rank: int, tmp: str, params_np, data):
    torch.set_num_threads(1)
    for store, (dp, tp), name, ranks in PHASES:
        if rank not in ranks:
            continue
        r = ranks.index(rank)
        tmesh.init_distributed(r, dp * tp,
                               init_method=f"file://{tmp}/store-{store}",
                               backend="gloo", timeout_s=TIMEOUT_S)
        mesh = tmesh.make_local_mesh(dp, tp, device="cpu",
                                     timeout_s=TIMEOUT_S)
        out = globals()[name](mesh, params_np, data)
        with open(os.path.join(tmp, f"{name}_{dp}x{tp}_{r}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
        torch.distributed.destroy_process_group()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_np(v) for v in tree]
    return tree.detach().float().numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_parity")
    data = _data()
    data["params"] = _tree_np(tapi.Runner(_cfg(), device="cpu", max_seq=S)
                              .init_train_params(0))
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((data, B, S, LR, SB, P, NEW, SEQ, ENGINE, SAMPLED), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    parts = [f"{dp}x{tp}" for dp, tp in TRAIN_MESHES] + ["serve"]
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / f"ref-{part}.pkl"), part], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in parts]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp), data["params"], data))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S * 4)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    ref = {"train": {}}
    for part, proc in zip(parts, refs):
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, (part, log[-3000:])
        with open(tmp / f"ref-{part}.pkl", "rb") as f:
            got = pickle.load(f)
        ref["train"].update(got["train"])
        ref.update({k: v for k, v in got.items() if k != "train"})
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]

    def load(name, mesh, r):
        with open(tmp / f"{name}_{mesh[0]}x{mesh[1]}_{r}.pkl", "rb") as f:
            return pickle.load(f)
    port = {m: [load("_train_phase", m, r) for r in range(m[0] * m[1])]
            for m in TRAIN_MESHES}
    serve = [load("_serve_phase", (1, 2), r) for r in range(2)]
    serve21 = [load("_serve21_phase", (2, 1), r) for r in range(2)]
    return ref, port, serve, serve21


def _env(dp, tp, rank):
    """An AxisEnv at a rank's coordinates (no process group): for cutting
    global arrays."""
    return sharding.make_axis_env(tmesh.Mesh.at(dp, tp, rank, device="cpu"))


def _specs(dp, tp):
    """{leaf path: spec} of the parameters at a (dp, tp) mesh."""
    return dict(_named(TM.param_specs(_cfg(), _env(dp, tp, 0), S)))


def _hold_params(got, ref, what):
    """AdamW's rule: 1e-6 for all but 1e-4 of each leaf, 1e-5 for all."""
    for k, r in ref.items():
        err = np.abs(got[k] - r)
        assert err.max() <= 1e-5, (what, k, float(err.max()))
        assert np.mean(err > 1e-6) <= 1e-4, (what, k, float(np.mean(
            err > 1e-6)))


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_init_params_are_slices_of_the_one_rank_parameters(runs, mesh):
    """Every rank's `init_params(0)` and `init_train_params(0)` equal its
    slice of the (1, 1) runner's, bit for bit."""
    _, port, _, _ = runs
    one = tapi.Runner(_cfg(), device="cpu", max_seq=S)
    full = {"init": _np(one.init_train_params(0)),
            "serve_init": _np(one.init_params(0))}
    specs = _specs(*mesh)
    for r, rank in enumerate(port[mesh]):
        env = _env(*mesh, r)
        for kind in ("init", "serve_init"):
            for k, v in full[kind].items():
                np.testing.assert_array_equal(
                    rank[kind][k], sharding.shard(v, specs[k], env),
                    err_msg=f"{mesh} rank {r} {kind} {k}")


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_gradients_loss_and_metrics_match_the_reference(runs, mesh):
    """`make_loss_and_grad` at step 1 (router warmup active): every rank's
    reduced gradient shards against its slice of the reference's global
    gradients, the loss and the metrics."""
    ref, port, _, _ = runs
    rt = ref["train"][mesh]
    specs = _specs(*mesh)
    print(f"\n{mesh} moe/dropped_frac port "
          f"{port[mesh][0]['metrics']['moe/dropped_frac']} reference "
          f"{rt['metrics']['moe/dropped_frac']}")
    for r, rank in enumerate(port[mesh]):
        env = _env(*mesh, r)
        np.testing.assert_allclose(rank["loss"], rt["loss"], rtol=1e-5)
        assert set(rank["metrics"]) == set(rt["metrics"])
        for k, v in rt["metrics"].items():
            np.testing.assert_allclose(rank["metrics"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=f"{mesh} {k}")
        assert set(rank["grads"]) == set(rt["grads"])
        for k, g in rt["grads"].items():
            want = sharding.shard(g, specs[k], env)
            np.testing.assert_allclose(
                rank["grads"][k], want, rtol=0,
                atol=1e-5 * max(np.abs(g).max(), 1e-30),
                err_msg=f"{mesh} rank {r} grad {k}")


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_two_train_steps_match_the_reference(runs, mesh):
    """Two optimizer steps (router warmup active): each step's loss and
    grad norm, then every rank's parameter shards."""
    ref, port, _, _ = runs
    rt = ref["train"][mesh]
    specs = _specs(*mesh)
    for r, rank in enumerate(port[mesh]):
        for got, want in zip(rank["steps"], rt["steps"]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-4)
        env = _env(*mesh, r)
        _hold_params(rank["params2"],
                     {k: sharding.shard(v, specs[k], env)
                      for k, v in rt["params2"].items()}, (mesh, r))


@pytest.mark.parametrize("stream", ["dense", "prefilled", "paged",
                                    "sampled"])
def test_serving_streams_on_1x2_match_the_reference(runs, stream):
    """At (1, 2): greedy dense decode (token by token, and after the dense
    prefill into tp-sharded caches), the paged OnlineEngine (each rank 4
    of a page's 8 offsets) greedy and sampled: both ranks' streams equal
    each other and the reference's."""
    ref, _, serve, _ = runs
    want = ref["serve"]["dense" if stream == "prefilled" else stream]
    for r in range(2):
        np.testing.assert_array_equal(serve[r][stream], want,
                                      err_msg=f"{stream} rank {r}")
    assert serve[0]["pool_rows"] == 4


@pytest.mark.parametrize("stream", ["dense", "prefilled"])
def test_dense_serving_on_2x1_splits_the_rows_and_matches_the_reference(
        runs, stream):
    """At (2, 1) each rank decodes its 2 of the 4 rows (its caches hold
    them) and returns all 4 rows' tokens: the reference's (2, 1) greedy
    streams, token by token and after the prefill."""
    ref, _, _, serve21 = runs
    for r in range(2):
        np.testing.assert_array_equal(serve21[r][stream],
                                      ref["serve"]["dense21"],
                                      err_msg=f"{stream} rank {r}")
        assert serve21[r]["cache_rows"] == SB // 2


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_dry_run_collectives_equal_each_ranks_train_step(runs, mesh):
    """The dry run of rank r's train step (the file's config, batch and
    step) gives the collectives rank r counted, calls and bytes per op."""
    _, port, _, _ = runs
    for r, rank in enumerate(port[mesh]):
        rec = dryrun.trace(_cfg(), ShapeConfig("mesh_parity", S, B, "train"),
                           *mesh, rank=r)
        assert rec["collective_stats"] == rank["stats"], (mesh, r)
        assert rank["stats"]


def test_dry_run_collectives_equal_each_ranks_decode_tick(runs):
    _, _, _, serve21 = runs
    for r in range(2):
        rec = dryrun.trace(_cfg(), ShapeConfig("mesh_parity", SEQ, SB,
                                               "decode"), 2, 1, rank=r,
                           serve_fsdp=True)
        assert rec["collective_stats"] == serve21[r]["stats"], r
        assert serve21[r]["stats"]


def test_whole_parameter_serving_on_2x1_matches_the_reference(runs):
    """At (2, 1) with the parameters whole on each dp rank (`fsdp=False`,
    the reference dry run's serving storage): the reference's (2, 1)
    stream after the prefill, and the dry run's tick (without
    `serve_fsdp`) gives the collectives each rank counted: no weight
    gathered over dp."""
    ref, _, _, serve21 = runs
    for r in range(2):
        np.testing.assert_array_equal(serve21[r]["whole"],
                                      ref["serve"]["dense21"],
                                      err_msg=f"rank {r}")
        rec = dryrun.trace(_cfg(), ShapeConfig("mesh_parity", SEQ, SB,
                                               "decode"), 2, 1, rank=r)
        assert rec["collective_stats"] == serve21[r]["whole_stats"], r
        assert serve21[r]["whole_stats"]["all_gather"]["calls"] == 1
        assert (serve21[r]["stats"]["all_gather"]["calls"]
                > serve21[r]["whole_stats"]["all_gather"]["calls"])
