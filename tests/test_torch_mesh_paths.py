"""The rest of Ling-Lite's paths on a (dp, tp) mesh, the port against the
JAX package on the same mesh, at Ling-Lite's smoke config with fp32
compute, from the same global parameters (the port's (1, 1)
`init_train_params(0)`, handed to the reference whole and cut into each
rank's shards by the port's spec tree) and the same numpy-made inputs:

  * the int8 sequence-parallel boundary: `sharding.quant_rows` against
    the reference's `_quant_rows` bit for bit; the quantized gather and
    scatter (`sp_comm="int8"`) and their backward at tp = 2 against the
    reference's `custom_vjp`; the int8 train step at (1, 2) and (2, 2);
  * `moe_ffn` in the "fused", "ragged" and "batched" dispatch modes at
    tp = 2 and "batched" at tp = 1 (capacity factor 1, so slots drop):
    each rank's partial output, its gradients and `moe/dropped_frac`;
    and "auto" resolving to "batched" where T % tp != 0;
  * `make_score_fn` at (1, 2) and (2, 2), an item of odd length at
    (1, 2) (SP off and the "batched" dispatch, as the reference's
    seq_parallel=False runner scores it), and the eval harness's
    reports on those scores;
  * speculative decoding at (1, 2): greedy and sampled streams with a
    1-layer self-drafter and greedy with a `ConfigDrafter` of given
    global weights, each rank's equal to the reference's;
  * the SLO gate at (1, 2) on injected clocks (rank 1's ten times rank
    0's): both ranks shed the rids the port's (1, 1) engine sheds on
    rank 0's clock, though rank 1's own tracker would decide otherwise.

The reference runs once for the file, in 4-host-device subprocesses, one
per part, side by side.  The port's ranks are 4 gloo processes on the
CPU, spawned once beside them: (2, 2) on all four, then two (1, 2) meshes
on ranks 0-1 and 2-3, each over a fresh file store under the test's
tmp_path, with a 120 s group timeout and a join limit.

Tolerances: `quant_rows` bit for bit.  The int8 collectives: every
element within one quantization step of its row (amax / 127; the sum of
the two blocks' steps for the scatter), and at most 1% of the elements
a level apart (a value on a level boundary may round the other way); the
rest within fp32's rounding of q0 s0 + q1 s1, which the reference's
XLA sum may fuse into a multiply-add (the port's is two products and an
add, as numpy's).  The int8 train step: loss and grad norm 1e-4
relative; each gradient leaf 1e-2 of its largest in its L2 norm and
2e-2 in every element (`_grad_misses`: an activation the two forwards
round to either side of a level boundary quantizes a level, 1/127 of its
row, apart), where the port's native-SP gradients, the control, miss
them.  `moe_ffn`: outputs and gradients 1e-5 of the largest, the
dropped fraction equal.  Scores 1e-5 relative.  Token streams, the
harness's reports and the shed rids identical."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import api as tapi
from repro_torch import interop, sharding
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import moe as tmoe
from repro_torch.evals import harness as TH
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import prng
from repro_torch.optim import adamw
from repro_torch.serving import draft as tdraft
from repro_torch.serving import online as tonline
from repro_torch.telemetry.slo import SLOConfig


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
B, S, LR = 4, 16, 1e-4                  # training and scoring batch
T_MOE = 12                              # moe_ffn's tokens
SB, P, NEW, SEQ, K = 4, 6, 5, 32, 2     # serving; K drafts a spec tick
ENGINE = dict(max_slots=SB, max_context=SEQ, page_size=8, prefill_chunk=4)
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=16)
MODES = ("fused", "ragged", "batched")
# harness items: contexts of 5, options of 2 and 3 tokens -> scored
# sequences of 7 (T = 6, SP on) and 8 (T = 7, odd: SP off, "batched")
N_ITEMS, CTX = 3, 5
SLO_CLOCK = 1e-3          # seconds a perf_counter call advances, rank 0
SLO_TTFT_MS = 20.0


def _cfg():
    return dataclasses.replace(get_smoke_config("ling-lite"),
                               compute_dtype="float32")


def _moe_cfg():
    cfg = _cfg()
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


def _draft_cfg():
    return dataclasses.replace(_cfg(), n_layers=1)


def _data():
    rs = np.random.RandomState(0)
    cfg = _cfg()
    V, d = cfg.vocab_size, cfg.d_model
    items = [dict(context=rs.randint(0, V, CTX).astype(np.int32),
                  options=[rs.randint(0, V, n).astype(np.int32)
                           for n in (2, 3)], answer=i % 2)
             for i in range(N_ITEMS)]
    quant = rs.randn(6, 32).astype(np.float32) * 3
    quant[1] = 0.0                                   # amax 0
    quant[2, :8] = [127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5]
    quant[2, 8:] = 0.25                              # scale exactly 1
    return {"tokens": rs.randint(0, V, (B, S)).astype(np.int32),
            "labels": rs.randint(0, V, (B, S)).astype(np.int32),
            "mask": (rs.rand(B, S) > 0.3).astype(np.float32),
            "prompts": rs.randint(0, V, (SB, P)).astype(np.int32),
            "moe_x": rs.randn(T_MOE, d).astype(np.float32),
            "moe_ct": rs.randn(T_MOE, d).astype(np.float32),
            "q_gather": (rs.randn(2, 4, 6).astype(np.float32),
                         rs.randn(2, 8, 6).astype(np.float32)),
            "q_scatter": (rs.randn(2, 8, 6).astype(np.float32),
                          rs.randn(2, 4, 6).astype(np.float32)),
            "quant": quant, "items": items}


REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import api, sharding
    from repro.configs.base import get_smoke_config
    from repro.core import moe as JM
    from repro.evals import harness as JH
    from repro.launch.mesh import make_local_mesh
    from repro.models import model as M
    from repro.optim import adamw
    from repro.serving.draft import ConfigDrafter, SelfDrafter
    from repro.serving.online import OnlineConfig, OnlineEngine, OnlineRequest

    (data, B, S, LR, SB, P_, NEW, SEQ, K, ENGINE, SAMPLED,
     MODES) = pickle.load(open(sys.argv[1], "rb"))
    part = sys.argv[3]
    cfg = dataclasses.replace(get_smoke_config("ling-lite"),
                              compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, data["params"])
    out = {}

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k in sorted(tree)
                    for k2, v2 in flat(tree[k], f"{prefix}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, t in enumerate(tree)
                    for k2, v2 in flat(t, f"{prefix}/{i}").items()}
        return {prefix: np.asarray(jax.device_get(tree), np.float32)}

    def stacked(fn, mesh, in_specs, args):
        # fn(*local args) -> a tree; every leaf stacked over the ranks
        def body(*a):
            return jax.tree.map(lambda t: jnp.asarray(t)[None], fn(*a))
        names = ("data", "model")
        sm = sharding.shard_map(body, mesh=mesh, in_specs=in_specs,
                                out_specs=P(names))
        return jax.tree.map(np.asarray, jax.jit(sm)(*args))

    if part == "units":
        from repro.sharding import _quant_rows, make_axis_env
        q, s = _quant_rows(jnp.asarray(data["quant"]))
        out["quant"] = (np.asarray(q), np.asarray(s))
        mesh = make_local_mesh(1, 2)
        env = dataclasses.replace(make_axis_env(mesh), sp_comm="int8")
        for name, call in (("q_gather", env.sp_gather),
                           ("q_scatter", env.sp_scatter)):
            x, ct = data[name]
            def body(x, ct, call=call):
                y, pull = jax.vjp(call, x[0])
                return y[None], pull(ct[0])[0][None]
            sm = sharding.shard_map(body, mesh=mesh,
                                    in_specs=(P("model"), P("model")),
                                    out_specs=(P("model"), P("model")))
            out[name] = tuple(np.asarray(t) for t in jax.jit(sm)(
                jnp.asarray(x), jnp.asarray(ct)))
        mcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
        moe_p = jax.tree.map(lambda t: jnp.asarray(t[0]),
                             data["params"]["blocks"]["moe"])
        x, ct = jnp.asarray(data["moe_x"]), jnp.asarray(data["moe_ct"])
        for tp, mode in [(2, m) for m in MODES] + [(1, "batched")]:
            mesh = make_local_mesh(1, tp)
            env = make_axis_env(mesh)
            _, specs = JM.init_moe(jax.random.PRNGKey(0), mcfg, env)

            def fn(p, x, ct, env=env, mode=mode):
                def f(p, x):
                    y, _, mets = JM.moe_ffn(mcfg, env, p, x, train=True,
                                            dispatch=mode)
                    return y, mets["moe/dropped_frac"]
                (y, frac), pull = jax.vjp(f, p, x)
                gp, gx = pull((ct, jnp.zeros_like(frac)))
                return {"y": y, "frac": frac, "gx": gx, "gp": gp}
            out[("moe", tp, mode)] = stacked(fn, mesh, (specs, P(), P()),
                                             (moe_p, x, ct))

    elif part == "train":
        batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
        for dp, tp in ((1, 2), (2, 2)):
            r = api.Runner(cfg, make_local_mesh(dp, tp), max_seq=S,
                           flags=M.RunFlags(remat=False), sp_comm="int8")
            step = jax.jit(r.make_train_step(B))
            opt = adamw.init_opt_state(params)
            _, opt, m = step(params, opt, batch, jnp.int32(1),
                             jax.random.PRNGKey(1), jnp.float32(LR))
            ocfg = adamw.AdamWConfig()
            scale = jnp.minimum(1.0, ocfg.clip_norm
                                / jnp.maximum(m["grad_norm"], 1e-12))
            grads = jax.tree.map(lambda v: v / (1 - ocfg.beta1) / scale,
                                 opt["m"])
            out[("train", dp, tp)] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "grads": flat(grads)}

    elif part == "score":
        tok, mask = jnp.asarray(data["tokens"]), jnp.asarray(data["mask"])
        runners = {}

        def runner(dp, sp):
            key = (dp, sp)
            if key not in runners:
                runners[key] = api.Runner(cfg, make_local_mesh(dp, 2),
                                          max_seq=S, seq_parallel=sp)
            return runners[key]
        for dp in (1, 2):
            out[("score", dp)] = np.asarray(jax.jit(
                runner(dp, True).make_score_fn(B, S))(params, tok, mask))
        out[("score", "odd")] = np.asarray(jax.jit(
            runner(1, False).make_score_fn(1, S))(params, tok[:1], mask[:1]))
        fns, calls = {}, []

        def score_fn(seq, m):
            n = len(seq)
            if n not in fns:
                sp = (n - 1) % 2 == 0
                fns[n] = jax.jit(runner(1, sp).make_score_fn(1, n))
            v = float(fns[n](params, jnp.asarray(seq[None], jnp.int32),
                             jnp.asarray(m[None], jnp.float32))[0])
            calls.append(v)
            return v
        items = [JH.MCItem(**it) for it in data["items"]]
        out["harness"] = (JH.ppl_eval_content(items, score_fn), calls)

    elif part == "spec":
        r = api.Runner(cfg, make_local_mesh(1, 2), fsdp=False,
                       seq_parallel=False, max_seq=SEQ)
        prompts = data["prompts"]

        def streams(drafter, knobs, base=0):
            eng = OnlineEngine(r, params, OnlineConfig(**ENGINE, spec_k=K),
                               drafter=drafter)
            res = []
            for kn, b in knobs:
                eng.alloc.flush_radix()
                eng.submit_many([OnlineRequest(
                    rid=b + i, prompt=prompts[i], max_new=NEW, seed=i, **kn)
                    for i in range(SB)])
                eng.run(max_ticks=500)
                res.append(np.stack([np.asarray(eng.reqs[b + i].out)
                                     for i in range(SB)]))
            return res
        out["self"] = streams(SelfDrafter(draft_layers=1),
                              [({}, 0), (SAMPLED, SB)])
        dcfg = dataclasses.replace(cfg, n_layers=1)
        dparams = jax.tree.map(jnp.asarray, data["draft_params"])
        out["config"] = streams(ConfigDrafter(dcfg, params=dparams),
                                [({}, 0)])
    pickle.dump(out, open(sys.argv[2], "wb"))
""")
REF_PARTS = ("units", "train", "score", "spec")


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k],
                                                          f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree)
                for kv in _named(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _train(mesh, data):
    """The int8 train step: the reduced gradients, one step's loss and
    grad norm; and the same gradients with sp_comm="native" (the
    control).  Each gradient pass's collectives' calls and bytes."""
    cfg = _cfg()
    batch = {k: torch.from_numpy(data[k]).long()
             for k in ("tokens", "labels")}
    out = {}
    for comm in ("native", "int8"):
        runner = tapi.Runner(cfg, device="cpu", max_seq=S, mesh=mesh,
                             sp_comm=comm)
        params = interop.params_from_numpy(data["params"], cfg,
                                           device="cpu", masters=True,
                                           env=runner.env)
        mesh.stats.clear()
        _, grads, _ = runner.make_loss_and_grad()(params, batch, 1,
                                                  prng.prng_key(1))
        out[comm] = {"grads": {k: g.numpy() for (k, _), g in
                               zip(_named(params), grads)},
                     "stats": {k: dict(v) for k, v in mesh.stats.items()}}
    _, _, _, m = runner.make_train_step()(
        params, adamw.init_opt_state(params), None, batch, 1,
        prng.prng_key(1), LR)
    out["int8"].update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    return out


def _scores(mesh, data):
    cfg = _cfg()
    runner = tapi.Runner(cfg, device="cpu", max_seq=S, mesh=mesh)
    params = interop.params_from_numpy(data["params"], cfg, device="cpu",
                                       env=runner.env)
    score = runner.make_score_fn()
    tok, mask = data["tokens"], data["mask"]
    out = {"score": score(params, tok, mask).numpy()}
    if mesh.dp == 1:
        modes = []
        orig = tmoe.resolve_dispatch

        def seen(*a, **k):
            mode = orig(*a, **k)
            modes.append(mode)
            return mode
        tmoe.resolve_dispatch = seen
        try:
            out["odd"] = score(params, tok[:1], mask[:1]).numpy()
            calls = []

            def score_fn(seq, m):
                v = float(score(params, seq[None], m[None])[0])
                calls.append(v)
                return v
            items = [TH.MCItem(**it) for it in data["items"]]
            out["harness"] = (TH.ppl_eval_content(items, score_fn), calls)
        finally:
            tmoe.resolve_dispatch = orig
        out["odd_modes"] = sorted(set(modes))
    return out


def _units(mesh, data):
    """int8 collectives and `moe_ffn` modes at tp = 2 (a rank's
    values)."""
    r = mesh.tp_index
    env = sharding.make_axis_env(mesh, sp_comm="int8")
    out = {}
    for name, call in (("q_gather", env.sp_gather),
                       ("q_scatter", env.sp_scatter)):
        x, ct = (torch.from_numpy(a[r]) for a in data[name])
        x.requires_grad_(True)
        y = call(x)
        (g,) = torch.autograd.grad(y, [x], ct)
        out[name] = (y.detach().numpy(), g.numpy())
    cfg = _moe_cfg()
    env = sharding.make_axis_env(mesh)
    for mode in MODES:
        out[("moe", mode)] = _moe_call(cfg, env, data, mode)
    return out


def _moe_call(cfg, env, data, mode):
    """One rank's `moe_ffn` at `mode`: partial output, dropped fraction,
    gradients of x and of the rank's layer-0 MoE parameters."""
    full = interop.params_from_numpy(data["params"], cfg, device="cpu",
                                     masters=True, env=env)
    p = TM.layer_params(full["blocks"], 0)["moe"]
    p = {k: (v.detach().clone() if torch.is_tensor(v) else
             {k2: v2.detach().clone() for k2, v2 in v.items()})
         for k, v in p.items()}
    leaves = adamw.leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(data["moe_x"]).requires_grad_(True)
    y, _, mets = tmoe.moe_ffn(cfg, p, x, dispatch=mode, train=True, env=env)
    grads = torch.autograd.grad(y, [x] + leaves,
                                torch.from_numpy(data["moe_ct"]))
    return {"y": y.detach().numpy(), "gx": grads[0].numpy(),
            "gp": {k: g.numpy() for (k, _), g in zip(_named(p), grads[1:])},
            "frac": float(mets["moe/dropped_frac"])}


def _spec(mesh, data):
    cfg = _cfg()
    runner = tapi.Runner(cfg, device="cpu", max_seq=SEQ, mesh=mesh)
    params = interop.params_from_numpy(data["params"], cfg, device="cpu",
                                       env=runner.env)
    dparams = interop.params_from_numpy(data["draft_params"], _draft_cfg(),
                                        device="cpu")

    def streams(drafter, knobs):
        eng = tonline.OnlineEngine(
            runner, params, tonline.OnlineConfig(**ENGINE, spec_k=K),
            drafter=drafter)
        res = []
        for kn, b in knobs:
            eng.alloc.flush_radix()
            eng.submit_many([tonline.OnlineRequest(
                rid=b + i, prompt=data["prompts"][i], max_new=NEW, seed=i,
                **kn) for i in range(SB)])
            eng.run(max_ticks=500)
            res.append(np.stack([np.asarray(eng.reqs[b + i].out)
                                 for i in range(SB)]))
        return res
    return {"self": streams(tdraft.SelfDrafter(draft_layers=1),
                            [({}, 0), (SAMPLED, SB)]),
            "config": streams(tdraft.ConfigDrafter(_draft_cfg(),
                                                   params=dparams),
                              [({}, 0)])}


def _slo_engine(mesh, data, clock_step):
    """The SLO engine on an injected clock (`clock_step` seconds a
    perf_counter call): 2 warm-up requests, then 12 submitted two at a
    time between ticks.  Returns (shed rids, the rank's own tracker's
    verdicts)."""
    cfg = _cfg()
    runner = tapi.Runner(cfg, device="cpu", max_seq=SEQ, mesh=mesh)
    params = interop.params_from_numpy(data["params"], cfg, device="cpu",
                                       env=runner.env)
    now = [0.0]

    def perf_counter():
        now[0] += clock_step
        return now[0]
    saved = tonline.time
    tonline.time = types.SimpleNamespace(perf_counter=perf_counter,
                                         sleep=saved.sleep)
    try:
        eng = tonline.OnlineEngine(runner, params, tonline.OnlineConfig(
            **ENGINE, overload="slo", slo=SLOConfig(
                ttft_p99_ms=SLO_TTFT_MS, min_observations=2, window=16)))
        own = []
        orig = eng.slo.should_shed

        def should_shed(*a, **k):
            v = orig(*a, **k)
            own.append(v is not None)
            return v
        eng.slo.should_shed = should_shed
        prompts = data["prompts"]
        for i in range(2):
            eng.submit(tonline.OnlineRequest(rid=i, prompt=prompts[i],
                                             max_new=NEW))
        eng.run(max_ticks=500)
        shed = []
        for i in range(2, 14, 2):
            for rid in (i, i + 1):
                if not eng.submit(tonline.OnlineRequest(
                        rid=rid, prompt=prompts[rid % SB], max_new=NEW)):
                    shed.append(rid)
            eng.tick()
            eng.tick()
        eng.run(max_ticks=500)
    finally:
        tonline.time = saved
    return shed, own


def _serve_lo(mesh, data):
    return {"units": _units(mesh, data), "train": _train(mesh, data),
            "scores": _scores(mesh, data)}


def _serve_hi(mesh, data):
    return {"spec": _spec(mesh, data),
            "slo": _slo_engine(mesh, data,
                               SLO_CLOCK * (1 + 9 * mesh.tp_index))}


def _all(mesh, data):
    return {"train": _train(mesh, data), "scores": _scores(mesh, data)}


# (store, mesh, function, the global ranks that run it)
PHASES = (("all", (2, 2), "_all", (0, 1, 2, 3)),
          ("lo", (1, 2), "_serve_lo", (0, 1)),
          ("hi", (1, 2), "_serve_hi", (2, 3)))


def _worker(rank: int, tmp: str, data):
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
        out = globals()[name](mesh, data)
        with open(os.path.join(tmp, f"{name}_{r}.pkl"), "wb") as f:
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
    tmp = tmp_path_factory.mktemp("mesh_paths")
    data = _data()
    data["params"] = _tree_np(tapi.Runner(_cfg(), device="cpu", max_seq=S)
                              .init_train_params(0))
    data["draft_params"] = _tree_np(tapi.Runner(_draft_cfg(), device="cpu",
                                                max_seq=SEQ)
                                    .init_train_params(7))
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((data, B, S, LR, SB, P, NEW, SEQ, K, ENGINE, SAMPLED,
                     MODES), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / f"ref-{part}.pkl"), part], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in REF_PARTS]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp), data))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S * 4)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    ref = {}
    for part, proc in zip(REF_PARTS, refs):
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, (part, log[-3000:])
        with open(tmp / f"ref-{part}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]

    def load(name, r):
        with open(tmp / f"{name}_{r}.pkl", "rb") as f:
            return pickle.load(f)
    port = {"all": [load("_all", r) for r in range(4)],
            "lo": [load("_serve_lo", r) for r in range(2)],
            "hi": [load("_serve_hi", r) for r in range(2)]}
    return data, ref, port


def _env(dp, tp, rank):
    return sharding.make_axis_env(tmesh.Mesh.at(dp, tp, rank, device="cpu"))


# ---------------------------------------------------------------------------
# the int8 SP boundary
# ---------------------------------------------------------------------------


def test_quant_rows_is_the_references_bit_for_bit(runs):
    """Values and scales of `quant_rows` equal `_quant_rows`' bits,
    including an all-zero row and ties at half a level (half to even)."""
    data, ref, _ = runs
    q, s = sharding.quant_rows(torch.from_numpy(data["quant"]))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), ref["quant"][0])
    np.testing.assert_array_equal(s.numpy(), ref["quant"][1])
    assert q[2, :6].tolist() == [127, 0, 2, 2, 0, -2]


def _hold_quantized(got, want, step, what):
    """Within one quantization step of the row (`step`, broadcast); an
    element further apart than fp32's rounding of the dequantized terms
    (the reference's XLA sum of q0 s0 + q1 s1 may fuse a multiply-add,
    within a few ulps of 127 * step) is a level flip, at most 1% of
    them."""
    d = np.abs(got - want)
    assert np.all(d <= step * (1 + 1e-6)), (what, float(d.max()))
    flips = float(np.mean(d > 4 * np.finfo(np.float32).eps * 127 * step))
    print(f"\n{what}: {flips:.4f} of the elements one level apart, "
          f"{float(np.mean(d > 0)):.4f} apart at all")
    assert flips <= 0.01, (what, flips)


@pytest.mark.parametrize("name", ["q_gather", "q_scatter"])
def test_int8_collectives_and_backward_match_the_reference(runs, name):
    """`sp_gather` / `sp_scatter` with sp_comm="int8" at tp = 2: each
    rank's value and the backward of a random cotangent (the quantized
    scatter and gather) against the reference's custom_vjp."""
    data, ref, port = runs
    x, ct = data[name]

    def steps(a, blocks):
        # a (2 ranks, rows, d): each source row's quantization step,
        # summed over the blocks a scatter adds
        s = np.abs(a).max(-1, keepdims=True) / 127.0
        if not blocks:
            return np.concatenate(list(s), 0)
        n = a.shape[1] // 2
        return np.stack([s[0, j * n:(j + 1) * n] + s[1, j * n:(j + 1) * n]
                         for j in range(2)])
    gather = name == "q_gather"
    y_step = steps(x, not gather)
    g_step = steps(ct, gather)
    for r in range(2):
        y, g = port["lo"][r]["units"][name]
        _hold_quantized(y, ref[name][0][r],
                        y_step if gather else y_step[r], f"{name} {r}")
        _hold_quantized(g, ref[name][1][r],
                        g_step[r] if gather else g_step, f"{name} vjp {r}")


def _grad_misses(got, want, specs, env):
    """The gradient leaves past the int8 bars: each leaf within 1e-2 of
    its largest value in its L2 norm and 2e-2 in every element.  The
    int8 step's gradients are that sensitive to fp32 rounding: where the
    two forwards round an activation to the other side of a level
    boundary, it moves a level (1/127 of its row) and the gradients it
    feeds move with it; a 1e-6 relative change of the parameters moves
    the port's own int8 gradients by up to 1.09e-2 of a leaf's largest
    value and 1.23e-2 of its L2 norm, and native SP boundaries move them
    by 0.71-1.93e-2 and 0.99-2.19e-2 (scripts/torch_int8_sensitivity.py,
    on other data)."""
    misses = []
    for k, g in want.items():
        w = sharding.shard(g, specs[k], env)
        d = got[k] - w
        elem = np.abs(d).max() / max(np.abs(g).max(), 1e-30)
        l2 = np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30)
        if elem > 2e-2 or l2 > 1e-2:
            misses.append((k, float(elem), float(l2)))
    return misses


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_int8_train_step_matches_the_reference(runs, mesh):
    """The int8-SP train step at step 1 (router warmup active): loss and
    grad norm 1e-4 relative, each rank's reduced gradient shards within
    `_grad_misses`' bars (1e-2 of the leaf's L2 norm, 2e-2 of its largest
    element).  The control: the port's gradients with native SP
    boundaries miss those bars against the reference's int8 ones.  The
    SP boundaries moved int8 rows: the SP all-gathers carry d + 4 bytes
    a row (d int8 values, the fp32 scale) where native's carry 4 d, and
    no reduce-scatter runs at (1, 2)."""
    _, ref, port = runs
    want = ref[("train",) + mesh]
    ranks = port["all"] if mesh == (2, 2) else port["lo"]
    specs = dict(_named(TM.param_specs(_cfg(), _env(*mesh, 0), S)))
    for r, rank in enumerate(ranks):
        got, native = rank["train"]["int8"], rank["train"]["native"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        assert set(got["grads"]) == set(want["grads"])
        env = _env(*mesh, r)
        assert _grad_misses(got["grads"], want["grads"], specs, env) == [], \
            (mesh, r)
        missed = _grad_misses(native["grads"], want["grads"], specs, env)
        print(f"\n{mesh} rank {r}: native SP misses the int8 bars on "
              f"{len(missed)} of {len(want['grads'])} leaves {missed}")
        assert missed, (mesh, r)
    i8, nat = (ranks[0]["train"][c]["stats"] for c in ("int8", "native"))
    print(f"\n{mesh} collectives: int8 {i8}\nnative {nat}")
    d = _cfg().d_model
    if mesh == (1, 2):
        assert i8["all_gather"]["calls"] == nat["all_gather"]["calls"] > 0
        assert (i8["all_gather"]["bytes"] * 4 * d
                == nat["all_gather"]["bytes"] * (d + 4))
        assert "reduce_scatter" not in i8 and \
            nat["reduce_scatter"]["calls"] > 0
    else:               # (2, 2): the FSDP gathers run in both
        saved = nat["all_gather"]["bytes"] - i8["all_gather"]["bytes"]
        assert saved > 0 and saved % (3 * d - 4) == 0


# ---------------------------------------------------------------------------
# the MoE dispatch modes
# ---------------------------------------------------------------------------


def _hold_moe(got, want, what):
    for key in ("y", "gx"):
        big = max(np.abs(want[key]).max(), 1e-30)
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-5 * big, err_msg=f"{what} {key}")
    for k, g in want["gp"].items():
        big = max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(got["gp"][k], g, rtol=0, atol=1e-5 * big,
                                   err_msg=f"{what} grad {k}")
    assert got["frac"] == pytest.approx(want["frac"], abs=0), what


@pytest.mark.parametrize("mode", MODES)
def test_moe_modes_at_tp2_match_the_reference(runs, mode):
    """`moe_ffn(dispatch=mode)` at tp = 2 with capacity factor 1: each
    rank's partial output, its gradients of x and of its MoE shards, and
    the dropped fraction, against the reference's rank."""
    _, ref, port = runs
    want = ref[("moe", 2, mode)]
    for r in range(2):
        got = port["lo"][r]["units"][("moe", mode)]
        w = {"y": want["y"][r], "gx": want["gx"][r],
             "frac": float(want["frac"][r]),
             "gp": {k: v[r] for k, v in _named_np(want["gp"]).items()}}
        _hold_moe(got, w, (mode, r))
    print(f"\n{mode} tp=2 dropped fraction {float(want['frac'][0])}")


def _named_np(tree, prefix=""):
    return dict(_named(tree, prefix))


def test_batched_at_tp1_matches_the_reference(runs):
    """"batched" at one rank (slots past an expert's capacity drop) against
    the reference's."""
    data, ref, _ = runs
    want = ref[("moe", 1, "batched")]
    got = _moe_call(_moe_cfg(), sharding.LOCAL, data, "batched")
    w = {"y": want["y"][0], "gx": want["gx"][0], "frac": float(want["frac"][0]),
         "gp": {k: v[0] for k, v in _named_np(want["gp"]).items()}}
    _hold_moe(got, w, "batched tp=1")
    assert got["frac"] > 0


def test_auto_dispatch_falls_back_to_batched_on_odd_token_counts():
    """"auto" at tp = 2: "ep" when T divides over tp, else "batched"; an
    explicit "ep" there raises, as the reference's; tp = 1 runs
    "fused" for "auto" and "ep"."""
    cfg = _cfg()
    env = _env(1, 2, 0)
    assert tmoe.resolve_dispatch(cfg, "auto", env, 8) == "ep"
    assert tmoe.resolve_dispatch(cfg, "auto", env, 7) == "batched"
    for mode in MODES:
        assert tmoe.resolve_dispatch(cfg, mode, env, 7) == mode
    with pytest.raises(ValueError, match="divisible"):
        tmoe.resolve_dispatch(cfg, "ep", env, 7)
    assert tmoe.resolve_dispatch(cfg, "auto", sharding.LOCAL, 7) == "fused"
    assert tmoe.resolve_dispatch(cfg, "ep", sharding.LOCAL, 7) == "fused"
    with pytest.raises(ValueError, match="unknown"):
        tmoe.resolve_dispatch(cfg, "dense", env, 8)


# ---------------------------------------------------------------------------
# scoring and the harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_scores_match_the_reference(runs, mesh):
    """`make_score_fn` on 4 x 16 tokens, rows over dp and the vocabulary
    over tp: every rank returns the whole (B,) scores, 1e-5 relative to
    the reference's."""
    _, ref, port = runs
    ranks = port["all"] if mesh == (2, 2) else port["lo"]
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["scores"]["score"],
                                   ref[("score", mesh[0])], rtol=1e-5,
                                   err_msg=f"{mesh} rank {r}")


def test_odd_length_scores_and_the_harness_match_the_reference(runs):
    """At (1, 2): a 1 x 16 item (15 tokens, odd) scores with SP off and the
    "batched" dispatch, as the reference's seq_parallel=False runner; the
    harness's content-perplexity report (items of odd and even length)
    and every score it asked for equal the reference's."""
    _, ref, port = runs
    for r in range(2):
        sc = port["lo"][r]["scores"]
        np.testing.assert_allclose(sc["odd"], ref[("score", "odd")],
                                   rtol=1e-5, err_msg=f"rank {r}")
        assert "batched" in sc["odd_modes"] and "ep" in sc["odd_modes"], \
            sc["odd_modes"]
        rep, calls = sc["harness"]
        want_rep, want_calls = ref["harness"]
        assert rep == want_rep
        np.testing.assert_allclose(calls, want_calls, rtol=1e-5)


# ---------------------------------------------------------------------------
# speculative decoding and the SLO gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drafter,which", [("self", 0), ("self", 1),
                                           ("config", 0)])
def test_spec_streams_on_1x2_match_the_reference(runs, drafter, which):
    """At (1, 2), k = 2: the self-drafter's greedy (0) and sampled (1)
    streams and a ConfigDrafter's (given global weights) greedy ones;
    both ranks' equal the reference's."""
    _, ref, port = runs
    want = ref[drafter][which]
    for r in range(2):
        np.testing.assert_array_equal(port["hi"][r]["spec"][drafter][which],
                                      want, err_msg=f"{drafter} rank {r}")


def test_slo_gate_on_1x2_sheds_rank0s_decisions(runs):
    """Both ranks of the (1, 2) engine shed the rids the port's (1, 1)
    engine sheds on rank 0's clock, though rank 1's clock runs ten times
    faster and its own tracker would decide otherwise."""
    data, _, port = runs
    one, _ = _slo_engine(tmesh.Mesh.local("cpu"), data, SLO_CLOCK)
    (shed0, own0), (shed1, own1) = (port["hi"][r]["slo"] for r in range(2))
    print(f"\nshed (1, 1) {one}; (1, 2) ranks {shed0} {shed1}")
    assert one and len(one) < 12, one
    assert shed0 == one and shed1 == one
    assert own0 != own1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 64])
def test_fused_tp2_rows_on_the_card_match_the_plain_versions(T):
    """"fused" at tp = 2 (rank 0's coordinates; no collective runs at
    train=False): K1 over the rank's capacity rows, the trailing rows of
    the other rank's experts gated 0, and the backward's K2 and weight
    gradient, against the same call on CPU tensors (the plain versions),
    at Ling-Lite's widths with 8 of its experts, bf16: outputs and
    gradients within 2^-7 of their largest (two bf16 roundings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    base = get_config("ling-lite")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=8, n_shared_experts=0))
    env = _env(1, 2, 0)
    gen = torch.Generator().manual_seed(T)
    init = TL.Init(device=torch.device("cpu"), generator=gen, env=env)
    p = tmoe.init_moe(cfg, init)
    x = torch.randn(T, cfg.d_model, generator=gen).to(torch.bfloat16)
    ct = torch.randn(T, cfg.d_model, generator=gen).to(torch.bfloat16)
    out = []
    for dev in ("cuda", "cpu"):
        pd = {k: (v.to(dev).requires_grad_(True) if torch.is_tensor(v) else
                  {k2: v2.to(dev) for k2, v2 in v.items()})
              for k, v in p.items()}
        xd = x.to(dev).requires_grad_(True)
        before = build.LAUNCHES["fused_moe_ffn"]
        y, _ = tmoe.moe_ffn(cfg, pd, xd, dispatch="fused", env=env)
        if dev == "cuda":
            assert build.LAUNCHES["fused_moe_ffn"] == before + 1
        g = torch.autograd.grad(y, [xd, pd["we1"], pd["we2"], pd["we3"]],
                                ct.to(dev))
        out.append([t.float().cpu() for t in (y,) + g])
    for a, b in zip(*out):
        assert (a - b).abs().max() <= 2.0 ** -7 * b.abs().max()
