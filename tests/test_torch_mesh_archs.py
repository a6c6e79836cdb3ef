"""The other architectures on a (dp, tp) mesh: the port against the JAX
package on the same mesh, at smoke configs with fp32 compute, from the
same global parameters and the same numpy-made batches and prompts.

The configs (`CONFIGS`), each a smoke config with its overrides stated:

  * ling-plus, phi3-mini-3.8b and chameleon-34b as they are;
  * deepseek-moe-16b with its 2 shared experts (the smoke config has 1);
  * granite-moe-3b-a800m (no shared expert) with a vocabulary of 515, so
    that it pads: 640 rows at tp = 1, 768 at tp = 2;
  * "padded": Ling-Lite's smoke config with 5 query heads over 2 kv heads
    (uneven at tp = 1: the last kv head reads three) of head_dim 64 and 5
    experts, so that at tp = 2 a sixth head and a sixth (dummy) expert
    are padded in;
  * rwkv6-3b at d_model 320: 5 heads of 64, padded to 6 at tp = 2;
  * moonshot-v1-16b-a3b, whose smoke config differs from deepseek's only
    in its arch_id, is held at init only (a train step would repeat
    deepseek's checks).

A padded config at tp = 2 is another function with other global shapes
than at tp = 1 (padded heads and experts are drawn, not zeros), so the
global parameters of a tp = 2 mesh are the port's own, drawn at that
mesh's padded shapes: the (1, 2) ranks' `init_train_params(0)` put back
together along each leaf's tp dim (`_global`), handed to the reference
whole and cut into each rank's shards by `interop`.  The checks:

  * init: at (2, 1), (1, 2) and (2, 2) every rank's `init_params(0)` and
    `init_train_params(0)` is its slice of the global tree at the mesh's
    tp (the (1, 1) runner's at tp = 1, and at tp = 2 too where nothing
    pads), and the global shapes are the reference's at every mesh;
  * at (2, 2) (DP, FSDP, TP, SP and the "ep" MoE dispatch at once, the
    router warmup active): the reduced gradients (the reference's read
    back from its first AdamW moment), the loss and metrics, two
    optimizer steps' losses and grad norms, and the parameters after
    them;
  * at (1, 2): the greedy dense decode fed token by token and after the
    dense prefill into tp-sharded caches, and, for the attention
    configs, the paged OnlineEngine (page 8) greedy and sampled: every
    stream equal to the reference's on both ranks;
  * a mesh checkpoint of granite's smoke model (as it is: vocabulary
    512, so that both meshes have the same global shapes), saved by a
    Trainer at (2, 1) after a step, restores at (1, 2): every rank's
    params, moments and guard state its slice of the saved state, bit
    for bit.

The reference runs once for the file, in subprocesses with 4 host
devices forced before JAX starts, side by side: two for the train step
(each several configs) and one for serving and the shapes.  The
port's ranks are 4 gloo processes on the CPU, spawned once beside them:
(2, 2) on all four, then two (1, 2) meshes on ranks 0-1 and 2-3, then
the checkpoint's (2, 1) and (1, 2) on ranks 0-1, each mesh over a fresh
file store under the test's tmp_path, with a 120 s group timeout and a
join limit.

Tolerances, those of test_torch_mesh_parity (the port's tp = 1 tests
against the reference with fp32 compute): the loss and the metrics 1e-5
relative, each gradient leaf 1e-5 of its largest value, the grad norms
1e-4 relative, the parameters after two AdamW steps at lr 1e-4 1e-6
absolute for all but 1e-4 of each leaf's elements and 1e-5 for every
element.  Token streams must be identical."""
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
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.models import prng
from repro_torch.optim import adamw
from repro_torch.optim.schedule import WSDSchedule
from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                        OnlineRequest)
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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120.0
B, S, LR = 4, 16, 1e-4                  # training batch
SB, P, NEW, SEQ = 4, 6, 5, 32           # serving: slots, prompt, new, context
ENGINE = dict(max_slots=SB, max_context=SEQ, page_size=8, prefill_chunk=4)
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=16)

# name -> (arch, top-level overrides, MoE overrides)
CONFIGS = {
    "ling-plus": ("ling-plus", {}, {}),
    "deepseek": ("deepseek-moe-16b", {}, {"n_shared_experts": 2}),
    "granite": ("granite-moe-3b-a800m", {"vocab_size": 515}, {}),
    "phi3": ("phi3-mini-3.8b", {}, {}),
    "chameleon": ("chameleon-34b", {}, {}),
    "padded": ("ling-lite", {"n_heads": 5, "n_kv_heads": 2, "head_dim": 64},
               {"n_experts": 5}),
    "rwkv6": ("rwkv6-3b", {"d_model": 320}, {}),
    "moonshot": ("moonshot-v1-16b-a3b", {}, {}),
}
TRAIN = ("ling-plus", "deepseek", "granite", "phi3", "chameleon", "padded",
         "rwkv6")
# the reference's train subprocesses, each a share of TRAIN
TRAIN_PARTS = (("ling-plus", "deepseek", "granite", "phi3"),
               ("chameleon", "padded", "rwkv6"))
# the (1, 2) serving runs: (ranks, configs)
SERVE_PARTS = (((0, 1), ("granite", "padded")), ((2, 3), ("phi3", "rwkv6")))
SERVE = ("granite", "phi3", "padded", "rwkv6")
RECURRENT = ("rwkv6",)
MESHES = ((2, 1), (1, 2), (2, 2))


def _cfg(name):
    arch, fields, moe = CONFIGS[name]
    cfg = get_smoke_config(arch)
    if moe:
        fields = dict(fields, moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, compute_dtype="float32", **fields)


def _data(name):
    rs = np.random.RandomState(sorted(CONFIGS).index(name))
    V = _cfg(name).vocab_size
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

    (configs, data, B, S, LR, SB, P, NEW, SEQ, ENGINE, SAMPLED,
     recurrent) = pickle.load(open(sys.argv[1], "rb"))
    part, names = sys.argv[3], sys.argv[4].split(",")

    def cfg_of(name):
        arch, fields, moe = configs[name]
        cfg = get_smoke_config(arch)
        if moe:
            fields = dict(fields, moe=dataclasses.replace(cfg.moe, **moe))
        return dataclasses.replace(cfg, compute_dtype="float32", **fields)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k in sorted(tree)
                    for k2, v2 in flat(tree[k], f"{prefix}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, t in enumerate(tree)
                    for k2, v2 in flat(t, f"{prefix}/{i}").items()}
        return {prefix: np.asarray(jax.device_get(tree), np.float32)}

    def flat_shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k in sorted(tree)
                    for k2, v2 in flat_shapes(tree[k],
                                              f"{prefix}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, t in enumerate(tree)
                    for k2, v2 in flat_shapes(t, f"{prefix}/{i}").items()}
        return {prefix: tuple(tree.shape)}

    def shapes(cfg):
        # the global shapes of the parameters at each mesh (no compile)
        return {(dp, tp): flat_shapes(api.Runner(
                    cfg, make_local_mesh(dp, tp), max_seq=S).shapes)
                for dp, tp in ((1, 1), (2, 1), (1, 2), (2, 2))}

    def train(name):
        # two steps at (2, 2); the gradients read back from the first
        # moment: m = (1 - b1) * g * clip scale
        cfg, d = cfg_of(name), data[name]
        batch = {k: jnp.asarray(d[k]) for k in ("tokens", "labels")}
        r = api.Runner(cfg, make_local_mesh(2, 2), max_seq=S,
                       flags=M.RunFlags(remat=False))
        params = jax.tree.map(jnp.asarray, d["params"])
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

    def serve(name):
        # serving on (1, 2), as tests/test_online_serving.py's tp=2 script
        cfg, d = cfg_of(name), data[name]
        r = api.Runner(cfg, make_local_mesh(1, 2), fsdp=False,
                       seq_parallel=False, max_seq=SEQ)
        params = jax.tree.map(jnp.asarray, d["params"])
        prompts = d["prompts"]
        decode, _ = r.make_decode_step(global_batch=SB, seq_len=SEQ)
        decode = jax.jit(decode)
        # zeros at the global cache shapes (rwkv6's wkv state has the
        # mesh's padded heads)
        caches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                              r.init_cache_shapes(SB, SEQ)[0])
        tok, dense = None, []
        for pos in range(P):
            tok, caches = decode(params, caches,
                                 jnp.asarray(prompts[:, pos]), jnp.int32(pos))
        dense.append(np.asarray(tok))
        for pos in range(P, P + NEW - 1):
            tok, caches = decode(params, caches, tok, jnp.int32(pos))
            dense.append(np.asarray(tok))
        out = {"dense": np.stack(dense, 1)}
        if name in recurrent:
            return out
        eng = OnlineEngine(r, params, OnlineConfig(**ENGINE))

        def engine_streams(knobs, base):
            eng.alloc.flush_radix()
            eng.submit_many([OnlineRequest(rid=base + i, prompt=prompts[i],
                                           max_new=NEW, seed=i, **knobs)
                             for i in range(SB)])
            eng.run(max_ticks=500)
            return np.stack([np.asarray(eng.reqs[base + i].out)
                             for i in range(SB)])
        out.update(paged=engine_streams({}, 0),
                   sampled=engine_streams(SAMPLED, SB))
        return out

    if part == "train":
        res = {"train": {n: train(n) for n in names}}
    else:      # serving, then every config's shapes (no compile)
        res = {"serve": {n: serve(n) for n in names},
               "shapes": {n: shapes(cfg_of(n)) for n in configs}}
    pickle.dump(res, open(sys.argv[2], "wb"))
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


def _env(dp, tp, rank):
    """An AxisEnv at a rank's coordinates (no process group): for cutting
    global arrays and drawing a rank's parameters."""
    return sharding.make_axis_env(tmesh.Mesh.at(dp, tp, rank, device="cpu"))


def _runner(name, dp, tp, rank, max_seq=S):
    return tapi.Runner(_cfg(name), device="cpu", max_seq=max_seq,
                       mesh=tmesh.Mesh.at(dp, tp, rank, device="cpu"))


def _global(name, tp, serving=False):
    """The global parameters at tp's padded shapes ({path: array}): the
    (1, tp) ranks' `init_train_params(0)` (`init_params(0)` when
    `serving`) put back together along each leaf's tp dim."""
    specs = dict(_named(TM.param_specs(_cfg(name), _env(1, tp, 0), S)))
    ranks = [_np(_runner(name, 1, tp, r).init_params(0) if serving else
                 _runner(name, 1, tp, r).init_train_params(0))
             for r in range(tp)]
    out = {}
    for k, spec in specs.items():
        dims = [i for i, part in enumerate(spec) if part == "tp"]
        out[k] = (np.concatenate([t[k] for t in ranks], axis=dims[0])
                  if dims else ranks[0][k])
    return out


def _nest(flat):
    """{"/a/b/0/c": v} -> the nested dicts and lists the paths name."""
    root = {}
    for path, v in flat.items():
        keys = path.strip("/").split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _train_one(name, mesh, inp):
    """One rank's (2, 2) run of a TRAIN config: the loss, metrics and
    gradients of `make_loss_and_grad`, then two train steps."""
    cfg = _cfg(name)
    runner = tapi.Runner(cfg, device="cpu", max_seq=S, mesh=mesh)
    params = interop.params_from_numpy(inp["params"], cfg, device="cpu",
                                       masters=True, env=runner.env)
    batch = {k: torch.from_numpy(inp[k]).long() for k in ("tokens", "labels")}
    loss, grads, mets = runner.make_loss_and_grad()(
        params, batch, 1, prng.prng_key(1))
    names = [k for k, _ in _named(params)]
    rec = {"loss": float(loss),
           "metrics": {k: float(v) for k, v in mets.items()},
           "grads": {k: g.numpy() for k, g in zip(names, grads)},
           "steps": []}
    step = runner.make_train_step()
    opt = adamw.init_opt_state(params)
    for i in (1, 2):
        params, opt, _, m = step(params, opt, None, batch, i,
                                 prng.prng_key(i), LR)
        rec["steps"].append({k: float(v) for k, v in m.items()})
    rec["params2"] = _np(params)
    return rec


def _serve_one(name, mesh, inp):
    cfg = _cfg(name)
    runner = tapi.Runner(cfg, device="cpu", max_seq=SEQ, mesh=mesh)
    params = interop.params_from_numpy(inp["params"], cfg,
                                       device="cpu", env=runner.env)
    prompts = torch.from_numpy(inp["prompts"]).long()
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
    out = {"dense": torch.stack(dense, 1).numpy(),
           "prefilled": torch.stack(prefilled, 1).numpy()}
    if name in RECURRENT:
        return out
    eng = OnlineEngine(runner, params, OnlineConfig(**ENGINE))

    def engine_streams(knobs, base):
        eng.alloc.flush_radix()
        eng.submit_many([OnlineRequest(rid=base + i,
                                       prompt=inp["prompts"][i],
                                       max_new=NEW, seed=i, **knobs)
                         for i in range(SB)])
        eng.run(max_ticks=500)
        return np.stack([np.asarray(eng.reqs[base + i].out)
                         for i in range(SB)])

    out.update(paged=engine_streams({}, 0),
               sampled=engine_streams(SAMPLED, SB))
    return out


def _trainer(ck, mesh):
    """granite's smoke model on `mesh`, checkpointing every step into
    `ck`."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    runner = tapi.Runner(cfg, device="cpu", mesh=mesh)
    return Trainer(runner,
                   DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                               seq_len=16, batch_size=4)),
                   TrainConfig(n_steps=1,
                               lr_schedule=WSDSchedule(max_lr=1e-3,
                                                       warmup_steps=2,
                                                       total_steps=100),
                               log_every=1, seed=0, checkpoint_dir=ck,
                               checkpoint_every=1))


def _state(tr):
    """(the state's leaves, their specs) in `adamw.leaves` order."""
    return ([t.detach().clone().numpy()
             for t in adamw.leaves(tr._state_tree())],
            [tuple(s) for s in adamw.leaves(tr._state_specs())])


def _ckpt_save(mesh, ck):
    tr = _trainer(ck, mesh)
    try:
        tr.train(1)
    finally:
        tr.close()
    return _state(tr)


def _ckpt_load(mesh, ck):
    tr = _trainer(ck, mesh)
    try:
        name = tr.restore("latest")
    finally:
        tr.close()
    return (name, tr.step) + _state(tr)


def _worker(rank: int, tmp: str, data):
    """One rank: (2, 2) training of every TRAIN config on all four, then
    its (1, 2) serving share (`SERVE_PARTS`)."""
    torch.set_num_threads(1)
    phases = [("all", (2, 2), (0, 1, 2, 3), None)]
    phases += [(f"serve{i}", (1, 2), ranks, names)
               for i, (ranks, names) in enumerate(SERVE_PARTS)]
    phases += [("ck-save", (2, 1), (0, 1), _ckpt_save),
               ("ck-load", (1, 2), (0, 1), _ckpt_load)]
    for store, (dp, tp), ranks, names in phases:
        if rank not in ranks:
            continue
        r = ranks.index(rank)
        tmesh.init_distributed(r, dp * tp,
                               init_method=f"file://{tmp}/store-{store}",
                               backend="gloo", timeout_s=TIMEOUT_S)
        mesh = tmesh.make_local_mesh(dp, tp, device="cpu",
                                     timeout_s=TIMEOUT_S)
        if names is None:
            out = {n: _train_one(n, mesh, data[n]) for n in TRAIN}
        elif callable(names):
            out = names(mesh, os.path.join(tmp, "ck"))
        else:
            out = {n: _serve_one(n, mesh, data[n]) for n in names}
        with open(os.path.join(tmp, f"{store}_{r}.pkl"), "wb") as f:
            pickle.dump(out, f)
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_archs")
    # every SERVE config is a TRAIN config: one global tree each, at
    # tp = 2's padded shapes
    data = {n: dict(_data(n), params=_nest(_global(n, 2))) for n in TRAIN}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((CONFIGS, data, B, S, LR, SB, P, NEW, SEQ, ENGINE,
                     SAMPLED, RECURRENT), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    parts = ([("train", names) for names in TRAIN_PARTS]
             + [("serve", SERVE)])
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / f"ref-{i}.pkl"), part, ",".join(names)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (part, names) in enumerate(parts)]
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
    ref = {"train": {}, "serve": {}, "shapes": {}}
    for i, ((part, names), proc) in enumerate(zip(parts, refs)):
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, (part, names, log[-3000:])
        with open(tmp / f"ref-{i}.pkl", "rb") as f:
            for k, v in pickle.load(f).items():
                ref[k].update(v)
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]

    def load(store, r):
        with open(tmp / f"{store}_{r}.pkl", "rb") as f:
            return pickle.load(f)
    train = [load("all", r) for r in range(4)]
    serve = {}
    for i, (_, names) in enumerate(SERVE_PARTS):
        ranks = [load(f"serve{i}", r) for r in range(2)]
        serve.update({n: [rk[n] for rk in ranks] for n in names})
    ckpt = {store: [load(store, r) for r in range(2)]
            for store in ("ck-save", "ck-load")}
    return ref, train, serve, ckpt


def _specs(name, dp, tp):
    """{leaf path: spec} of a config's parameters at a (dp, tp) mesh."""
    return dict(_named(TM.param_specs(_cfg(name), _env(dp, tp, 0), S)))


def _hold_params(got, ref, what):
    """AdamW's rule: 1e-6 for all but 1e-4 of each leaf, 1e-5 for all."""
    for k, r in ref.items():
        err = np.abs(got[k] - r)
        assert err.max() <= 1e-5, (what, k, float(err.max()))
        assert np.mean(err > 1e-6) <= 1e-4, (what, k, float(np.mean(
            err > 1e-6)))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_params_are_slices_of_the_global_parameters(name, mesh):
    """Every rank's `init_params(0)` and `init_train_params(0)` at `mesh`
    equal its slice of the global parameters at the mesh's tp, bit for
    bit; where no head, expert or vocabulary row pads, the global
    parameters at tp = 2 are the (1, 1) runner's."""
    dp, tp = mesh
    specs = _specs(name, dp, tp)
    for serving in (False, True):
        full = _global(name, tp, serving)
        one = _global(name, 1, serving)
        if all(full[k].shape == one[k].shape for k in one):
            for k, v in one.items():
                np.testing.assert_array_equal(full[k], v, err_msg=k)
        for r in range(dp * tp):
            runner = _runner(name, dp, tp, r)
            got = _np(runner.init_params(0) if serving
                      else runner.init_train_params(0))
            assert set(got) == set(full)
            env = _env(dp, tp, r)
            for k, v in full.items():
                np.testing.assert_array_equal(
                    got[k], sharding.shard(v, specs[k], env),
                    err_msg=f"{name} {mesh} rank {r} {k}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_global_shapes_match_the_reference(runs, name):
    """The global parameter shapes at (1, 1), (2, 1), (1, 2) and (2, 2)
    are the reference's: padded query heads' wq columns and wo rows,
    padded experts, padded rwkv heads and vocabulary rows drawn."""
    ref, _, _, _ = runs
    for (dp, tp), want in ref["shapes"][name].items():
        got = {k: v.shape for k, v in _global(name, tp).items()}
        assert got == want, (name, (dp, tp))


def _hold_grads(name, rank, r, rt):
    specs = _specs(name, 2, 2)
    env = _env(2, 2, r)
    np.testing.assert_allclose(rank["loss"], rt["loss"], rtol=1e-5)
    assert set(rank["metrics"]) == set(rt["metrics"])
    for k, v in rt["metrics"].items():
        np.testing.assert_allclose(rank["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=f"{name} {k}")
    assert set(rank["grads"]) == set(rt["grads"])
    for k, g in rt["grads"].items():
        np.testing.assert_allclose(
            rank["grads"][k], sharding.shard(g, specs[k], env), rtol=0,
            atol=1e-5 * max(np.abs(g).max(), 1e-30),
            err_msg=f"{name} rank {r} grad {k}")


@pytest.mark.parametrize("name", TRAIN)
def test_gradients_loss_and_metrics_match_the_reference(runs, name):
    """`make_loss_and_grad` at (2, 2), step 1 (router warmup active):
    every rank's reduced gradient shards against its slice of the
    reference's global gradients, the loss and the metrics."""
    ref, train, _, _ = runs
    for r, rank in enumerate(train):
        _hold_grads(name, rank[name], r, ref["train"][name])


@pytest.mark.parametrize("name", TRAIN)
def test_two_train_steps_match_the_reference(runs, name):
    """Two optimizer steps at (2, 2) (router warmup active): each step's
    loss and grad norm, then every rank's parameter shards."""
    ref, train, _, _ = runs
    rt = ref["train"][name]
    specs = _specs(name, 2, 2)
    for r, rank in enumerate(train):
        for got, want in zip(rank[name]["steps"], rt["steps"]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-4)
        env = _env(2, 2, r)
        _hold_params(rank[name]["params2"],
                     {k: sharding.shard(v, specs[k], env)
                      for k, v in rt["params2"].items()}, (name, r))


STREAMS = [(n, s) for n in SERVE
           for s in (("dense", "prefilled") if n in RECURRENT else
                     ("dense", "prefilled", "paged", "sampled"))]


@pytest.mark.parametrize("name,stream", STREAMS)
def test_serving_streams_on_1x2_match_the_reference(runs, name, stream):
    """At (1, 2): greedy dense decode (token by token, and after the dense
    prefill into tp-sharded caches or state), and for the attention
    configs the paged OnlineEngine (each rank 4 of a page's 8 offsets)
    greedy and sampled: both ranks' streams equal the reference's."""
    ref, _, serve, _ = runs
    want = ref["serve"][name]["dense" if stream == "prefilled" else stream]
    for r in range(2):
        np.testing.assert_array_equal(serve[name][r][stream], want,
                                      err_msg=f"{name} {stream} rank {r}")


def test_granite_checkpoint_saved_at_2x1_restores_at_1x2(runs):
    """The (2, 1) Trainer's state after a step, saved with every rank
    writing its slices, assembled whole from both ranks' shards: each
    (1, 2) rank restores its slice of it, bit for bit."""
    _, _, _, ckpt = runs
    whole = []
    for i, spec in enumerate(ckpt["ck-save"][0][1]):
        parts = [ckpt["ck-save"][r][0][i] for r in range(2)]
        dims = [d for d, part in enumerate(spec) if part == "dp"]
        whole.append(np.concatenate(parts, axis=dims[0]) if dims
                     else parts[0])
    for r in range(2):
        name, step, leaves, specs = ckpt["ck-load"][r]
        assert (name, step) == ("step_1", 1)
        env = _env(1, 2, r)
        assert len(leaves) == len(whole)
        for i, (got, w) in enumerate(zip(leaves, whole)):
            np.testing.assert_array_equal(
                got, sharding.shard(w, specs[i], env),
                err_msg=f"rank {r} leaf {i}")
