"""The block families on a (dp, tp) mesh: LayerNorm (nemotron-4-15b),
sliding windows with rolling caches (h2o-danube-1.8b), RG-LRU hybrids
(recurrentgemma-2b, the list layout) and whisper's encoder-decoder with
cross caches, the port against the JAX package on the same mesh, at
smoke configs with fp32 compute, from the same global parameters and
the same numpy-made batches, frames and prompts.

The configs (`CONFIGS`), each a smoke config with its overrides stated:

  * nemotron-4-15b as it is;
  * h2o-danube-1.8b and recurrentgemma-2b with windows of 16 beside a
    32-position context (`SEQ`), so that the rolling caches wrap inside
    the test: 8 slots a rank at tp = 2;
  * whisper-tiny as it is (4 heads of 64);
  * "whisper6": whisper-tiny's smoke config at its published 6 heads of
    64 (d_model 384), whose heads pad 6 -> 8 at tp = 4.

A config whose heads pad at tp = 4 is another function there, so its
global parameters at a mesh are the port's own at that mesh's tp: the
(1, tp) ranks' `init_train_params(0)` put back together along each
leaf's tp dim (`_global`), handed to the reference whole and cut into
each rank's shards by `interop`.  The checks:

  * init: at (2, 1), (1, 2) and (2, 2) (whisper6 also at (1, 4)) every
    rank's `init_params(0)` and `init_train_params(0)` is its slice of
    the global tree, the global shapes are the reference's, and
    `interop` cuts the reference's list-layout tree and the RG-LRU
    leaves into the same shards; every architecture builds a Runner and
    its rank's parameters at (1, 2) and (2, 2);
  * at (2, 2) (DP, FSDP, TP and SP at once, whisper's encoder on SP
    rows of B * S_enc): the reduced gradients (the reference's read back
    from its first AdamW moment), the loss and metrics, two optimizer
    steps' losses and grad norms, and the parameters after them;
  * at (1, 2) (whisper6 at (1, 4)): the greedy dense decode fed token by
    token and after the dense prefill into tp-sharded caches, past the
    windows' wrap: every stream equal to the reference's on every rank;
    whisper's cross caches are filled by its encoder (the prefill's);
  * a recurrentgemma checkpoint (the list layout) saved by a Trainer at
    (2, 1) after a step restores at (1, 2): every rank's params, moments
    and guard state its slice of the saved state, bit for bit;
  * a window that does not divide over tp raises, naming the window and
    tp, before any process group is touched (the reference floors it:
    ROADMAP queue 3, breakage e), and the rolling cache's valid mask on
    a rank is the reference's across the wrap;
  * the reference's own dense caches built by `M.init_caches` have a
    rank's local shapes (ROADMAP queue 3, breakage c): for the list
    layout's RG-LRU state and cross caches the test records what its
    decode step does with them beside the global caches it takes.

The reference runs once for the file, in two subprocesses side by side
(the train steps; serving and the shapes), each with 4 host devices
forced before JAX starts.  The port's ranks are 4 gloo processes on the
CPU, one intra-op thread each, spawned once beside them: (2, 2) on all
four, then two (1, 2) meshes on ranks 0-1 and 2-3, then (1, 4) on all
four, then the checkpoint's (2, 1) and (1, 2) on ranks 0-1, each mesh
over a fresh file store under the test's tmp_path, with a 120 s group
timeout and a join limit.

Tolerances, those of test_torch_mesh_archs: the loss and the metrics
1e-5 relative, each gradient leaf 1e-5 of its largest value, the grad
norms 1e-4 relative, the parameters after two AdamW steps at lr 1e-4
1e-6 absolute for all but 1e-4 of each leaf's elements (rounded up: a
leaf of fewer than 10^4 elements may have one past it, as whisper's
8192-element decoder positions do here, an element whose four ranks'
gradient partials cancel to 2.4e-7 out of ~0.2 each) and 1e-5 for every
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
from repro_torch.configs.base import ARCH_IDS, get_smoke_config
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import prng
from repro_torch.optim import adamw
from repro_torch.optim.schedule import WSDSchedule
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
SB, P, NEW, SEQ = 4, 6, 16, 32          # serving: batch, prompt, new, context
WINDOW = 16

# name -> (arch, overrides)
CONFIGS = {
    "nemotron": ("nemotron-4-15b", {}),
    "danube": ("h2o-danube-1.8b", {"attn_window": WINDOW}),
    "rgemma": ("recurrentgemma-2b", {"attn_window": WINDOW}),
    "whisper": ("whisper-tiny", {}),
    "whisper6": ("whisper-tiny", {"d_model": 384, "n_heads": 6,
                                  "n_kv_heads": 6}),
}
TRAIN = ("nemotron", "danube", "rgemma", "whisper")
# the (1, tp) serving runs: (name, ranks, tp)
SERVE_PARTS = ((("danube", "rgemma"), (0, 1), 2),
               (("nemotron", "whisper"), (2, 3), 2),
               (("whisper6",), (0, 1, 2, 3), 4))
SERVE_TP = {n: tp for names, _, tp in SERVE_PARTS for n in names}
# list-layout configs whose reference caches are built both ways
BOTH_WAYS = ("rgemma", "whisper")
MESHES = ((2, 1), (1, 2), (2, 2))
INIT = [(n, m) for n in CONFIGS for m in MESHES] + [("whisper6", (1, 4))]


def _cfg(name):
    arch, fields = CONFIGS[name]
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **fields)


def _data(name):
    rs = np.random.RandomState(sorted(CONFIGS).index(name))
    cfg = _cfg(name)
    V = cfg.vocab_size
    out = {"tokens": rs.randint(0, V, (B, S)).astype(np.int32),
           "labels": rs.randint(0, V, (B, S)).astype(np.int32),
           "prompts": rs.randint(0, V, (SB, P)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        shape = (cfg.encoder_seq_len, cfg.d_model)
        out["enc_frames"] = rs.randn(B, *shape).astype(np.float32)
        out["frames"] = rs.randn(SB, *shape).astype(np.float32)
    return out


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

    (configs, data, B, S, LR, SB, P, NEW, SEQ, serve_tp,
     both_ways) = pickle.load(open(sys.argv[1], "rb"))
    part, names = sys.argv[3], sys.argv[4].split(",")

    def cfg_of(name):
        arch, fields = configs[name]
        return dataclasses.replace(get_smoke_config(arch),
                                   compute_dtype="float32", **fields)

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
        return {(dp, tp): flat_shapes(api.Runner(
                    cfg, make_local_mesh(dp, tp), max_seq=SEQ).shapes)
                for dp, tp in ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4))}

    def train(name):
        # two steps at (2, 2); the gradients read back from the first
        # moment: m = (1 - b1) * g * clip scale
        cfg, d = cfg_of(name), data[name]
        batch = {k: jnp.asarray(d[k]) for k in ("tokens", "labels",
                                                "enc_frames") if k in d}
        r = api.Runner(cfg, make_local_mesh(2, 2), max_seq=SEQ,
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

    def stream(decode, params, caches, prompts, n):
        tok, out = None, []
        for pos in range(P):
            tok, caches = decode(params, caches,
                                 jnp.asarray(prompts[:, pos]), jnp.int32(pos))
        out.append(np.asarray(tok))
        for pos in range(P, P + n - 1):
            tok, caches = decode(params, caches, tok, jnp.int32(pos))
            out.append(np.asarray(tok))
        return np.stack(out, 1)

    def serve(name):
        # token by token on (1, tp) from zeros at the global cache shapes
        # (`init_cache_shapes`), whisper's cross caches the prefill's
        cfg, d = cfg_of(name), data[name]
        r = api.Runner(cfg, make_local_mesh(1, serve_tp[name]), fsdp=False,
                       seq_parallel=False, max_seq=SEQ)
        params = jax.tree.map(jnp.asarray, d["params"])
        decode, _ = r.make_decode_step(global_batch=SB, seq_len=SEQ)
        decode = jax.jit(decode)
        zeros = lambda: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     r.init_cache_shapes(SB, SEQ)[0])
        caches = zeros()
        if cfg.is_encoder_decoder:
            _, pc = jax.jit(r.make_prefill(SB))(
                params, {"tokens": jnp.asarray(d["prompts"]),
                         "enc_frames": jnp.asarray(d["frames"])})
            for c, p in zip(caches, pc):
                c["cross"] = p["cross"]
        out = {"dense": stream(decode, params, caches, d["prompts"], NEW)}
        if name in both_ways:
            # breakage c for the list layout: the global caches against
            # `M.init_caches`' (a rank's local shapes, as the reference's
            # offline launcher builds them), both zeroed, 3 tokens
            local = M.init_caches(cfg, r.env, SB, SEQ,
                                  cross_len=cfg.encoder_seq_len)
            out["both"] = {
                "global": stream(decode, params, zeros(), d["prompts"], 3),
                "global_shapes": flat_shapes(zeros()),
                "local_shapes": flat_shapes(local)}
            try:
                out["both"]["local"] = stream(decode, params, local,
                                              d["prompts"], 3)
            except Exception as e:  # the shard_map's own refusal
                out["both"]["local"] = f"{type(e).__name__}: {e}"[:300]
        return out

    if part == "train":
        res = {"train": {n: train(n) for n in names}}
    else:      # serving, then every config's shapes (no compile)
        res = {"serve": {n: serve(n) for n in names},
               "shapes": {n: shapes(cfg_of(n)) for n in configs}}
    pickle.dump(res, open(sys.argv[2], "wb"))
""")


def _named(tree, prefix=""):
    """(path, leaf) pairs in `adamw.leaves` order, paths as the reference
    script's `flat` writes them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k],
                                                          f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree)
                for kv in _named(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _np(tree):
    return {k: v.detach().float().numpy() for k, v in _named(tree)}


def _mesh_at(dp, tp, rank):
    return tmesh.Mesh.at(dp, tp, rank, device="cpu")


def _env(dp, tp, rank):
    """An AxisEnv at a rank's coordinates (no process group)."""
    return sharding.make_axis_env(_mesh_at(dp, tp, rank))


def _runner(name, dp, tp, rank):
    return tapi.Runner(_cfg(name), device="cpu", max_seq=SEQ,
                       mesh=_mesh_at(dp, tp, rank))


def _global(name, tp, serving=False):
    """The global parameters at tp's padded shapes ({path: array}): the
    (1, tp) ranks' `init_train_params(0)` (`init_params(0)` when
    `serving`) put back together along each leaf's tp dim."""
    specs = dict(_named(TM.param_specs(_cfg(name), _env(1, tp, 0), SEQ)))
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


def _batch(inp):
    out = {k: torch.from_numpy(inp[k]).long() for k in ("tokens", "labels")}
    if "enc_frames" in inp:
        out["enc_frames"] = torch.from_numpy(inp["enc_frames"])
    return out


def _train_one(name, mesh, inp):
    """One rank's (2, 2) run of a TRAIN config: the loss, metrics and
    gradients of `make_loss_and_grad`, then two train steps."""
    cfg = _cfg(name)
    runner = tapi.Runner(cfg, device="cpu", max_seq=SEQ, mesh=mesh)
    params = interop.params_from_numpy(inp["params"], cfg, device="cpu",
                                       masters=True, env=runner.env)
    batch = _batch(inp)
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
    """One rank's (1, tp) greedy dense streams: token by token from zeroed
    caches (whisper's cross caches the prefill's), and after the dense
    prefill into caches of SEQ positions."""
    cfg = _cfg(name)
    runner = tapi.Runner(cfg, device="cpu", max_seq=SEQ, mesh=mesh)
    params = interop.params_from_numpy(inp["params"], cfg,
                                       device="cpu", env=runner.env)
    prompts = torch.from_numpy(inp["prompts"]).long()
    batch = {"tokens": prompts}
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = torch.from_numpy(inp["frames"])
    decode = runner.make_decode_step()
    first, pre = runner.make_prefill(seq_len=SEQ)(params, batch)
    caches = runner.init_caches(SB, SEQ)
    if cfg.is_encoder_decoder:
        for c, p in zip(caches, pre):
            for k in ("k", "v"):
                c["cross"][k].copy_(p["cross"][k])
    for pos in range(P):
        tok, caches = decode(params, caches, prompts[:, pos], pos)
    dense = [tok]
    for pos in range(P, P + NEW - 1):
        tok, caches = decode(params, caches, tok, pos)
        dense.append(tok)
    tok, prefilled = first, [first]
    for pos in range(P, P + NEW - 1):
        tok, pre = decode(params, pre, tok, pos)
        prefilled.append(tok)
    return {"dense": torch.stack(dense, 1).numpy(),
            "prefilled": torch.stack(prefilled, 1).numpy(),
            "window_rows": sorted({c["self"]["k"].shape[-3] for c in
                                   (caches if isinstance(caches, list)
                                    else [caches]) if "self" in c})}


def _trainer(ck, mesh):
    """recurrentgemma's smoke model (the list layout) on `mesh`,
    checkpointing every step into `ck`."""
    cfg = get_smoke_config("recurrentgemma-2b")
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
    """One rank: (2, 2) training of every TRAIN config on all four, its
    (1, tp) serving shares (`SERVE_PARTS`), then the checkpoint."""
    torch.set_num_threads(1)
    phases = [("all", (2, 2), (0, 1, 2, 3), None)]
    phases += [(f"serve{i}", (1, tp), ranks, names)
               for i, (names, ranks, tp) in enumerate(SERVE_PARTS)]
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
    tmp = tmp_path_factory.mktemp("mesh_families")
    data = {n: dict(_data(n), params=_nest(_global(n, SERVE_TP.get(n, 2))))
            for n in CONFIGS}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((CONFIGS, data, B, S, LR, SB, P, NEW, SEQ, SERVE_TP,
                     BOTH_WAYS), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    parts = [("train", TRAIN), ("serve", tuple(SERVE_TP))]
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
    for i, (names, ranks, _) in enumerate(SERVE_PARTS):
        got = [load(f"serve{i}", r) for r in range(len(ranks))]
        serve.update({n: [rk[n] for rk in got] for n in names})
    ckpt = {store: [load(store, r) for r in range(2)]
            for store in ("ck-save", "ck-load")}
    return ref, train, serve, ckpt


def _specs(name, dp, tp):
    """{leaf path: spec} of a config's parameters at a (dp, tp) mesh."""
    return dict(_named(TM.param_specs(_cfg(name), _env(dp, tp, 0), SEQ)))


@pytest.mark.parametrize("name,mesh", INIT)
def test_init_params_are_slices_of_the_global_parameters(name, mesh):
    """Every rank's `init_params(0)` and `init_train_params(0)` at `mesh`
    equal its slice of the global parameters at the mesh's tp, bit for
    bit (lists of per-layer trees, RG-LRU's channel- and block-sharded
    leaves, LayerNorm's biases, whisper's positions and encoder), and
    `interop.params_from_numpy` cuts the global tree into the same
    shards; where no head pads, the global parameters at tp are the
    (1, 1) runner's."""
    dp, tp = mesh
    specs = _specs(name, dp, tp)
    cfg = _cfg(name)
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
            cut = _np(interop.params_from_numpy(
                _nest(full), cfg, device="cpu", masters=not serving,
                env=env))
            for k, v in full.items():
                want = sharding.shard(v, specs[k], env)
                np.testing.assert_array_equal(
                    got[k], want, err_msg=f"{name} {mesh} rank {r} {k}")
                np.testing.assert_array_equal(
                    cut[k], want, err_msg=f"interop {name} {mesh} {k}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_global_shapes_match_the_reference(runs, name):
    """The global parameter shapes at (1, 1), (2, 1), (1, 2), (2, 2) and
    (1, 4) are the reference's: the list layouts, RG-LRU's leaves,
    whisper6's heads padded 6 -> 8 at tp = 4."""
    ref, _, _, _ = runs
    for (dp, tp), want in ref["shapes"][name].items():
        got = {k: v.shape for k, v in _global(name, tp).items()}
        assert got == want, (name, (dp, tp))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_builds_on_a_mesh(arch):
    """Every architecture of the registry builds a Runner and its rank's
    parameters at (1, 2) and (2, 2) on its smoke config (no process
    group: the ranks' coordinates only)."""
    for dp, tp in ((1, 2), (2, 2)):
        runner = tapi.Runner(get_smoke_config(arch), device="cpu",
                             mesh=_mesh_at(dp, tp, dp * tp - 1))
        leaves = adamw.leaves(runner.init_params(0))
        specs = adamw.leaves(runner.specs)
        assert len(leaves) == len(specs) > 0


def _hold_params(got, ref, what):
    """AdamW's rule: 1e-6 for all but 1e-4 of each leaf's elements (a
    leaf of fewer than 10^4 elements may have one: 1e-4 of them rounds
    up), 1e-5 for all.  AdamW turns a gradient near its eps (1e-8) into
    an update whose size depends on the gradient's last bits, so an
    element whose gradient sums cancel can move ~1e-6 between two fp32
    summation orders after two steps at lr 1e-4."""
    for k, r in ref.items():
        err = np.abs(got[k] - r)
        assert err.max() <= 1e-5, (what, k, float(err.max()))
        assert np.sum(err > 1e-6) <= max(1, 1e-4 * err.size), (
            what, k, int(np.sum(err > 1e-6)))


@pytest.mark.parametrize("name", TRAIN)
def test_gradients_loss_and_metrics_match_the_reference(runs, name):
    """`make_loss_and_grad` at (2, 2), step 1: every rank's reduced
    gradient shards against its slice of the reference's global
    gradients, the loss and the metrics."""
    ref, train, _, _ = runs
    rt = ref["train"][name]
    specs = _specs(name, 2, 2)
    for r, rank in enumerate(train):
        rank = rank[name]
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
def test_two_train_steps_match_the_reference(runs, name):
    """Two optimizer steps at (2, 2): each step's loss and grad norm,
    then every rank's parameter shards."""
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


STREAMS = [(n, s) for n in SERVE_TP for s in ("dense", "prefilled")]


@pytest.mark.parametrize("name,stream", STREAMS)
def test_serving_streams_match_the_reference(runs, name, stream):
    """At (1, 2) (whisper6 at (1, 4)): greedy dense decode token by token
    and after the dense prefill into tp-sharded caches, the windows'
    rolling caches (8 slots a rank) wrapping at position 16: every
    rank's stream equals the reference's."""
    ref, _, serve, _ = runs
    want = ref["serve"][name]["dense"]
    assert want.shape == (SB, NEW)
    for r, got in enumerate(serve[name]):
        np.testing.assert_array_equal(got[stream], want,
                                      err_msg=f"{name} {stream} rank {r}")
        if CONFIGS[name][1].get("attn_window"):
            assert got["window_rows"] == [WINDOW // SERVE_TP[name]]


def test_rgemma_checkpoint_saved_at_2x1_restores_at_1x2(runs):
    """The (2, 1) Trainer's state after a step (per-layer lists: RG-LRU
    and window layers), saved with every rank writing its slices,
    assembled whole from both ranks' shards: each (1, 2) rank restores
    its slice of it, bit for bit."""
    _, _, _, ckpt = runs
    whole = []
    for i, spec in enumerate(ckpt["ck-save"][0][1]):
        parts = [ckpt["ck-save"][r][0][i] for r in range(2)]
        dims = [d for d, part in enumerate(spec) if part == "dp"]
        whole.append(np.concatenate(parts, axis=dims[0]) if dims
                     else parts[0])
    assert any("tp" in spec for spec in ckpt["ck-load"][0][3])
    for r in range(2):
        name, step, leaves, specs = ckpt["ck-load"][r]
        assert (name, step) == ("step_1", 1)
        env = _env(1, 2, r)
        assert len(leaves) == len(whole)
        for i, (got, w) in enumerate(zip(leaves, whole)):
            np.testing.assert_array_equal(
                got, sharding.shard(w, specs[i], env),
                err_msg=f"rank {r} leaf {i}")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-2b"])
def test_a_window_that_does_not_divide_over_tp_raises(arch):
    """A rolling cache whose window does not divide over tp raises at the
    caches, naming the window and tp, before any collective (the ranks'
    coordinates only); the reference floors the rank's share instead
    (ROADMAP queue 3, breakage e)."""
    cfg = dataclasses.replace(get_smoke_config(arch), attn_window=15)
    runner = tapi.Runner(cfg, device="cpu", mesh=_mesh_at(1, 2, 0))
    with pytest.raises(ValueError, match=r"window of 15 .*tp=2"):
        runner.init_caches(2, 32)
    one = tapi.Runner(cfg, device="cpu")
    assert one.init_caches(2, 32) is not None


@pytest.mark.parametrize("tp", [2, 4])
def test_rolling_valid_mask_is_the_reference_rule_across_the_wrap(tp):
    """Each rank's valid slots of a rolling cache of W = s_loc * tp slots
    (`layers.dense_page_view` at offset r * s_loc, the tick's view) are
    the reference's `kpos < min(pos + 1, s_loc * tp)` with kpos = r *
    s_loc + j (`src/repro/models/layers.py` decode_attention), at every
    position up to three wraps, and the slot a tick writes lies on
    exactly one rank (`pos % W`)."""
    s_loc = 8
    W = s_loc * tp
    for pos in range(3 * W):
        owners = 0
        for r in range(tp):
            _, valid = TL.dense_page_view(2, s_loc, pos, "cpu",
                                          offset=r * s_loc)
            kpos = r * s_loc + np.arange(TL.dense_rows(s_loc))
            want = (kpos < min(pos + 1, W)) & (np.arange(kpos.size) < s_loc)
            np.testing.assert_array_equal(valid[0, 0].numpy(), want,
                                          err_msg=f"pos {pos} rank {r}")
            owners += r * s_loc <= pos % W < (r + 1) * s_loc
        assert owners == 1


@pytest.mark.parametrize("name", BOTH_WAYS)
def test_reference_list_caches_built_both_ways(runs, name):
    """Breakage c (ROADMAP queue 3) for the list layout: the reference's
    `M.init_caches(cfg, env, ...)` gives the RG-LRU state a rank's
    dr / tp channels and the cross caches a rank's S_enc / tp positions,
    while its shard_mapped decode step takes the global caches
    (`init_cache_shapes`) and splits them over tp again.  Fed the global
    caches it runs; fed `M.init_caches`' it raises (RG-LRU) or reads a
    cross cache of S_enc / tp^2 positions a rank (whisper's zeroed
    cross caches attend to zeros either way, so its stream is
    unchanged)."""
    ref, _, _, _ = runs
    both = ref["serve"][name]["both"]
    tp = SERVE_TP[name]
    glob, loc = both["global_shapes"], both["local_shapes"]
    assert set(glob) == set(loc)
    halved = {k for k in glob if glob[k] != loc[k]}
    kinds = {k.split("/")[2] for k in halved}
    if name == "rgemma":
        assert kinds == {"rglru", "self"}, halved
        assert all(glob[k][-1] == tp * loc[k][-1]
                   for k in halved if "/rglru/" in k)
        assert isinstance(both["local"], str), both["local"]
    else:
        assert kinds == {"self", "cross"}, halved
        assert all(glob[k][1] == tp * loc[k][1] for k in halved)
        np.testing.assert_array_equal(both["local"], both["global"])
