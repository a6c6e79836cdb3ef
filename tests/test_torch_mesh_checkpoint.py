"""Checkpoints of a sharded run, mesh-free on disk: the port's Trainer on
a (2, 2) mesh of 4 gloo ranks (Ling-Lite's smoke config, the router
warmup active) saves at step 2 with every rank writing the slices it
holds of each whole leaf (`PCache.save_sharded`), and

  * the files hold the gathered state (every rank's shards at step 2,
    assembled) bit for bit, and the JAX package's `PCache.load` reads
    them as the same arrays;
  * a fresh (2, 2) Trainer restores "latest" (rank 0's newest, agreed
    across ranks) and its step equals the unbroken run's bit for bit
    (loss, grad norm, every rank's shards);
  * (1, 2) and (2, 1) Trainers restore the checkpoint, and so does a
    (1, 1) one: each rank's params, moments and guard state equal its
    slice of the files bit for bit;
  * a checkpoint the JAX package's `PCache.save` wrote at one device
    (whole leaves) loads onto the (2, 2) ranks' shards bit for bit;
  * the writer plan: one writer per distinct slice, every byte written
    once, the replicated leaves' writers spread over the ranks.

The ranks are spawned once: (2, 2) on all four, then (1, 2) on ranks 0-1
beside (2, 1) on ranks 2-3, each mesh over a fresh file store under the
test's tmp_path, with a 120 s group timeout and a join limit.

Tolerances: none.  Every restored value is held bit for bit, and the
resumed step to the unbroken one's bits (the CPU step is
deterministic)."""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.checkpoint import pcache as JPC
from repro_torch import api as tapi
from repro_torch import sharding
from repro_torch.checkpoint import pcache as PC
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch import mesh as tmesh
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


TIMEOUT_S = 120.0
STEPS, EVERY = 3, 2
NAME = f"step_{EVERY}"


def _trainer(ck, mesh=None, steps=STEPS, every=EVERY):
    cfg = get_smoke_config("ling-lite")
    runner = tapi.Runner(cfg, device="cpu", mesh=mesh)
    return Trainer(runner,
                   DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                               seq_len=16, batch_size=4)),
                   TrainConfig(n_steps=steps,
                               lr_schedule=WSDSchedule(max_lr=1e-3,
                                                       warmup_steps=2,
                                                       total_steps=100),
                               log_every=1, seed=0, checkpoint_dir=str(ck),
                               checkpoint_every=every))


def _leaves(tr):
    return [t.detach().clone().numpy()
            for t in adamw.leaves(tr._state_tree())]


def _hist(tr):
    return [(r["step"], r["loss"], r["grad_norm"]) for r in tr.history]


def _run_all(mesh, ck, jck):
    """(2, 2): the unbroken run A (saving at step 2), the JAX-written
    checkpoint's slices, and a fresh Trainer B resumed from "latest"."""
    out = {}
    a = _trainer(ck, mesh)
    try:
        a.train(EVERY)
        out["at_save"] = _leaves(a)
        a.train()
    finally:
        a.close()
    out["a_hist"], out["a_final"] = _hist(a), _leaves(a)
    out["specs"] = [tuple(s) for s in adamw.leaves(a._state_specs())]
    out["plan"] = PC.shard_writers(
        out["specs"], [x.nbytes for x in out["at_save"]], a.runner.env)
    jx = PC.PCache(str(jck)).load_sharded("jax", a._state_tree(),
                                          a._state_specs(), a.runner.env)
    out["jax_slices"] = [t.numpy() for t in adamw.leaves(jx)]
    b = _trainer(ck, mesh)
    try:
        out["b_restored"] = b.restore("latest")
        out["b_at_restore"] = _leaves(b)
        b.train()
    finally:
        b.close()
    out["b_hist"], out["b_final"] = _hist(b), _leaves(b)
    return out


def _run_restore(mesh, ck, jck):
    """Another mesh restores the (2, 2) checkpoint."""
    tr = _trainer(ck, mesh)
    try:
        name = tr.restore(NAME)
    finally:
        tr.close()
    return {"name": name, "step": tr.step, "leaves": _leaves(tr),
            "specs": [tuple(s) for s in adamw.leaves(tr._state_specs())]}


PHASES = (("all", (2, 2), "_run_all", (0, 1, 2, 3)),
          ("lo", (1, 2), "_run_restore", (0, 1)),
          ("hi", (2, 1), "_run_restore", (2, 3)))


def _worker(rank: int, tmp: str):
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
        out = globals()[name](mesh, os.path.join(tmp, "ck"),
                              os.path.join(tmp, "jck"))
        with open(os.path.join(tmp, f"{store}_{r}.pkl"), "wb") as f:
            pickle.dump(out, f)
        torch.distributed.destroy_process_group()


def _jax_tree(tmp):
    """A one-device state tree as the JAX package saves it: the (1, 1)
    Trainer's, the moments and guard filled from numpy seed 1."""
    tr = _trainer(tmp / "unused")
    tr.close()
    rs = np.random.RandomState(1)
    tree = {k: [np.array(t.detach().numpy()) for t in adamw.leaves(v)]
            for k, v in tr._state_tree().items()}
    for k in ("opt", "guard"):
        tree[k] = [np.asarray(rs.randn(*a.shape), a.dtype)
                   if a.dtype.kind == "f" else a for a in tree[k]]
    like = tr._state_tree()
    return {k: PC.tree_unflatten(like[k], tree[k]) for k in like}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    jtree = _jax_tree(tmp)
    JPC.PCache(str(tmp / "jck")).save(
        "jax", {k: _map(jnp.asarray, v) for k, v in jtree.items()})
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S * 4)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]

    def load(store, r):
        with open(tmp / f"{store}_{r}.pkl", "rb") as f:
            return pickle.load(f)
    return {"tmp": tmp, "jtree": jtree,
            "all": [load("all", r) for r in range(4)],
            "lo": [load("lo", r) for r in range(2)],
            "hi": [load("hi", r) for r in range(2)]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _env(dp, tp, rank):
    return sharding.make_axis_env(tmesh.Mesh.at(dp, tp, rank, device="cpu"))


def _files(tmp):
    """The checkpoint's leaves as whole arrays, read by numpy."""
    path = tmp / "ck" / NAME
    m = PC.PCache(str(tmp / "ck")).manifest(NAME)
    return [np.load(path / e["file"]) for e in m["leaves"]]


def _hold_slices(ranks, files, mesh, what):
    for r, rank in enumerate(ranks):
        env = _env(*mesh, r)
        assert len(rank["leaves"]) == len(files)
        for i, (got, whole, spec) in enumerate(zip(rank["leaves"], files,
                                                   rank["specs"])):
            np.testing.assert_array_equal(
                got, sharding.shard(whole, spec, env),
                err_msg=f"{what} rank {r} leaf {i}")


def test_files_hold_the_gathered_state(runs):
    """Each whole leaf file equals the (2, 2) ranks' shards at step 2
    assembled, bit for bit; the manifest is the reference's layout."""
    files = _files(runs["tmp"])
    ranks = runs["all"]
    specs = ranks[0]["specs"]
    for i, whole in enumerate(files):
        assert whole.shape == PC.global_shape(
            specs[i], ranks[0]["at_save"][i].shape, _env(2, 2, 0))
        for r, rank in enumerate(ranks):
            idx = PC.slice_index(specs[i], rank["at_save"][i].shape,
                                 _env(2, 2, r))
            np.testing.assert_array_equal(whole[idx], rank["at_save"][i],
                                          err_msg=f"leaf {i} rank {r}")
    path = runs["tmp"] / "ck" / NAME
    assert {f".done_{r}" for r in range(4)} <= set(os.listdir(path))
    assert (path / "host_state.pkl").exists()


def test_the_references_pcache_load_reads_a_mesh_checkpoint(runs):
    """The JAX package's `PCache.load` reads the (2, 2) run's checkpoint as
    the whole leaves, bit for bit."""
    files = _files(runs["tmp"])
    like = [np.zeros_like(a) for a in files]
    got = JPC.PCache(str(runs["tmp"] / "ck")).load(NAME, like)
    assert len(got) == len(files)
    for a, b in zip(got, files):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_resumed_2x2_step_equals_the_unbroken_run(runs):
    """A fresh (2, 2) Trainer restores "latest" (step 2): its state equals
    the state A saved, and its step 2 and final state equal A's bits on
    every rank."""
    for r, rank in enumerate(runs["all"]):
        assert rank["b_restored"] == NAME
        for got, want in zip(rank["b_at_restore"], rank["at_save"]):
            np.testing.assert_array_equal(got, want)
        assert rank["b_hist"] == rank["a_hist"][EVERY:], r
        for got, want in zip(rank["b_final"], rank["a_final"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("part,mesh", [("lo", (1, 2)), ("hi", (2, 1))])
def test_restore_at_another_mesh_is_the_files_slice(runs, part, mesh):
    """(1, 2) and (2, 1) Trainers restore the (2, 2) checkpoint: each
    rank's params, moments and guard state equal its slice of the
    files."""
    ranks = runs[part]
    assert all(r["name"] == NAME and r["step"] == EVERY for r in ranks)
    _hold_slices(ranks, _files(runs["tmp"]), mesh, mesh)


def test_restore_at_one_rank_is_the_files(runs):
    """A (1, 1) Trainer restores the (2, 2) checkpoint whole."""
    tr = _trainer(runs["tmp"] / "ck")
    try:
        tr.restore(NAME)
    finally:
        tr.close()
    for got, want in zip(_leaves(tr), _files(runs["tmp"])):
        np.testing.assert_array_equal(got, want)
    assert tr.step == EVERY


def test_a_jax_one_device_checkpoint_loads_onto_2x2_shards(runs):
    """`PCache.load_sharded` reads the JAX package's one-device checkpoint
    into each (2, 2) rank's shards, bit for bit."""
    whole = [np.asarray(a) for k in sorted(runs["jtree"])
             for a in adamw.leaves(runs["jtree"][k])]
    for r, rank in enumerate(runs["all"]):
        env = _env(2, 2, r)
        for i, (got, w) in enumerate(zip(rank["jax_slices"], whole)):
            np.testing.assert_array_equal(
                got, sharding.shard(w, rank["specs"][i], env),
                err_msg=f"rank {r} leaf {i}")


def test_writer_plan_writes_each_slice_once_and_disperses(runs):
    """One writer per distinct slice of a leaf (every rank for a leaf
    sharded over both axes, one for a replicated leaf) and the replicated
    leaves' writers spread over all four ranks."""
    rank = runs["all"][0]
    env = _env(2, 2, 0)
    replicated = []
    for spec, writers in zip(rank["specs"], rank["plan"]):
        n_slices = 4 // sharding.replication(spec, env)
        assert len(writers) == n_slices == len(set(writers)), (spec, writers)
        if n_slices == 1:
            replicated.extend(writers)
    assert set(replicated) == {0, 1, 2, 3}
