"""The port's mesh collectives (`repro_torch.sharding.AxisEnv`, the EP
exchange `kernels.ops.ep_all_to_all`) against the same functions under
the reference's `shard_map` at 2 ranks: each method's value and its
backward (the vjp of a random cotangent), on a (1, 2) mesh for the tp
roles and a (2, 1) mesh for the dp roles.

The reference runs once for the file, in a subprocess with 4 host
devices forced before JAX starts.  The port's ranks are 2 gloo processes
on the CPU (`torch.multiprocessing` spawn, a file store under the test's
tmp_path, a 60 s group timeout and a join limit, so a hung rank fails
the test in its own time).  Also: at one rank every method is an
identity that builds no process group, the host-staging table of a
gloo group on a card, and the card exchange's assembly of each op's
result from the members' pieces (`launch.mesh.CardExchange`; the pieces
come from gloo on the CPU here).

Tolerance: none for the collectives.  Each moves, adds or averages two
fp32 values (or casts to bf16 and adds two), which both packages round
alike, so values and gradients are held bit for bit.  The vocab-sharded
cross entropy (`sharded_xent`, its pmax, psums and their transposes
around exp and log, which XLA and torch each round their own way) is
held to 1e-6 of its largest value, tighter than the 1e-5 of the port's
tp = 1 fp32 tests."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import sharding
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as tmesh
from repro_torch.models import embedding as emb


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
TIMEOUT_S = 60.0

# name -> (mesh (dp, tp), local x shape, the call, with a gradient)
CASES = {
    "psum_tp": ((1, 2), (4, 6), "env.psum_tp(x)", True),
    "psum_dp": ((2, 1), (4, 6), "env.psum_dp(x)", True),
    "psum_all": ((1, 2), (4, 6), "env.psum_all(x)", True),
    "pmean_dp": ((2, 1), (4, 6), "env.pmean_dp(x)", True),
    "pmean_all": ((2, 1), (4, 6), "env.pmean_all(x)", True),
    "pmax_tp": ((1, 2), (4, 6), "env.pmax_tp(x)", False),
    "all_gather_tp_0": ((1, 2), (2, 6), "env.all_gather_tp(x, axis=0)", True),
    "all_gather_tp_1": ((1, 2), (4, 3), "env.all_gather_tp(x, axis=1)", True),
    "scatter_tp_0": ((1, 2), (4, 6), "env.scatter_tp(x, axis=0)", True),
    "scatter_tp_1": ((1, 2), (4, 6), "env.scatter_tp(x, axis=1)", True),
    "all_to_all_tp": ((1, 2), (2, 3, 4), "env.all_to_all_tp(x)", True),
    "sp_gather": ((1, 2), (2, 6), "env.sp_gather(x)", True),
    "sp_scatter": ((1, 2), (4, 6), "env.sp_scatter(x)", True),
    "sp_scatter_no_sp": ((1, 2), (4, 6), "env_nosp.sp_scatter(x)", True),
    "gather_fsdp": ((2, 1), (4, 3), "env.gather_fsdp(x, 1)", True),
    "gather_fsdp_cast": ((2, 1), (4, 3),
                         "env.gather_fsdp(x, 1, dtype=BF16)", True),
    "tp_index": ((1, 2), (4, 6), "x * (env.tp_index() + 1)", True),
    "dp_index": ((2, 1), (4, 6), "x * (env.dp_index() + 1)", True),
    "ep_all_to_all": ((1, 2), (2, 3, 4), "EP(x, env)", True),
    # the vocab-sharded cross entropy: 2 x 8 logit columns over a vocab of
    # 14 (the last two padding), labels on both ranks and one ignored
    "sharded_xent": ((1, 2), (4, 8), "XENT(env, x)", True),
}
XENT_VOCAB, XENT_LABELS = 14, [3, 12, -1, 9]

REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import sharding
    from repro.kernels import ops as kops
    from repro.launch.mesh import make_local_mesh
    from repro.sharding import make_axis_env

    cases, inputs, vocab, labels = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    BF16 = jnp.bfloat16
    def EP(x, env):
        return kops.ep_all_to_all(x, axis_name=env.tp_axis)
    from types import SimpleNamespace
    from repro.models import embedding as JE
    def XENT(env, x):
        return JE.sharded_xent(SimpleNamespace(vocab_size=vocab), env, x,
                               jnp.asarray(labels))[0]
    for name, (mesh_shape, _, expr, grad) in cases.items():
        mesh = make_local_mesh(*mesh_shape)
        env = make_axis_env(mesh)
        env_nosp = dataclasses.replace(env, seq_parallel=False)
        f = eval("lambda env, env_nosp, x: " + expr)
        x, ct = inputs[name]
        spec = P(("data", "model"))

        def body(x, ct):
            x, ct = x[0], ct[0]
            if not grad:
                return f(env, env_nosp, x)[None], x[None]
            y, pull = jax.vjp(lambda a: f(env, env_nosp, a), x)
            return y[None], pull(ct.astype(y.dtype))[0][None]
        sm = sharding.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                out_specs=(spec, spec))
        y, g = jax.jit(sm)(jnp.asarray(x), jnp.asarray(ct))
        out[name] = (np.asarray(y.astype(jnp.float32)),
                     np.asarray(g.astype(jnp.float32)))
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _inputs():
    """Per case: x (2, *local) and the cotangent (2, *y's local shape),
    one row per rank, from numpy seed 0."""
    rs = np.random.RandomState(0)
    out = {}
    for name, (_, shape, expr, _) in CASES.items():
        x = rs.randn(2, *shape).astype(np.float32)
        yshape = list(shape)
        if "XENT" in expr:
            yshape = []                        # a scalar loss
        elif "gather" in expr:
            axis = 1 if ("axis=1" in expr or "gather_fsdp" in expr) else 0
            yshape[axis] *= 2
        elif "scatter_tp(x, axis=1)" in expr:
            yshape[1] //= 2
        elif "scatter" in expr and "nosp" not in expr:
            yshape[0] //= 2
        out[name] = (x, rs.randn(2, *yshape).astype(np.float32))
    return out


def _rank(rank: int, store: str, inputs, out_dir: str):
    torch.set_num_threads(1)
    tmesh.init_distributed(rank, 2, init_method=f"file://{store}",
                           backend="gloo", timeout_s=TIMEOUT_S)
    meshes = {shape: tmesh.make_local_mesh(*shape, device="cpu",
                                           timeout_s=TIMEOUT_S)
              for shape in ((1, 2), (2, 1))}
    BF16 = torch.bfloat16

    def EP(x, env):
        return kops.ep_all_to_all(x, group=env.mesh.tp_group)

    def XENT(env, x):
        return emb.sharded_xent(SimpleNamespace(vocab_size=XENT_VOCAB), x,
                                torch.tensor(XENT_LABELS), env)[0]
    out = {}
    for name, (mesh_shape, _, expr, grad) in CASES.items():
        env = sharding.make_axis_env(meshes[mesh_shape])
        env_nosp = sharding.make_axis_env(meshes[mesh_shape],
                                          seq_parallel=False)
        x = torch.from_numpy(inputs[name][0][rank]).requires_grad_(grad)
        y = eval(expr, {"env": env, "env_nosp": env_nosp, "x": x,
                        "BF16": BF16, "EP": EP, "XENT": XENT})
        g = x
        if grad:
            y.backward(torch.as_tensor(np.asarray(inputs[name][1][rank]))
                       .to(y.dtype))
            g = x.grad
        out[name] = (y.detach().float().numpy(), g.detach().float().numpy())
    exchange = _exchange_cases(meshes[(1, 2)].tp_group, rank)
    exchange["barrier"] = _barrier_case(meshes[(1, 2)].tp_group, rank)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((out, meshes[(1, 2)].stats, meshes[(1, 2)].describe(),
                     exchange), f)
    torch.distributed.destroy_process_group()


class _HostExchange(tmesh.CardExchange):
    """`CardExchange` with each piece gathered by gloo on the CPU in place
    of the card's IPC buffers: its pieces and each op's assembly of the
    result, run where there is no card."""

    def exchange(self, flat):
        out = [torch.empty_like(flat) for _ in range(self.size)]
        torch.distributed.all_gather(out, flat.contiguous(), group=self.pg)
        return out


def _barrier_case(group, rank):
    """A `HostBarrier` of the two ranks: rank 1 arrives 1 s late at the
    third of five waits.  Returns (its count, seconds rank 0 waited at
    each)."""
    import time
    bar = tmesh.HostBarrier.connect(group.pg, group.index, group.size, 30.0)
    waits = []
    for i in range(5):
        if rank == 1 and i == 2:
            time.sleep(1.0)
        t0 = time.perf_counter()
        bar.wait()
        waits.append(time.perf_counter() - t0)
    return bar.count, waits


EXCHANGE_OPS = {
    "all_reduce": lambda g, x: g.all_reduce(x),
    "all_reduce max": lambda g, x: g.all_reduce(
        x, op=torch.distributed.ReduceOp.MAX),
    "broadcast 1": lambda g, x: g.broadcast(x, 1),
    "all_gather axis 1": lambda g, x: g.all_gather(x, 1),
    "reduce_scatter axis 0": lambda g, x: g.reduce_scatter(x, 0),
    "reduce_scatter axis 1": lambda g, x: g.reduce_scatter(x, 1),
    "all_to_all": lambda g, x: g.all_to_all(x.reshape(2, 3, -1)),
}


def _exchange_cases(group, rank):
    """Each op through the card exchange's assembly in pieces of 40 bytes
    (so that a piece straddles the blocks), and through gloo: (rank's
    results, equal bit for bit) per op, in fp32 and bf16."""
    ex = _HostExchange(group.pg, group.index, group.size, group.device,
                       barrier=None)
    card = dataclasses.replace(group, exchange=ex, stats={})
    saved, tmesh.EXCHANGE_BYTES = tmesh.EXCHANGE_BYTES, 40
    rs = np.random.RandomState(rank)
    out = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rs.randn(6, 10).astype(np.float32)) \
                .to(dtype)
            for name, fn in EXCHANGE_OPS.items():
                a, b = fn(card, x), fn(group, x)
                out[f"{name} {dtype}"] = (
                    tuple(a.shape) == tuple(b.shape)
                    and torch.equal(a.view(-1).view(torch.uint8),
                                    b.contiguous().view(-1)
                                    .view(torch.uint8)))
    finally:
        tmesh.EXCHANGE_BYTES = saved
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_collectives")
    inputs = _inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((CASES, inputs, XENT_VOCAB, XENT_LABELS), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            str(tmp / "in.pkl"), str(tmp / "ref.pkl")],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "store"), inputs,
                                            str(tmp)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S * 2)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    log, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, log[-3000:]
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    with open(tmp / "ref.pkl", "rb") as f:
        ref_out = pickle.load(f)
    port = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref_out, port


@pytest.mark.parametrize("name", sorted(CASES))
def test_method_and_its_transpose_match_shard_map(results, name):
    """The value on each rank and the gradient of a random cotangent,
    bit for bit (a psum's transpose a psum, an all-gather's a
    reduce-scatter, an all-to-all's the same all-to-all); the cross
    entropy within 1e-6 of its largest value."""
    ref, port = results
    y_ref, g_ref = ref[name]
    tol = (lambda a: 1e-6 * np.abs(a).max()) if name == "sharded_xent" \
        else (lambda a: 0.0)
    for r in range(2):
        y, g = port[r][0][name]
        np.testing.assert_allclose(y, y_ref[r], rtol=0, atol=tol(y_ref),
                                   err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(g, g_ref[r], rtol=0, atol=tol(g_ref),
                                   err_msg=f"{name} grad rank {r}")


def test_stats_count_the_collectives(results):
    """The (1, 2) mesh's `stats` counted every collective its cases ran,
    with bytes, and nothing went through host buffers on a CPU gloo
    group."""
    _, port = results
    stats, describe = port[0][1], port[0][2]
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
        assert stats[op]["calls"] > 0 and stats[op]["bytes"] > 0, op
        assert stats[op]["host_bytes"] == 0, op
    assert "backend=gloo" in describe and "via_host=-" in describe


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_card_exchange_assembles_gloo_results_bit_for_bit(results, dtype):
    """The card exchange's pieces (here 40 bytes, straddling the blocks)
    assembled into each op's result (sum and max in member order, a
    broadcast, gathers and reduce-scatters along dims 0 and 1, the
    all-to-all's blocks) are gloo's results bit for bit on both ranks;
    the members' pieces come from gloo on the CPU in place of the card's
    buffers (the buffers themselves: scripts/torch_card_exchange.py and
    chip_smoke.py phases 9b-9e on the card)."""
    _, port = results
    for r in range(2):
        got = {k: v for k, v in port[r][3].items()
               if k != "barrier" and k.endswith(dtype)}
        assert len(got) == len(EXCHANGE_OPS) and all(got.values()), got


def test_host_barrier_waits_for_every_member(results):
    """The card exchange's barrier (a shared file on the host): rank 0
    waits at the third of five barriers until rank 1, 1 s late,
    arrives, and passes the next ones without that wait."""
    _, port = results
    for r in range(2):
        count, waits = port[r][3]["barrier"]
        assert count == 5
    waits = port[0][3]["barrier"][1]
    assert waits[2] >= 0.9, waits
    assert max(waits[3:]) < 0.9, waits


def test_one_rank_is_an_identity_without_a_process_group():
    """At (1, 1) every method returns its input (the same tensor) and no
    process group exists."""
    env = sharding.LOCAL
    x = torch.randn(4, 6)
    for fn in (env.psum_tp, env.psum_dp, env.psum_all, env.pmax_tp,
               env.pmean_dp, env.pmean_all, env.all_gather_tp,
               env.scatter_tp, env.sp_gather, env.sp_scatter):
        assert fn(x) is x
    assert env.gather_fsdp(x, 0) is x
    x1 = x[:1]
    assert env.all_to_all_tp(x1) is x1
    assert kops.ep_all_to_all(x, group=env.mesh.tp_group) is x
    assert (env.tp_index(), env.dp_index()) == (0, 0)
    assert not torch.distributed.is_initialized()
    assert tmesh.make_local_mesh(1, 1, device="cpu").world.pg is None


def test_gloo_on_a_card_stages_the_collectives_it_lacks():
    """The staging table is fixed from the backend and the device: a gloo
    group on a card reduces and broadcasts CUDA tensors itself and copies
    the gathers, reduce-scatters and all-to-alls through pinned host
    buffers; NCCL and CPU gloo stage nothing."""
    g = tmesh.Group(None, (0, 1), 0, "gloo", torch.device("cuda", 0))
    assert g.staged == {"all_gather", "reduce_scatter", "all_to_all"}
    assert tmesh.Group(None, (0, 1), 0, "nccl",
                       torch.device("cuda", 0)).staged == frozenset()
    assert tmesh.Group(None, (0, 1), 0, "gloo",
                       torch.device("cpu")).staged == frozenset()


def test_specs_and_shards():
    """The spec helpers as the reference's: FSDP only over dp > 1, the
    replication count, and a rank's slice of a global array."""
    env = sharding.make_axis_env(tmesh.Mesh.at(2, 2, 3, device="cpu"))
    assert sharding.fsdp_spec(env, 2, 0, 1) == sharding.P("dp", "tp")
    assert sharding.ep_spec(env, 3, 1, 0) == sharding.P("tp", "dp", None)
    assert sharding.fsdp_spec(sharding.LOCAL, 2, 0, 1) == \
        sharding.P(None, "tp")
    assert sharding.replication(sharding.P("dp", None), env) == 2
    assert sharding.replication(sharding.P(), env) == 4
    a = np.arange(8 * 6).reshape(8, 6)
    np.testing.assert_array_equal(
        sharding.shard(a, sharding.P("dp", "tp"), env), a[4:, 3:])
    assert sharding.local_shape(sharding.P("tp", None), (8, 6), env) == \
        (4, 6)
    assert json.dumps(list(sharding.P(None, "tp"))) == '[null, "tp"]'
