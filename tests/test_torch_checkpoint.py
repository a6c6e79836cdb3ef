"""The port's checkpoint modules against the JAX package: PCache (the
on-disk layout of the reference's, leaf for leaf, in both directions; an
asynchronous save holds the values of the moment it was called; the
writer-dispersal model), Babel, the data pipeline's and the prefetcher's
checkpoint state, and the spike detector's policy and state.

Tolerances: none.  Every array and batch is held bit for bit, and every
policy decision equal, to the reference's."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import pcache as JPC
from repro.core import spikes as JS
from repro.data.pipeline import DataPipeline as JPipe
from repro.data.pipeline import PipelineConfig as JPipeCfg
from repro_torch.checkpoint import babel as B
from repro_torch.checkpoint import pcache as PC
from repro_torch.core import spikes as TS
from repro_torch.data.pipeline import DataPipeline as TPipe
from repro_torch.data.pipeline import PipelineConfig as TPipeCfg
from repro_torch.data.pipeline import Prefetcher
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# PCache
# ---------------------------------------------------------------------------


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32),
                  "a": torch.full((), 0.5)}}


def test_pcache_roundtrip(tmp_path):
    pc = PC.PCache(str(tmp_path))
    tree = _tree()
    pc.save("step_10", tree)
    out = pc.load("step_10", tree)
    for a, b in zip(adamw.leaves(tree), adamw.leaves(out)):
        assert b.dtype == a.dtype and torch.equal(a, b)
    assert pc.list_checkpoints() == ["step_10"]
    # metadata cache: second manifest read hits the cache
    pc.manifest("step_10")
    assert "step_10" in pc._meta_cache
    assert pc.last_load["bytes"] == 12 * 4 + 2 * 4 + 4


def test_pcache_async(tmp_path):
    pc = PC.PCache(str(tmp_path))
    tree = {"w": torch.ones((64, 64))}
    pc.save("a", tree, block=False)
    pc.wait()
    out = pc.load("a", tree)
    np.testing.assert_array_equal(out["w"].numpy(), np.ones((64, 64)))
    assert pc.last_save["bytes"] == 64 * 64 * 4
    assert pc.last_save["fetch_s"] >= 0 and pc.last_save["write_s"] >= 0


def test_pcache_async_save_holds_the_values_it_was_given(tmp_path):
    """The trainer updates its tensors in place right after a save: the
    checkpoint must hold the values of the moment save() was called."""
    pc = PC.PCache(str(tmp_path))
    w = torch.zeros(1 << 16)
    pc.save("s", {"w": w}, block=False)
    w.add_(1.0)                       # the next step, in place
    pc.wait()
    assert float(pc.load("s", {"w": w})["w"].abs().max()) == 0.0


def test_pcache_surfaces_write_errors_and_bad_trees(tmp_path):
    pc = PC.PCache(str(tmp_path))
    pc.save("x", {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        pc.load("x", {"w": torch.ones(3), "v": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        pc.load("x", {"w": torch.ones(4)})
    os.makedirs(tmp_path / "y" / "leaf_0.npy")      # np.save cannot write
    pc.save("y", {"w": torch.ones(3)}, block=False)
    with pytest.raises(RuntimeError, match="background"):
        pc.wait()


def test_pcache_layout_is_the_references(tmp_path):
    """The trainer's tree shape (params / opt / guard, nested and out of
    order): the reference's PCache and the port's write the same manifest
    and the same leaf files, and each loads what the other wrote."""
    rs = np.random.RandomState(0)
    arrays = {"params": {"w": rs.randn(3, 4).astype(np.float32),
                         "embed": {"table": rs.randn(5, 2)
                                   .astype(np.float32)}},
              "opt": {"m": {"x": rs.randn(2).astype(np.float32)},
                      "v": {"x": rs.rand(2).astype(np.float32)},
                      "count": np.int32(3)},
              "guard": {"mean": np.float32(4.5), "n": np.int32(7)}}
    to_t = lambda t: ({k: to_t(v) for k, v in t.items()}
                      if isinstance(t, dict) else torch.tensor(t))
    to_j = lambda t: ({k: to_j(v) for k, v in t.items()}
                      if isinstance(t, dict) else jnp.asarray(t))
    jpc, tpc = JPC.PCache(str(tmp_path / "j")), PC.PCache(str(tmp_path / "t"))
    jpc.save("c", to_j(arrays))
    tpc.save("c", to_t(arrays))
    jm, tm = jpc.manifest("c"), tpc.manifest("c")
    assert tm["treedef"] == jm["treedef"]
    assert tm["leaves"] == jm["leaves"] and tm["n_leaves"] == jm["n_leaves"]
    for e in jm["leaves"]:
        a = np.load(tmp_path / "j" / "c" / e["file"])
        b = np.load(tmp_path / "t" / "c" / e["file"])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the reference's checkpoint into the port's tensors, and back
    like = to_t(arrays)
    got = PC.PCache(str(tmp_path / "j")).load("c", like)
    for a, b in zip(adamw.leaves(like), adamw.leaves(got)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    back = JPC.PCache(str(tmp_path / "t")).load("c", to_j(arrays))
    for a, b in zip(jax.tree.leaves(to_j(arrays)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with open(tmp_path / "t" / "c" / "manifest.json") as f:
        assert json.load(f)["n_leaves"] == 7


def test_pcache_latest_prefers_newest_step(tmp_path):
    pc = PC.PCache(str(tmp_path))
    for name in ("init", "run_v999", "step_20", "step_100"):
        pc.save(name, {"x": np.zeros(2)})
    assert pc.latest() == "step_100"
    os.makedirs(tmp_path / "step_200")              # no manifest: incomplete
    assert pc.latest() == "step_100"
    assert PC.PCache(str(tmp_path / "empty")).latest() is None


def test_pcache_host_state_roundtrip(tmp_path):
    pc = PC.PCache(str(tmp_path))
    obj = {"step": 3, "pipeline": {"buffer": np.arange(5)}}
    pc.save_host("s", obj)
    out = pc.load_host("s")
    assert out["step"] == 3
    np.testing.assert_array_equal(out["pipeline"]["buffer"], np.arange(5))


def test_writer_dispersal_balances_nodes():
    """The AI-co-design claim: rank-0 writers pile up on the first nodes;
    dispersed writers spread evenly -> the Table-2-shaped win."""
    kw = dict(n_dp_groups=16, ranks_per_group=8, n_nodes=16,
              ranks_per_node=8)
    concentrated = PC.assign_writers(disperse=False, **kw)
    dispersed = PC.assign_writers(disperse=True, **kw)
    assert concentrated == JPC.assign_writers(disperse=False, **kw)
    assert dispersed == JPC.assign_writers(disperse=True, **kw)
    load_c = PC.node_load(concentrated, 8)
    load_d = PC.node_load(dispersed, 8)
    assert max(load_c.values()) > max(load_d.values())
    assert max(load_d.values()) == 1
    t_c = PC.simulate_checkpoint_write(disperse=False,
                                       bytes_per_group=1e9, **kw)
    t_d = PC.simulate_checkpoint_write(disperse=True,
                                       bytes_per_group=1e9, **kw)
    assert t_c / t_d >= 2.0            # paper: ~50% latency reduction


# ---------------------------------------------------------------------------
# Babel
# ---------------------------------------------------------------------------


def _make_tree(root, n_dirs=4, files_per=6, size=2000):
    rs = np.random.RandomState(0)
    for d in range(n_dirs):
        p = os.path.join(root, f"shard_{d}")
        os.makedirs(p, exist_ok=True)
        for f in range(files_per):
            with open(os.path.join(p, f"f{f}.bin"), "wb") as fh:
                fh.write(rs.bytes(size))


def test_babel_listing_parallel_equals_serial(tmp_path):
    _make_tree(str(tmp_path))
    assert B.list_parallel(str(tmp_path)) == B.list_serial(str(tmp_path))


def test_babel_sync_and_verify(tmp_path):
    src = str(tmp_path / "src")
    dst = str(tmp_path / "dst")
    os.makedirs(src)
    _make_tree(src)
    rep = B.Babel(verify="sampled").sync(src, dst)
    assert rep.files_copied == rep.files_total == 24
    assert not rep.verify_failures
    # idempotent: second sync copies nothing
    rep2 = B.Babel(verify="off").sync(src, dst)
    assert rep2.files_copied == 0
    # corrupt a destination file -> verification catches it
    victim = os.path.join(dst, "shard_0", "f0.bin")
    with open(victim, "rb") as f:
        data = bytearray(f.read())
    data[10] ^= 0xFF
    with open(victim, "wb") as f:
        f.write(bytes(data))
    os.utime(victim, (0, 0))  # make it look in-sync
    os.utime(os.path.join(src, "shard_0", "f0.bin"), (0, 0))
    rep3 = B.Babel(verify="sampled").sync(src, dst)
    assert "shard_0/f0.bin" in rep3.verify_failures


def test_babel_sharded_large_file(tmp_path):
    src = str(tmp_path / "s")
    dst = str(tmp_path / "d")
    os.makedirs(src)
    big = np.random.RandomState(1).bytes(3 << 20)
    with open(os.path.join(src, "big.bin"), "wb") as f:
        f.write(big)
    B.Babel(chunk_bytes=1 << 20, verify="full").sync(src, dst)
    with open(os.path.join(dst, "big.bin"), "rb") as f:
        assert f.read() == big


def test_crc_sampled_is_size_independent(tmp_path):
    small = str(tmp_path / "s")
    large = str(tmp_path / "l")
    with open(small, "wb") as f:
        f.write(os.urandom(1 << 16))
    with open(large, "wb") as f:
        f.write(os.urandom(1 << 24))
    t0 = time.perf_counter()
    B.crc_sampled(small)
    t_small = time.perf_counter() - t0
    t0 = time.perf_counter()
    B.crc_sampled(large)
    t_large = time.perf_counter() - t0
    assert t_large < max(t_small, 1e-3) * 50   # ~O(1) in file size


# ---------------------------------------------------------------------------
# pipeline and prefetcher state
# ---------------------------------------------------------------------------


def _pipes(**kw):
    cfg = dict(vocab_size=300, seq_len=32, batch_size=2, seed=3,
               retry_injection_prob=0.5, **kw)
    return JPipe(JPipeCfg(**cfg)), TPipe(TPipeCfg(**cfg))


def _same(a, b):
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_state_roundtrip_continues_as_the_references():
    """Mid-stream (a retry queued, the mixture adjusted, a buffer partly
    used), the port's state_dict restored into a fresh port pipeline
    continues exactly as the reference's pipeline does."""
    j, t = _pipes()
    for p in (j, t):
        p.next_macrobatch(2)
        p.push_retry(p.next_macrobatch(2), 2)
        p.set_mixture({"code": 3.0})
    state = t.state_dict()
    assert set(state) == set(j.state_dict())
    seq = [1, 2, 4, 2, 1]
    want = [j.next_macrobatch(a) for a in seq]
    fresh = TPipe(TPipeCfg(vocab_size=300, seq_len=32, batch_size=2,
                           seed=99, retry_injection_prob=0.5))
    fresh.load_state_dict(state)
    for a, w in zip(seq, want):
        _same(fresh.next_macrobatch(a), w)
    assert fresh.stats == j.stats
    # batches(): the reference's generator over next_batch
    j2, t2 = _pipes()
    for a, b in zip(j2.batches(3), t2.batches(3)):
        _same(a, b)


def test_prefetcher_preload_and_paused():
    """paused() quiesces the producer and yields the queued batches; a
    Prefetcher preloaded with them serves them first, then new ones."""
    _, t = _pipes()
    pf = Prefetcher(lambda: t.next_macrobatch(1), depth=3)
    first = pf.get()
    deadline = time.monotonic() + 10
    while len(pf._q) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    with pf.paused() as pending:
        state = t.state_dict()
    pf.stop()
    assert len(pending) == 3
    _, ref = _pipes()
    want = [ref.next_macrobatch(1) for _ in range(7)]
    _same(first, want[0])
    t.load_state_dict(state)
    pf2 = Prefetcher(lambda: t.next_macrobatch(1), depth=2, preload=pending)
    try:
        for w in want[1:]:
            _same(pf2.get(), w)
    finally:
        pf2.stop()


# ---------------------------------------------------------------------------
# spike detector
# ---------------------------------------------------------------------------


LOSSES = [4.0, 3.9, 3.95, 3.8, 9.0, 9.5, 9.8, 3.7, 3.75, 12.0, 3.6, 3.65]


def test_detector_observe_matches_reference_and_resumes():
    """The synchronous policy (is_spike, observe: narrow, then wide with
    the LR window, retry queue) step for step as the reference's; a state
    round trip halfway continues identically."""
    cfg = dict(warmup_steps=3, wide_after=2, lr_reduce_steps=4)
    j = JS.SpikeDetector(JS.SpikeConfig(**cfg))
    t = TS.SpikeDetector(TS.SpikeConfig(**cfg))
    half = len(LOSSES) // 2
    for i, loss in enumerate(LOSSES):
        if i == half:
            state = t.state_dict()
            assert set(state) == set(j.state_dict())
            t = TS.SpikeDetector(TS.SpikeConfig(**cfg))
            t.load_state_dict(state)
        assert t.is_spike(loss) == j.is_spike(loss)
        assert t.observe(i, loss, batch={"i": i}) == \
            j.observe(i, loss, batch={"i": i})
        assert t.lr_scale_for(i + 1) == j.lr_scale_for(i + 1)
    assert [(e.step, e.kind, e.action) for e in t.events] == \
        [(e.step, e.kind, e.action) for e in j.events]
    assert any(e.kind == "wide" for e in t.events)
    while True:
        a, b = t.pop_retry(), j.pop_retry()
        assert a == b
        if a is None:
            break


def test_detector_ingest_and_synthetic_spikes():
    det = TS.SpikeDetector(TS.SpikeConfig())
    det.ingest(3, 9.0, skipped=True, batch={"id": 3})
    assert det.pop_retry() == {"id": 3}
    assert det.pop_retry() is None
    curve = np.linspace(5.0, 3.0, 20)
    np.testing.assert_array_equal(
        TS.inject_synthetic_spikes(curve, [4, 18], 2.0),
        JS.inject_synthetic_spikes(curve, [4, 18], 2.0))
