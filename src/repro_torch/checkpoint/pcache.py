"""PCache — distributed checkpoint I/O (§2.3.1, C10; own copy of
`repro.checkpoint.pcache`).

What transfers from the paper to this environment:

  * tree save/load with a manifest (real array I/O);
  * the **AI co-design writer-dispersal strategy**: instead of every DP
    group's rank-0 writing from the same few physical nodes (contention!),
    writers are assigned round-robin across nodes.  `assign_writers` is the
    actual algorithm; `simulate_checkpoint_write` models the contention win
    (Table 2: 70s vs 160s / 90s vs 240s shape);
  * metadata caching for fast repeated loads;
  * asynchronous (background-thread) writes so training continues.

The on-disk layout is the reference's: `manifest.json`, one `leaf_i.npy`
per leaf and `host_state.pkl`.  A tree is nested dicts of tensors (or
numpy arrays), flattened in sorted key order as `jax.tree.flatten` orders
a dict, so leaf i of the trainer's {"params", "opt", "guard"} tree is the
same array in both packages.

A sharded run (`save_sharded` / `load_sharded`, a (dp, tp) mesh of
ranks) keeps the same layout on disk, each leaf whole, so a checkpoint
restores at any mesh and the reference's `PCache.load` reads it;
`save` / `load` are the one-rank case (`sharding.LOCAL`).  No
data moves through the collectives: rank 0 lays out every leaf's file
(the .npy header and its size), and after one barrier each rank's
background writer fills the slices it holds through a memory map
(`np.lib.format.open_memmap`); a slice that several ranks hold (a leaf
replicated over an axis) is written by one of them, the least loaded in
bytes (`shard_writers`, the dispersal rule of `assign_writers` with a
rank for a node).  Each rank then drops a done-marker, and rank 0's
writer writes the manifest once every marker is there.  A restore reads
each rank's slice alone (one read where the slice is one block of the
file, else through `mmap_mode="r"`).

A save copies every leaf to host memory before it returns,
and waits for the copy: the trainer updates its tensors in place, so a
copy still in flight when the next step is enqueued would save that
step's values.  Only the file writes run on the background writers.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.optim import adamw

# how long rank 0's writer waits for the other ranks' done-markers
MARKER_TIMEOUT_S = 3600.0


# ---------------------------------------------------------------------------
# writer dispersal (the paper's core scheduling idea)
# ---------------------------------------------------------------------------


def assign_writers(n_dp_groups: int, ranks_per_group: int, n_nodes: int,
                   ranks_per_node: int, disperse: bool = True
                   ) -> List[int]:
    """Return the writer *global rank* for each DP group.

    DP groups are strided across the cluster (Megatron layout: group g's
    members are ranks {g + r * n_dp_groups}), so the default rank-0 writers
    (`disperse=False`) all land on the first few physical nodes — the
    contention the paper observed.  PCache (`disperse=True`) picks, per
    group, the member on the least-loaded node (greedy), dispersing writes
    across the cluster.
    """
    writers = []
    load = [0] * n_nodes
    for g in range(n_dp_groups):
        members = [g + r * n_dp_groups for r in range(ranks_per_group)]
        if not disperse:
            w = members[0]
        else:
            w = min(members, key=lambda m: (load[(m // ranks_per_node)
                                                 % n_nodes], m))
        load[(w // ranks_per_node) % n_nodes] += 1
        writers.append(w)
    return writers


def node_load(writers: Sequence[int], ranks_per_node: int) -> Dict[int, int]:
    load: Dict[int, int] = {}
    for w in writers:
        load[w // ranks_per_node] = load.get(w // ranks_per_node, 0) + 1
    return load


def simulate_checkpoint_write(n_dp_groups: int, ranks_per_group: int,
                              n_nodes: int, ranks_per_node: int,
                              bytes_per_group: float,
                              node_bw: float = 3e9,
                              disperse: bool = True) -> float:
    """Write time = max over nodes of (groups_on_node * bytes) / node_bw."""
    writers = assign_writers(n_dp_groups, ranks_per_group, n_nodes,
                             ranks_per_node, disperse)
    load = node_load(writers, ranks_per_node)
    worst = max(load.values())
    return worst * bytes_per_group / node_bw


def shard_writers(specs: Sequence[Any], nbytes: Sequence[int],
                  env) -> List[List[int]]:
    """For each leaf (its spec and the bytes of one rank's slice), the
    ranks that write it: of every group of ranks holding the same slice,
    the one with the fewest bytes assigned so far (ties to the lowest
    rank), leaf by leaf in order.  Every rank computes the same plan."""
    dp, tp = env.dp, env.tp
    load = [0] * (dp * tp)
    plan = []
    for spec, n in zip(specs, nbytes):
        parts = set(spec)
        groups: Dict[tuple, List[int]] = {}
        for rank in range(dp * tp):
            d, t = divmod(rank, tp)
            key = (d if "dp" in parts else 0, t if "tp" in parts else 0)
            groups.setdefault(key, []).append(rank)
        writers = []
        for holders in groups.values():
            w = min(holders, key=lambda r: (load[r], r))
            load[w] += n
            writers.append(w)
        plan.append(sorted(writers))
    return plan


def global_shape(spec: Sequence[Any], shape: Sequence[int], env) -> tuple:
    """The whole leaf's shape of a rank's slice of `shape` under `spec`."""
    return tuple(n * (sharding.axis_size(env, spec[i]) if i < len(spec)
                      else 1) for i, n in enumerate(shape))


def slice_index(spec: Sequence[Any], shape: Sequence[int], env) -> tuple:
    """The index of this rank's slice (local `shape`) in the whole leaf."""
    idx = []
    for i, n in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        j = sharding.axis_index(env, part)
        idx.append(slice(j * n, (j + 1) * n))
    return tuple(idx)


def _header(f):
    """(shape, fortran_order, dtype) of the open .npy file `f`, left at
    its first data byte."""
    major, _ = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if major == 1
            else np.lib.format.read_array_header_2_0)
    return read(f)


def _block_start(idx: tuple, shape: Sequence[int]) -> Optional[int]:
    """The first element of slice `idx` of a C-ordered leaf of `shape`
    where the slice is one contiguous block of the file (a whole leaf, or
    a cut of one dim with every dim before it of size 1), else None."""
    cut = [k for k, (s, n) in enumerate(zip(idx, shape))
           if (s.start, s.stop) != (0, n)]
    if not cut:
        return 0
    if len(cut) == 1 and all(n == 1 for n in shape[:cut[0]]):
        return idx[cut[0]].start * int(np.prod(shape[cut[0] + 1:]))
    return None


def _write_slice(path: str, idx: tuple, a: np.ndarray):
    """Write `a` into its slice `idx` of the .npy file at `path` (laid out
    whole beforehand): one sequential write where the slice is one
    contiguous block of the file, else through a memory map (a small
    write per leading index, one per row of an FSDP-cut embedding, is far
    slower)."""
    with open(path, "r+b") as f:
        shape, _, _ = _header(f)
        start = _block_start(idx, shape)
        if start is not None:
            f.seek(f.tell() + start * a.itemsize)
            np.ascontiguousarray(a).tofile(f)
            return
    mm = np.load(path, mmap_mode="r+")
    mm[idx] = a
    mm.flush()
    del mm


def _read_slice(path: str, idx: tuple, whole: tuple, what: str) -> np.ndarray:
    """Slice `idx` of the .npy file at `path`, whose leaf must have shape
    `whole`: one sequential read where the slice is one contiguous block
    of a C-ordered file, else through a memory map."""
    with open(path, "rb") as f:
        shape, fortran, dtype = _header(f)
        if tuple(shape) != tuple(whole):
            raise ValueError(f"{what}: shape {tuple(shape)} != {whole}")
        start = None if fortran else _block_start(idx, shape)
        if start is not None:
            local = tuple(s.stop - s.start for s in idx)
            f.seek(f.tell() + start * dtype.itemsize)
            return np.fromfile(f, dtype=dtype, count=int(np.prod(local))
                               ).reshape(local)
    mm = np.load(path, mmap_mode="r")
    a = np.array(mm[idx])
    del mm
    return a


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_unflatten(like, leaves: List[Any]):
    """The tree `like` with its leaves replaced, in `adamw.leaves` order
    (sorted dict keys, list entries in index order, as
    `jax.tree.flatten` orders them)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)
    return build(like)


def _treedef(tree) -> str:
    """The tree's structure as `str(jax.tree.structure(tree))` spells it."""
    def spell(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {spell(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(spell(v) for v in node) + "]"
        return "*"
    return f"PyTreeDef({spell(tree)})"


def _to_host(leaf) -> np.ndarray:
    """A numpy copy of one leaf, complete when this returns (a blocking
    device-to-host copy for a card's tensor; a fresh copy of a CPU one,
    never a view of storage that the next step writes)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


# ---------------------------------------------------------------------------
# real save/load
# ---------------------------------------------------------------------------


class PCache:
    """Local-filesystem checkpoint store with dispersed parallel writers.

    `last_save` holds the newest save's bytes and its fetch seconds (the
    copy to host memory), and its write seconds once the writers are
    done; `last_load` the newest load's bytes and seconds."""

    def __init__(self, root: str, n_writers: int = 4):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.n_writers = n_writers
        self._meta_cache: Dict[str, Dict] = {}
        self._async_jobs: List[Any] = []
        self.last_save: Dict[str, Any] = {}
        self.last_load: Dict[str, Any] = {}

    # -- save/load (one process's whole tree: the one-rank mesh) ----------
    def save(self, name: str, tree: Any, block: bool = True) -> str:
        """Save `tree` whole: `save_sharded` at one rank."""
        return self.save_sharded(name, tree, sharding.replicated_specs(tree),
                                 sharding.LOCAL, block=block)

    def load(self, name: str, like: Any) -> Any:
        """The checkpoint as `like`'s tree: `load_sharded` at one rank."""
        return self.load_sharded(name, like, sharding.replicated_specs(like),
                                 sharding.LOCAL)

    def wait(self):
        """Join the background writers; raise the first error one hit."""
        jobs, self._async_jobs = self._async_jobs, []
        for t, _ in jobs:
            t.join()
        for _, errors in jobs:
            if errors:
                raise RuntimeError("a background checkpoint write failed") \
                    from errors[0]

    def manifest(self, name: str) -> Dict:
        if name in self._meta_cache:                 # metadata cache
            return self._meta_cache[name]
        with open(os.path.join(self.root, name, "manifest.json")) as f:
            m = json.load(f)
        self._meta_cache[name] = m
        return m

    # -- sharded save/load (a mesh of ranks, one file per whole leaf) -------
    def save_sharded(self, name: str, tree: Any, specs: Any, env,
                     block: bool = False) -> str:
        """Every rank of `env`'s mesh calls this with its shards of `tree`
        (specs: the same layout, a `sharding.P` per leaf).  Rank 0 lays
        out the leaf files, one barrier, then this rank's writer fills the
        slices `shard_writers` gives it, flushes them and drops its
        done-marker; rank 0's writer writes the manifest last, once every
        rank's marker is there (no collective in a writer thread).  The
        slices are copied to host memory before this returns."""
        path = os.path.join(self.root, name)
        rank, n_ranks = env.mesh.rank, env.dp * env.tp
        spec_list = [tuple(sp) for sp in adamw.leaves(specs)]
        t0 = time.perf_counter()
        arrays = [_to_host(x) for x in adamw.leaves(tree)]
        if len(arrays) != len(spec_list):
            raise ValueError(f"{len(arrays)} leaves, {len(spec_list)} specs")
        shapes = [global_shape(sp, a.shape, env)
                  for sp, a in zip(spec_list, arrays)]
        plan = shard_writers(spec_list, [a.nbytes for a in arrays], env)
        mine = [i for i, w in enumerate(plan) if rank in w]
        stats = {"bytes": sum(arrays[i].nbytes for i in mine),
                 "fetch_s": time.perf_counter() - t0, "write_s": None}
        self.last_save = stats
        manifest = {
            "treedef": _treedef(tree),
            "n_leaves": len(arrays),
            "leaves": [{"file": f"leaf_{i}.npy", "shape": list(sh),
                        "dtype": str(a.dtype)}
                       for i, (sh, a) in enumerate(zip(shapes, arrays))],
            "time": time.time(),
        }
        marker = lambda r: os.path.join(path, f".done_{r}")
        layout_error: List[Exception] = []
        if rank == 0:
            try:
                os.makedirs(path, exist_ok=True)
                for f in ["manifest.json"] + [f".done_{r}"
                                              for r in range(n_ranks)]:
                    if os.path.exists(os.path.join(path, f)):
                        os.remove(os.path.join(path, f))
                for i, (sh, a) in enumerate(zip(shapes, arrays)):
                    np.lib.format.open_memmap(
                        os.path.join(path, f"leaf_{i}.npy"), mode="w+",
                        dtype=a.dtype, shape=sh)
            except OSError as e:     # raised by the writer, as a write's
                layout_error.append(e)
        env.mesh.agree(0.0)              # the files exist on every rank

        def write_one(i):
            _write_slice(os.path.join(path, f"leaf_{i}.npy"),
                         slice_index(spec_list[i], arrays[i].shape, env),
                         arrays[i])

        def write_all():
            t1 = time.perf_counter()
            if layout_error:
                raise layout_error[0]
            with ThreadPoolExecutor(self.n_writers) as ex:
                for f in [ex.submit(write_one, i) for i in mine]:
                    f.result()
            open(marker(rank), "w").close()
            if rank == 0:
                end = time.time() + MARKER_TIMEOUT_S
                while not all(os.path.exists(marker(r))
                              for r in range(n_ranks)):
                    if time.time() > end:
                        raise TimeoutError(f"{path}: ranks' done-markers "
                                           f"missing after "
                                           f"{MARKER_TIMEOUT_S}s")
                    time.sleep(0.01)
                with open(os.path.join(path, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
            stats["write_s"] = time.perf_counter() - t1

        if block:
            write_all()
        else:
            errors: List[Exception] = []

            def run():
                try:
                    write_all()
                except Exception as e:  # noqa: BLE001 — re-raised by wait()
                    errors.append(e)
            t = threading.Thread(target=run, daemon=True)
            t.start()
            self._async_jobs.append((t, errors))
        return path

    def load_sharded(self, name: str, like: Any, specs: Any, env) -> Any:
        """This rank's slices of a checkpoint written at any mesh (or by
        the reference), as `like`'s tree (the rank's shards; specs the
        same layout): only the slice of each leaf file is read, in one
        sequential read where it is one block of the file, else through a
        memory map.  A tensor leaf of `like` gives a tensor on its device
        in its dtype, any other leaf a numpy array.  Raises if the leaf
        count or a whole leaf's shape differs."""
        t0 = time.perf_counter()
        m = self.manifest(name)
        path = os.path.join(self.root, name)
        likes = adamw.leaves(like)
        spec_list = [tuple(sp) for sp in adamw.leaves(specs)]
        if len(likes) != m["n_leaves"]:
            raise ValueError(f"{name}: {m['n_leaves']} leaves on disk, "
                             f"{len(likes)} in the tree to load into")
        out, nbytes = [], 0
        for e, ref, sp in zip(m["leaves"], likes, spec_list):
            shape = tuple(ref.shape)
            a = _read_slice(os.path.join(path, e["file"]),
                            slice_index(sp, shape, env),
                            global_shape(sp, shape, env),
                            f"{name}/{e['file']}")
            nbytes += a.nbytes
            if isinstance(ref, torch.Tensor):
                a = torch.from_numpy(a).to(device=ref.device, dtype=ref.dtype)
            out.append(a)
        self.last_load = {"bytes": nbytes,
                          "seconds": time.perf_counter() - t0}
        return tree_unflatten(like, out)

    def list_checkpoints(self) -> List[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def latest(self) -> Optional[str]:
        """Newest complete checkpoint (has a manifest), ``step_N``-aware:
        numeric suffixes sort numerically so step_100 beats step_20."""
        def key(name: str):
            # step_N names rank above (and among themselves by N) any
            # manually-named checkpoint, digit-suffixed or not
            tail = name[5:] if name.startswith("step_") else ""
            return (1, int(tail), "") if tail.isdigit() else (0, 0, name)

        done = [d for d in self.list_checkpoints()
                if os.path.exists(os.path.join(self.root, d,
                                               "manifest.json"))]
        return max(done, key=key) if done else None

    # -- host-side state (pipeline / detector / step counter) --------------
    def save_host(self, name: str, obj: Any):
        """Pickle non-array host state next to the array leaves.  Written
        synchronously (it is tiny); the array writers may still be running
        in the background."""
        path = os.path.join(self.root, name)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "host_state.pkl"), "wb") as f:
            pickle.dump(obj, f)

    def load_host(self, name: str) -> Any:
        """Unpickle the host state that `save_host` wrote (only load
        checkpoints this program wrote: unpickling can run code)."""
        with open(os.path.join(self.root, name, "host_state.pkl"),
                  "rb") as f:
            return pickle.load(f)
