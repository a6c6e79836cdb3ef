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

`save(block=False)` copies every leaf to host memory before it returns,
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

from repro_torch.optim import adamw


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


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_unflatten(like, leaves: List[Any]):
    """The tree `like` with its leaves replaced, in `adamw.leaves` order
    (sorted dict keys, as `jax.tree.flatten` orders them)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def _treedef(tree) -> str:
    """The tree's structure as `str(jax.tree.structure(tree))` spells it."""
    def spell(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {spell(node[k])}"
                                   for k in sorted(node)) + "}"
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

    # -- save -------------------------------------------------------------
    def save(self, name: str, tree: Any, block: bool = True) -> str:
        path = os.path.join(self.root, name)
        os.makedirs(path, exist_ok=True)
        t0 = time.perf_counter()
        arrays = [_to_host(x) for x in adamw.leaves(tree)]
        stats = {"bytes": sum(a.nbytes for a in arrays),
                 "fetch_s": time.perf_counter() - t0, "write_s": None}
        self.last_save = stats
        manifest = {
            "treedef": _treedef(tree),
            "n_leaves": len(arrays),
            "leaves": [{"file": f"leaf_{i}.npy", "shape": list(a.shape),
                        "dtype": str(a.dtype)} for i, a in enumerate(arrays)],
            "time": time.time(),
        }

        def write_all():
            t1 = time.perf_counter()
            # dispersed parallel writers (one pool worker ~ one node)
            with ThreadPoolExecutor(self.n_writers) as ex:
                futs = [ex.submit(np.save, os.path.join(path, f"leaf_{i}"),
                                  a) for i, a in enumerate(arrays)]
                for f in futs:
                    f.result()
            # the manifest last: a checkpoint without one is incomplete
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

    def wait(self):
        """Join the background writers; raise the first error one hit."""
        jobs, self._async_jobs = self._async_jobs, []
        for t, _ in jobs:
            t.join()
        for _, errors in jobs:
            if errors:
                raise RuntimeError("a background checkpoint write failed") \
                    from errors[0]

    # -- load -------------------------------------------------------------
    def manifest(self, name: str) -> Dict:
        if name in self._meta_cache:                 # metadata cache
            return self._meta_cache[name]
        with open(os.path.join(self.root, name, "manifest.json")) as f:
            m = json.load(f)
        self._meta_cache[name] = m
        return m

    def load(self, name: str, like: Any) -> Any:
        """The checkpoint as `like`'s tree: a tensor leaf of `like` gives a
        tensor on its device in its dtype, any other leaf a numpy array.
        Raises if the leaf count or a shape differs from `like`'s."""
        t0 = time.perf_counter()
        m = self.manifest(name)
        path = os.path.join(self.root, name)
        likes = adamw.leaves(like)
        if len(likes) != m["n_leaves"]:
            raise ValueError(f"{name}: {m['n_leaves']} leaves on disk, "
                             f"{len(likes)} in the tree to load into")
        out, nbytes = [], 0
        for e, ref in zip(m["leaves"], likes):
            a = np.load(os.path.join(path, e["file"]))
            nbytes += a.nbytes
            if isinstance(ref, torch.Tensor):
                if tuple(a.shape) != tuple(ref.shape):
                    raise ValueError(f"{name}/{e['file']}: shape "
                                     f"{a.shape} != {tuple(ref.shape)}")
                a = torch.from_numpy(a).to(device=ref.device,
                                           dtype=ref.dtype)
            out.append(a)       # a blocking copy from pageable memory
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
