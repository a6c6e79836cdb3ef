"""A (dp, tp) mesh of torch.distributed ranks (counterpart of
`repro.launch.mesh.make_local_mesh`).

One process per rank.  Rank g sits at mesh coordinates (g // tp, g % tp),
the row-major layout of the reference's `jax.make_mesh((dp, tp), ...)`:
dp index d owns the d-th rows of a dp-sharded batch, tp index t the t-th
slice of a tp-sharded dim.  `make_local_mesh` builds, on every rank and
in the same order, one tp group per dp index and one dp group per tp
index, and keeps the rank's own two beside the world group.

The backend and the device are explicit:

  * "nccl", each rank on its own card: every collective on CUDA tensors;
  * "gloo" on the CPU: every collective on CPU tensors;
  * "gloo" with ranks sharing one card (NCCL refuses two ranks on one
    device): gloo reduces CUDA tensors (all-reduce, broadcast) itself,
    and the collectives it lacks on CUDA tensors (all-gather,
    reduce-scatter, all-to-all) copy through pinned host buffers.

Which collective takes which path is fixed when the group is built, from
its backend and device (`Group.staged`), and printed by `describe`.
Every group carries a timeout, so a rank whose peers diverged fails in
its own seconds instead of hanging.  A mesh's `stats` count each
collective's calls, its bytes, the bytes staged through the host and
the host seconds spent in it (waits for the peers included).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis import contracts

DEFAULT_TIMEOUT_S = 300.0

# collectives gloo runs on CUDA tensors itself; the rest stage through
# pinned host memory when a gloo group works on a card
GLOO_ON_CUDA = frozenset({"all_reduce", "broadcast"})
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
               "all_to_all")



def _all_gather_tensor(out, x, group):
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_tensor(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, group=group)


@dataclasses.dataclass
class Group:
    """One mesh axis' process group, as this rank sees it: `size` ranks,
    this one at `index`.  The ops take and return tensors on the mesh's
    device and count into `stats` (shared by a mesh's groups); a size-1
    group never communicates."""
    pg: Optional[object]
    ranks: Tuple[int, ...]
    index: int
    backend: str
    device: torch.device
    stats: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def staged(self) -> frozenset:
        """The collectives this group copies through pinned host
        buffers."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return frozenset(COLLECTIVES) - GLOO_ON_CUDA
        return frozenset()

    def _run(self, op: str, x: torch.Tensor, fn) -> torch.Tensor:
        """fn(x on the wire, an allocator on the wire) -> result on the
        wire.  A staged op copies x into pinned host memory, runs on
        pinned buffers and copies the result back without waiting (an
        announced drain under the debug sync guards)."""
        t0 = time.perf_counter()
        staged = op in self.staged
        if staged:
            with contracts.announced_drain():
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x)
                out = fn(h, lambda shape: torch.empty(
                    shape, dtype=x.dtype, pin_memory=True))
                out = out.to(x.device, non_blocking=True)
        else:
            x = x.contiguous()
            out = fn(x, lambda shape: torch.empty(shape, dtype=x.dtype,
                                                  device=x.device))
        s = self.stats.setdefault(op, {"calls": 0, "bytes": 0,
                                       "host_bytes": 0, "seconds": 0.0})
        nbytes = x.numel() * x.element_size()
        s["calls"] += 1
        s["bytes"] += nbytes
        s["host_bytes"] += nbytes if staged else 0
        s["seconds"] += time.perf_counter() - t0
        return out

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM):
        """A new tensor: x reduced over the group (`op`)."""
        def fn(t, empty):
            t = t.clone()
            dist.all_reduce(t, op=op, group=self.pg)
            return t
        return self._run("all_reduce", x, fn)

    def broadcast(self, x: torch.Tensor, src_index: int = 0):
        """A new tensor: the group member `src_index`'s x."""
        def fn(t, empty):
            t = t.clone()
            dist.broadcast(t, self.ranks[src_index], group=self.pg)
            return t
        return self._run("broadcast", x, fn)

    def all_gather(self, x: torch.Tensor, axis: int = 0):
        """The members' x concatenated along `axis`, in index order (a
        contiguous tensor: the kernels take their operands so)."""
        xm = x.movedim(axis, 0).contiguous()

        def fn(t, empty):
            out = empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
            _all_gather_tensor(out, t, self.pg)
            return out
        return self._run("all_gather", xm, fn).movedim(0, axis).contiguous()

    def reduce_scatter(self, x: torch.Tensor, axis: int = 0):
        """x summed over the group, this member's `axis` slice kept."""
        if x.shape[axis] % self.size:
            raise ValueError(f"reduce-scatter of dim {x.shape[axis]} over "
                             f"{self.size} ranks")
        xm = x.movedim(axis, 0).contiguous()

        def fn(t, empty):
            out = empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))
            _reduce_scatter_tensor(out, t, self.pg)
            return out
        return self._run("reduce_scatter", xm, fn).movedim(0, axis) \
            .contiguous()

    def all_to_all(self, x: torch.Tensor):
        """x (size, ...): block j goes to member j; returns (size, ...)
        with block s from member s."""
        if x.shape[0] != self.size:
            raise ValueError(f"all-to-all of {x.shape[0]} blocks over "
                             f"{self.size} ranks")

        def fn(t, empty):
            out = empty(t.shape)
            dist.all_to_all_single(out, t, group=self.pg)
            return out
        return self._run("all_to_all", x, fn)


def _local_group(device) -> Group:
    return Group(None, (0,), 0, "none", torch.device(device))


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (dp, tp) mesh: its coordinates, the world
    group, its tp group (the ranks of its dp index) and its dp group (the
    ranks of its tp index).  `Mesh.local(device)` is the one-rank mesh:
    no process group, every collective an identity."""
    dp: int
    tp: int
    rank: int
    backend: str
    device: torch.device
    world: Group
    tp_group: Group
    dp_group: Group

    @classmethod
    def local(cls, device="cpu") -> "Mesh":
        g = _local_group(device)
        return cls(1, 1, 0, "none", torch.device(device), g, g, g)

    @classmethod
    def at(cls, dp: int, tp: int, rank: int, device="cpu") -> "Mesh":
        """A rank's coordinates on a (dp, tp) mesh with no process group:
        for laying out and cutting its shards (`sharding.shard`), never
        for a collective."""
        g = _local_group(device)
        return cls(dp, tp, rank, "none", torch.device(device), g, g, g)

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per collective: calls, bytes, bytes staged through the host,
        host seconds (every group of the mesh counts here)."""
        return self.world.stats

    def describe(self) -> str:
        """One line: the mesh, the backend, and which collectives run on
        the device's tensors and which through host buffers."""
        staged = sorted(self.world.staged)
        native = [c for c in COLLECTIVES if c not in staged]
        return (f"mesh (dp={self.dp}, tp={self.tp}) rank {self.rank} "
                f"backend={self.backend} device={self.device} "
                f"on_device={','.join(native)} "
                f"via_host={','.join(staged) or '-'}")

    def agree(self, value: float) -> float:
        """Rank 0's `value` on every rank (a broadcast over the world):
        how host decisions keyed by a clock stay in lockstep."""
        if self.size == 1:
            return value
        t = torch.full((1,), value, dtype=torch.float64, device=self.device)
        return float(self.world.broadcast(t)[0])


def comm_backend(device, local_ranks: int) -> str:
    """The backend for `local_ranks` ranks of this host on `device`: NCCL
    where each has its own card, else gloo (the CPU, or ranks sharing a
    card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_ranks else "gloo"


def init_distributed(rank: int, world_size: int, *, init_method: str,
                     backend: str, timeout_s: float = DEFAULT_TIMEOUT_S):
    """`torch.distributed.init_process_group` with an explicit address
    (``tcp://localhost:<port>``, ``file://<path>`` or ``env://``), world
    size, rank and timeout."""
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_local_mesh(dp: int = 1, tp: int = 1, *, device="cpu",
                    backend: Optional[str] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's (dp, tp) mesh.  At dp * tp == 1 without an initialized
    process group it is `Mesh.local(device)`; otherwise the default group
    must be initialized (`init_distributed`) with world size dp * tp,
    and its backend is the mesh's unless `backend` names another for the
    axis groups.  Every rank builds every group, in the same order."""
    device = torch.device(device)
    n = dp * tp
    if n == 1 and not dist.is_initialized():
        return Mesh.local(device)
    if not dist.is_initialized():
        raise RuntimeError(f"a (dp={dp}, tp={tp}) mesh needs "
                           f"torch.distributed initialized with {n} ranks "
                           f"(launch.mesh.init_distributed)")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh (dp={dp}, tp={tp}) needs {n} ranks; the "
                         f"world has {dist.get_world_size()}")
    backend = backend or dist.get_backend()
    rank = dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)

    def group(ranks: List[int]) -> Tuple[object, Tuple[int, ...]]:
        return dist.new_group(ranks, timeout=timeout, backend=backend), \
            tuple(ranks)

    world_pg, world_ranks = group(list(range(n)))
    tp_groups = [group([d * tp + t for t in range(tp)]) for d in range(dp)]
    dp_groups = [group([d * tp + t for d in range(dp)]) for t in range(tp)]
    d, t = rank // tp, rank % tp

    stats: Dict[str, Dict[str, float]] = {}

    def mk(pg_ranks, index):
        return Group(pg_ranks[0], pg_ranks[1], index, backend, device, stats)
    return Mesh(dp, tp, rank, backend, device,
                mk((world_pg, world_ranks), rank), mk(tp_groups[d], t),
                mk(dp_groups[t], d))


def rank_device(device, rank: int) -> torch.device:
    """The device a rank works on: its own card under NCCL (the local
    rank's), the shared card(s) under gloo, the CPU as asked."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _rank_main(rank: int, world: int, init_method: str, dp: int, tp: int,
               device: str, backend: str, timeout_s: float, fn: Callable,
               args: tuple):
    init_distributed(rank, world, init_method=init_method, backend=backend,
                     timeout_s=timeout_s)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:           # the ranks share the host's cores
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    quiet = open(os.devnull, "w") if rank else None
    try:
        with contextlib.redirect_stdout(quiet) if quiet \
                else contextlib.nullcontext():
            fn(make_local_mesh(dp, tp, device=dev, timeout_s=timeout_s),
               *args)
    finally:
        dist.destroy_process_group()
        if quiet:
            quiet.close()


def run_ranks(fn: Callable, dp: int, tp: int, device, *args,
              timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on every rank of a (dp, tp) mesh; rank 0's
    standard output is the run's.  One rank: in this process, no process
    group.  Under torchrun (RANK and WORLD_SIZE set) this process is one
    rank and joins the others through torchrun's environment.  Otherwise
    it starts dp * tp processes (`torch.multiprocessing` spawn) that meet
    at a file store in a fresh temporary directory and waits for them;
    the backend is `comm_backend` (NCCL with a card per rank, else
    gloo).  `fn` must be importable by the spawned processes."""
    n = dp * tp
    device = torch.device(device)
    if n == 1:
        return fn(make_local_mesh(1, 1, device=device), *args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"ranks for a (dp={dp}, tp={tp}) mesh")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        _rank_main(int(os.environ["RANK"]), n, "env://", dp, tp,
                   str(device), comm_backend(device, local), timeout_s, fn,
                   args)
        return None
    import torch.multiprocessing as mp
    backend = comm_backend(device, n)
    print(f"[mesh] starting {n} ranks (dp={dp}, tp={tp}) on {device} over "
          f"{backend}", flush=True)
    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=n, join=True,
                 args=(n, f"file://{tmp}/store", dp, tp, str(device),
                       backend, timeout_s, fn, args))
    return None
