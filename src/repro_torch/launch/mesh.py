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
    device): every collective goes through the card's own memory
    (`CardExchange`: each member copies its operand into a device buffer
    the others have opened through CUDA IPC, a barrier through a shared
    file on the host (`HostBarrier`), then each reads the others'
    buffers), gloo carrying only the setup.  Where the buffers cannot be
    shared (a member on another card, no CUDA IPC, no shared temporary
    directory) gloo reduces CUDA tensors (all-reduce, broadcast) itself,
    and the collectives it lacks on CUDA tensors (all-gather,
    reduce-scatter, all-to-all) copy through pinned host buffers.

Which collective takes which path is fixed when the group is built, from
its backend and device (`Group.staged`, `Group.exchange`), and printed
by `describe`.  The card exchange sums in member order, in the
operand's dtype: over two members a + b, the bits gloo gives.
Every group carries a timeout, so a rank whose peers diverged fails in
its own seconds instead of hanging.  A mesh's `stats` count each
collective's calls, its bytes, the bytes staged through the host and
the host seconds spent in it (waits for the peers included).

`Mesh.dry` is one rank of a mesh that communicates with no one, for the
dry run (`launch.dryrun`): its groups have the mesh's sizes and no
process group, and each collective returns a `meta` tensor of its
result's shape and counts in `stats` as a real one would.
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

# the card exchange's buffers: two of at most this many bytes a member
# (calls alternate between them), larger operands go in pieces
EXCHANGE_BYTES = 1 << 27

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


class HostBarrier:
    """A barrier of the processes of one host through a small shared file
    (memory-mapped; each member bumps its own counter and waits until
    every counter has reached its own), in microseconds where a gloo
    barrier takes about a millisecond.  The file is made in the temporary
    directory, mapped by every member, then removed.  A member whose
    peers stop arriving raises after `timeout_s`."""

    SLOT = 8                # int64 counters a member, one cache line apart

    def __init__(self, path: str, index: int, size: int, timeout_s: float):
        import mmap
        import numpy as np
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, 8 * self.SLOT * size)
        finally:
            os.close(fd)
        self._slots = np.frombuffer(self._mm, dtype=np.int64)
        self._mine = self._slots[index * self.SLOT:index * self.SLOT + 1]
        self._all = self._slots[::self.SLOT]
        self.count = 0
        self.timeout_s = timeout_s

    @classmethod
    def connect(cls, pg, index: int, size: int,
                timeout_s: float) -> Optional["HostBarrier"]:
        """The group's barrier, or None where its members cannot share
        the file (all members then agree on None)."""
        path = None
        if index == 0:
            fd, path = tempfile.mkstemp(prefix="host_barrier_")
            os.ftruncate(fd, 8 * cls.SLOT * size)
            os.close(fd)
        got: List[Optional[str]] = [None] * size
        dist.all_gather_object(got, path, group=pg)
        try:
            bar = cls(got[0], index, size, timeout_s)
        except OSError:     # another host, or no shared temporary dir
            bar = None
        flags: List[Optional[bool]] = [None] * size
        dist.all_gather_object(flags, bar is not None, group=pg)
        if index == 0:
            os.remove(path)
        return bar if all(flags) else None

    def wait(self):
        self.count += 1
        self._mine[0] = self.count
        spins, deadline = 0, None
        while (self._all < self.count).any():
            spins += 1
            if spins > 2000:
                time.sleep(20e-6)
                if deadline is None:
                    deadline = time.monotonic() + self.timeout_s
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"host barrier {self.count}: peers "
                                       f"at {self._all.tolist()} after "
                                       f"{self.timeout_s}s")


class CardExchange:
    """The collectives of a group whose members share one card, through
    the card's memory.  Each member holds two device buffers and has
    opened the other members' through CUDA IPC (`torch.multiprocessing`'s
    tensor sharing).  A call copies the operand (in pieces of at most
    EXCHANGE_BYTES) into the member's buffer, waits for its stream, meets
    the others at a `HostBarrier`, and reads every member's piece into a
    new tensor.  Calls alternate between the two buffers: a member
    overwrites one only after the next call's barrier, which every member
    reaches only after its reads of it are done."""

    def __init__(self, pg, index: int, size: int, device: torch.device,
                 barrier: HostBarrier):
        self.pg, self.index, self.size = pg, index, size
        self.device = device
        self.barrier = barrier
        self.cap = 0
        self.bufs: List[List[torch.Tensor]] = []
        self.calls = 0

    @classmethod
    def connect(cls, pg, index: int, size: int, device: torch.device,
                timeout_s: float = DEFAULT_TIMEOUT_S
                ) -> Optional["CardExchange"]:
        """The exchange of a group, or None where its members do not all
        work on `device` or its buffers or barrier cannot be shared.  Each
        step ends with the members' agreement, so that on a failure every
        member returns None at the same point and none waits alone."""
        def agree(ok: bool) -> bool:
            flags: List[Optional[bool]] = [None] * size
            dist.all_gather_object(flags, ok, group=pg)
            return all(flags)
        got: List[Optional[str]] = [None] * size
        dist.all_gather_object(got, str(device), group=pg)
        if len(set(got)) != 1:
            return None
        barrier = HostBarrier.connect(pg, index, size, timeout_s)
        if barrier is None:
            return None
        ex = cls(pg, index, size, device, barrier)
        if not ex._grow(1 << 20):
            return None
        ok = True
        try:
            probe = torch.full((4,), float(index), device=device)
            ok = all(float(v[0]) == j for j, v in
                     enumerate(ex.exchange(probe)))
        except RuntimeError:
            ok = False
        return ex if agree(ok) else None

    def _grow(self, nbytes: int) -> bool:
        """Buffers of at least `nbytes` (every member grows at the same
        call: the operands' sizes agree), shared with the others; False
        on every member where one could not share or open them."""
        from torch.multiprocessing.reductions import reduce_tensor
        cap = min(EXCHANGE_BYTES, 1 << max(nbytes - 1, 1).bit_length())
        try:
            mine = [torch.empty(cap, dtype=torch.uint8, device=self.device)
                    for _ in range(2)]
            shared = [reduce_tensor(b) for b in mine]
        except RuntimeError:    # no CUDA IPC here
            mine, shared = None, None
        got: List[Optional[list]] = [None] * self.size
        dist.all_gather_object(got, shared, group=self.pg)
        bufs = None
        if all(g is not None for g in got):
            try:
                bufs = [[mine[k] if j == self.index else
                         got[j][k][0](*got[j][k][1])
                         for j in range(self.size)] for k in range(2)]
            except RuntimeError:
                bufs = None
        flags: List[Optional[bool]] = [None] * self.size
        dist.all_gather_object(flags, bufs is not None, group=self.pg)
        if not all(flags):
            return False
        self.bufs, self.cap = bufs, cap
        return True

    def exchange(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Every member's 1-d `flat` (at most the buffers' bytes): views
        into their buffers, valid until this member's next call but
        one."""
        nb = flat.numel() * flat.element_size()
        if nb > self.cap and not self._grow(nb):
            raise RuntimeError(f"the card exchange could not grow its "
                               f"buffers to {nb} bytes")
        side = self.bufs[self.calls % 2]
        self.calls += 1
        view = lambda b: b[:nb].view(flat.dtype)
        view(side[self.index]).copy_(flat)
        torch.cuda.current_stream(self.device).synchronize()
        self.barrier.wait()
        return [view(b) for b in side]

    def pieces(self, x: torch.Tensor):
        """(lo, hi, every member's x.flatten()[lo:hi]) for the pieces of
        x that fit the buffers."""
        flat = x.reshape(-1)
        step = max(1, EXCHANGE_BYTES // max(flat.element_size(), 1))
        for lo in range(0, flat.numel(), step):
            hi = min(lo + step, flat.numel())
            yield lo, hi, self.exchange(flat[lo:hi])


def _summed(parts: List[torch.Tensor], op) -> torch.Tensor:
    """The members' parts reduced in member order."""
    acc = parts[0].clone()
    for p in parts[1:]:
        if op == dist.ReduceOp.SUM:
            acc += p
        elif op == dist.ReduceOp.MAX:
            torch.maximum(acc, p, out=acc)
        elif op == dist.ReduceOp.MIN:
            torch.minimum(acc, p, out=acc)
        else:
            raise ValueError(f"the card exchange reduces by SUM, MAX or "
                             f"MIN, not {op}")
    return acc


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
    exchange: Optional[CardExchange] = None
    # a dry group (`Mesh.dry`): no communication; `own` counts this
    # group's collectives apart from the mesh's `stats`
    dry: bool = False
    own: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def staged(self) -> frozenset:
        """The collectives this group copies through pinned host buffers
        when it has no card exchange."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return frozenset(COLLECTIVES) - GLOO_ON_CUDA
        return frozenset()

    def _run(self, op: str, x: torch.Tensor, fn, card=None) -> torch.Tensor:
        """fn(x on the wire, an allocator on the wire) -> result on the
        wire.  A staged op copies x into pinned host memory, runs on
        pinned buffers and copies the result back without waiting (an
        announced drain under the debug sync guards).  With a card
        exchange, `card` = (fill, out_shape) makes the result instead: a
        new tensor of out_shape that fill(out, lo, hi, every member's
        x.flatten()[lo:hi]) fills piece by piece, the waits announced
        too.  A dry group makes an empty `meta` tensor of out_shape."""
        t0 = time.perf_counter()
        staged = op in self.staged and self.exchange is None
        if self.dry:
            out = torch.empty(card[1], dtype=x.dtype, device=x.device)
        elif self.exchange is not None:
            fill, out_shape = card
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
            with contracts.announced_drain():
                for lo, hi, parts in self.exchange.pieces(x):
                    fill(out, lo, hi, parts)
        elif staged:
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
        seconds = time.perf_counter() - t0
        _count(self.stats, op, x, staged, seconds)
        if self.dry:
            _count(self.own, op, x, staged, seconds)
        return out

    def _blocks(self, fill_block, n: int):
        """A card exchange's filler for ops whose result is made of the
        pieces of one block of each member's x (x of `size` blocks of n
        elements): fill_block(out, j, a, b, part) with the elements
        [a, b) of member j's block `self.index`, `part` their values."""
        me = self.index

        def fill(out, lo, hi, parts):
            a, b = max(lo, me * n), min(hi, (me + 1) * n)
            if a < b:
                for j, p in enumerate(parts):
                    fill_block(out.view(-1), j, a - me * n, b - me * n,
                               p[a - lo:b - lo])
        return fill

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM):
        """A new tensor: x reduced over the group (`op`)."""
        def fn(t, empty):
            t = t.clone()
            dist.all_reduce(t, op=op, group=self.pg)
            return t

        def fill(out, lo, hi, parts):
            out.view(-1)[lo:hi] = _summed(parts, op)
        return self._run("all_reduce", x, fn, (fill, x.shape))

    def broadcast(self, x: torch.Tensor, src_index: int = 0):
        """A new tensor: the group member `src_index`'s x."""
        def fn(t, empty):
            t = t.clone()
            dist.broadcast(t, self.ranks[src_index], group=self.pg)
            return t

        def fill(out, lo, hi, parts):
            out.view(-1)[lo:hi] = parts[src_index]
        return self._run("broadcast", x, fn, (fill, x.shape))

    def all_gather(self, x: torch.Tensor, axis: int = 0):
        """The members' x concatenated along `axis`, in index order (a
        contiguous tensor: the kernels take their operands so)."""
        xm = x.movedim(axis, 0).contiguous()

        def fn(t, empty):
            out = empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
            _all_gather_tensor(out, t, self.pg)
            return out

        n = xm.numel()

        def fill(out, lo, hi, parts):
            flat = out.view(-1)
            for j, p in enumerate(parts):
                flat[j * n + lo:j * n + hi] = p
        shape = (self.size * xm.shape[0],) + tuple(xm.shape[1:])
        return self._run("all_gather", xm, fn, (fill, shape)) \
            .movedim(0, axis).contiguous()

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

        n = xm.numel() // self.size
        acc = {}

        def add(flat, j, a, b, part):
            if j == 0:
                acc["sum"] = part.clone()
            else:
                acc["sum"] += part
            if j == self.size - 1:
                flat[a:b] = acc.pop("sum")
        shape = (xm.shape[0] // self.size,) + tuple(xm.shape[1:])
        return self._run("reduce_scatter", xm, fn,
                         (self._blocks(add, n), shape)) \
            .movedim(0, axis).contiguous()

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

        n = x.numel() // self.size

        def put(flat, j, a, b, part):
            flat[j * n + a:j * n + b] = part
        return self._run("all_to_all", x, fn,
                         (self._blocks(put, n), x.shape))


def _count(stats, op: str, x: torch.Tensor, staged: bool, seconds: float):
    """One call of collective `op` on operand x into `stats`."""
    s = stats.setdefault(op, {"calls": 0, "bytes": 0, "host_bytes": 0,
                              "seconds": 0.0})
    nbytes = x.numel() * x.element_size()
    s["calls"] += 1
    s["bytes"] += nbytes
    s["host_bytes"] += nbytes if staged else 0
    s["seconds"] += seconds


def _local_group(device) -> Group:
    return Group(None, (0,), 0, "none", torch.device(device))


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (dp, tp) mesh: its coordinates, the world
    group, its tp group (the ranks of its dp index) and its dp group (the
    ranks of its tp index).  `Mesh.local(device)` is the one-rank mesh:
    no process group, every collective an identity.  Every constructor
    works on the card unless the caller asks for the CPU (device="cpu"),
    as the Runner and the launchers do."""
    dp: int
    tp: int
    rank: int
    backend: str
    device: torch.device
    world: Group
    tp_group: Group
    dp_group: Group

    @classmethod
    def local(cls, device="cuda") -> "Mesh":
        g = _local_group(device)
        return cls(1, 1, 0, "none", torch.device(device), g, g, g)

    @classmethod
    def at(cls, dp: int, tp: int, rank: int, device="cuda") -> "Mesh":
        """A rank's coordinates on a (dp, tp) mesh with no process group:
        for laying out and cutting its shards (`sharding.shard`), never
        for a collective."""
        g = _local_group(device)
        return cls(dp, tp, rank, "none", torch.device(device), g, g, g)

    @classmethod
    def dry(cls, dp: int, tp: int, rank: int = 0) -> "Mesh":
        """Rank `rank` of a (dp, tp) mesh on the `meta` device, with no
        process group: each collective returns an empty `meta` tensor of
        its result's shape and counts its calls and bytes in `stats`
        (and in its group's `own`) through the same bookkeeping as a real
        group's.  For the dry run: shapes, work and traffic, no data."""
        if not 0 <= rank < dp * tp:
            raise ValueError(f"rank {rank} of a (dp={dp}, tp={tp}) mesh")
        d, t = rank // tp, rank % tp
        stats: Dict[str, Dict[str, float]] = {}
        meta = torch.device("meta")

        def group(ranks, index):
            return Group(None, tuple(ranks), index, "dry", meta, stats,
                         dry=True)
        return cls(dp, tp, rank, "dry", meta,
                   group(range(dp * tp), rank),
                   group([d * tp + j for j in range(tp)], t),
                   group([i * tp + t for i in range(dp)], d))

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
        the device's tensors, which through the card's memory and which
        through host buffers."""
        if self.world.exchange is not None:
            return (f"mesh (dp={self.dp}, tp={self.tp}) rank {self.rank} "
                    f"backend={self.backend} device={self.device} "
                    f"via_card={','.join(COLLECTIVES)}")
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


def make_local_mesh(dp: int = 1, tp: int = 1, *, device="cuda",
                    backend: Optional[str] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's (dp, tp) mesh.  At dp * tp == 1 without an initialized
    process group it is `Mesh.local(device)`; otherwise the default group
    must be initialized (`init_distributed`) with world size dp * tp,
    and its backend is the mesh's unless `backend` names another for the
    axis groups.  Every rank builds every group, in the same order.  Under
    gloo on a card, the collectives of groups whose members share the
    card run through its memory (`CardExchange`; groups of the same ranks
    share one, and a group where it cannot be set up stays on gloo)."""
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
    exchanges: Dict[Tuple[int, ...], Optional[CardExchange]] = {}
    use_card = backend == "gloo" and device.type == "cuda"

    def mk(pg_ranks, index):
        pg, ranks = pg_ranks
        g = Group(pg, ranks, index, backend, device, stats)
        if use_card and len(ranks) > 1:
            if ranks not in exchanges:
                exchanges[ranks] = CardExchange.connect(
                    pg, index, len(ranks), device, timeout_s)
            g.exchange = exchanges[ranks]
        return g
    # every rank connects the groups in the same order: the world, then
    # its tp group, then its dp group (the others' calls name other pgs)
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
