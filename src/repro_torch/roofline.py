"""Three-term roofline on the H100's constants, the hand-written kernels'
cost functions, and the counter the dry run traces a program with
(counterpart of `repro.roofline`):

    compute    = sum over dtypes of FLOPs / that dtype's peak
    memory     = HBM bytes / HBM bandwidth
    collective = sum over mesh axes of ring bytes / that axis' link

Every quantity is one device's: the dry run (`launch.dryrun`) traces one
rank's program, so per-rank counts over one card's rates.  One peak for
every dtype would hide that an fp32 product runs 15x slower than a bf16
one on this card (TF32 stays off, `api.Runner`).

The reference parses compiled HLO, weighting while bodies by their trip
counts and keeping fusion bodies out of the HBM traffic.  Nothing here
parses: PyTorch runs eagerly, so every aten op that is not a view reads
its operands from HBM and writes its result back, and the memory term is
each op's own input and output bytes (an in-place op counts a read and a
write of what it changes).  The layers are a Python loop that the trace
sees each time, so there are no trip counts to weigh.

The hand-written kernels count by their cost functions (`k1_cost` ...),
not by the aten ops of whichever branch of their wrapper ran (the plain
version on the CPU, the launch on a card, the allocation on `meta`): the
same work on every device.  A cost takes the counts the work depends on
(the rows that hold a slot, the experts routed, the live pages, the
valid positions) where a caller reads them from the data; a wrapper sees
only shapes and passes none, and the cost then takes their static upper
bounds and says so (`Cost.bounded`).  `chip_smoke.py`'s bounds come from
the same functions.

This module imports no torch at module level: the constants and the cost
functions are plain arithmetic, and `counter()` builds its dispatch mode
on first use.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import weakref
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

# NVIDIA H100 Tensor Core GPU datasheet, the H100 SXM5 column, dense rates
# (without sparsity), at the card's 700 W limit
BF16_FLOPS = 989e12       # bf16 on the tensor cores
FP32_FLOPS = 67e12        # fp32 on the CUDA cores (TF32 off)
FP64_FLOPS = 67e12        # fp64 on the tensor cores (the serving router)
HBM_BYTES_S = 3.35e12     # HBM3
HBM_BYTES = 80e9          # device memory
# the same datasheet: NVLink 4 at 900 GB/s a GPU, 450 GB/s each way,
# within an 8-GPU node; across nodes one 400 Gb/s NDR InfiniBand port per
# GPU (DGX H100: eight ConnectX-7 ports), 50 GB/s
NVLINK_BYTES_S = 450e9
IB_BYTES_S = 50e9
NODE_GPUS = 8

PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS,
              "float64": FP64_FLOPS}

# the port's collectives (`launch.mesh.Group`) under the reference's HLO
# names; a broadcast moves its operand once a member, as the reference's
# collective-permute
COLLECTIVE_KINDS = {"all_gather": "all-gather",
                    "reduce_scatter": "reduce-scatter",
                    "all_reduce": "all-reduce", "all_to_all": "all-to-all",
                    "broadcast": "collective-permute"}

DECAY_RANK = 32           # csrc/rwkv_decay.cu: the decay LoRA's rank


def peak_flops(dtype: str) -> float:
    if dtype not in PEAK_FLOPS:
        raise ValueError(f"no H100 peak for {dtype} products: "
                         f"{sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[dtype]


def link_bytes_s(ranks: Iterable[int]) -> float:
    """The link a group of global ranks communicates over: NVLink where
    every member sits in one node of NODE_GPUS (ranks fill nodes in
    order, tp fastest: `launch.mesh`), InfiniBand where it spans nodes."""
    return (NVLINK_BYTES_S if len({r // NODE_GPUS for r in ranks}) == 1
            else IB_BYTES_S)


def _ring_traffic(kind: str, operand_bytes: float, g: int) -> float:
    """Per-device ICI send volume under a ring/bidirectional model."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return operand_bytes * (g - 1)          # shard sent (g-1) times
    if kind == "reduce-scatter":
        return operand_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * operand_bytes * (g - 1) / g
    if kind == "all-to-all":
        return operand_bytes * (g - 1) / g
    return operand_bytes                         # collective-permute


def paged_attn_hbm_bytes(slots: int, n_lp: int, pages_touched: int,
                         page_size: int, kv: int, hd: int,
                         dtype_bytes: int = 2):
    """Analytic per-layer HBM KV traffic of the two paged-attention modes.

    "gathered" (`ops.paged_gather`) materializes each slot's FULL
    table-width view: K and V each read `slots * n_lp * page_size` cache
    rows from the pool AND write them back as the gathered intermediate
    — O(B * S_g) regardless of how many pages are actually allocated.
    "fused" (`kernels/paged_attn.py`) streams only the physical pages the
    tables reference: K twice (max pass + accumulate pass) and V once
    (accumulate pass only) — O(pages touched), independent of table
    width.  Returns (gathered_bytes, fused_bytes).
    """
    row = kv * hd * dtype_bytes
    s_g = n_lp * page_size
    gathered = 2 * 2 * slots * s_g * row      # k+v, pool read + view write
    fused = sum(page_bytes(pages_touched, page_size, kv, hd, dtype_bytes,
                           second_pass=p) for p in (False, True))
    return gathered, fused


def page_bytes(pages: int, ps: int, kv: int, hd: int, itemsize: int, *,
               second_pass: bool) -> int:
    """The pool bytes a K3 pass (K of each page) or, with `second_pass`, a
    K4 pass (K and V) streams over `pages` pages: one definition for the
    kernels' costs (`paged_attn_cost`) and `paged_attn_hbm_bytes`."""
    return pages * ps * kv * hd * itemsize * (2 if second_pass else 1)


def fmt_seconds(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.2f}ms"
    return f"{s*1e6:.1f}us"


def model_flops_per_chip(cfg, shape, n_chips: int) -> float:
    """6 N_active D (train) or 2 N_active D (prefill, decode) per chip."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len / n_chips
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len / n_chips
    return 2.0 * n_active * shape.global_batch / n_chips


# ---------------------------------------------------------------------------
# the hand-written kernels' work
# ---------------------------------------------------------------------------


class Cost(NamedTuple):
    """A kernel call's work: operations by the dtype whose peak they run
    at, the bytes it must move (each input read once, each output written
    once), and whether a count the work depends on was a static upper
    bound."""
    flops: Dict[str, float]
    bytes: float
    bounded: bool = False


def bound_ms(cost: Cost) -> Tuple[float, str]:
    """The least time the card could take for `cost`, in ms, and what
    bounds it ("bytes" or "operations")."""
    t_bytes = cost.bytes / HBM_BYTES_S
    t_ops = sum(f / peak_flops(dt) for dt, f in cost.flops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_cost(T: int, d: int, ff: int, G: int, n_m: int, bm: int, *,
            gated: bool = True, x_itemsize: int = 2, w_itemsize: int = 2,
            rows: Optional[int] = None,
            experts: Optional[int] = None) -> Cost:
    """K1 (`fused_moe_ffn`): the weights of the experts routed, x (T, d),
    the layout (row_idx int32 and gates fp32 a padded row, tile_group
    int32 a tile) and the fp32 (T, d) output; 2 d ff operations a product
    (three when gated) for each row that holds a slot.  Static bounds:
    every capacity row held (M_pad - G (bm - 1), the layout's largest
    cap) and min(G, rows) experts."""
    bounded = rows is None or experts is None
    if rows is None:
        rows = max(n_m * bm - G * (bm - 1), 0)
    if experts is None:
        experts = min(G, rows)
    mats = 3 if gated else 2
    w_bytes = experts * mats * d * ff * w_itemsize
    nbytes = (w_bytes + T * d * x_itemsize + n_m * bm * 4 + n_m * bm * 4
              + n_m * 4 + T * d * 4)
    return Cost({"bfloat16": 2 * rows * mats * d * ff}, nbytes, bounded)


def k2_cost(M_pad: int, K: int, N: int, G: int, bm: int, *,
            lhs_itemsize: int, rhs_itemsize: int = 2,
            rows: Optional[int] = None, live_tiles: Optional[int] = None,
            experts: Optional[int] = None) -> Cost:
    """K2 (`grouped_matmul_aligned`): the live tiles' lhs rows, the
    routed groups' (K, N) matrices, the fp32 (M_pad, N) output and
    tile_group; 2 K N operations a row (each held row, at the bf16 rate:
    an fp32 lhs's three passes are the kernel's way to an exact fp32
    product).  Static bounds: every capacity row held (M_pad - G (bm -
    1)), every tile live, min(G, tiles) groups routed."""
    n_tiles = M_pad // bm
    bounded = rows is None or live_tiles is None or experts is None
    if rows is None:
        rows = max(M_pad - G * (bm - 1), 0)
    if live_tiles is None:
        live_tiles = n_tiles
    if experts is None:
        experts = min(G, live_tiles)
    nbytes = (live_tiles * bm * K * lhs_itemsize
              + experts * K * N * rhs_itemsize + M_pad * N * 4
              + n_tiles * 4)
    return Cost({"bfloat16": 2 * rows * K * N}, nbytes, bounded)


def wgrad_cost(M: int, K: int, N: int, G: int, *, lhs_itemsize: int,
               rhs_itemsize: int, out_itemsize: int, sizes_itemsize: int,
               rows: Optional[int] = None) -> Cost:
    """The grouped weight gradient (`grouped_matmul_wgrad`): lhs (M, K),
    rhs (M, N), the group sizes and the (G, K, N) output; 2 K N
    operations a row.  Static bound: all M rows in a group."""
    bounded = rows is None
    if rows is None:
        rows = M
    nbytes = (M * K * lhs_itemsize + M * N * rhs_itemsize
              + G * sizes_itemsize + G * K * N * out_itemsize)
    return Cost({"bfloat16": 2 * rows * K * N}, nbytes, bounded)


def paged_attn_cost(B: int, KV: int, GQ: int, hd: int, ps: int, n_lp: int,
                    Q: int, *, second_pass: bool, q_itemsize: int = 2,
                    pool_itemsize: int = 2, table_itemsize: int = 4,
                    mask_itemsize: int = 1, heads: Optional[int] = None,
                    live_pages: Optional[int] = None,
                    valid: Optional[int] = None) -> Cost:
    """K3 (`paged_attn_scores_max`) and, with `second_pass`, K4
    (`paged_attn_accumulate`): each (slot, kv head) reads the pages that
    hold a valid position (K, and V in pass 2); 2 hd operations a valid
    score (2 hd more a PV term in pass 2) of each of the `heads` query
    heads (every row of the layout by default: a regrouped layout's zero
    rows are no work the function needs); q, the table, the mask, and the
    fp32 outputs (m; or num, den and the m_safe read).  Static bounds:
    every page of the table live, every position valid."""
    bounded = live_pages is None or valid is None
    if live_pages is None:
        live_pages = B * n_lp
    if valid is None:
        valid = B * Q * n_lp * ps
    g = GQ // Q if heads is None else heads / KV
    pool_bytes = page_bytes(live_pages, ps, KV, hd, pool_itemsize,
                            second_pass=second_pass)
    flops = (4 if second_pass else 2) * hd * valid * g * KV
    rows = B * KV * g * Q
    q_bytes = rows * hd * q_itemsize
    out_bytes = rows * 4 * ((hd + 2) if second_pass else 1)
    index_bytes = B * n_lp * table_itemsize + B * Q * n_lp * ps * mask_itemsize
    return Cost({"bfloat16": flops},
                pool_bytes + q_bytes + index_bytes + out_bytes, bounded)


def normhead_cost(T: int, V: int, d: int, *, x_itemsize: int,
                  w_itemsize: int) -> Cost:
    """K5 (`normhead_matmul`): x (T, d), the head (V, d) read once, the
    fp32 (T, V) logits; 2 T V d operations and 2 V d for the rows'
    norms."""
    return Cost({"bfloat16": 2 * T * V * d + 2 * V * d},
                T * d * x_itemsize + V * d * w_itemsize + T * V * 4)


def wkv6_cost(B: int, T: int, H: int, hd: int, *, dtype: str,
              itemsize: int) -> Cost:
    """K6 (`wkv6`): r, k, v in `dtype`, w fp32, u, the fp32 state read and
    written, y in `dtype`; 5 hd^2 operations a (b, t, h), at the rate of
    r's dtype."""
    act = B * T * H * hd
    state = B * H * hd * hd * 4
    nbytes = (3 * act * itemsize + act * 4 + H * hd * 4 + state
              + act * itemsize + state)
    return Cost({dtype: 5 * hd * hd * B * H * T}, nbytes)


def decay_cost(M: int, d: int, n: int, *, x_itemsize: int) -> Cost:
    """rwkv6's decay kernel (`rwkv_decay`): x (M, d), the fp32 LoRA (d,
    32) and (32, n), w0 and the fp32 (M, n) output; 2 M 32 (d + n) fp32
    operations."""
    r = DECAY_RANK
    nbytes = (M * d * x_itemsize + d * r * 4 + r * n * 4 + n * 4
              + M * n * 4)
    return Cost({"float32": 2 * M * r * (d + n)}, nbytes)


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    flops: float                 # per chip
    hbm_bytes: float             # per chip
    collective_bytes: float      # per chip, operand sizes (brief's metric)
    link_bytes: float            # per chip, ring-traffic model (for time)
    compute_s: float
    memory_s: float
    collective_s: float          # sum over axes of link_bytes / their link
    bottleneck: str
    model_flops: float           # 6*N_active*D useful flops per chip
    useful_ratio: float          # model_flops / flops
    collectives: Dict[str, float]
    collective_counts: Dict[str, int]
    flops_by_dtype: Dict[str, float]
    links: Dict[str, float]      # mesh axis -> its link's bytes/s

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline(flops_by_dtype: Dict[str, float], hbm_bytes: float,
             axes: Dict[str, Tuple[int, float, Dict[str, Dict[str, float]]]],
             *, model_flops: float = 0.0) -> Roofline:
    """The three terms from one device's counts.  `axes`: mesh axis ->
    (its group's size, its link's bytes/s, {collective: {"calls",
    "bytes"}} with each call's operand bytes summed)."""
    flops = float(sum(flops_by_dtype.values()))
    coll_bytes: Dict[str, float] = {}
    link_bytes: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    collective_s = 0.0
    for _, (g, link, ops) in sorted(axes.items()):
        for op, s in ops.items():
            kind = COLLECTIVE_KINDS[op]
            ring = _ring_traffic(kind, s["bytes"], g)
            coll_bytes[kind] = coll_bytes.get(kind, 0.0) + s["bytes"]
            link_bytes[kind] = link_bytes.get(kind, 0.0) + ring
            counts[kind] = counts.get(kind, 0) + int(s["calls"])
            collective_s += ring / link
    cs = sum(f / peak_flops(dt) for dt, f in flops_by_dtype.items())
    ms = hbm_bytes / HBM_BYTES_S
    bn = max((("compute", cs), ("memory", ms), ("collective", collective_s)),
             key=lambda kv: kv[1])[0]
    return Roofline(
        flops=flops, hbm_bytes=float(hbm_bytes),
        collective_bytes=float(sum(coll_bytes.values())),
        link_bytes=float(sum(link_bytes.values())), compute_s=cs,
        memory_s=ms, collective_s=collective_s, bottleneck=bn,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0,
        collectives={k: v for k, v in link_bytes.items() if v},
        collective_counts={k: v for k, v in counts.items() if v},
        flops_by_dtype=dict(flops_by_dtype),
        links={a: link for a, (_, link, _) in axes.items()})


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

# the counter the kernel wrappers report to while one is active (`counted`)
ACTIVE = None

# ops that allocate and write nothing
_ALLOC_ONLY = frozenset({"empty", "empty_strided", "empty_like",
                         "new_empty", "new_empty_strided", "empty_permuted"})


def counted(name: str, cost):
    """Decorates a kernel wrapper: while a counter is active the call
    counts as one launch of `name` with `cost(*args, **kwargs)` (a `Cost`
    from the operands' shapes and dtypes), and the wrapper's own aten ops
    count nothing; with none active the call costs one module-global
    read."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            c = ACTIVE
            if c is None:
                return fn(*args, **kwargs)
            return c.kernel(name, cost(*args, **kwargs), fn, args, kwargs)
        return inner
    return wrap


def counter():
    """A new `Counter`: a TorchDispatchMode that, while entered, keeps

      * `flops`: operations by dtype (the output's) of the matmul family,
        through `torch.utils.flop_counter`'s formulas, and the kernels';
      * `bytes`: each non-view op's input and output bytes, and the
        kernels' cost bytes;
      * `live` / `peak`: the bytes of the storages made while it is
        entered and not yet freed (tensors that existed before, such as
        parameters, are arguments and count nothing) and their peak;
      * `kernels`: each kernel wrapper's launches, flops, bytes and
        whether a count was a static bound.

    Entering it makes it `ACTIVE` for the kernel wrappers."""
    return _counter_class()()


@functools.cache
def _counter_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    def tensors(tree):
        return [t for t in tree_flatten(tree)[0]
                if isinstance(t, torch.Tensor)]

    def nbytes(t) -> int:
        return t.numel() * t.element_size()

    def key(t) -> int:
        return t.untyped_storage()._cdata

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops: Dict[str, float] = {}
            self.bytes = 0.0
            self.live = 0
            self.peak = 0
            self.kernels: Dict[str, dict] = {}
            self._hidden = 0
            self._storages: Dict[int, int] = {}
            # re-entrant: a storage's finalizer (`_free`) can run inside
            # `_track`'s locked region, where an allocation starts the
            # garbage collector
            self._lock = threading.RLock()
            self._outer = None

        def __enter__(self):
            global ACTIVE
            self._outer, ACTIVE = ACTIVE, self
            return super().__enter__()

        def __exit__(self, *exc):
            global ACTIVE
            ACTIVE = self._outer
            return super().__exit__(*exc)

        @property
        def launches(self) -> Dict[str, int]:
            return {k: v["launches"] for k, v in self.kernels.items()}

        def _add_flops(self, flops: Dict[str, float]):
            for dt, f in flops.items():
                self.flops[dt] = self.flops.get(dt, 0.0) + f

        def kernel(self, name, cost: Cost, fn, args, kwargs):
            self._hidden += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._hidden -= 1
            rec = self.kernels.setdefault(name, {
                "launches": 0, "flops": {}, "bytes": 0.0, "bounded": False})
            rec["launches"] += 1
            for dt, f in cost.flops.items():
                rec["flops"][dt] = rec["flops"].get(dt, 0.0) + f
            rec["bytes"] += cost.bytes
            rec["bounded"] = rec["bounded"] or cost.bounded
            self._add_flops(cost.flops)
            self.bytes += cost.bytes
            return out

        def _free(self, k: int, n: int):
            with self._lock:
                self._storages.pop(k, None)
                self.live -= n

        def _track(self, ins, outs):
            seen = {key(t) for t in ins}
            for t in outs:
                k = key(t)
                if k in seen or k in self._storages:
                    continue
                st = t.untyped_storage()
                n = st.nbytes()
                with self._lock:
                    self._storages[k] = n
                    self.live += n
                    self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, k, n)
                seen.add(k)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ins, outs = tensors((args, kwargs)), tensors(out)
            self._track(ins, outs)
            if self._hidden or func._overloadpacket.__name__ in _ALLOC_ONLY:
                return out
            written = [a.name for a in func._schema.arguments
                       if a.alias_info is not None and a.alias_info.is_write]
            in_keys = {key(t) for t in ins}
            if not written and outs and all(key(t) in in_keys for t in outs):
                return out                 # a view, or metadata only
            packet = func._overloadpacket
            if packet in flop_registry and outs:
                dt = str(outs[0].dtype).replace("torch.", "")
                self._add_flops({dt: float(flop_registry[packet](
                    *args, **kwargs, out_val=out))})
            moved = sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
            if written:
                # a mutated operand the op does not return is written too
                out_ids = {id(t) for t in outs}
                schema_args = func._schema.arguments
                for i, a in enumerate(schema_args):
                    if a.name not in written:
                        continue
                    v = args[i] if i < len(args) else kwargs.get(a.name)
                    for t in tensors(v):
                        if id(t) not in out_ids:
                            moved += nbytes(t)
            self.bytes += moved
            return out

    return Counter
