"""Mesh axis roles and the manual collectives (counterpart of
`repro.sharding`).

The reference runs every model function inside `shard_map` over a (dp,
tp) mesh: each function sees its *local* shards and calls the
collectives below by role.  Here each rank is a process
(`launch.mesh`), the tensors are the rank's shards, and each collective
acts on a `torch.distributed` group of the mesh.

Axis roles:
  dp  data parallelism: batch rows sharded; FSDP (ZeRO-3) reuses the dp
      axis for parameter storage, gathered at use (`gather_fsdp`);
  tp  tensor parallelism: heads / ff / vocab / experts sharded; sequence
      parallelism (SP) reuses it for the activations between blocks
      (`sp_gather`, `sp_scatter`), and expert parallelism (EP) for the
      token exchange of the "ep" MoE dispatch (`all_to_all_tp`).

Gradients follow the transposes the reference's `shard_map` gives with
replication checking off (`check_vma=False`): psum <-> psum, all-gather
<-> reduce-scatter, all-to-all <-> the same all-to-all, and pmax only on
values that carry no gradient.  Every rank seeds the cotangent of its
own copy of the loss, so a raw gradient comes out N = dp * tp times the
true one; `optim.adamw.reduce_replicated_grads` divides N back out.  At
one rank every method is an exact identity and nothing communicates.

The spec helpers mirror the reference's PartitionSpec trees with one
entry per dim: None (whole), "dp" or "tp" (sharded over that axis).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Group, Mesh


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _PSum(torch.autograd.Function):
    """psum; its transpose is psum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along `axis`; its transpose is the
    reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return group.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along `axis`; its transpose is the all-gather."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return group.reduce_scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    """Blocked all-to-all over dim 0; an involution, so its transpose is
    the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all(g), None


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.size == 1 else _PSum.apply(x, group)


def all_gather(x: torch.Tensor, group: Group, axis: int = 0) -> torch.Tensor:
    return x if group.size == 1 else _AllGather.apply(x, group, axis)


def reduce_scatter(x: torch.Tensor, group: Group,
                   axis: int = 0) -> torch.Tensor:
    return x if group.size == 1 else _ReduceScatter.apply(x, group, axis)


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.size == 1 else _AllToAll.apply(x, group)


# ---------------------------------------------------------------------------
# the axis environment
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    """The mesh axes a model function runs under.  Parameters are
    FSDP-sharded over dp wherever dp > 1 (the reference's default) and
    `seq_parallel` shards the boundary activations over tp (off in the
    decode steps, `denv`)."""
    mesh: Mesh
    seq_parallel: bool = True

    @property
    def dp(self) -> int:
        return self.mesh.dp

    @property
    def tp(self) -> int:
        return self.mesh.tp

    # -- indices (Python ints: a rank's coordinates are fixed) ----------------
    def tp_index(self) -> int:
        return self.mesh.tp_index

    def dp_index(self) -> int:
        return self.mesh.dp_index

    # -- collectives ------------------------------------------------------------
    def _map(self, fn, x):
        if isinstance(x, (tuple, list)):
            return type(x)(fn(t) for t in x)
        return fn(x)

    @staticmethod
    def _psum(x, group: Group):
        """psum of a tensor, or of a tuple of tensors of one dtype in one
        collective (each element's sum is the same as alone)."""
        if not isinstance(x, (tuple, list)):
            return psum(x, group)
        if group.size == 1:
            return x
        flat = psum(torch.cat([t.reshape(-1) for t in x]), group)
        parts = flat.split([t.numel() for t in x])
        return type(x)(p.reshape(t.shape) for p, t in zip(parts, x))

    def psum_tp(self, x):
        return self._psum(x, self.mesh.tp_group)

    def psum_dp(self, x):
        return self._psum(x, self.mesh.dp_group)

    def psum_all(self, x):
        return self._psum(x, self.mesh.world)

    def pmax_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Max over tp, of a value that carries no gradient (the
        reference takes it under a stop-gradient)."""
        if self.tp == 1:
            return x
        return self.mesh.tp_group.all_reduce(x.detach(),
                                             op=dist.ReduceOp.MAX)

    def pmin_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Min over tp (no gradient): the reference's -pmax(-x)."""
        if self.tp == 1:
            return x
        return self.mesh.tp_group.all_reduce(x.detach(),
                                             op=dist.ReduceOp.MIN)

    def pmean_dp(self, x):
        return self._map(lambda t: t if self.dp == 1
                         else psum(t, self.mesh.dp_group) / self.dp, x)

    def pmean_all(self, x):
        n = self.dp * self.tp
        return self._map(lambda t: t if n == 1
                         else psum(t, self.mesh.world) / n, x)

    def all_gather_tp(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        return all_gather(x, self.mesh.tp_group, axis)

    def all_to_all_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Blocked all-to-all over tp: x (tp, ...) -> (tp, ...), block s
        the one rank s addressed to this rank (differentiable; the EP
        dispatch's payload goes through `kernels.ops.ep_all_to_all`)."""
        return all_to_all(x, self.mesh.tp_group)

    def scatter_tp(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Reduce-scatter over tp (the transpose of `all_gather_tp`)."""
        return reduce_scatter(x, self.mesh.tp_group, axis)

    # -- FSDP parameter (un)sharding ---------------------------------------------
    def gather_fsdp(self, w: torch.Tensor, axis: int,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """All-gather an FSDP-sharded weight over dp along `axis`.  With
        `dtype` the cast comes BEFORE the gather, so fp32 masters travel
        in the compute dtype and the gradient's reduce-scatter (the
        gather's transpose) runs in it too."""
        if dtype is not None:
            w = w.to(dtype)
        return all_gather(w, self.mesh.dp_group, axis)

    # -- sequence-parallel boundaries ---------------------------------------------
    def sp_gather(self, x_sp: torch.Tensor) -> torch.Tensor:
        """(T_sp, ...) -> (T, ...): gather SP activations before a block."""
        if not self.seq_parallel or self.tp == 1:
            return x_sp
        return all_gather(x_sp, self.mesh.tp_group, 0)

    def sp_scatter(self, partial: torch.Tensor) -> torch.Tensor:
        """(T, ...) partial sums -> (T_sp, ...): combine over tp and
        return to SP (a psum when SP is off)."""
        if not self.seq_parallel or self.tp == 1:
            return self.psum_tp(partial)
        return reduce_scatter(partial, self.mesh.tp_group, 0)


LOCAL = AxisEnv(Mesh.local())


def make_axis_env(mesh: Optional[Mesh] = None, *,
                  seq_parallel: bool = True) -> AxisEnv:
    """The AxisEnv of a mesh built by `launch.mesh.make_local_mesh` (the
    one-rank env without one)."""
    return AxisEnv(mesh if mesh is not None else Mesh.local(),
                   seq_parallel=seq_parallel)


def denv(env: AxisEnv) -> AxisEnv:
    """The decode steps' env: activations replicated over tp (no SP)."""
    if not env.seq_parallel:
        return env
    return dataclasses.replace(env, seq_parallel=False)


# ---------------------------------------------------------------------------
# PartitionSpec helpers for parameter trees
# ---------------------------------------------------------------------------


class P(tuple):
    """A PartitionSpec: one entry per dim, None (whole) or an axis role
    ("dp", "tp")."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def fsdp_spec(env: AxisEnv, ndim: int, fsdp_dim: Optional[int],
              tp_dim: Optional[int] = None) -> P:
    """A weight stored FSDP-sharded over dp (dim `fsdp_dim`) and
    TP-sharded over tp (dim `tp_dim`)."""
    parts: list = [None] * ndim
    if fsdp_dim is not None and env.dp > 1:
        parts[fsdp_dim] = "dp"
    if tp_dim is not None:
        parts[tp_dim] = "tp"
    return P(*parts)


def ep_spec(env: AxisEnv, ndim: int, fsdp_dim: Optional[int],
            expert_dim: int = 0) -> P:
    """An expert-parallel weight: the expert dim over tp (rank r owns
    experts [r*E_loc, (r+1)*E_loc)), one other dim FSDP over dp."""
    return fsdp_spec(env, ndim, fsdp_dim, expert_dim)


def replicated_specs(tree) -> Any:
    """A spec tree replicating every leaf."""
    if isinstance(tree, dict):
        return {k: replicated_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replicated_specs(v) for v in tree]
    return P()


def batch_spec(env: AxisEnv, ndim: int, batch_dim: int = 0) -> P:
    parts: list = [None] * ndim
    parts[batch_dim] = "dp"
    return P(*parts)


def divide(a: int, b: int, what: str = "") -> int:
    if a % b:
        raise ValueError(f"{what or 'dim'}={a} not divisible by {b}")
    return a // b


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def axis_size(env: AxisEnv, part) -> int:
    return {None: 1, "dp": env.dp, "tp": env.tp}[part]


def axis_index(env: AxisEnv, part) -> int:
    return {None: 0, "dp": env.dp_index(), "tp": env.tp_index()}[part]


def local_shape(spec: Sequence, shape: Sequence[int],
                env: AxisEnv) -> tuple:
    """The shard's shape of a global `shape` under `spec` (trailing dims
    past the spec whole)."""
    return tuple(divide(n, axis_size(env, spec[i]) if i < len(spec) else 1,
                        f"dim {i} of {tuple(shape)}")
                 for i, n in enumerate(shape))


def shard(t, spec: Sequence, env: AxisEnv, lead: int = 0):
    """This rank's slice of a global tensor or array under `spec`, whose
    first entry is dim `lead` (the dims before it whole)."""
    for i, part in enumerate(spec):
        n = axis_size(env, part)
        if n == 1:
            continue
        dim = lead + i
        size = divide(t.shape[dim], n, f"dim {dim} of {tuple(t.shape)}")
        j = axis_index(env, part)
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(j * size, (j + 1) * size)
        t = t[tuple(idx)]
    return t


def replication(spec: Sequence, env: AxisEnv) -> int:
    """How many ranks hold identical copies of a leaf under `spec`."""
    covered = 1
    for part in set(spec):
        covered *= axis_size(env, part)
    return env.dp * env.tp // covered
