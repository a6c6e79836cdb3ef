"""The grouped-matmul kernels — wrappers over the CUDA kernels and their
plain PyTorch versions (counterpart of `repro.kernels.grouped_matmul`):

  K1 `fused_moe_ffn`           csrc/fused_moe_ffn.cu, the MoE forward;
  K2 `grouped_matmul_aligned`  csrc/grouped_matmul.cu, the row-ragged
                               products of the MoE backward;
  `grouped_matmul_wgrad`       csrc/grouped_matmul.cu, their weight
                               gradient (no TPU kernel: the reference
                               leaves the transpose of ragged_dot to XLA).

K2 and the weight gradient run bf16 wgmma on the tensor cores; an fp32
operand is cut exactly into three bf16 pieces (`split_bf16` is that
arithmetic in PyTorch, for the tests), so their results equal fp32
products up to summation order.

K1 runs bf16 wgmma too, on one of two paths chosen from the static
shapes (`k1_path`): weight streaming for a few rows per expert, 128-row
tensor-core tiles for training batches.

K1's operands follow the reference's expert-aligned layout
(`kernels.ops._fused_layout`): x (T, d) unsorted activations; w1/w3
(G, d, ff) and w2 (G, ff, d); row_idx (n_m, bm) int32 token per padded
row; gates (n_m, bm) fp32 router weight per row, 0 for padding;
tile_group (n_m,) int32 expert per row tile, G for all-padding tiles.
The result is (T, d) fp32: sum over rows of gate * FFN_e(x[row_idx]).

Every wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors, raising on anything the kernel does not take.
Never a fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

GATED_ACTS = ("swiglu", "geglu")
_ACT_IDS = {"swiglu": 0, "geglu": 1, "gelu": 2, "squared_relu": 3}
# K1's weight-streaming path takes layouts of at most this many routed rows
# per expert (cap / G); above it, the tensor-core path.  32 is the
# streaming kernel's narrow side (wgmma N): at or below it most tiles need
# one pass over their expert's weights.
K1_STREAM_MAX_ROWS = 32


def apply_act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The reference's activations, op for op in x's dtype
    (jax.nn.silu = x * sigmoid(x); jax.nn.gelu uses the tanh form with
    its constants rounded to x's dtype, as JAX's weak typing does)."""
    if name == "swiglu":
        return x * torch.sigmoid(x)
    if name in ("geglu", "gelu"):
        c = torch.tensor([0.7978845608028654, 0.044715], dtype=x.dtype,
                         device=x.device)
        cdf = 0.5 * (1.0 + torch.tanh(c[0] * (x + c[1] * (x * x * x))))
        return x * cdf
    if name == "squared_relu":
        r = torch.relu(x)
        return r * r
    raise ValueError(name)


def fused_moe_ffn_ref(x, w1, w2, w3, row_idx, gates, tile_group, *,
                      act: str = "swiglu") -> torch.Tensor:
    """Plain version of K1: fp32 operands, fp32 hidden, per-expert
    products, and a gated combine that adds rows in ascending row order
    (on the CPU; `index_add_` on CUDA uses atomics)."""
    T, d = x.shape
    G = w1.shape[0]
    n_m, bm = row_idx.shape
    tok = row_idx.reshape(-1).long()
    gate = gates.reshape(-1).float()
    expert = tile_group.long().repeat_interleave(bm)
    live = (gate != 0) & (expert < G)
    xs = x.float()
    y = torch.zeros((n_m * bm, d), dtype=torch.float32, device=x.device)
    for e in range(G):
        sel = torch.nonzero(live & (expert == e)).squeeze(1)
        if sel.numel() == 0:
            continue
        xe = xs[tok[sel]]
        h = apply_act(act, xe @ w1[e].float())
        if w3 is not None:
            h = h * (xe @ w3[e].float())
        y[sel] = (h @ w2[e].float()) * gate[sel, None]
    rows = torch.nonzero(live).squeeze(1)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    return out.index_add_(0, tok[rows], y[rows])


def k1_rows_per_expert(n_m: int, bm: int, G: int) -> float:
    """cap / G of a K1 layout, read off its static shape: the layout pads
    cap rows to M_pad = n_m * bm = round_up(cap + G (bm - 1), bm), so this
    is cap / G rounded up by less than bm / G (an upper bound)."""
    return (n_m * bm - G * (bm - 1)) / G


def k1_path(n_m: int, bm: int, G: int) -> str:
    """K1's kernels for a layout of n_m tiles of bm rows over G experts:
    "stream" (the weights stream through swap-AB wgmma, for a few rows per
    expert: decode ticks, prefill chunks) or "tensor_cores" (128-row wgmma
    tiles, for training batches).  Static shapes only: nothing is read
    from the device."""
    if k1_rows_per_expert(n_m, bm, G) <= K1_STREAM_MAX_ROWS:
        return "stream"
    return "tensor_cores"


def _k1_launch(x, w1, w2, w3, row_idx, gates, tile_group, act):
    """Checks K1's CUDA operands and prepares its launch: (out, the C
    entry's arguments, the tensors they point into).  Allocation
    only: the combine's index arrays are computed by the C entry's own
    launches."""
    T, d = x.shape
    G, _, ff = w1.shape
    n_m, bm = row_idx.shape
    gated = act in GATED_ACTS
    if gated != (w3 is not None):
        raise ValueError(f"act={act!r} needs w3 iff it is gated")
    weights = (w1, w2) + ((w3,) if gated else ())
    for name, t in (("x", x),) + tuple(zip(("w1", "w2", "w3"), weights)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"fused_moe_ffn: {name} must be contiguous "
                             f"bf16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_moe_ffn: {name} must be 16-byte "
                             f"aligned")
    if (w1.shape[1] != d or w2.shape != (G, ff, d)
            or (w3 is not None and w3.shape != w1.shape) or d % 8 or ff % 8):
        raise ValueError(f"fused_moe_ffn: w1 {tuple(w1.shape)} / w2 "
                         f"{tuple(w2.shape)}: shapes must agree and d and "
                         f"ff be multiples of 8")
    row_idx = row_idx.to(torch.int32).contiguous()
    gates = gates.to(torch.float32).contiguous()
    tile_group = tile_group.to(torch.int32).contiguous()
    if gates.shape != (n_m, bm) or tile_group.shape != (n_m,):
        raise ValueError(f"fused_moe_ffn: row_idx {(n_m, bm)}, gates "
                         f"{tuple(gates.shape)}, tile_group "
                         f"{tuple(tile_group.shape)} must agree")
    rows = n_m * bm
    # scratch: h and y (fp32), the combine's index arrays (int32)
    hy = torch.empty(rows * (ff + d), dtype=torch.float32, device=x.device)
    idx = torch.empty(3 * T + 2 * rows, dtype=torch.int32, device=x.device)
    out = torch.empty((T, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    c_args = tuple(ptr(t) for t in (x, w1, w3, w2, row_idx, gates,
                                    tile_group, idx)) + (
        hy.data_ptr(), hy.data_ptr() + rows * ff * 4, out.data_ptr(),
        T, d, ff, G, n_m, bm, _ACT_IDS[act], int(gated),
        int(k1_path(n_m, bm, G) == "stream"), stream)
    # the tensors the pointers name, for a caller that keeps c_args
    held = (x, w1, w2, w3, row_idx, gates, tile_group, hy, idx)
    return out, c_args, held


def fused_moe_ffn(x, w1, w2, w3, row_idx, gates, tile_group, *,
                  act: str = "swiglu") -> torch.Tensor:
    """K1.  CPU tensors: the plain version.  CUDA tensors: the kernels of
    `k1_path`'s path (x and the weights bf16, 16-byte aligned, d and ff
    multiples of 8)."""
    if x.device.type == "cpu":
        return fused_moe_ffn_ref(x, w1, w2, w3, row_idx, gates, tile_group,
                                 act=act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_moe_ffn: unsupported device {x.device}")
    out, c_args, _ = _k1_launch(x, w1, w2, w3, row_idx, gates, tile_group,
                                act)
    build.check(build.entry("fused_moe_ffn")(*c_args), "fused_moe_ffn")
    build.LAUNCHES["fused_moe_ffn"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: grouped matmul over group-aligned rows, and its weight gradient
# ---------------------------------------------------------------------------


def grouped_matmul_aligned_ref(lhs, rhs, tile_group, *, bm: int,
                               trans_b: bool = False) -> torch.Tensor:
    """Plain version of K2: lhs (M_pad, K) group-aligned; rhs (G, K, N), or
    (G, N, K) used transposed when `trans_b`; tile_group (M_pad / bm,)
    int32, G for overflow tiles.  Returns (M_pad, N) fp32: each bm-row
    tile times its group's rhs in fp32, overflow tiles 0."""
    M_pad, K = lhs.shape
    G = rhs.shape[0]
    N = rhs.shape[1] if trans_b else rhs.shape[2]
    tiles = lhs.float().reshape(M_pad // bm, bm, K)
    out = torch.zeros((M_pad // bm, bm, N), dtype=torch.float32,
                      device=lhs.device)
    tg = tile_group.long()
    for g in range(G):
        sel = torch.nonzero(tg == g).squeeze(1)
        if sel.numel():
            w = rhs[g].float()
            out[sel] = tiles[sel] @ (w.T if trans_b else w)
    return out.reshape(M_pad, N)


def split_bf16(x: torch.Tensor, n: int = 3):
    """The kernels' split of an fp32 operand, in PyTorch (used by tests):
    n fp32 tensors, each a bf16 value (low 16 bits zero), cut by
    truncation: piece_i = top 16 bits of (x - piece_0 - ... - piece_i-1).
    With n = 3, x = sum of the pieces exactly where |x| >= 2^-110; below
    that the last piece drops bits under 2^-133 (bf16's smallest
    subnormal).  Truncation keeps the first piece finite at fp32's
    maximum; an infinite x gives NaN pieces after the first."""
    pieces, r = [], x.float()
    for _ in range(n):
        p = (r.view(torch.int32) & -65536).view(torch.float32)
        pieces.append(p)
        r = r - p
    return pieces


def _check_cuda(name: str, **tensors):
    for arg, (t, dtypes) in tensors.items():
        if t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous "
                             f"{'/'.join(str(d) for d in dtypes)}, got "
                             f"{t.dtype}")
        if t.data_ptr() % 8:
            raise ValueError(f"{name}: {arg} must be 8-byte aligned")


def grouped_matmul_aligned(lhs, rhs, tile_group, *, bm: int,
                           trans_b: bool = False) -> torch.Tensor:
    """K2.  CPU tensors: the plain version.  CUDA tensors: the kernel
    (lhs fp32 or bf16, rhs bf16; K and N multiples of 4; an fp32 lhs takes
    three bf16 wgmma passes)."""
    if lhs.device.type == "cpu":
        return grouped_matmul_aligned_ref(lhs, rhs, tile_group, bm=bm,
                                          trans_b=trans_b)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul_aligned: unsupported device "
                         f"{lhs.device}")
    M_pad, K = lhs.shape
    G = rhs.shape[0]
    N = rhs.shape[1] if trans_b else rhs.shape[2]
    K_rhs = rhs.shape[2] if trans_b else rhs.shape[1]
    _check_cuda("grouped_matmul_aligned",
                lhs=(lhs, (torch.float32, torch.bfloat16)),
                rhs=(rhs, (torch.bfloat16,)))
    tile_group = tile_group.to(torch.int32).contiguous()
    if (K_rhs != K or M_pad % bm or tile_group.shape != (M_pad // bm,)
            or K % 4 or N % 4):
        raise ValueError(f"grouped_matmul_aligned: lhs {tuple(lhs.shape)}, "
                         f"rhs {tuple(rhs.shape)} (trans_b={trans_b}), bm "
                         f"{bm}, tile_group {tuple(tile_group.shape)}: "
                         f"shapes must agree and K, N be multiples of 4")
    out = torch.empty((M_pad, N), dtype=torch.float32, device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    err = build.entry("grouped_matmul_aligned")(
        lhs.data_ptr(), rhs.data_ptr(), tile_group.data_ptr(),
        out.data_ptr(), M_pad, K, N, G, bm,
        int(lhs.dtype == torch.bfloat16), int(trans_b), stream)
    build.check(err, "grouped_matmul_aligned")
    build.LAUNCHES["grouped_matmul_aligned"] += 1
    return out


def grouped_matmul_wgrad_ref(lhs, rhs, group_sizes, *,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the weight-gradient kernel: lhs (M, K) and rhs
    (M, N) row-sorted by group; returns (G, K, N) with out[g] =
    lhs_rows_g^T rhs_rows_g over group g's rows in fp32, rounded once to
    `out_dtype`; rows past the last group contribute nothing."""
    M, K = lhs.shape
    N = rhs.shape[1]
    G = group_sizes.shape[0]
    out = torch.zeros((G, K, N), dtype=torch.float32, device=lhs.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        end = min(start + n, M)
        if end > start:
            out[g] = lhs[start:end].float().T @ rhs[start:end].float()
        start = end
    return out.to(out_dtype)


def grouped_matmul_wgrad(lhs, rhs, group_sizes, *,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The grouped weight gradient.  CPU tensors: the plain version.  CUDA
    tensors: the kernel (lhs and rhs fp32 or bf16; K and N multiples of
    4), with the group offsets cumulated on the device.  `out_dtype`
    fp32 or bf16: a bf16 result is the fp32 sum rounded once to nearest
    even, what `.to(torch.bfloat16)` of the fp32 result gives."""
    if lhs.device.type == "cpu":
        return grouped_matmul_wgrad_ref(lhs, rhs, group_sizes,
                                        out_dtype=out_dtype)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul_wgrad: unsupported device "
                         f"{lhs.device}")
    M, K = lhs.shape
    N = rhs.shape[1]
    G = group_sizes.shape[0]
    both = (torch.float32, torch.bfloat16)
    _check_cuda("grouped_matmul_wgrad", lhs=(lhs, both), rhs=(rhs, both))
    if rhs.shape[0] != M or K % 4 or N % 4 or out_dtype not in both:
        raise ValueError(f"grouped_matmul_wgrad: lhs {tuple(lhs.shape)}, "
                         f"rhs {tuple(rhs.shape)}, out_dtype {out_dtype}: "
                         f"rows must agree, K, N be multiples of 4 and the "
                         f"output fp32 or bf16")
    sizes = group_sizes.to(torch.int32).contiguous()
    offsets = (torch.cumsum(group_sizes.long(), 0) - group_sizes.long()) \
        .to(torch.int32)
    out = torch.empty((G, K, N), dtype=out_dtype, device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    err = build.entry("grouped_matmul_wgrad")(
        lhs.data_ptr(), rhs.data_ptr(), offsets.data_ptr(), sizes.data_ptr(),
        out.data_ptr(), M, K, N, G, int(lhs.dtype == torch.bfloat16),
        int(rhs.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        stream)
    build.check(err, "grouped_matmul_wgrad")
    build.LAUNCHES["grouped_matmul_wgrad"] += 1
    return out
