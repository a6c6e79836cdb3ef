"""K3 / K4: two-pass paged attention — wrappers over the CUDA kernels and
their plain PyTorch versions (counterparts of
`repro.kernels.paged_attn.paged_attn_scores_max` / `paged_attn_accumulate`).

Operands: q (B, KV, g*Q, hd) per-kv-head query groups, g-major (row r is
query r % Q of group head r // Q); k_pool / v_pool (n_pages, ps, KV, hd);
table (B, n_lp) int32 physical page per logical page (0 = the scratch
page, masked); mask (B, Q, n_lp, ps) bool.  Pass 1 returns each row's max
masked score (-inf where nothing is valid); pass 2 takes the caller's
safe max and returns fp32 (num, den) with p = exp(s - m_safe) rounded to
the pool dtype before the PV product and den summing the unrounded p.

The plain versions gather the pages (`pool[table]`) and contract in fp32,
the same math as the gathered path (`layers._paged_scores_combine`).  The
wrappers take them for CPU tensors and launch csrc/paged_attn.cu for CUDA
tensors, raising on anything the kernels do not take.

On the card each pass is one launch that splits every slot's page walk
into runs of `split_pages(ps)` logical pages, one block per (run, kv
head and group of up to 64 query rows, slot); the last block of a (slot,
kv head, row group) combines the runs' partials (max, or num and den in
ascending run order) and resets its ticket.  The tickets and the
partials' scratch are kept per pass, device and stream (`_scratch`), so
calls on one stream run in order and calls on two streams never share
them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

HD_MAX = 128   # csrc/paged_attn.cu limits
PS_MAX = 32
SPLIT_POSITIONS = 64   # positions a block covers, at most

# (pass, device index, stream handle) -> (tickets, partials)
_SCRATCH: Dict[Tuple[str, int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def split_pages(ps: int) -> int:
    """Logical pages per block of the kernels' split page walk."""
    return max(1, SPLIT_POSITIONS // ps)


def n_splits(n_lp: int, ps: int) -> int:
    """Blocks per (slot, kv head): runs of `split_pages(ps)` pages."""
    P = split_pages(ps)
    return max(1, -(-n_lp // P))


def _scratch(name: str, q, stream: int, n_tickets: int, n_part: int):
    """The pass's ticket counters (zero; each launch leaves them zero) and
    fp32 partials on q's device for `stream`, at least n_tickets and
    n_part long: allocated on the pass's first call on the stream, and
    again only to grow.  Launches on one stream are ordered, so the next
    call finds both free; another stream gets buffers of its own."""
    key = (name, q.get_device(), stream)
    s = _SCRATCH.get(key)
    if s is None or s[0].numel() < n_tickets or s[1].numel() < n_part:
        tickets, part = s if s is not None else (None, None)
        if tickets is None or tickets.numel() < n_tickets:
            tickets = torch.zeros(max(n_tickets, 256), dtype=torch.int32,
                                  device=q.device)
        if part is None or part.numel() < n_part:
            part = torch.empty(n_part, dtype=torch.float32, device=q.device)
        s = _SCRATCH[key] = (tickets, part)
    return s


def _check_shapes(q, k_pool, table, mask):
    B, KV, GQ, hd = q.shape
    n_pages, ps, KV2, hd2 = k_pool.shape
    if (KV, hd) != (KV2, hd2):
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    n_lp = table.shape[1]
    n_q = mask.shape[1]
    g = GQ // n_q
    if g * n_q != GQ or tuple(mask.shape) != (B, n_q, n_lp, ps):
        raise ValueError(f"q {tuple(q.shape)}, mask {tuple(mask.shape)}, "
                         f"table {tuple(table.shape)}")
    return B, KV, GQ, hd, ps, n_lp, n_q, g


def _scores(q, k_pool, table, mask):
    """Masked fp32 scores (B, KV, GQ, S) and the broadcast mask."""
    B, KV, GQ, hd, ps, n_lp, n_q, g = _check_shapes(q, k_pool, table, mask)
    S = n_lp * ps
    kg = k_pool[table.long()].reshape(B, S, KV, hd)
    s = torch.einsum("bkrd,bskd->bkrs", q.float(), kg.float()) * hd ** -0.5
    mskg = mask.reshape(B, 1, 1, n_q, S).expand(B, KV, g, n_q, S) \
               .reshape(B, KV, GQ, S)
    return torch.where(mskg, s, float("-inf")), mskg


def paged_attn_scores_max_ref(q, k_pool, table, mask):
    """Plain version of K3."""
    s, _ = _scores(q, k_pool, table, mask)
    return s.amax(dim=-1)


def paged_attn_accumulate_ref(q, k_pool, v_pool, table, mask, m_safe):
    """Plain version of K4."""
    B, KV, GQ, hd, ps, n_lp, _, _ = _check_shapes(q, k_pool, table, mask)
    s, mskg = _scores(q, k_pool, table, mask)
    p = torch.where(mskg, torch.exp(s - m_safe[..., None]), 0.0)
    vg = v_pool[table.long()].reshape(B, n_lp * ps, KV, hd)
    num = torch.einsum("bkrs,bskd->bkrd", p.to(v_pool.dtype).float(),
                       vg.float())
    return num, p.sum(dim=-1)


def _cuda_operands(q, pools, table, mask):
    """Validate and prepare the operands both kernels share."""
    B, KV, GQ, hd, ps, n_lp, n_q, _ = _check_shapes(q, pools[0], table,
                                                    mask)
    if not q.is_cuda:
        raise ValueError(f"paged attention: unsupported device {q.device}")
    for t in (q,) + tuple(pools):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("paged attention kernels take contiguous bf16 "
                             f"q and pools, got {t.dtype}")
    if hd > HD_MAX or ps > PS_MAX:
        raise ValueError(f"paged attention kernels take head_dim <= "
                         f"{HD_MAX} and page_size <= {PS_MAX}; got {hd}, "
                         f"{ps}")
    if table.dtype != torch.int32 or not table.is_contiguous():
        table = table.to(torch.int32).contiguous()
    if mask.dtype != torch.bool or not mask.is_contiguous():
        mask = mask.to(torch.bool).contiguous()
    dims = (B, KV, GQ, hd, ps, n_lp, n_q, split_pages(ps), hd ** -0.5)
    return table, mask, dims, torch.cuda.current_stream(q.device).cuda_stream


def paged_attn_scores_max(q, k_pool, table, mask):
    """K3.  CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if q.device.type == "cpu":
        return paged_attn_scores_max_ref(q, k_pool, table, mask)
    table, mask, dims, stream = _cuda_operands(q, (k_pool,), table, mask)
    B, KV, GQ, _, ps, n_lp = dims[:6]
    m = torch.empty((B, KV, GQ), dtype=torch.float32, device=q.device)
    tickets, part = _scratch("scores_max", q, stream, B * KV * GQ,
                             n_splits(n_lp, ps) * 2 * B * KV * GQ)
    err = build.entry("paged_attn_scores_max")(
        q.data_ptr(), k_pool.data_ptr(), table.data_ptr(), mask.data_ptr(),
        m.data_ptr(), part.data_ptr(), tickets.data_ptr(), *dims, stream)
    build.check(err, "paged_attn_scores_max")
    build.LAUNCHES["paged_attn_scores_max"] += 1
    return m


def paged_attn_accumulate(q, k_pool, v_pool, table, mask, m_safe):
    """K4.  CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if q.device.type == "cpu":
        return paged_attn_accumulate_ref(q, k_pool, v_pool, table, mask,
                                         m_safe)
    table, mask, dims, stream = _cuda_operands(q, (k_pool, v_pool), table,
                                               mask)
    B, KV, GQ, hd = dims[:4]
    if v_pool.shape != k_pool.shape or m_safe.shape != (B, KV, GQ):
        raise ValueError(f"v_pool {tuple(v_pool.shape)}, m_safe "
                         f"{tuple(m_safe.shape)}")
    if m_safe.dtype != torch.float32 or not m_safe.is_contiguous():
        m_safe = m_safe.to(torch.float32).contiguous()
    ps, n_lp = dims[4:6]
    R = B * KV * GQ
    num = torch.empty((B, KV, GQ, hd), dtype=torch.float32, device=q.device)
    den = torch.empty((B, KV, GQ), dtype=torch.float32, device=q.device)
    tickets, part = _scratch("accumulate", q, stream, R,
                             n_splits(n_lp, ps) * R * (hd + 2))
    err = build.entry("paged_attn_accumulate")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        mask.data_ptr(), m_safe.data_ptr(), num.data_ptr(), den.data_ptr(),
        part.data_ptr(), tickets.data_ptr(), *dims, stream)
    build.check(err, "paged_attn_accumulate")
    build.LAUNCHES["paged_attn_accumulate"] += 1
    return num, den
