"""On the card: the kernels at the shapes padded query heads, padded
experts and rwkv6 over tp give them (chip_smoke.py phase 3's new cases),
against their plain versions.  No JAX here: these tests run only where
`torch.cuda.is_available()` (`-m cuda` on the card) and skip elsewhere;
the regrouped layout's CPU checks against the JAX package are
test_torch_gqa_regroup's.

  * K3/K4 through `ops` (the regrouped query layout, `ops.gqa_layout`)
    at whisper-tiny's 6 heads padded to 8 for tp = 4 (kv head 5 takes
    three) and at granite's heads on a tp = 2 rank, decode and prefill,
    over a rank's in-page offsets;
  * K1, K2 and the weight gradient on a rank whose last local expert is
    a padding expert (an empty group);
  * K5 on granite's 24704-row vocabulary shard at tp = 2;
  * K6 and the decay kernel at rwkv6-3b's 20 local heads.

Tolerances as chip_smoke.py's phase 3 (fp32 summation order): 1e-5 of
the largest for K3; K4 that plus one bf16 flip of p, 2^-8 of the largest
|v|; 1e-4 of the largest output for K1, K2, the weight gradient, K5, K6
and the decay kernel, K6's bf16 y also one ulp of each element (a sum
rounded once)."""
import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.configs.base import get_config
from repro_torch.kernels import build
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import normhead as nh
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as pa
from repro_torch.kernels import rwkv_decay as rd
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _bf(rs, *shape):
    return torch.tensor(rs.randn(*shape).astype(np.float32),
                        device="cuda").to(torch.bfloat16)


# (query heads, kv heads, padded heads, head_dim, tp, rank, Q)
PA_CASES = {
    "whisper tp4 decode": (6, 6, 8, 64, 4, 1, 1),
    "whisper tp4 prefill": (6, 6, 8, 64, 4, 3, 64),
    "granite tp2 decode": (24, 8, 24, 64, 2, 0, 1),
    "granite tp2 prefill": (24, 8, 24, 64, 2, 1, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PA_CASES))
def test_k3_k4_cuda_on_the_regrouped_layout_match_plain(name):
    """K3/K4 through `ops` (the regroup) against their plain versions on
    the same regrouped operands, at a tp rank's in-page offsets (page 16,
    ps_loc = 16 / tp)."""
    _need_cuda()
    H, KV, Hp, hd, tp, rank, Q = PA_CASES[name]
    rs = np.random.RandomState(3)
    env = sharding.make_axis_env(tmesh.Mesh.at(1, tp, rank, device="cuda"))
    B, page, n_lp = (8, 16, 32) if Q == 1 else (1, 16, 12)
    ps = page // tp
    kp, vp = _bf(rs, 1 + B * n_lp, ps, KV, hd), _bf(rs, 1 + B * n_lp, ps,
                                                   KV, hd)
    table = torch.arange(1, 1 + B * n_lp, dtype=torch.int32,
                         device="cuda").reshape(B, n_lp)
    ctx = torch.tensor(rs.randint(Q, n_lp * page, B), device="cuda")
    pos = ctx[:, None] - Q + torch.arange(Q, device="cuda")[None]
    valid = L.paged_valid_mask(table, pos, page_size=page, env=env)
    q = _bf(rs, B, Q, Hp, hd)
    lay = ops.gqa_layout(Hp, KV, H, q.device)
    before = dict(build.LAUNCHES)
    m = ops.paged_attention_scores_max(q, kp, table, valid, lay)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    num, den = ops.paged_attention_accumulate(q, kp, vp, table, valid,
                                              m_safe, lay)
    torch.cuda.synchronize()
    for k in ("paged_attn_scores_max", "paged_attn_accumulate"):
        assert build.LAUNCHES[k] == before[k] + 1
    mask4 = valid.reshape(B, Q, n_lp, ps)
    m_r = ops._pa_ungroup(pa.paged_attn_scores_max_ref(
        ops._pa_group_q(q, KV, lay), kp, table, mask4), Q, lay)
    num_r, den_r = pa.paged_attn_accumulate_ref(
        ops._pa_group_q(q, KV, lay), kp, vp, table, mask4,
        ops._pa_group_q(m_safe, KV, lay))
    num_r, den_r = ops._pa_ungroup(num_r, Q, lay), ops._pa_ungroup(den_r,
                                                                   Q, lay)
    fin = torch.isfinite(m_r)
    assert torch.equal(fin, torch.isfinite(m))
    assert (m[fin] - m_r[fin]).abs().max() <= 1e-5 * max(
        m_r[fin].abs().max().item(), 1.0)
    tol4 = (1e-5 * max(num_r.abs().max().item(), den_r.abs().max().item())
            + 2.0 ** -8 * vp.float().abs().max().item())
    assert (num - num_r).abs().max().item() <= tol4
    assert (den - den_r).abs().max().item() <= tol4


@pytest.mark.cuda
def test_k1_k2_wgrad_cuda_with_an_empty_dummy_expert_match_plain():
    """A tp rank whose last local expert is a padding expert (never
    routed to): granite's d and ff, 20 local experts top-8, expert 19's
    group empty, through K1, K2 and the weight gradient."""
    _need_cuda()
    cfg = get_config("granite-moe-3b-a800m")
    d, ff, G, k, T = cfg.d_model, cfg.moe.expert_d_ff, 20, 8, 64
    rs = np.random.RandomState(4)
    experts = np.stack([rs.choice(G - 1, k, replace=False)
                        for _ in range(T)]).reshape(-1)
    order = np.argsort(experts, kind="stable")
    tok = torch.tensor(order // k, dtype=torch.int32, device="cuda")
    gate = torch.tensor(rs.uniform(0.05, 1, T * k), dtype=torch.float32,
                        device="cuda")
    gs = torch.tensor(np.bincount(experts, minlength=G), device="cuda")
    assert gs[-1].item() == 0
    x = _bf(rs, T, d)
    w1, w3 = _bf(rs, G, d, ff) * 0.05, _bf(rs, G, d, ff) * 0.05
    w2 = _bf(rs, G, ff, d) * 0.05
    y = ops.moe_fused_ffn(x, w1, w2, w3, tok, gate, gs)
    rows, gates, tg = ops._fused_layout(tok, gate, gs, T, 128)
    y_r = gm.fused_moe_ffn_ref(x, w1, w2, w3, rows, gates, tg)
    torch.cuda.synchronize()
    assert (y - y_r).abs().max().item() <= 1e-4 * y_r.abs().max().item()
    xs = x[tok.long()].float()
    out = ops.grouped_matmul(xs, w1, gs)
    lay = ops.align_layout(gs, xs.shape[0], 128)
    out_r = ops._take_rows(gm.grouped_matmul_aligned_ref(
        ops._take_rows(xs, lay.row_map), w1, lay.tile_group, bm=128),
        lay.dest)
    assert (out - out_r).abs().max().item() <= \
        1e-4 * out_r.abs().max().item()
    dy = torch.tensor(rs.randn(T * k, ff).astype(np.float32), device="cuda")
    dw = ops.grouped_matmul_wgrad(xs, dy, gs)
    dw_r = gm.grouped_matmul_wgrad_ref(xs, dy, gs)
    torch.cuda.synchronize()
    assert (dw - dw_r).abs().max().item() <= 1e-4 * dw_r.abs().max().item()
    assert dw[-1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_k5_cuda_on_granites_tp2_shard_matches_plain():
    """K5 on rank 1's 24704 rows of granite's 49408-row head (49155 padded
    to tp * 128 at tp = 2), T = 8."""
    _need_cuda()
    cfg = get_config("granite-moe-3b-a800m")
    rs = np.random.RandomState(6)
    w = torch.tensor(rs.randn(24704, cfg.d_model).astype(np.float32),
                     device="cuda")
    x = _bf(rs, 8, cfg.d_model)
    got = ops.normhead_logits(x, w)
    want = nh.normhead_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert got.shape == (8, 24704)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64])
def test_k6_and_decay_cuda_at_20_local_heads_match_plain(T):
    """rwkv6-3b's 40 heads on a tp = 2 rank: the decay kernel over 1280
    local columns, then K6 over 20 heads of 64, prefill and tick."""
    _need_cuda()
    cfg = get_config("rwkv6-3b")
    d, H, hd, B = cfg.d_model, 20, 64, 8
    rs = np.random.RandomState(7)
    xw = _bf(rs, B * T, d)
    a = torch.tensor(0.02 * rs.randn(d, 32), dtype=torch.float32,
                     device="cuda")
    b = torch.tensor(0.02 * rs.randn(32, H * hd), dtype=torch.float32,
                     device="cuda")
    w0 = torch.full((H * hd,), -6.0, device="cuda")
    w = ops.rwkv_decay(xw, a, b, w0)
    w_r = rd.rwkv_decay_ref(xw, a, b, w0)
    torch.cuda.synchronize()
    assert w.shape == (B * T, H * hd)
    assert (w - w_r).abs().max().item() <= 1e-4 * w_r.abs().max().item()
    r, k, v = (_bf(rs, B, T, H, hd) for _ in range(3))
    u = torch.tensor(0.5 * rs.randn(H, hd), dtype=torch.float32,
                     device="cuda")
    s0 = torch.tensor(0.1 * rs.randn(B, H, hd, hd), dtype=torch.float32,
                      device="cuda")
    wt = w_r.reshape(B, T, H, hd)
    y, s1 = ops.wkv6(r, k, v, wt, u, s0)
    y_r, s1_r = wk.wkv6_ref(r, k, v, wt, u, s0)
    torch.cuda.synchronize()
    y_r = y_r.float()
    ulp = torch.ldexp(torch.ones_like(y_r), torch.frexp(y_r).exponent - 8)
    assert ((y.float() - y_r).abs() - ulp).max().item() <= \
        1e-4 * y_r.abs().max().item()
    assert (s1 - s1_r).abs().max().item() <= 1e-4 * s1_r.abs().max().item()
