"""The port's kernels: plain versions of K1 (fused MoE FFN) and K3/K4
(two-pass paged attention) against the JAX package's Pallas kernels run
in interpret mode, on the same numpy-made inputs; and, on a CUDA card
only, the CUDA kernels against the plain versions.

Tolerances: K1 and K3 compute fp32 products of bf16 operands in both
packages, so they differ only in fp32 summation order (1e-5 relative to
the largest value).  K4 rounds p to bf16 before the PV product: where a
score differs in its last fp32 bit, one p may round one bf16 ulp (2^-8)
the other way, so num also gets 2^-8 * max|v|.

The card-only tests import no JAX, so the file also runs where only
the port's dependencies are installed (`-m cuda` on the card)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attn as pa
from repro_torch.models import layers as TL
from torch_helpers import Elsewhere


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ACTS = ["swiglu", "geglu", "gelu", "squared_relu"]


def _reference():
    """(jax.numpy, repro.kernels.ops): the JAX package's Pallas wrappers.
    Imported here, not at the top, so the card-only tests need no JAX;
    a reference that fails to import fails the test, it never skips it."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jnp, jops


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16), both rounded to nearest."""
    jnp, _ = _reference()
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)


def _routing(rs, T, k, G, empty=(2,), drop=0):
    """Expert-sorted slots: each token picks k distinct experts outside
    `empty`; returns (tok, gate, group_sizes) with the last `drop` slots
    left out of group_sizes (ragged_dot drops rows past the sum)."""
    allowed = [e for e in range(G) if e not in empty]
    experts = np.stack([rs.choice(allowed, k, replace=False)
                        for _ in range(T)]).reshape(-1)
    order = np.argsort(experts, kind="stable")
    tok = (order // k).astype(np.int32)
    gate = rs.uniform(0.05, 1.0, T * k).astype(np.float32)
    gs = np.bincount(experts[order], minlength=G).astype(np.int32)
    for _ in range(drop):
        gs[np.flatnonzero(gs)[-1]] -= 1
    return tok, gate, gs


def _moe_case(seed, T, act, G=4, k=2, d=64, ff=128, drop=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(T, d).astype(np.float32)
    w1 = (0.1 * rs.randn(G, d, ff)).astype(np.float32)
    w2 = (0.1 * rs.randn(G, ff, d)).astype(np.float32)
    w3 = ((0.1 * rs.randn(G, d, ff)).astype(np.float32)
          if act in gm.GATED_ACTS else None)
    tok, gate, gs = _routing(rs, T, k, G, drop=drop)
    return x, w1, w2, w3, tok, gate, gs


@pytest.mark.parametrize("act,T,drop", [(a, 13, 0) for a in ACTS]
                         + [("swiglu", 70, 0), ("swiglu", 13, 3)])
def test_k1_plain_matches_pallas(act, T, drop):
    """Empty expert 2, ragged groups, T not a multiple of bm (T=13:
    cap=26=bm; T=70: cap=140, bm=128, groups over two tiles), dropped
    tail slots, every activation."""
    jnp, jops = _reference()
    x, w1, w2, w3, tok, gate, gs = _moe_case(T + len(act), T, act,
                                             drop=drop)
    jx, tx = _bf16(x)
    (jw1, tw1), (jw2, tw2) = _bf16(w1), _bf16(w2)
    jw3, tw3 = _bf16(w3) if w3 is not None else (None, None)
    ref = np.asarray(jops.moe_fused_ffn(
        jx, jw1, jw2, jw3, jnp.asarray(tok), jnp.asarray(gate),
        jnp.asarray(gs), act=act, interpret=True))
    out = tops.moe_fused_ffn(tx, tw1, tw2, tw3, torch.tensor(tok),
                             torch.tensor(gate), torch.tensor(gs), act=act)
    assert out.dtype == torch.float32 and out.shape == (T, 64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("T,bm", [(13, 26), (70, 128), (5, 8)])
def test_fused_layout_matches_reference_exactly(T, bm):
    jnp, jops = _reference()
    _, _, _, _, tok, gate, gs = _moe_case(T, T, "swiglu")
    ref = jops._fused_layout(jnp.asarray(tok), jnp.asarray(gate),
                             jnp.asarray(gs), T, bm)
    out = tops._fused_layout(torch.tensor(tok), torch.tensor(gate),
                             torch.tensor(gs), T, bm)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _paged_case(seed, Q, *, B=3, KV=2, g=2, hd=32, ps=8, n_lp=4):
    """Slot 0: a context with unallocated (scratch) logical pages past its
    end; slot 1: inactive (table all 0, every row masked); slot 2: a
    short context.  Physical pages are shuffled."""
    rs = np.random.RandomState(seed)
    n_pages = 1 + B * n_lp
    k_pool = rs.randn(n_pages, ps, KV, hd).astype(np.float32)
    v_pool = rs.randn(n_pages, ps, KV, hd).astype(np.float32)
    ctx = [2 * ps + 3, 0, Q + 1]
    table = np.zeros((B, n_lp), np.int32)
    perm = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // ps)
        table[b, :n] = perm[used:used + n]
        used += n
    pos = np.array([[max(c - Q, 0) + j for j in range(Q)] for c in ctx],
                   np.int32)
    mask = TL.paged_valid_mask(torch.tensor(table), torch.tensor(pos),
                               page_size=ps).numpy()
    q = rs.randn(B, Q, KV * g, hd).astype(np.float32)
    return q, k_pool, v_pool, table, mask


@pytest.mark.parametrize("Q", [1, 8, 3], ids=["decode", "prefill_C",
                                             "verify_k1"])
def test_k3_k4_plain_match_pallas(Q):
    jnp, jops = _reference()
    q, k_pool, v_pool, table, mask = _paged_case(Q, Q)
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k_pool), _bf16(v_pool)
    jt, tt = jnp.asarray(table), torch.tensor(table)
    jm, tm = jnp.asarray(mask), torch.tensor(mask)
    m_ref = np.asarray(jops.paged_attention_scores_max(jq, jk, jt, jm,
                                                       interpret=True))
    m = tops.paged_attention_scores_max(tq, tk, tt, tm).numpy()
    assert m.shape == (3, Q, 4)
    # slot 1 is inactive: every row -inf, in both
    assert np.isneginf(m_ref[1]).all()
    np.testing.assert_array_equal(np.isneginf(m), np.isneginf(m_ref))
    fin = np.isfinite(m_ref)
    np.testing.assert_allclose(m[fin], m_ref[fin], rtol=0,
                               atol=1e-5 * np.abs(m_ref[fin]).max())

    m_safe = np.where(fin, m_ref, 0.0).astype(np.float32)
    num_r, den_r = jops.paged_attention_accumulate(
        jq, jk, jv, jt, jm, jnp.asarray(m_safe), interpret=True)
    num_r, den_r = np.asarray(num_r), np.asarray(den_r)
    num, den = tops.paged_attention_accumulate(tq, tk, tv, tt, tm,
                                               torch.tensor(m_safe))
    num, den = num.numpy(), den.numpy()
    assert (num[1] == 0).all() and (den[1] == 0).all()
    atol = 1e-5 * np.abs(num_r).max() + 2.0 ** -8 * np.abs(v_pool).max()
    np.testing.assert_allclose(num, num_r, rtol=0, atol=atol)
    np.testing.assert_allclose(den, den_r, rtol=0,
                               atol=1e-5 * np.abs(den_r).max())


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    build.reset_launches()
    q, k_pool, v_pool, table, mask = _paged_case(0, 1)
    tq = torch.tensor(q).to(torch.bfloat16)
    tk = torch.tensor(k_pool).to(torch.bfloat16)
    m = tops.paged_attention_scores_max(tq, tk, torch.tensor(table),
                                        torch.tensor(mask))
    assert m.device.type == "cpu"
    assert build.LAUNCHES == {name: 0 for name in build.SIGNATURES}


def test_wrappers_refuse_devices_without_a_kernel():
    x = Elsewhere(4, 64, dtype=torch.bfloat16)
    w = Elsewhere(2, 64, 64, dtype=torch.bfloat16)
    ri = Elsewhere(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        gm.fused_moe_ffn(x, w, w, w, ri, Elsewhere(1, 8),
                         Elsewhere(1, dtype=torch.int32))
    q = Elsewhere(1, 2, 2, 32, dtype=torch.bfloat16)
    pool = Elsewhere(3, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_attn_scores_max(q, pool, Elsewhere(1, 2, dtype=torch.int32),
                                 Elsewhere(1, 1, 2, 8, dtype=torch.bool))


# ---------------------------------------------------------------------------
# on the card: CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
def test_k1_cuda_kernel_matches_plain(act):
    _need_cuda()
    x, w1, w2, w3, tok, gate, gs = _moe_case(1, 70, act)
    dev = lambda a: None if a is None else torch.tensor(a).cuda()
    bf = lambda a: None if a is None else dev(a).to(torch.bfloat16)
    row_idx, gates, tg = tops._fused_layout(dev(tok), dev(gate), dev(gs),
                                            70, 128)
    args = (bf(x), bf(w1), bf(w2), bf(w3), row_idx, gates, tg)
    before = build.LAUNCHES["fused_moe_ffn"]
    out = gm.fused_moe_ffn(*args, act=act)
    assert build.LAUNCHES["fused_moe_ffn"] == before + 1
    ref = gm.fused_moe_ffn_ref(*args, act=act)
    torch.cuda.synchronize()
    tol = 1e-5 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol


# K1's two paths at small widths (`gm.k1_path` picks one from the shapes;
# tests/test_torch_k1_split.py checks which on the CPU): T=70 over 4
# experts top-2 (cap/G ~ 35) takes the tensor cores, T=13 (~6.5) and the
# skewed T=60 (30, expert 0 holding all 60 rows) stream.  d=96 and ff=200
# are no multiples of the 64- and 128-wide tiles (column and contraction
# tails); expert 2 is empty, so some tiles are all padding.
K1_PATH_CASES = {"tensor_cores": 70, "stream": 13}


def _k1_cuda_case(seed, T, act, *, d=96, ff=200, skew=False):
    """(args on the card, bm) for the plain version and the kernels."""
    x, w1, w2, w3, tok, gate, gs = _moe_case(seed, T, act, d=d, ff=ff)
    if skew:   # every token picks expert 0 and one of experts 1 and 3
        rs = np.random.RandomState(seed)
        other = rs.choice([1, 3], T)
        experts = np.stack([np.zeros(T, np.int64), other], 1).reshape(-1)
        order = np.argsort(experts, kind="stable")
        tok = (order // 2).astype(np.int32)
        gs = np.bincount(experts[order], minlength=4).astype(np.int32)
    dev = lambda a: None if a is None else torch.tensor(a).cuda()
    bf = lambda a: None if a is None else dev(a).to(torch.bfloat16)
    bm = min(128, max(8, tok.shape[0]))
    row_idx, gates, tg = tops._fused_layout(dev(tok), dev(gate), dev(gs), T,
                                            bm)
    return (bf(x), bf(w1), bf(w2), bf(w3), row_idx, gates, tg), bm


def _k1_check(args, act):
    before = build.LAUNCHES["fused_moe_ffn"]
    out = gm.fused_moe_ffn(*args, act=act)
    assert build.LAUNCHES["fused_moe_ffn"] == before + 1
    ref = gm.fused_moe_ffn_ref(*args, act=act)
    torch.cuda.synchronize()
    tol = 1e-5 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("path", sorted(K1_PATH_CASES))
def test_k1_cuda_paths_tails_and_padding_tiles(path, act):
    """Each path, every activation, d and ff off the tiles' multiples, an
    all-padding tile, and tiles with fewer live rows than the MMA's narrow
    side (the stream path's N = 32, the tensor cores' 64-row warpgroup
    tiles)."""
    _need_cuda()
    T = K1_PATH_CASES[path]
    args, bm = _k1_cuda_case(2, T, act)
    row_idx, gates, tg = args[4:]
    assert gm.k1_path(row_idx.shape[0], bm, 4) == path
    assert (tg == 4).any()
    live = (gates != 0).sum(1)
    narrow = 32 if path == "stream" else 64
    assert ((live > 0) & (live < narrow)).any()
    _k1_check(args, act)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["swiglu", "squared_relu"])
def test_k1_cuda_stream_tile_over_one_pass(act):
    """A streamed tile with 60 live rows takes two 32-row passes."""
    _need_cuda()
    args, bm = _k1_cuda_case(3, 60, act, skew=True)
    assert gm.k1_path(args[4].shape[0], bm, 4) == "stream"
    assert (args[5] != 0).sum(1).max().item() > 32
    _k1_check(args, act)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(K1_PATH_CASES))
def test_k1_cuda_deterministic(path):
    _need_cuda()
    args, _ = _k1_cuda_case(4, K1_PATH_CASES[path], "geglu")
    a = gm.fused_moe_ffn(*args, act="geglu")
    b = gm.fused_moe_ffn(*args, act="geglu")
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(K1_PATH_CASES))
def test_k1_cuda_non_finite_input_stays_non_finite(path):
    """An inf in one token's row makes that token's output non-finite, as
    in the plain version, and leaves every other token as it was."""
    _need_cuda()
    args, _ = _k1_cuda_case(5, K1_PATH_CASES[path], "swiglu")
    x = args[0].clone()
    x[3, 5] = float("inf")
    args = (x,) + args[1:]
    out = gm.fused_moe_ffn(*args, act="swiglu")
    ref = gm.fused_moe_ffn_ref(*args, act="swiglu")
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    assert not fin[3].any()
    assert torch.equal(torch.isfinite(out), fin)
    tol = 1e-5 * ref[fin].abs().max().item()
    assert (out[fin] - ref[fin]).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 8, 3])
def test_k3_k4_cuda_kernels_match_plain(Q):
    _need_cuda()
    q, k_pool, v_pool, table, mask = _paged_case(Q, Q)
    bf = lambda a: torch.tensor(a).cuda().to(torch.bfloat16)
    tq, tk, tv = bf(q), bf(k_pool), bf(v_pool)
    tt, tm = torch.tensor(table).cuda(), torch.tensor(mask).cuda()
    m = tops.paged_attention_scores_max(tq, tk, tt, tm)
    lay = tops.gqa_layout(4, 2, 4)
    m_ref = pa.paged_attn_scores_max_ref(
        tops._pa_group_q(tq, 2, lay), tk, tt, tm.reshape(3, Q, 4, 8))
    m_ref = tops._pa_ungroup(m_ref, Q, lay)
    assert torch.equal(torch.isinf(m), torch.isinf(m_ref))
    fin = torch.isfinite(m_ref)
    assert (m[fin] - m_ref[fin]).abs().max() <= 1e-5 * m_ref[fin].abs().max()
    m_safe = torch.where(fin, m_ref, 0.0)
    num, den = tops.paged_attention_accumulate(tq, tk, tv, tt, tm, m_safe)
    gq = tops._pa_group_q(tq, 2, lay)
    num_r, den_r = pa.paged_attn_accumulate_ref(
        gq, tk, tv, tt, tm.reshape(3, Q, 4, 8),
        tops._pa_group_q(m_safe[..., None], 2, lay)[..., 0])
    num_r, den_r = tops._pa_ungroup(num_r, Q, lay), tops._pa_ungroup(den_r,
                                                                     Q, lay)
    atol = 1e-5 * num_r.abs().max() + 2.0 ** -8 * tv.float().abs().max()
    assert (num - num_r).abs().max() <= atol
    assert (den - den_r).abs().max() <= 1e-5 * den_r.abs().max()


# Serving shapes (Ling-Lite: 4 KV heads, g = 4, head_dim 128, page 16, 32
# logical pages): decode contexts as chip_smoke.py's, with two inactive
# slots and a full 512-token slot, and a 64-row causal prefill chunk; the
# kernels split each walk into runs of 4 pages, and a kv head's query rows
# into blocks of at most 64 (48 rows: three 16-row tiles in one block; 80:
# a block of four tiles and one of one).  Then shapes off the fast paths:
# head_dim 40 (not a multiple of 16: zero columns), 36 (not of 8: element
# copies) and 30, pages of 12 (runs of 5 pages, 60 positions) and of 5.
PA_SERVING = {
    "decode": dict(Q=1, ctx=[100, 300, 0, 171, 512, 0, 129, 233]),
    "prefill": dict(Q=64, ctx=[192], base=128),
    "verify": dict(Q=4, ctx=[37, 0, 250]),
    "rows48": dict(Q=12, ctx=[77, 0, 300]),
    "rows80": dict(Q=20, ctx=[90, 0, 33]),
    "hd40_ps12": dict(Q=3, ctx=[7, 100, 0], hd=40, ps=12, n_lp=9),
    "hd36_ps5": dict(Q=2, ctx=[41, 3], hd=36, ps=5, n_lp=13),
    "hd30_ps16": dict(Q=5, ctx=[60, 16], hd=30, ps=16, n_lp=5),
}


def _pa_cuda_case(seed, Q, ctx, base=None, KV=4, g=4, hd=128, ps=16,
                  n_lp=32):
    """Grouped operands on the card: (gq, k_pool, v_pool, table, mask4)."""
    rs = np.random.RandomState(seed)
    B = len(ctx)
    n_pages = 1 + B * n_lp
    bf = lambda *s: torch.tensor(rs.randn(*s).astype(np.float32),
                                 device="cuda").to(torch.bfloat16)
    k_pool, v_pool = bf(n_pages, ps, KV, hd), bf(n_pages, ps, KV, hd)
    table = np.zeros((B, n_lp), np.int32)
    perm = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // ps)
        table[b, :n] = perm[used:used + n]
        used += n
    if base is None:
        pos = [[max(c - Q, 0) + j for j in range(Q)] for c in ctx]
    else:
        pos = [[base + j for j in range(Q)] for _ in ctx]
    table = torch.tensor(table, device="cuda")
    mask = TL.paged_valid_mask(table, torch.tensor(pos, device="cuda"),
                               page_size=ps)
    q = bf(B, Q, KV * g, hd)
    return (tops._pa_group_q(q, KV, tops.gqa_layout(KV * g, KV, KV * g)),
            k_pool, v_pool, table,
            mask.reshape(B, Q, n_lp, ps))


def _pa_cuda_check(case):
    """Both kernels against their plain versions, with chip_smoke.py's
    tolerances (check_pa): fp32 summation order for m; for num, also one
    bf16 flip of a p that sits on a rounding boundary."""
    gq, k_pool, v_pool, table, mask4 = case
    m = pa.paged_attn_scores_max(gq, k_pool, table, mask4)
    m_ref = pa.paged_attn_scores_max_ref(gq, k_pool, table, mask4)
    torch.cuda.synchronize()
    inf = torch.isinf(m_ref)
    assert torch.equal(torch.isinf(m), inf)
    fin = ~inf
    if fin.any():
        tol3 = 1e-5 * max(m_ref[fin].abs().max().item(), 1.0)
        assert (m[fin] - m_ref[fin]).abs().max().item() <= tol3
    m_safe = torch.where(fin, m_ref, 0.0)
    num, den = pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask4,
                                        m_safe)
    num_r, den_r = pa.paged_attn_accumulate_ref(gq, k_pool, v_pool, table,
                                                mask4, m_safe)
    torch.cuda.synchronize()
    assert (num[inf] == 0).all() and (den[inf] == 0).all()
    tol4 = (1e-5 * max(num_r.abs().max().item(), den_r.abs().max().item())
            + 2.0 ** -8 * v_pool.float().abs().max().item())
    assert (num - num_r).abs().max().item() <= tol4
    assert (den - den_r).abs().max().item() <= tol4
    return m, m_safe, num, den


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PA_SERVING))
def test_k3_k4_cuda_split_walk_at_serving_shapes(name):
    _need_cuda()
    case = _pa_cuda_case(7, **PA_SERVING[name])
    before = dict(build.LAUNCHES)
    _pa_cuda_check(case)
    assert build.LAUNCHES["paged_attn_scores_max"] == \
        before["paged_attn_scores_max"] + 1
    assert build.LAUNCHES["paged_attn_accumulate"] == \
        before["paged_attn_accumulate"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode", "prefill"])
def test_k3_k4_cuda_are_deterministic(name):
    """Which block of a (slot, kv head) combines varies between calls;
    the splits are added in one order, so the results do not."""
    _need_cuda()
    gq, k_pool, v_pool, table, mask4 = _pa_cuda_case(8, **PA_SERVING[name])
    m1 = pa.paged_attn_scores_max(gq, k_pool, table, mask4)
    m2 = pa.paged_attn_scores_max(gq, k_pool, table, mask4)
    m_safe = torch.where(torch.isfinite(m1), m1, 0.0)
    a = pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask4, m_safe)
    b = pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask4, m_safe)
    torch.cuda.synchronize()
    assert torch.equal(m1, m2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_k3_k4_cuda_streams_keep_their_own_scratch():
    """Two streams running the same passes at once, at the same shapes:
    each takes its own tickets and partials, so each gives its inputs'
    one-stream results bitwise."""
    _need_cuda()
    cases = [_pa_cuda_case(seed, **PA_SERVING["decode"]) for seed in (9, 10)]

    def m_of(case):
        gq, k_pool, _, table, mask4 = case
        return pa.paged_attn_scores_max(gq, k_pool, table, mask4)

    def num_den(case, m):
        gq, k_pool, v_pool, table, mask4 = case
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        return pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask4,
                                        m_safe)

    want = []
    for case in cases:
        m = m_of(case)
        want.append((m,) + tuple(num_den(case, m)))
    streams = [torch.cuda.Stream() for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[] for _ in cases]
    for _ in range(4):                  # each pass issued on both streams
        ms = []
        for s, case in zip(streams, cases):
            with torch.cuda.stream(s):
                ms.append(m_of(case))
        for i, (s, case) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                got[i].append((ms[i],) + tuple(num_den(case, ms[i])))
    torch.cuda.synchronize()
    for w, runs in zip(want, got):
        for g in runs:
            assert all(torch.equal(a, b) for a, b in zip(w, g))
    handles = {key[2] for key in pa._SCRATCH}
    assert all(s.cuda_stream in handles for s in streams)


@pytest.mark.cuda
def test_cuda_kernels_refuse_fp32_operands():
    _need_cuda()
    q = torch.zeros((1, 2, 2, 32), device="cuda")
    pool = torch.zeros((3, 8, 2, 32), device="cuda")
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    mask = torch.zeros((1, 1, 2, 8), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        pa.paged_attn_scores_max(q, pool, table, mask)
