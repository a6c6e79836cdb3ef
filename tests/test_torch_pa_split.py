"""K3 / K4's split page walk (kernels/csrc/paged_attn.cu) emulated in plain
PyTorch, in the kernels' order: each slot's logical pages cut into runs
of `paged_attn.split_pages(ps)` pages, a run live when any query of the
slot has a valid position in it, each live run's partial (the rows' max;
num and den) computed alone, and the runs combined as the last block
combines them (the max; num and den added in ascending run order).

The emulation takes the plain version's scores and p, so only the split
and the combine differ from it: pass 1 must equal the plain version
bitwise (the max is order-free), and num / den within fp32 summation
order.  Both are also held to the JAX package's Pallas kernels in
interpret mode, with the tolerances of tests/test_torch_kernels.py: 1e-5
of the largest value, and for num one bf16 flip of a p (2^-8 * max|v|)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attn as pa
from repro_torch.models import layers as TL


def _reference():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jnp, jops


def _runs(mask4):
    """[(pages, live (B,))] per run of the split walk, ascending."""
    n_lp, ps = mask4.shape[2:]
    P = pa.split_pages(ps)
    out = []
    for s in range(pa.n_splits(n_lp, ps)):
        pages = slice(s * P, min((s + 1) * P, n_lp))
        out.append((pages, mask4[:, :, pages].flatten(1).any(1)))
    return out


def emulate_scores_max(gq, k_pool, table, mask4):
    """K3 as the kernel computes it: each live run's max, then the max of
    the runs' maxima (a run with no live page takes no part)."""
    B, KV, GQ, _ = gq.shape
    n_lp, ps = mask4.shape[2:]
    s, _ = pa._scores(gq, k_pool, table, mask4)
    s = s.reshape(B, KV, GQ, n_lp, ps)
    m = torch.full((B, KV, GQ), float("-inf"))
    for pages, live in _runs(mask4):
        part = s[:, :, :, pages].flatten(3).amax(-1)
        m = torch.where(live[:, None, None], torch.maximum(m, part), m)
    return m


def emulate_accumulate(gq, k_pool, v_pool, table, mask4, m_safe):
    """K4 as the kernel computes it: each live run's num (p rounded to the
    pool's dtype) and den, added over the live runs in ascending order."""
    B, KV, GQ, hd = gq.shape
    n_lp, ps = mask4.shape[2:]
    s, mskg = pa._scores(gq, k_pool, table, mask4)
    p = torch.where(mskg, torch.exp(s - m_safe[..., None]), 0.0)
    p = p.reshape(B, KV, GQ, n_lp, ps)
    pb = p.to(v_pool.dtype).float()
    vg = v_pool[table.long()].float()                # (B, n_lp, ps, KV, hd)
    num = torch.zeros((B, KV, GQ, hd))
    den = torch.zeros((B, KV, GQ))
    for pages, live in _runs(mask4):
        n_r = torch.einsum("bkrps,bpskd->bkrd", pb[:, :, :, pages],
                           vg[:, pages])
        d_r = p[:, :, :, pages].flatten(3).sum(-1)
        num = torch.where(live[:, None, None, None], num + n_r, num)
        den = torch.where(live[:, None, None], den + d_r, den)
    return num, den


# ctx: tokens each slot holds after the step (0: inactive, its table on
# the scratch page); ps and n_lp give runs of split_pages(ps) pages with
# n_lp not a multiple of it, and contexts that end mid-page and leave the
# last runs without a live page.
CASES = {
    "decode_ps16": dict(Q=1, ps=16, n_lp=10, ctx=[37, 0, 120, 70]),
    "decode_ps8": dict(Q=1, ps=8, n_lp=11, ctx=[5, 0, 61, 88]),
    "prefill_ps16": dict(Q=8, ps=16, n_lp=9, ctx=[70, 0, 23]),
    "prefill_ps5": dict(Q=8, ps=5, n_lp=14, ctx=[33, 0, 66]),
    "verify_ps16": dict(Q=3, ps=16, n_lp=10, ctx=[100, 0, 19]),
    "verify_ps12": dict(Q=3, ps=12, n_lp=7, ctx=[50, 0, 13]),
}


def _case(seed, Q, ps, n_lp, ctx, KV=2, g=2, hd=32):
    """numpy-made (q (B, Q, Hp, hd), k_pool, v_pool, table, mask (B, Q,
    S)), each page table shuffled over the pool."""
    rs = np.random.RandomState(seed)
    B = len(ctx)
    n_pages = 1 + B * n_lp
    k_pool = rs.randn(n_pages, ps, KV, hd).astype(np.float32)
    v_pool = rs.randn(n_pages, ps, KV, hd).astype(np.float32)
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


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_cases_cover_the_split_walks_edges(name):
    """Each case has an inactive slot, a context that ends mid-page, a run
    with no live page in an active slot, and n_lp off the run length."""
    c = CASES[name]
    q, k_pool, v_pool, table, mask = _case(1, **c)
    B, Q = mask.shape[:2]
    mask4 = torch.tensor(mask).reshape(B, Q, c["n_lp"], c["ps"])
    assert 0 in c["ctx"]
    assert any(x % c["ps"] for x in c["ctx"])
    assert c["n_lp"] % pa.split_pages(c["ps"])
    active = torch.tensor([x > 0 for x in c["ctx"]])
    assert any((~live & active).any() for _, live in _runs(mask4))


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_walk_matches_the_plain_version(name):
    c = CASES[name]
    q, k_pool, v_pool, table, mask = _case(2, **c)
    B, Q, Hp, _ = q.shape
    KV = k_pool.shape[2]
    gq, tk, tv = tops._pa_group_q(_bf16(q), KV), _bf16(k_pool), _bf16(v_pool)
    tt = torch.tensor(table)
    mask4 = torch.tensor(mask).reshape(B, Q, c["n_lp"], c["ps"])
    m = emulate_scores_max(gq, tk, tt, mask4)
    m_ref = pa.paged_attn_scores_max_ref(gq, tk, tt, mask4)
    assert torch.equal(m, m_ref)                 # bitwise, -inf rows too
    inactive = torch.tensor([x == 0 for x in c["ctx"]])
    assert torch.isneginf(m[inactive]).all()
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    num, den = emulate_accumulate(gq, tk, tv, tt, mask4, m_safe)
    num_r, den_r = pa.paged_attn_accumulate_ref(gq, tk, tv, tt, mask4,
                                                m_safe)
    assert (num[inactive] == 0).all() and (den[inactive] == 0).all()
    atol = 1e-5 * num_r.abs().max() + 2.0 ** -8 * tv.float().abs().max()
    assert (num - num_r).abs().max() <= atol
    assert (den - den_r).abs().max() <= 1e-5 * den_r.abs().max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_walk_matches_the_pallas_kernels(name):
    jnp, jops = _reference()
    c = CASES[name]
    q, k_pool, v_pool, table, mask = _case(3, **c)
    B, Q, Hp, _ = q.shape
    KV = k_pool.shape[2]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k_pool, v_pool))
    jt, jm = jnp.asarray(table), jnp.asarray(mask)
    gq, tk, tv = tops._pa_group_q(_bf16(q), KV), _bf16(k_pool), _bf16(v_pool)
    tt = torch.tensor(table)
    mask4 = torch.tensor(mask).reshape(B, Q, c["n_lp"], c["ps"])

    m_r = np.asarray(jops.paged_attention_scores_max(jq, jk, jt, jm,
                                                     interpret=True))
    m = tops._pa_ungroup(emulate_scores_max(gq, tk, tt, mask4), Q,
                         Hp).numpy()
    np.testing.assert_array_equal(np.isneginf(m), np.isneginf(m_r))
    fin = np.isfinite(m_r)
    np.testing.assert_allclose(m[fin], m_r[fin], rtol=0,
                               atol=1e-5 * np.abs(m_r[fin]).max())

    m_safe = np.where(fin, m_r, 0.0).astype(np.float32)
    num_r, den_r = jops.paged_attention_accumulate(
        jq, jk, jv, jt, jm, jnp.asarray(m_safe), interpret=True)
    num_r, den_r = np.asarray(num_r), np.asarray(den_r)
    gm_safe = tops._pa_group_q(torch.tensor(m_safe)[..., None], KV)[..., 0]
    num, den = emulate_accumulate(gq, tk, tv, tt, mask4, gm_safe)
    num = tops._pa_ungroup(num, Q, Hp).numpy()
    den = tops._pa_ungroup(den, Q, Hp).numpy()
    atol = 1e-5 * np.abs(num_r).max() + 2.0 ** -8 * np.abs(v_pool).max()
    np.testing.assert_allclose(num, num_r, rtol=0, atol=atol)
    np.testing.assert_allclose(den, den_r, rtol=0,
                               atol=1e-5 * np.abs(den_r).max())


@pytest.mark.parametrize("ps", [1, 5, 8, 12, 16, 24, 32])
def test_runs_fit_a_block(ps):
    """A run covers at most 64 positions (the kernel's K / V rows in
    shared memory) and at least one page; the runs cover every page."""
    P = pa.split_pages(ps)
    assert 1 <= P and P * ps <= pa.SPLIT_POSITIONS
    for n_lp in (0, 1, P - 1, P, P + 1, 32):
        n = pa.n_splits(n_lp, ps)
        assert n >= 1 and n * P >= n_lp and (n - 1) * P < max(n_lp, 1)


def test_scratch_is_kept_per_pass_device_and_stream(monkeypatch):
    """The tickets and partials a launch uses: allocated on a pass's
    first call on a stream, the same buffers again while they fit, grown
    when a call needs more (the tickets kept, still zero), and never
    shared between streams or passes."""
    monkeypatch.setattr(pa, "_SCRATCH", {})
    q = torch.zeros(1)
    t, p = pa._scratch("accumulate", q, 7, 10, 100)
    assert t.dtype == torch.int32 and t.numel() >= 10 and not t.any()
    assert p.dtype == torch.float32 and p.numel() >= 100
    t2, p2 = pa._scratch("accumulate", q, 7, 10, 50)
    assert t2 is t and p2 is p
    t3, p3 = pa._scratch("accumulate", q, 7, 10, 1000)
    assert t3 is t and p3.numel() >= 1000
    t4, p4 = pa._scratch("accumulate", q, 7, 1000, 10)
    assert t4.numel() >= 1000 and not t4.any() and p4 is p3
    other = [pa._scratch("accumulate", q, 8, 10, 100),
             pa._scratch("scores_max", q, 7, 10, 100)]
    for t5, p5 in other:
        assert t5 is not t4 and p5 is not p3
    assert len(pa._SCRATCH) == 3
