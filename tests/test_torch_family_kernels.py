"""On the card: K3/K4 at the decode shapes of the block families that the
Ling blocks do not cover, against their plain versions, through the page
view a dense tick reads (`layers.dense_page_view`).  No JAX here: these
tests run only where `torch.cuda.is_available()` (`-m cuda` on the
card) and skip elsewhere.

  * recurrentgemma-2b's heads (10 queries over one kv head of 256: the
    kernels' head_dim-256 instantiation) over its rolling window cache
    of 2048 rows, every row valid, and over 544 positions mid-cache;
  * h2o-danube-1.8b's (4 over each of 8 kv heads of 80) at 544;
  * whisper-tiny's cross attention (6 heads of 64, group 1) over its 1504
    encoder positions, every one valid;
  * at head_dim 256 a slot's bits do not depend on the call's other
    slots (the contract two warps a tile keep at every shape).

Tolerances as chip_smoke.py's phase 3: fp32 summation order, 1e-5 of the
largest output for K3's maxima, and for K4 that plus one bf16 rounding
flip of p (2^-8 of the largest |v|)."""

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as pa
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


# label -> (arch, cache positions, the tick's position: pos >= S is a
# rolling window past its wrap, or a cross cache, every row valid)
CASES = {"recurrentgemma rolling 2048": ("recurrentgemma-2b", 2048, 2071),
         "recurrentgemma 544": ("recurrentgemma-2b", 544, 300),
         "danube 544": ("h2o-danube-1.8b", 544, 543),
         "whisper cross 1504": ("whisper-tiny", 1504, 1503)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def dense_case(arch, S, pos, B=8, seed=0):
    """q grouped per kv head, the cache's page pools and the tick's view,
    as `layers.decode_attention` hands them to K3/K4."""
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = L.init_decode_cache(cfg, B, S, "cuda")
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    table, valid = L.dense_page_view(B, S, pos, "cuda")
    n_lp = table.shape[1]
    q = torch.randn((B, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lay = ops.gqa_layout(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads)
    return (ops._pa_group_q(q, cfg.n_kv_heads, lay),
            L.dense_pages(cache["k"]),
            L.dense_pages(cache["v"]), table,
            valid.reshape(B, 1, n_lp, L.DENSE_PAGE))


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(CASES))
def test_k3_k4_over_the_families_dense_views(label):
    _need_cuda()
    gq, k_pool, v_pool, table, mask = dense_case(*CASES[label])
    m = pa.paged_attn_scores_max(gq, k_pool, table, mask)
    m_ref = pa.paged_attn_scores_max_ref(gq, k_pool, table, mask)
    assert torch.isfinite(m_ref).all()
    assert (m - m_ref).abs().max().item() <= \
        1e-5 * m_ref.abs().max().item()
    num, den = pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask,
                                        m_ref)
    num_r, den_r = pa.paged_attn_accumulate_ref(gq, k_pool, v_pool, table,
                                                mask, m_ref)
    torch.cuda.synchronize()
    tol = (1e-5 * max(num_r.abs().max().item(), den_r.abs().max().item())
           + 2.0 ** -8 * v_pool.float().abs().max().item())
    assert (num - num_r).abs().max().item() <= tol
    assert (den - den_r).abs().max().item() <= tol


@pytest.mark.cuda
def test_head_dim_256_rows_keep_their_bits_whatever_the_other_slots():
    _need_cuda()
    gq, k_pool, v_pool, table, mask = dense_case("recurrentgemma-2b", 544,
                                                 300)
    n_lp = table.shape[1]
    m8 = pa.paged_attn_scores_max(gq, k_pool, table, mask)
    num8, den8 = pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask,
                                          m8)
    one = (gq[3:4].contiguous(), k_pool, v_pool, table[3:4].contiguous(),
           mask[3:4].contiguous())
    m1 = pa.paged_attn_scores_max(one[0], k_pool, one[3], one[4])
    num1, den1 = pa.paged_attn_accumulate(*one, m1)
    torch.cuda.synchronize()
    assert n_lp == 34
    assert torch.equal(m1, m8[3:4])
    assert torch.equal(num1, num8[3:4]) and torch.equal(den1, den8[3:4])
