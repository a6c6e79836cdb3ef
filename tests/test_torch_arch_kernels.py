"""On the card: the port's kernels at the shapes of the reference's other
uniform-attention architectures, against their plain versions, and the
pieces of this slice that must keep their bits there.  No JAX here: these
tests run only where `torch.cuda.is_available()` (`-m cuda` on the
card) and skip elsewhere.

  * K1 (fused MoE FFN) on one full-width layer of Ling-Plus (96 experts
    top-4, d 8192: a decode tick's 32 routed rows stream past mostly
    empty experts) and of granite (40 experts top-8, ff 512), each on the
    path `k1_path` picks;
  * K3/K4 at a decode tick on Ling-Plus's, granite's, deepseek's and
    phi3's heads (query groups of 8, 3, 1, 1; head_dim 128, 64, 128, 96);
  * K5 on Ling-Plus's and granite's fp32 heads (granite's vocabulary,
    49155, is odd);
  * `segment_pooled_logps` gives the same bits twice;
  * a dense cache of 100 positions (no multiple of the page view's 16)
    decodes the same greedy stream through K3/K4 as through the gathered
    combine.

Tolerances as chip_smoke.py's phase 3: fp32 summation order, 1e-4 of
the largest output for K1 and K5, 1e-5 for K3's maxima, and for K4 that
plus one bf16 rounding flip of p (2^-8 of the largest |v|)."""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import moe, router
from repro_torch.kernels import build
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import normhead as nh
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as pa
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.training import dpo


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


def _gen(seed=0):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,T,path", [
    ("ling-plus", 8, "stream"), ("granite-moe-3b-a800m", 8, "stream"),
    ("granite-moe-3b-a800m", 64, "stream"),
    ("granite-moe-3b-a800m", 2048, "tensor_cores")])
def test_k1_at_the_archs_shapes_matches_plain(arch, T, path):
    _need_cuda()
    cfg, gen = get_config(arch), _gen(1)
    p = moe.init_moe(cfg, L.Init(device=torch.device("cuda"), generator=gen))
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    tok, gates, gs, _ = moe.sort_slots(cfg, *router.route(cfg, p["router"],
                                                          x))
    bm = min(128, max(8, tok.shape[0]))
    row_idx, g, tg = ops._fused_layout(tok, gates, gs, T, bm)
    assert gm.k1_path(row_idx.shape[0], bm, cfg.moe.n_experts) == path
    args = (x, p["we1"], p["we2"], p["we3"], row_idx, g, tg)
    before = build.LAUNCHES["fused_moe_ffn"]
    out = gm.fused_moe_ffn(*args)
    assert build.LAUNCHES["fused_moe_ffn"] == before + 1
    ref = gm.fused_moe_ffn_ref(*args)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["ling-plus", "granite-moe-3b-a800m",
                                  "deepseek-moe-16b", "phi3-mini-3.8b"])
def test_k3_k4_decode_at_the_archs_heads(arch):
    """8 slots of one query each, contexts 0-300 (two inactive slots on
    the scratch page) over pages of 16."""
    _need_cuda()
    cfg, gen = get_config(arch), _gen(2)
    B, ps, n_lp, KV, hd = 8, 16, 32, cfg.n_kv_heads, cfg.head_dim
    ctx = [100, 300, 0, 171, 256, 0, 129, 233]
    n_pages = B * n_lp + 1
    pool = lambda: torch.randn((n_pages, ps, KV, hd), generator=gen,
                               device="cuda").to(torch.bfloat16)
    k_pool, v_pool = pool(), pool()
    table = torch.zeros((B, n_lp), dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // ps)
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    pos = torch.tensor([[max(c - 1, 0)] for c in ctx], device="cuda")
    mask = L.paged_valid_mask(table, pos, page_size=ps) \
        .reshape(B, 1, n_lp, ps)
    q = torch.randn((B, 1, cfg.n_heads, hd), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    gq = ops._pa_group_q(q, KV,
                         ops.gqa_layout(cfg.n_heads, KV, cfg.n_heads))
    m = pa.paged_attn_scores_max(gq, k_pool, table, mask)
    m_ref = pa.paged_attn_scores_max_ref(gq, k_pool, table, mask)
    fin = torch.isfinite(m_ref)
    assert torch.equal(torch.isfinite(m), fin)
    assert (m[fin] - m_ref[fin]).abs().max().item() <= \
        1e-5 * m_ref[fin].abs().max().item()
    m_safe = torch.where(fin, m_ref, 0.0)
    num, den = pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask,
                                        m_safe)
    num_r, den_r = pa.paged_attn_accumulate_ref(gq, k_pool, v_pool, table,
                                                mask, m_safe)
    torch.cuda.synchronize()
    tol = (1e-5 * max(num_r.abs().max().item(), den_r.abs().max().item())
           + 2.0 ** -8 * v_pool.float().abs().max().item())
    assert (num - num_r).abs().max().item() <= tol
    assert (den - den_r).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["ling-plus", "granite-moe-3b-a800m"])
def test_k5_on_the_archs_heads(arch):
    _need_cuda()
    cfg, gen = get_config(arch), _gen(3)
    w = 0.02 * torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                           device="cuda")
    x = torch.randn((8, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    out, ref = nh.normhead_matmul(x, w), nh.normhead_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert out.shape == (8, cfg.vocab_size)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_segment_pooled_logps_repeats_its_bits_on_the_card():
    _need_cuda()
    rs = np.random.RandomState(0)
    pairs = [dpo.PairExample(prompt=rs.randint(0, 1000, rs.randint(8, 64)),
                             chosen=rs.randint(0, 1000, rs.randint(8, 64)),
                             rejected=rs.randint(0, 1000, rs.randint(8, 64)))
             for _ in range(12)]
    packed = dpo.pack_pairs(pairs, 256)
    dev = lambda a: torch.from_numpy(np.asarray(a)).cuda()
    logits = torch.randn(packed["tokens"].shape + (1000,),
                         generator=_gen(4), device="cuda")
    args = (logits, dev(packed["tokens"]).long(), dev(packed["resp_mask"]),
            dev(packed["segment_ids"]), packed["n_pairs"])
    (c1, r1), n1 = dpo.segment_pooled_logps(*args)
    (c2, r2), n2 = dpo.segment_pooled_logps(*args)
    assert torch.equal(c1, c2) and torch.equal(r1, r2) \
        and torch.equal(n1, n2)
    (cc, rc), nc = dpo.segment_pooled_logps(*[
        a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
    scale = torch.stack([cc, rc]).abs().max().item()
    assert (torch.stack([c1, r1]).cpu() - torch.stack([cc, rc])).abs() \
        .max().item() <= 1e-5 * scale
    assert torch.equal(n1.cpu(), nc)


@pytest.mark.cuda
def test_dense_cache_of_any_length_on_the_card():
    """Smoke Ling-Lite on the card: prefill into caches of 100 positions
    and decode past their end; K3/K4 over the padded page view and the
    gathered combine emit the same greedy tokens."""
    _need_cuda()
    cfg = get_smoke_config("ling-lite")
    runner = api.Runner(cfg, device="cuda")
    params = runner.init_params(0)
    gathered = api.Runner(cfg, device="cuda",
                          flags=M.RunFlags(paged_attn="gathered"))
    prompt = torch.randint(0, cfg.vocab_size, (4, 90), generator=_gen(5),
                           device="cuda")

    def stream(r):
        tok, caches = r.make_prefill(seq_len=100)(params, {"tokens": prompt})
        assert caches["self"]["k"].shape[2] == 100
        dec, out = r.make_decode_step(), [tok]
        for pos in range(90, 110):
            tok, caches = dec(params, caches, tok, pos)
            out.append(tok)
        return torch.stack(out, 1)

    assert torch.equal(stream(runner), stream(gathered))
