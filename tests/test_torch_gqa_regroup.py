"""Padded query heads and uneven GQA grouping through K3/K4's regrouped
query layout (`kernels.ops.gqa_layout`): query head h reads kv head
min(h // max(H // KV, 1), KV - 1) (the reference's map), and K3/K4 take
each kv head's query heads as one group, every group padded with zero
rows to the largest group's size.  On the CPU (the kernels' plain
versions) and with no spawn:

  * the layout's round trip at padded and uneven layouts, each head in
    its kv head's group and the empty slots zero;
  * `_paged_attention_core`'s fused mode (the plain K3/K4 through the
    regroup) against the gathered combine, whose ungrouped branch
    expands the kv heads by the same map as the reference's `jnp.take`:
    the row maxima, the sums and the outputs within fp32 summation order
    (1e-5 of the largest, test_torch_kernels' bar for K3: the two modes'
    einsums reduce the same terms in shapes whose products may order
    their sums apart by a few ulps);
  * the "padded" config (Ling-Lite's smoke with 5 query heads over 2 kv
    heads of 64, 5 experts; uneven at tp = 1) served greedy at (1, 1):
    dense decode and the OnlineEngine, every stream equal to the
    reference's, which takes its ungrouped gathered path, and the port's
    fused and gathered engines equal to each other (its sampled streams
    and its train step are held at (1, 2) and (2, 2) by
    test_torch_mesh_archs).

The same shapes on the card, through the kernels: test_torch_regroup_kernels
(no JAX there, so that it runs where only the port's dependencies are)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import get_smoke_config as jsmoke
from repro.launch.mesh import make_local_mesh
from repro.serving.online import OnlineConfig as JConfig
from repro.serving.online import OnlineEngine as JEngine
from repro.serving.online import OnlineRequest as JRequest
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                        OnlineRequest)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (query heads, kv heads, padded heads): uneven at tp = 1 (5 over 2),
# padded at tp = 2 (6 of 5), whisper-tiny padded at tp = 4 (8 of 6),
# recurrentgemma-2b's 10 over 1 padded at tp = 4, fewer query heads than
# kv heads, and an even grouping
LAYOUTS = {"uneven 5/2": (5, 2, 5), "padded 5/2 tp2": (5, 2, 6),
           "whisper tp4": (6, 6, 8), "rgemma tp4": (10, 1, 12),
           "fewer 3/4": (3, 4, 4), "even 8/2": (8, 2, 8)}
SB, P, NEW, SEQ = 4, 6, 5, 32
ENGINE = dict(max_slots=SB, max_context=SEQ, page_size=8, prefill_chunk=4)


def _kv_of(H, KV, Hp):
    return np.minimum(np.arange(Hp) // max(H // KV, 1), KV - 1)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_regroup_round_trip_and_groups(name):
    """`_pa_group_q` puts head h at its kv head's group (in head order,
    then zero slots) and `_pa_ungroup` gives q back bit for bit;
    `AttnDims.kv_map` is the reference's map."""
    H, KV, Hp = LAYOUTS[name]
    B, Q, hd = 2, 3, 4
    q = torch.randn(B, Q, Hp, hd)
    lay = ops.gqa_layout(Hp, KV, H)
    g = lay[0]
    gq = ops._pa_group_q(q, KV, lay)
    assert gq.shape == (B, KV, g * Q, hd)
    kv = _kv_of(H, KV, Hp)
    assert L.AttnDims(H, KV, Hp, Hp, hd).kv_map().tolist() == kv.tolist()
    assert g == max(np.bincount(kv, minlength=KV))
    grouped = gq.reshape(B, KV, g, Q, hd)
    for j in range(KV):
        heads = np.flatnonzero(kv == j)
        for s in range(g):
            want = (q[:, :, heads[s]] if s < len(heads)
                    else torch.zeros(B, Q, hd))
            assert torch.equal(grouped[:, j, s], want), (j, s)
    assert torch.equal(ops._pa_ungroup(gq, Q, lay), q)
    # the heads' own order where every group is full (H // KV * KV = Hp)
    assert (lay[1] is None) == (max(H // KV, 1) * KV == Hp)


def _attn_case(H, KV, Hp, Q, seed):
    """q (B, Q, Hp, hd) and a pool of pages with one slot's table cut
    short, at positions past a page boundary."""
    rs = np.random.RandomState(seed)
    B, ps, n_lp, hd = 3, 8, 4, 16
    t = lambda *s: torch.tensor(rs.randn(*s).astype(np.float32))
    pool = {"k": t(1 + B * n_lp, ps, KV, hd), "v": t(1 + B * n_lp, ps, KV,
                                                      hd)}
    table = torch.arange(1, 1 + B * n_lp, dtype=torch.int32) \
        .reshape(B, n_lp)
    table[1, 2:] = 0
    pos = torch.tensor([[b + j for j in range(Q)] for b in (10, 3, 25)])
    valid = L.paged_valid_mask(table, pos, page_size=ps)
    return t(B, Q, Hp, hd), pool, table, valid


@pytest.mark.parametrize("Q", [1, 3], ids=["decode", "prefill"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plain_k3_k4_through_the_regroup_match_the_gathered_combine(name,
                                                                    Q):
    """The fused mode's plain K3/K4 through the regroup against the
    gathered combine's ungrouped branch: the row maxima (pass 1), the
    softmax sums and the outputs, term for term up to fp32 summation
    order."""
    H, KV, Hp = LAYOUTS[name]
    ad = L.AttnDims(H, KV, Hp, Hp, 16)
    cfg = dataclasses.replace(get_smoke_config("ling-lite"), n_heads=H,
                              n_kv_heads=KV, head_dim=16,
                              compute_dtype="float32")
    q, pool, table, valid = _attn_case(H, KV, Hp, Q, seed=Q)
    fused = L._paged_attention_core(cfg, ad, q, pool, table, valid,
                                    torch.float32, paged_attn="fused")
    gathered = L._paged_attention_core(cfg, ad, q, pool, table, valid,
                                       torch.float32, paged_attn="gathered")
    tol = 1e-5 * gathered.abs().max().item()
    assert (fused - gathered).abs().max().item() <= tol
    # pass 1 and the sums against the gathered scores of each head's kv
    lay = ad.layout()
    assert lay == ops.gqa_layout(Hp, KV, H)       # made once, then reused
    assert ad.grouped == (lay[1] is None)
    m = ops.paged_attention_scores_max(q, pool["k"], table, valid, lay)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    num, den = ops.paged_attention_accumulate(q, pool["k"], pool["v"],
                                              table, valid, m_safe, lay)
    kv = torch.as_tensor(_kv_of(H, KV, Hp))
    kg = ops.paged_gather(pool["k"], table).reshape(3, -1, KV, 16)[:, :, kv]
    s = torch.einsum("bqhd,bshd->bqhs", q, kg) * 16 ** -0.5
    s = torch.where(valid[:, :, None, :], s, float("-inf"))
    m_want = s.amax(-1)
    fin = torch.isfinite(m_want)
    assert torch.equal(fin, torch.isfinite(m))
    assert (m[fin] - m_want[fin]).abs().max().item() <= \
        1e-5 * m_want[fin].abs().max().item()
    p = torch.where(valid[:, :, None, :], torch.exp(s - m_safe[..., None]),
                    0.0)
    den_want = p.sum(-1)
    assert (den - den_want).abs().max().item() <= \
        1e-5 * den_want.abs().max().item()
    vg = ops.paged_gather(pool["v"], table).reshape(3, -1, KV, 16)[:, :, kv]
    num_want = torch.einsum("bqhs,bshd->bqhd", p, vg)
    assert (num - num_want).abs().max().item() <= \
        1e-5 * num_want.abs().max().item()


def _padded_cfgs():
    over = dict(n_heads=5, n_kv_heads=2, head_dim=64,
                compute_dtype="float32")
    tc = get_smoke_config("ling-lite")
    jc = jsmoke("ling-lite")
    return (dataclasses.replace(
                tc, moe=dataclasses.replace(tc.moe, n_experts=5), **over),
            dataclasses.replace(
                jc, moe=dataclasses.replace(jc.moe, n_experts=5), **over))


def _engine_streams(eng, Request, prompts, knobs, base):
    eng.alloc.flush_radix()
    eng.submit_many([Request(rid=base + i, prompt=prompts[i], max_new=NEW,
                             seed=i, **knobs) for i in range(SB)])
    eng.run(max_ticks=500)
    return np.stack([np.asarray(eng.reqs[base + i].out) for i in range(SB)])


@pytest.fixture(scope="module")
def padded_streams():
    """The "padded" config's greedy streams at (1, 1): the reference's
    (its ungrouped gathered path) and the port's, fused and gathered,
    from the reference's parameters."""
    tc, jc = _padded_cfgs()
    prompts = np.random.RandomState(5).randint(0, tc.vocab_size,
                                               (SB, P)).astype(np.int32)
    jr = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                     seq_parallel=False, max_seq=SEQ)
    jparams = jr.init_params(0)
    decode, _ = jr.make_decode_step(global_batch=SB, seq_len=SEQ)
    decode = jax.jit(decode)
    caches = jax.tree.map(lambda s: jax.numpy.zeros(s.shape, s.dtype),
                          jr.init_cache_shapes(SB, SEQ)[0])
    dense = []
    tok = None
    for pos in range(P + NEW - 1):
        inp = prompts[:, pos] if pos < P else tok
        tok, caches = decode(jparams, caches, jax.numpy.asarray(inp),
                             jax.numpy.int32(pos))
        if pos >= P - 1:
            dense.append(tok)
    jeng = JEngine(jr, jparams, JConfig(**ENGINE))
    ref = {"dense": np.stack(jax.device_get(dense), 1),
           "paged": _engine_streams(jeng, JRequest, prompts, {}, 0)}

    port = {}
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tc, device="cpu")
    for mode in ("fused", "gathered"):
        runner = tapi.Runner(tc, device="cpu", max_seq=SEQ,
                             flags=M.RunFlags(paged_attn=mode))
        step = runner.make_decode_step()
        caches = runner.init_caches(SB, SEQ)
        tp = torch.from_numpy(prompts).long()
        out = []
        for pos in range(P + NEW - 1):
            tok, caches = step(params, caches,
                               tp[:, pos] if pos < P else tok, pos)
            if pos >= P - 1:
                out.append(tok)
        eng = OnlineEngine(runner, params, OnlineConfig(**ENGINE))
        port[mode] = {
            "dense": torch.stack(out, 1).numpy(),
            "paged": _engine_streams(eng, OnlineRequest, prompts, {}, 0)}
    return ref, port


@pytest.mark.parametrize("stream", ["dense", "paged"])
def test_padded_config_streams_at_1x1_match_the_reference(padded_streams,
                                                          stream):
    """Uneven grouping at (1, 1), greedy: the port's fused streams (K3/K4's
    plain versions through the regroup) and its gathered ones equal the
    reference's ungrouped gathered streams."""
    ref, port = padded_streams
    for mode in ("fused", "gathered"):
        np.testing.assert_array_equal(port[mode][stream], ref[stream],
                                      err_msg=f"{mode} {stream}")
