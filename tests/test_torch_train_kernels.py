"""The MoE backward's kernels: plain versions of K2 (grouped matmul over
group-aligned rows) and of the grouped weight gradient against the JAX
package (its K2 Pallas kernel in interpret mode, and jax.vjp of
jax.lax.ragged_dot), the aligned layout against the reference's, and
`FusedFFN`'s gradients against jax.vjp of the reference's `fused_ffn`.
On a CUDA card only: the CUDA kernels against their plain versions.

Tolerances: every product here is an fp32 product of operands that are
exact in fp32 (bf16 weights upcast), so the two packages differ only in
fp32 summation order: 1e-5 of the largest value.  After the reference's
cast of a gradient to bf16, an element whose fp32 values differ in the
last bits can round one bf16 ulp the other way, so cast gradients are
held to one bf16 ulp of each element on top.

The card-only tests import no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core import moe as TMOE
from repro_torch.kernels import build
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops as tops
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


def _reference():
    """(jax, jax.numpy, repro.kernels.ops, repro.core.moe), imported here
    so the card-only tests need no JAX."""
    import jax
    import jax.numpy as jnp
    from repro.core import moe as jmoe
    from repro.kernels import ops as jops
    return jax, jnp, jops, jmoe


def _bf16_round(a):
    """fp32 numpy values rounded to bf16 (and back), like torch."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


# group sizes: ragged, an empty group, and (last case) rows past the sum
GROUPS = {"ragged": [5, 0, 9, 3], "tail": [4, 7, 0, 6], "one": [20, 0, 0, 0]}
M_ROWS = {"ragged": 17, "tail": 23, "one": 20}


def _gmm_case(name, K=64, N=96, seed=0):
    rs = np.random.RandomState(seed + len(name))
    gs = np.array(GROUPS[name], np.int32)
    M = M_ROWS[name]
    lhs = rs.randn(M, K).astype(np.float32)
    rhs = _bf16_round(0.2 * rs.randn(len(gs), K, N).astype(np.float32))
    return lhs, rhs, gs


@pytest.mark.parametrize("name", sorted(GROUPS))
@pytest.mark.parametrize("bm", [8, 16])
def test_align_groups_matches_reference_exactly(name, bm):
    _, jnp, jops, _ = _reference()
    lhs, _, gs = _gmm_case(name)
    ref = jops._align_groups(jnp.asarray(lhs), jnp.asarray(gs), bm)
    out = tops._align_groups(torch.tensor(lhs), torch.tensor(gs), bm)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", sorted(GROUPS))
@pytest.mark.parametrize("trans_b", [False, True])
def test_k2_plain_matches_pallas(name, trans_b):
    """`ops.grouped_matmul` on K2's plain version against the reference's
    `ops.grouped_matmul` (K2 in interpret mode, bm=8 so groups span
    several tiles and tiles hold padding).  The port takes rhs in bf16
    (read transposed from (G, N, K) storage when trans_b); the reference
    gets the same values in fp32."""
    _, jnp, jops, _ = _reference()
    lhs, rhs, gs = _gmm_case(name)
    ref = np.asarray(jops.grouped_matmul(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs), bm=8,
        interpret=True))
    t_rhs = torch.tensor(rhs).to(torch.bfloat16)
    if trans_b:
        t_rhs = t_rhs.transpose(1, 2).contiguous()
    out = tops.grouped_matmul(torch.tensor(lhs), t_rhs, torch.tensor(gs),
                              bm=8, trans_b=trans_b)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    # rows past sum(group_sizes) are exactly 0 in both
    np.testing.assert_array_equal(out.numpy()[gs.sum():], 0.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_wgrad_plain_matches_vjp_of_ragged_dot(name):
    jax, jnp, _, _ = _reference()
    lhs, rhs, gs = _gmm_case(name)
    rs = np.random.RandomState(5)
    cot = rs.randn(lhs.shape[0], rhs.shape[2]).astype(np.float32)
    _, pull = jax.vjp(lambda w: jax.lax.ragged_dot(
        jnp.asarray(lhs), w, jnp.asarray(gs)), jnp.asarray(rhs))
    ref = np.asarray(pull(jnp.asarray(cot))[0])
    out = tops.grouped_matmul_wgrad(torch.tensor(lhs), torch.tensor(cot),
                                    torch.tensor(gs))
    assert out.shape == ref.shape == (len(gs),) + (lhs.shape[1],
                                                  cot.shape[1])
    np.testing.assert_array_equal(out.numpy()[gs == 0], 0.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _ffn_case(seed, T=12, G=4, k=2, d=64, ff=96, act="swiglu"):
    rs = np.random.RandomState(seed)
    x = rs.randn(T, d).astype(np.float32)
    w1 = (0.1 * rs.randn(G, d, ff)).astype(np.float32)
    w2 = (0.1 * rs.randn(G, ff, d)).astype(np.float32)
    w3 = ((0.1 * rs.randn(G, d, ff)).astype(np.float32)
          if act in gm.GATED_ACTS else None)
    experts = np.stack([rs.choice([0, 1, 3], k, replace=False)
                        for _ in range(T)]).reshape(-1)    # expert 2 empty
    order = np.argsort(experts, kind="stable")
    tok = (order // k).astype(np.int32)
    gate = rs.uniform(0.05, 1.0, T * k).astype(np.float32)
    gs = np.bincount(experts[order], minlength=G).astype(np.int32)
    g = rs.randn(T, d).astype(np.float32)
    return x, w1, w2, w3, tok, gate, gs, g


@pytest.mark.parametrize("dt,act", [("float32", "swiglu"),
                                    ("bfloat16", "swiglu"),
                                    ("float32", "squared_relu")])
def test_fused_ffn_grads_match_reference_vjp(dt, act):
    """`FusedFFN` (K1 forward, K2/wgrad backward, plain versions on CPU)
    against jax.vjp of the reference's `fused_ffn` custom vjp: value,
    and the grads of x, w1, w2, w3 and gate in the inputs' dtype."""
    jax, jnp, _, jmoe = _reference()
    x, w1, w2, w3, tok, gate, gs, g = _ffn_case(7, act=act)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    gated = w3 is not None
    jargs = [jnp.asarray(a, jdt) for a in (x, w1, w2)] + \
        [jnp.asarray(w3, jdt) if gated else None]
    jtok, jgs = jnp.asarray(tok), jnp.asarray(gs)
    jgate = jnp.asarray(gate, jdt)
    out_r, pull = jax.vjp(
        lambda x_, w1_, w2_, gate_, *w3_: jmoe.fused_ffn(
            act, x_, w1_, w2_, w3_[0] if w3_ else None, jtok, gate_, jgs),
        jargs[0], jargs[1], jargs[2], jgate,
        *([jargs[3]] if gated else []))
    refs = pull(jnp.asarray(g))
    ref = dict(zip(["x", "w1", "w2", "gate", "w3"],
                   [np.asarray(jnp.asarray(r, jnp.float32)) for r in refs]))

    leaves = {n: torch.tensor(a).to(tdt).requires_grad_()
              for n, a in (("x", x), ("w1", w1), ("w2", w2), ("gate", gate))
              + ((("w3", w3),) if gated else ())}
    out = TMOE.FusedFFN.apply(act, leaves["x"], leaves["w1"], leaves["w2"],
                              leaves.get("w3"), torch.tensor(tok).long(),
                              leaves["gate"], torch.tensor(gs))
    out.backward(torch.tensor(g))
    out_r = np.asarray(out_r)
    np.testing.assert_allclose(out.detach().numpy(), out_r, rtol=0,
                               atol=1e-5 * np.abs(out_r).max())
    for n, t in leaves.items():
        assert t.grad.dtype == tdt, n
        r = ref[n]
        atol = 1e-5 * np.abs(r).max()
        if dt == "bfloat16":                   # one bf16 ulp of r
            atol = atol + np.ldexp(1.0, np.frexp(r)[1] - 8)
        err = np.abs(t.grad.float().numpy() - r)
        assert (err <= atol).all(), (n, float((err - atol).max()))


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    build.reset_launches()
    lhs, rhs, gs = _gmm_case("ragged")
    out = tops.grouped_matmul(torch.tensor(lhs), torch.tensor(rhs),
                              torch.tensor(gs))
    w = tops.grouped_matmul_wgrad(torch.tensor(lhs), out, torch.tensor(gs))
    assert out.device.type == "cpu" and w.device.type == "cpu"
    assert build.LAUNCHES == {name: 0 for name in build.SIGNATURES}


def test_k2_wrappers_refuse_devices_without_a_kernel():
    lhs = Elsewhere(16, 64)
    rhs = Elsewhere(2, 64, 64, dtype=torch.bfloat16)
    tg = Elsewhere(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        gm.grouped_matmul_aligned(lhs, rhs, tg, bm=8)
    with pytest.raises(ValueError, match="unsupported device"):
        gm.grouped_matmul_wgrad(lhs, lhs, tg)


# ---------------------------------------------------------------------------
# on the card: CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("lhs_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("bm", [8, 128, 200])
def test_k2_cuda_kernel_matches_plain(lhs_dt, trans_b, bm):
    """bm=8 (smaller than the kernel's 128-row block), 128, and 200 (a
    tile spans two blocks); N=132 leaves a partial column block."""
    _need_cuda()
    rs = np.random.RandomState(bm)
    gs = torch.tensor([70, 0, 301, 5, 140], device="cuda")
    M, K, N = 530, 136, 132                       # 14 rows past the sum
    lhs = torch.tensor(rs.randn(M, K).astype(np.float32), device="cuda") \
        .to(getattr(torch, lhs_dt))
    rhs = torch.tensor(rs.randn(5, N, K) if trans_b else rs.randn(5, K, N),
                       dtype=torch.float32, device="cuda").to(torch.bfloat16)
    lay = tops.align_layout(gs, M, bm)
    lhs_pad = tops._take_rows(lhs, lay.row_map)
    before = build.LAUNCHES["grouped_matmul_aligned"]
    out = gm.grouped_matmul_aligned(lhs_pad, rhs, lay.tile_group, bm=bm,
                                    trans_b=trans_b)
    assert build.LAUNCHES["grouped_matmul_aligned"] == before + 1
    ref = gm.grouped_matmul_aligned_ref(lhs_pad, rhs, lay.tile_group, bm=bm,
                                        trans_b=trans_b)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dts", [("float32", "float32"),
                                 ("bfloat16", "float32"),
                                 ("float32", "bfloat16")])
def test_wgrad_cuda_kernel_matches_plain(dts):
    _need_cuda()
    rs = np.random.RandomState(3)
    gs = torch.tensor([70, 0, 301, 5, 140], device="cuda")
    M, K, N = 530, 136, 132
    mk = lambda *s, dt: torch.tensor(rs.randn(*s).astype(np.float32),
                                     device="cuda").to(getattr(torch, dt))
    lhs, rhs = mk(M, K, dt=dts[0]), mk(M, N, dt=dts[1])
    before = build.LAUNCHES["grouped_matmul_wgrad"]
    out = gm.grouped_matmul_wgrad(lhs, rhs, gs)
    assert build.LAUNCHES["grouped_matmul_wgrad"] == before + 1
    ref = gm.grouped_matmul_wgrad_ref(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_fused_ffn_backward_on_the_card_matches_plain():
    """`fused_ffn_backward` on the kernels against the same function on
    the CPU (every wrapper's plain version), fp32 before any cast."""
    _need_cuda()
    x, w1, w2, w3, tok, gate, gs, g = _ffn_case(11, T=40, d=128, ff=192)
    args = [torch.tensor(x).to(torch.bfloat16)] + [
        torch.tensor(w).to(torch.bfloat16) for w in (w1, w2, w3)] + [
        torch.tensor(tok).long(), torch.tensor(gate).to(torch.bfloat16),
        torch.tensor(gs), torch.tensor(g)]
    ref = TMOE.fused_ffn_backward("swiglu", *args)
    out = TMOE.fused_ffn_backward("swiglu", *[a.cuda() for a in args])
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert (o.cpu() - r).abs().max().item() <= 1e-5 * r.abs().max().item()


# The tensor-core kernels' edges: each form at column counts that leave a
# partial 128-wide wgmma tile (N = 200: rows 16-byte aligned, so the expert
# tiles come by TMA; N = 132: 8-byte copies) and K with a tail shorter than
# the 16-deep wgmma step (K = 200 = 3 * 64 + 8; K = 132 = 2 * 64 + 4).
K2_EDGES = [(200, 200), (132, 132), (200, 132), (132, 200)]
WGRAD_FORMS = [("float32", "float32"), ("bfloat16", "float32"),
               ("float32", "bfloat16"), ("bfloat16", "bfloat16")]


def _k2_cuda_case(lhs_dt, trans_b, K, N, bm, seed):
    rs = np.random.RandomState(seed)
    gs = torch.tensor([70, 0, 301, 5, 140], device="cuda")
    M = 530
    lhs = torch.tensor(rs.randn(M, K).astype(np.float32), device="cuda") \
        .to(getattr(torch, lhs_dt))
    rhs = torch.tensor(rs.randn(5, N, K) if trans_b else rs.randn(5, K, N),
                       dtype=torch.float32, device="cuda").to(torch.bfloat16)
    lay = tops.align_layout(gs, M, bm)
    return tops._take_rows(lhs, lay.row_map), rhs, lay.tile_group


def _wgrad_cuda_case(dts, K, N, seed):
    rs = np.random.RandomState(seed)
    gs = torch.tensor([70, 0, 301, 5, 140], device="cuda")
    mk = lambda *s, dt: torch.tensor(rs.randn(*s).astype(np.float32),
                                     device="cuda").to(getattr(torch, dt))
    return mk(530, K, dt=dts[0]), mk(530, N, dt=dts[1]), gs


@pytest.mark.cuda
@pytest.mark.parametrize("lhs_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("K,N", K2_EDGES)
def test_k2_cuda_partial_tiles_and_k_tails(lhs_dt, trans_b, K, N):
    _need_cuda()
    lhs, rhs, tg = _k2_cuda_case(lhs_dt, trans_b, K, N, 128, K + N)
    out = gm.grouped_matmul_aligned(lhs, rhs, tg, bm=128, trans_b=trans_b)
    ref = gm.grouped_matmul_aligned_ref(lhs, rhs, tg, bm=128,
                                        trans_b=trans_b)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dts", WGRAD_FORMS)
@pytest.mark.parametrize("K,N", K2_EDGES)
def test_wgrad_cuda_partial_tiles_and_row_tails(dts, K, N):
    """Group sizes 70, 301, 5 and 140 end inside a 32-row stage."""
    _need_cuda()
    lhs, rhs, gs = _wgrad_cuda_case(dts, K, N, K * N)
    out = gm.grouped_matmul_wgrad(lhs, rhs, gs)
    ref = gm.grouped_matmul_wgrad_ref(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("lhs_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_b", [False, True])
def test_k2_cuda_is_deterministic(lhs_dt, trans_b):
    _need_cuda()
    lhs, rhs, tg = _k2_cuda_case(lhs_dt, trans_b, 200, 200, 128, 1)
    a = gm.grouped_matmul_aligned(lhs, rhs, tg, bm=128, trans_b=trans_b)
    b = gm.grouped_matmul_aligned(lhs, rhs, tg, bm=128, trans_b=trans_b)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dts", WGRAD_FORMS)
@pytest.mark.parametrize("out_dt", ["float32", "bfloat16"])
def test_wgrad_cuda_is_deterministic(dts, out_dt):
    _need_cuda()
    lhs, rhs, gs = _wgrad_cuda_case(dts, 200, 132, 2)
    odt = getattr(torch, out_dt)
    a = gm.grouped_matmul_wgrad(lhs, rhs, gs, out_dtype=odt)
    b = gm.grouped_matmul_wgrad(lhs, rhs, gs, out_dtype=odt)
    torch.cuda.synchronize()
    assert a.dtype == odt and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dts", WGRAD_FORMS)
def test_wgrad_cuda_bf16_output_is_the_plain_rounding(dts):
    """out_dtype=bf16 against the plain version's fp32 result rounded to
    bf16: the two fp32 sums differ in summation order only, so a sum near
    a rounding boundary may round one bf16 ulp the other way."""
    _need_cuda()
    lhs, rhs, gs = _wgrad_cuda_case(dts, 136, 132, 4)
    out = gm.grouped_matmul_wgrad(lhs, rhs, gs, out_dtype=torch.bfloat16)
    ref = gm.grouped_matmul_wgrad_ref(lhs, rhs, gs,
                                      out_dtype=torch.bfloat16).float()
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    err = (out.float() - ref).abs()
    assert (err <= ulp + 1e-5 * ref.abs().max()).all()
    assert torch.equal(out[1].float(), torch.zeros_like(ref[1]))


def _extreme_rows(M, K, rs, cls):
    """fp32 rows by class: 0 ordinary N(0, 1); 1 near fp32's maximum (the
    largest entries exactly +-3.4028235e38); 2 subnormal (N(0, 1) *
    1e-39)."""
    x = rs.randn(M, K).astype(np.float32)
    big = cls == 1
    x[big] = np.clip(x[big] / 4.0, -1, 1) * np.float32(3.4028235e38)
    x[big, 0] = np.float32(3.4028235e38)
    x[big, 1] = -np.float32(3.4028235e38)
    x[cls == 2] *= np.float32(1e-39)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
def test_k2_cuda_fp32_lhs_at_the_ends_of_the_range(trans_b):
    """The fp32-lhs form on rows near fp32's maximum (group 0, its rhs
    scaled by 2^-20 so the sums stay finite: truncation keeps the first
    piece finite where rounding would make it inf) and on subnormal rows
    beside ordinary ones (group 2, rhs N(0, 1)).  Each class is held to
    1e-5 of its own largest value; a subnormal row also to an absolute
    floor of K * 2^-126 * max|rhs|: parts of a value below fp32's
    smallest normal may be lost (pieces under bf16's 2^-133)."""
    _need_cuda()
    rs = np.random.RandomState(9)
    M, K, N = 256, 136, 132
    gs_np = np.array([100, 0, 156])
    cls = np.concatenate([np.ones(100, int), rs.randint(0, 2, 156) * 2])
    x = _extreme_rows(M, K, rs, cls)
    gs = torch.tensor(gs_np, device="cuda")
    lay = tops.align_layout(gs, M, 128)
    row_map = lay.row_map.cpu().numpy()
    cls_pad = np.where(row_map >= 0, cls[np.maximum(row_map, 0)], -1)
    lhs = tops._take_rows(torch.tensor(x, device="cuda"), lay.row_map)
    w = rs.randn(3, N, K) if trans_b else rs.randn(3, K, N)
    w[0] = np.ldexp(w[0], -20)
    rhs = torch.tensor(w, dtype=torch.float32,
                       device="cuda").to(torch.bfloat16)
    out = gm.grouped_matmul_aligned(lhs, rhs, lay.tile_group, bm=128,
                                    trans_b=trans_b)
    ref = gm.grouped_matmul_aligned_ref(lhs, rhs, lay.tile_group, bm=128,
                                        trans_b=trans_b)
    torch.cuda.synchronize()
    assert torch.isfinite(ref).all() and torch.isfinite(out).all()
    floor = K * 2.0 ** -126 * rhs.float().abs().max().item()
    for c in range(3):
        sel = torch.tensor(cls_pad == c, device="cuda")
        o, r = out[sel], ref[sel]
        tol = 1e-5 * r.abs().max().item() + (floor if c == 2 else 0.0)
        assert (o - r).abs().max().item() <= tol, c


@pytest.mark.cuda
def test_wgrad_cuda_fp32_lhs_at_the_ends_of_the_range():
    """The same rows through the weight gradient's fp32 x fp32 and fp32 x
    bf16 forms: the output's entries mix every class, so it is held to
    1e-5 of its largest value, which the near-maximum rows set."""
    _need_cuda()
    rs = np.random.RandomState(10)
    M, K, N = 256, 136, 132
    x = _extreme_rows(M, K, rs, rs.randint(0, 3, M))
    gs = torch.tensor([100, 0, 156], device="cuda")
    lhs = torch.tensor(x, device="cuda")
    for rdt in (torch.float32, torch.bfloat16):
        rhs = torch.tensor(np.ldexp(rs.randn(M, N), -20), dtype=torch.float32,
                           device="cuda").to(rdt)
        out = gm.grouped_matmul_wgrad(lhs, rhs, gs)
        ref = gm.grouped_matmul_wgrad_ref(lhs, rhs, gs)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and torch.isfinite(ref).all()
        assert (out - ref).abs().max().item() <= \
            1e-5 * ref.abs().max().item()


# ---------------------------------------------------------------------------
# on the card: the tensor cores' fp32 accumulation as the contraction grows
# ---------------------------------------------------------------------------
#
# Each kernel's result against a float64 product of the same bf16 values,
# at contraction lengths K = 256 ... 4096.  Summation order alone (each
# k16 block's fp32 sum rounded to nearest) makes the relative error grow
# about like sqrt(K); an accumulator that truncates instead of rounding
# shrinks every partial sum by half an ulp on average, so its error grows
# like K.  The exponent of the growth tells the two apart.  The H100's
# wgmma truncates: with one accumulator for the whole contraction K1's
# error grew like K^1.00 (about 1e-5 of the largest output at Ling-Lite's
# widths).  Since each 64-deep stage is summed in fresh registers and
# promoted to the fp32 accumulators (hopper_mma.cuh `promote`), the
# measured growth is K^0.05-0.27 and the error at K = 2048 (Ling-Lite's
# d_model; its ff, 1408, is shorter) 2e-7 to 6e-7 of the largest output;
# the test holds it to 1e-6.  K5 (the NormHead logits on mma.sync, an fp32
# head in three bf16 pieces) promotes each 64-column stage the same way
# and is held to the same bounds, its norm and division included.

ACC_K = [256, 512, 1024, 2048, 4096]
ACC_BOUND_LING_LITE = 1e-6      # max error / max |exact| at K = 2048


def _err_vs_f64(out, ref64):
    """(rms error, mean error along the sign of the exact value, max
    error), each relative to the rms or max of the exact value."""
    e = out.double() - ref64
    rms = ref64.pow(2).mean().sqrt()
    return ((e.pow(2).mean().sqrt() / rms).item(),
            ((e * ref64.sign()).mean() / rms).item(),
            (e.abs().max() / ref64.abs().max()).item())


def _k2_up_vs_f64(K, seed):
    rs = np.random.RandomState(seed)
    gs = torch.tensor([256, 256, 256, 256], device="cuda")
    lhs = torch.tensor(rs.randn(1024, K).astype(np.float32),
                       device="cuda").to(torch.bfloat16)
    rhs = torch.tensor(rs.randn(4, K, 256).astype(np.float32) * K ** -0.5,
                       device="cuda").to(torch.bfloat16)
    lay = tops.align_layout(gs, 1024, 128)
    lhs = tops._take_rows(lhs, lay.row_map)
    out = gm.grouped_matmul_aligned(lhs, rhs, lay.tile_group, bm=128)
    tiles, tg = lhs.double().reshape(-1, 128, K), lay.tile_group.long()
    ref = torch.zeros((tiles.shape[0], 128, 256), dtype=torch.float64,
                      device="cuda")
    for g in range(4):
        ref[tg == g] = tiles[tg == g] @ rhs[g].double()
    live = lay.row_map >= 0                        # rows that hold lhs rows
    return out[live], ref.reshape(-1, 256)[live]


def _k5_vs_f64(K, seed):
    """K5 with d = K: 8 bf16 rows of x (a decode tick) against 512 rows of
    an fp32 head, against the float64 NormHead of the same values."""
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.randn(8, K).astype(np.float32),
                     device="cuda").to(torch.bfloat16)
    w = torch.tensor(rs.randn(512, K).astype(np.float32), device="cuda")
    out = tops.normhead_logits(x, w)
    w64 = w.double()
    return out, (x.double() @ w64.T) / w64.norm(dim=1).clamp_min(1e-6)


def _k1_vs_f64(K, T, seed, act="swiglu"):
    """K1 with d = ff = K over 4 experts, top-2, against the same FFN in
    float64."""
    rs = np.random.RandomState(seed)
    G = 4
    x = torch.tensor(rs.randn(T, K).astype(np.float32), device="cuda")
    w = lambda *s: torch.tensor(rs.randn(*s).astype(np.float32) * K ** -0.5,
                                device="cuda").to(torch.bfloat16)
    w1, w2, w3 = w(G, K, K), w(G, K, K), w(G, K, K)
    experts = np.stack([rs.choice(G, 2, replace=False) for _ in range(T)])
    order = np.argsort(experts.reshape(-1), kind="stable")
    tok = torch.tensor(order // 2, dtype=torch.int32, device="cuda")
    gate = torch.tensor(rs.uniform(0.05, 1.0, 2 * T).astype(np.float32),
                        device="cuda")
    gs = torch.tensor(np.bincount(experts.reshape(-1), minlength=G),
                      dtype=torch.int32, device="cuda")
    bm = min(128, max(8, 2 * T))
    row_idx, gates, tg = tops._fused_layout(tok, gate, gs, T, bm)
    xb = x.to(torch.bfloat16)
    out = gm.fused_moe_ffn(xb, w1, w2, w3, row_idx, gates, tg, act=act)
    ref = torch.zeros((T, K), dtype=torch.float64, device="cuda")
    slot = 0
    for e in range(G):
        n = int(gs[e])
        t = tok[slot:slot + n].long()
        xe = xb[t].double()
        h = gm.apply_act(act, xe @ w1[e].double()) * (xe @ w3[e].double())
        ref.index_add_(0, t, (h @ w2[e].double())
                       * gate[slot:slot + n, None].double())
        slot += n
    return out, ref, gm.k1_path(row_idx.shape[0], bm, G)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["k2_up", "k1_tensor_cores", "k1_stream",
                                  "k5"])
def test_tensor_core_accumulation_error_grows_like_sqrt_k(form):
    _need_cuda()
    errs = []
    for K in ACC_K:
        if form == "k2_up":
            out, ref = _k2_up_vs_f64(K, K)
        elif form == "k5":
            out, ref = _k5_vs_f64(K, K)
        else:
            T = 70 if form == "k1_tensor_cores" else 13
            out, ref, path = _k1_vs_f64(K, T, K)
            assert path == form[3:]
        torch.cuda.synchronize()
        errs.append(_err_vs_f64(out, ref))
        print(f"[accumulation] {form} K={K}: rms {errs[-1][0]:.3e} "
              f"bias {errs[-1][1]:+.3e} max {errs[-1][2]:.3e}")
    growth = np.log(errs[-1][0] / errs[0][0]) / np.log(ACC_K[-1] / ACC_K[0])
    print(f"[accumulation] {form}: rms error ~ K^{growth:.2f}")
    assert growth < 0.75
    assert errs[ACC_K.index(2048)][2] <= ACC_BOUND_LING_LITE
