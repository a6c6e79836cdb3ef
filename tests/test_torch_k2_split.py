"""The exact bf16 split behind K2 and the grouped weight gradient on the
tensor cores, on the CPU.

`grouped_matmul.split_bf16` is the kernels' arithmetic in PyTorch: an fp32
value cut by truncation into bf16 pieces.  These tests hold that the three
pieces reconstruct fp32 exactly over the range where bf16 can hold them,
and emulate in float64 the schemes the kernels run (products of the
pieces, each exact): three passes for an fp32 operand against a bf16 one,
and the six piece products with i + j <= 2 for fp32 x fp32.  The
emulation is the CPU's prediction of the card's error before fp32
summation order: within 1e-7 of the largest product, against the card
tests' 1e-5.  The schemes the kernels do not use (one bf16 pass; three
piece products for fp32 x fp32) are shown to miss that margin.

Also: the weight gradient's bf16 output is the fp32 result rounded once,
and `fused_ffn_backward(w_dtype=...)` returns exactly the cast of its fp32
weight gradients."""
import numpy as np
import pytest
import torch

from repro_torch.core import moe as TMOE
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_MAX = np.float32(3.4028235e38)


def _low16(t):
    return (t.view(torch.int32) & 0xFFFF).abs().max().item()


def _sum64(pieces):
    return sum(p.double() for p in pieces)


@pytest.mark.parametrize("e", [-105, -80, -40, -10, 0, 10, 40, 80, 120, 125])
def test_split_bf16_reconstructs_fp32_exactly(e):
    """Seeded normals times 2^e: each piece is a bf16 value and the three
    sum to x exactly (in float64, where the sum is exact) wherever |x| >=
    2^-110, whose last bit bf16 can hold; a smaller x loses less than
    2^-133."""
    rs = np.random.RandomState(e + 200)
    x = torch.tensor(np.ldexp(rs.randn(4096), e).astype(np.float32))
    pieces = gm.split_bf16(x, 3)
    assert len(pieces) == 3 and _low16(torch.stack(pieces)) == 0
    big = x.abs() >= 2.0 ** -110
    assert big.float().mean() > 0.9
    assert torch.equal(_sum64(pieces)[big], x.double()[big])
    assert (_sum64(pieces) - x.double()).abs().max().item() < 2.0 ** -133
    # the first piece is x truncated: never larger in magnitude
    assert (pieces[0].abs() <= x.abs()).all()


def test_split_bf16_at_fp32_max_stays_finite_and_exact():
    x = torch.tensor([F32_MAX, -F32_MAX, np.nextafter(F32_MAX, 0),
                      np.float32(2.0 ** 127)], dtype=torch.float32)
    pieces = gm.split_bf16(x, 3)
    assert all(torch.isfinite(p).all() for p in pieces)
    assert torch.equal(_sum64(pieces), x.double())
    # rounding the first piece to nearest would have given inf
    assert torch.isinf(x[:1].to(torch.bfloat16).float()).all()


def test_split_bf16_on_subnormals_loses_only_what_bf16_cannot_hold():
    """Below 2^-110 the last piece can fall under bf16's smallest
    subnormal (2^-133): what is lost is less than that, and exact values
    on bf16's grid still reconstruct exactly."""
    rs = np.random.RandomState(3)
    x = torch.tensor(np.concatenate([
        np.ldexp(rs.randn(2048), -128),                  # subnormal
        np.ldexp(rs.randn(2048), -118),                  # small normal
        [np.float32(1.4e-45), -np.float32(1.4e-45), 0.0],
    ]).astype(np.float32))
    pieces = gm.split_bf16(x, 3)
    assert _low16(torch.stack(pieces)) == 0
    lost = (x.double() - _sum64(pieces)).abs()
    assert lost.max().item() < 2.0 ** -133
    on_grid = torch.tensor(np.ldexp(rs.randint(-127, 128, 512), -133)
                           .astype(np.float32))
    assert torch.equal(_sum64(gm.split_bf16(on_grid, 3)), on_grid.double())


def test_split_bf16_keeps_non_finite_values_non_finite():
    x = torch.tensor([float("inf"), -float("inf"), float("nan")])
    pieces = gm.split_bf16(x, 3)
    assert not torch.isfinite(_sum64(pieces)).any()
    assert torch.isinf(pieces[0][:2]).all()


# ---------------------------------------------------------------------------
# float64 emulation of the kernels' schemes
# ---------------------------------------------------------------------------

GROUPS = [70, 0, 301, 5, 140]        # the card tests' ragged groups


def _emulate_k2(lhs, rhs, n_pieces):
    """sum over the pieces of lhs of (piece @ rhs), every product exact:
    the card's K2 on an fp32 lhs, before fp32 summation order."""
    return sum(p.double() @ rhs.double()
               for p in gm.split_bf16(lhs, 3)[:n_pieces])


def _emulate_wgrad(lhs, rhs, pairs):
    """per group, sum over the kept piece pairs (i, j) of a_i^T b_j."""
    a, b = gm.split_bf16(lhs, 3), gm.split_bf16(rhs, 3)
    out, start = [], 0
    for n in GROUPS:
        s = slice(start, start + n)
        out.append(sum(a[i][s].double().T @ b[j][s].double()
                       for i, j in pairs))
        start += n
    return torch.stack(out)


def _wgrad_exact(lhs, rhs):
    out, start = [], 0
    for n in GROUPS:
        s = slice(start, start + n)
        out.append(lhs[s].double().T @ rhs[s].double())
        start += n
    return torch.stack(out)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("K", [136, 1408])
def test_emulated_three_pass_k2_is_exact(K):
    """fp32 rows (530 x K) against bf16 weights (K x 132): three passes
    give the float64 product of the fp32 operands; one pass (the rows
    rounded to bf16) misses the card's 1e-5 at K = 1408."""
    rs = np.random.RandomState(K)
    lhs = torch.tensor(rs.randn(530, K).astype(np.float32))
    rhs = torch.tensor(rs.randn(K, 132).astype(np.float32)) \
        .to(torch.bfloat16).float()
    exact = lhs.double() @ rhs.double()
    assert _rel(_emulate_k2(lhs, rhs, 3), exact) <= 1e-7
    one_pass = lhs.to(torch.bfloat16).double() @ rhs.double()
    if K == 1408:
        assert _rel(one_pass, exact) > 1e-5


@pytest.mark.parametrize("K,N", [(136, 132), (1408, 132)])
def test_emulated_six_product_wgrad_is_within_1e7(K, N):
    """fp32 x fp32 weight gradient over the card tests' groups: the six
    piece products with i + j <= 2 stay within 1e-7 of the largest
    product; the three with i + j <= 1 do not."""
    rs = np.random.RandomState(K + N)
    lhs = torch.tensor(rs.randn(530, K).astype(np.float32))
    rhs = torch.tensor(rs.randn(530, N).astype(np.float32))
    exact = _wgrad_exact(lhs, rhs)
    six = [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]
    assert _rel(_emulate_wgrad(lhs, rhs, six), exact) <= 1e-7
    three = [(0, 0), (0, 1), (1, 0)]
    assert _rel(_emulate_wgrad(lhs, rhs, three), exact) > 1e-7


@pytest.mark.parametrize("K,N", [(136, 132), (1408, 132)])
def test_emulated_three_pass_wgrad_is_exact(K, N):
    """bf16 lhs x fp32 rhs (dW1, dW3): the fp32 side's three pieces
    against the bf16 side reproduce the float64 product."""
    rs = np.random.RandomState(K * N)
    lhs = torch.tensor(rs.randn(530, K).astype(np.float32)) \
        .to(torch.bfloat16).float()
    rhs = torch.tensor(rs.randn(530, N).astype(np.float32))
    emu = _emulate_wgrad(lhs, rhs, [(0, 0), (0, 1), (0, 2)])
    assert _rel(emu, _wgrad_exact(lhs, rhs)) <= 1e-7


# ---------------------------------------------------------------------------
# the bf16 output of the weight gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dts", [("float32", "float32"),
                                 ("bfloat16", "float32"),
                                 ("float32", "bfloat16")])
def test_wgrad_bf16_output_is_the_rounding_of_fp32(dts):
    rs = np.random.RandomState(1)
    lhs = torch.tensor(rs.randn(530, 136).astype(np.float32)) \
        .to(getattr(torch, dts[0]))
    rhs = torch.tensor(rs.randn(530, 132).astype(np.float32)) \
        .to(getattr(torch, dts[1]))
    gs = torch.tensor(GROUPS)
    f32 = gm.grouped_matmul_wgrad_ref(lhs, rhs, gs)
    b16 = gm.grouped_matmul_wgrad_ref(lhs, rhs, gs, out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))
    via_ops = tops.grouped_matmul_wgrad(lhs, rhs, gs,
                                        out_dtype=torch.bfloat16)
    assert torch.equal(via_ops, b16)


@pytest.mark.parametrize("act", ["swiglu", "squared_relu"])
def test_fused_ffn_backward_w_dtype_is_the_cast_of_fp32(act):
    """w_dtype=None keeps fp32 weight gradients; w_dtype=bf16 gives
    exactly their cast, and leaves every other output as it was."""
    rs = np.random.RandomState(5)
    T, G, k, d, ff = 12, 4, 2, 64, 96
    x = torch.tensor(rs.randn(T, d).astype(np.float32)).to(torch.bfloat16)
    w = lambda *s: torch.tensor((0.1 * rs.randn(*s)).astype(np.float32)) \
        .to(torch.bfloat16)
    w1, w2 = w(G, d, ff), w(G, ff, d)
    w3 = w(G, d, ff) if act in gm.GATED_ACTS else None
    experts = np.stack([rs.choice([0, 1, 3], k, replace=False)
                        for _ in range(T)]).reshape(-1)
    order = np.argsort(experts, kind="stable")
    tok = torch.tensor(order // k).long()
    gate = torch.tensor(rs.uniform(0.05, 1.0, T * k).astype(np.float32)) \
        .to(torch.bfloat16)
    gs = torch.tensor(np.bincount(experts[order], minlength=G))
    g = torch.tensor(rs.randn(T, d).astype(np.float32))
    args = (act, x, w1, w2, w3, tok, gate, gs, g)
    f32 = TMOE.fused_ffn_backward(*args)
    b16 = TMOE.fused_ffn_backward(*args, w_dtype=torch.bfloat16)
    for i, (a, b) in enumerate(zip(f32, b16)):
        if a is None:
            assert b is None
        elif i in (1, 2, 3):                      # dw1, dw2, dw3
            assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
            assert torch.equal(b, a.to(torch.bfloat16))
        else:
            assert torch.equal(a, b)
