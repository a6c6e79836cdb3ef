"""K1's numerics and path choice on the CPU.

K1's down product h W2 runs on bf16 tensor cores with the fp32 hidden h
cut exactly into three bf16 pieces (`grouped_matmul.split_bf16` is that
arithmetic in PyTorch), each product of a piece with the bf16 W2 exact.
These tests emulate that scheme in float64 and hold it to the plain
version `fused_moe_ffn_ref` within 1e-6 of the largest output (what is
left is the plain version's own fp32 rounding), for every activation; and
show that one bf16 pass of h misses the 1e-5 bar the card's tests hold.

They also hold the wrapper's choice of kernels (`k1_path`, from static
shapes only): weight streaming at Ling-Lite's decode ticks (T = 8, cap / G
= 0.75) and prefill chunks (T = 64, 6), the tensor cores at its training
batch (T = 2048, 192), and the paths the card-only tests of
tests/test_torch_kernels.py mean to exercise."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops as tops

ACTS = ["swiglu", "geglu", "gelu", "squared_relu"]


def _case(seed, act, T=70, G=4, k=2, d=64, ff=128):
    """Weights and routing as the kernel tests make them (expert 2 empty),
    in the layout the wrapper receives."""
    rs = np.random.RandomState(seed)
    bf = lambda a: torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    x = bf(rs.randn(T, d))
    w1, w2 = bf(0.1 * rs.randn(G, d, ff)), bf(0.1 * rs.randn(G, ff, d))
    w3 = bf(0.1 * rs.randn(G, d, ff)) if act in gm.GATED_ACTS else None
    experts = np.stack([rs.choice([0, 1, 3], k, replace=False)
                        for _ in range(T)]).reshape(-1)
    order = np.argsort(experts, kind="stable")
    tok = torch.tensor((order // k).astype(np.int32))
    gate = torch.tensor(rs.uniform(0.05, 1.0, T * k).astype(np.float32))
    gs = torch.tensor(np.bincount(experts[order], minlength=G)
                      .astype(np.int32))
    bm = min(128, max(8, T * k))
    return (x, w1, w2, w3) + tuple(tops._fused_layout(tok, gate, gs, T, bm))


def _split_down(args, act, n):
    """The plain version with h W2 as the sum over h's n bf16 pieces of
    piece W2, in float64 (each piece's products exact, as on the card)."""
    x, w1, w2, w3, row_idx, gates, tile_group = args
    T, d = x.shape
    G = w1.shape[0]
    bm = row_idx.shape[1]
    tok = row_idx.reshape(-1).long()
    gate = gates.reshape(-1).double()
    expert = tile_group.long().repeat_interleave(bm)
    live = (gate != 0) & (expert < G)
    out = torch.zeros((T, d), dtype=torch.float64)
    for e in range(G):
        sel = torch.nonzero(live & (expert == e)).squeeze(1)
        if sel.numel() == 0:
            continue
        xe = x.float()[tok[sel]]
        h = gm.apply_act(act, xe @ w1[e].float())
        if w3 is not None:
            h = h * (xe @ w3[e].float())
        y = sum(p.double() @ w2[e].double() for p in gm.split_bf16(h, n))
        out.index_add_(0, tok[sel], y * gate[sel, None])
    return out


@pytest.mark.parametrize("act", ACTS)
def test_three_bf16_pieces_of_h_match_the_plain_version(act):
    args = _case(11, act)
    ref = gm.fused_moe_ffn_ref(*args, act=act).double()
    split = _split_down(args, act, 3)
    scale = ref.abs().max().item()
    assert (split - ref).abs().max().item() <= 1e-6 * scale


def test_one_bf16_pass_of_h_misses_the_card_tolerance():
    """h rounded to bf16 once (its first piece) errs by ~2^-9 of each
    product: far past the 1e-5 the card's tests hold, so the down product
    takes three passes."""
    args = _case(12, "swiglu")
    ref = gm.fused_moe_ffn_ref(*args, act="swiglu").double()
    one = _split_down(args, "swiglu", 1)
    assert (one - ref).abs().max().item() > 1e-5 * ref.abs().max().item()


def _layout_shape(T, k, G):
    """(n_m, bm) of the layout `ops.moe_fused_ffn` builds for T tokens
    top-k over G experts: cap = T k rows, bm = min(128, max(8, cap))."""
    cap = T * k
    bm = min(128, max(8, cap))
    rs = np.random.RandomState(T)
    gs = torch.tensor(np.bincount(rs.randint(0, G, cap), minlength=G))
    lay = tops.align_layout(gs, cap, bm)
    return lay.tile_group.shape[0], bm


@pytest.mark.parametrize("T,path", [(8, "stream"), (64, "stream"),
                                    (2048, "tensor_cores")])
def test_path_choice_at_ling_lite_shapes(T, path):
    """Ling-Lite: 64 experts top-6; cap / G = 0.75, 6 and 192."""
    G, k = 64, 6
    n_m, bm = _layout_shape(T, k, G)
    rows = gm.k1_rows_per_expert(n_m, bm, G)
    assert T * k / G <= rows < T * k / G + bm / G
    assert gm.k1_path(n_m, bm, G) == path


@pytest.mark.parametrize("T,path", [(70, "tensor_cores"), (13, "stream"),
                                    (60, "stream")])
def test_path_choice_of_the_card_tests(T, path):
    """The shapes tests/test_torch_kernels.py runs each path with (4
    experts top-2; the same cap whatever the routing)."""
    n_m, bm = _layout_shape(T, 2, 4)
    assert gm.k1_path(n_m, bm, 4) == path


def test_path_threshold_is_the_stream_kernels_narrow_side():
    """The last layout size whose rows per expert are at most 32 streams;
    one tile more takes the tensor cores."""
    G, bm = 64, 128
    n_m = (32 * G + G * (bm - 1)) // bm
    assert gm.k1_rows_per_expert(n_m, bm, G) <= 32
    assert gm.k1_path(n_m, bm, G) == "stream"
    assert gm.k1_path(n_m + 1, bm, G) == "tensor_cores"
