"""K5's arithmetic on the CPU: an emulation of csrc/normhead.cu's order of
operations, held against the JAX package's Pallas kernel (interpret
mode) and its jnp NormHead.

The kernel streams W onto the tensor cores as the 16-row operand of
mma.sync m16n8k16, x as the 8-column one.  An fp32 W is cut into three
exact bf16 pieces (`grouped_matmul.split_bf16`), a bf16 W is one; a bf16
x is one piece and an fp32 x three, and the piece products with i + j <=
2 run (three for fp32 W x bf16 x, six for fp32 x fp32).  Each k16
product is exact (bf16 x bf16) and summed in fp32; a 64-column stage (4
k16 steps) adds the leading piece product into one set of fresh
registers and the others into a second, and both are then added to the
fp32 accumulators.  The squared norm of each W row is summed from its
fp32 values beside the products, a stage at a time per lane (4 lanes of
4 columns per k16 step), and the 4 lanes' sums are added in a butterfly;
the division comes last.  Inside each k16 step the kernel permutes the
columns (a lane's 16 bytes of a row are its A-fragment slots), and reads
x in the same permutation: the permutation only reorders a sum, which
the emulation shows by running with it and without.

Tolerance: 1e-5 of the largest logit, as the port's other K5 tests
(fp32 summation order; the references divide W before the product)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import normhead as nh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAGE, K16 = 64, 16
# csrc/normhead.cu: the k position of each A-fragment slot (2q, 2q + 1,
# 2q + 8, 2q + 9 for lane q of a quad) inside a k16 step: slot s reads
# column PERM16[s]
PERM16 = [0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15]


def kernel_order(d):
    """The columns in the order the kernel's k16 steps read them."""
    return torch.tensor([16 * b + p for b in range(d // 16) for p in PERM16])


def emulate_k5(x, w, eps=nh.EPS, order=None):
    """csrc/normhead.cu's arithmetic: fp32 (T, V) logits.  `order`
    permutes the contraction (columns of x and w alike)."""
    if order is not None:
        x, w = x[:, order], w[:, order]
    xp = gm.split_bf16(x, 3) if x.dtype == torch.float32 else [x.float()]
    wp = gm.split_bf16(w, 3) if w.dtype == torch.float32 else [w.float()]
    wf = w.float()
    V, d = wf.shape
    acc = torch.zeros(V, x.shape[0])
    for c0 in range(0, d, STAGE):
        part, tail = torch.zeros_like(acc), torch.zeros_like(acc)
        for c in range(c0, c0 + STAGE, K16):
            for i, a in enumerate(wp):
                for j, b in enumerate(xp):
                    if i + j > 2:
                        continue
                    prod = a[:, c:c + K16] @ b[:, c:c + K16].T
                    if i + j == 0:
                        part = part + prod
                    else:
                        tail = tail + prod
        acc = acc + part
        if len(wp) * len(xp) > 1:
            acc = acc + tail
    # the norm: lane q of a quad holds columns 16 kk + 4q .. + 3 of each
    # k16 step; per stage a chain of 16 squares, then the running sum
    sq = wf.view(V, d // STAGE, STAGE // K16, 4, 4) ** 2   # [st, kk, q, e]
    lanes = torch.zeros(V, 4)
    for st in range(d // STAGE):
        m = torch.zeros(V, 4)
        for kk in range(STAGE // K16):
            for e in range(4):
                m = m + sq[:, st, kk, :, e]
        lanes = lanes + m
    n = (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
    return (acc / torch.clamp(n.sqrt(), min=eps)[:, None]).T


def _case(seed, T, x_dtype, w_dtype, V=512, d=256):
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.randn(T, d).astype(np.float32)) \
        .to(getattr(torch, x_dtype))
    w = torch.tensor((0.02 * rs.randn(V, d)).astype(np.float32)) \
        .to(getattr(torch, w_dtype))
    return x, w


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


CASES = [(T, xd, wd) for T in (1, 8, 32)
         for xd, wd in (("bfloat16", "float32"), ("float32", "float32"),
                        ("bfloat16", "bfloat16"), ("float32", "bfloat16"))]


@pytest.mark.parametrize("T,x_dtype,w_dtype", CASES)
def test_k5_emulation_matches_pallas_and_jnp(T, x_dtype, w_dtype):
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config as jcfg
    from repro.core import normhead as jnh
    from repro.kernels import ops as jops
    from util import smap_env
    x, w = _case(T, T, x_dtype, w_dtype)
    got = emulate_k5(x, w, order=kernel_order(x.shape[1]))
    jx = jnp.asarray(x.float().numpy(), x_dtype)
    jw = jnp.asarray(w.float().numpy(), w_dtype)
    cfg = jcfg("rwkv6-3b")
    call, _ = smap_env(lambda env, a, b: jnh.normhead_logits(cfg, env, b, a))
    _close(got, jops.normhead_logits(jx, jw, interpret=True))
    _close(got, call(jx, jw))


@pytest.mark.parametrize("order", ["kernel", "random"])
def test_k5_column_order_only_reorders_a_sum(order):
    """The kernel's permutation inside each k16 step, and any permutation
    of the contraction, change the emulated logits by fp32 summation
    order only; the plain version (normalize, then one product) agrees
    too."""
    x, w = _case(5, 8, "bfloat16", "float32")
    d = x.shape[1]
    perm = (kernel_order(d) if order == "kernel"
            else torch.tensor(np.random.RandomState(1).permutation(d)))
    assert sorted(perm.tolist()) == list(range(d))
    a, b = emulate_k5(x, w), emulate_k5(x, w, order=perm)
    _close(b, a, rel=1e-6)
    _close(b, nh.normhead_matmul_ref(x, w))


def test_k5_emulation_pieces_are_exact_and_the_tail_matters():
    """The three pieces of an fp32 head sum to it exactly, so the
    three-piece products match the fp32 product; the leading piece alone
    (a bf16 head) misses by far more than the tolerance."""
    x, w = _case(9, 8, "bfloat16", "float32")
    assert torch.equal(sum(p.double() for p in gm.split_bf16(w, 3)),
                       w.double())
    ref = nh.normhead_matmul_ref(x, w)
    _close(emulate_k5(x, w), ref)
    lead = emulate_k5(x, gm.split_bf16(w, 1)[0].to(torch.bfloat16))
    assert (lead - ref).abs().max() > 1e-4 * ref.abs().max()
