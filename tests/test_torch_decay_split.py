"""The rwkv6 decay kernel's arithmetic on the CPU: an emulation of
csrc/rwkv_decay.cu's order of operations in torch, held against the
JAX package's time mix (`repro.models.rwkv6._projections`, whose decay
is jnp) and the port's plain version.

The kernel computes w = exp(-exp(w0 + tanh(x A) B)) with every row
summed in one order that depends on d alone: d cut into 16 chunks, each
into 8 warp spans summed in i order with one fused multiply-add a step;
the spans added in warp order, the chunks in chunk order; then t B
summed over the 32 LoRA columns in order, plus w0.  The emulation does
the same, the fused multiply-add as an exact float64 product and sum
rounded to fp32.

Tolerance: 1e-5 of the largest |w|, as the port's other rwkv6 tests
(fp32 summation order).  Cases: rwkv6-3b's width (d = n = 2560) and the
smoke width (256), d = 100 (chunks and spans with tails; a span may be
empty), rows in bf16 and fp32.  The emulation gives a row the same bits
whatever the rows beside it, as the card test
`test_rwkv_decay_cuda_rows_do_not_depend_on_the_call` holds the kernel
to."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util import smap_env

from repro.configs.base import get_smoke_config
from repro.models import rwkv6 as JR6
from repro_torch.kernels import rwkv_decay as dk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WARPS = 8     # csrc/rwkv_decay.cu: warp spans a chunk


def _fma(p, q, acc):
    """fmaf in fp32: the exact product and sum, rounded once."""
    return (p.double() * q.double() + acc.double()).float()


def emulate_decay(x, a, b, w0):
    """csrc/rwkv_decay.cu's arithmetic: x (M, d) -> w (M, n) fp32."""
    xf, af, bf = x.float(), a.float(), b.float()
    M, d = xf.shape
    chunk = -(-d // dk.NCHUNK)
    span = -(-chunk // WARPS)
    total = None
    for c in range(dk.NCHUNK):
        block = None
        for w in range(WARPS):
            lo = min(d, c * chunk + w * span)
            hi = min(d, c * chunk + min(chunk, (w + 1) * span))
            acc = torch.zeros(M, dk.RANK)
            for i in range(lo, hi):
                acc = _fma(xf[:, i:i + 1], af[i], acc)
            block = acc if block is None else block + acc
        total = block if total is None else total + block
    t = torch.tanh(total)
    acc = torch.zeros(M, bf.shape[1])
    for j in range(dk.RANK):
        acc = _fma(t[:, j:j + 1], bf[j], acc)
    return torch.exp(-torch.exp(acc + w0.float()))


def _case(M, d, n, dtype, seed=0):
    """Rows ~ N(0, 1) in `dtype`; A ~ N(0, 1 / d) and B ~ N(0, 1 / 8),
    so that x A and tanh(x A) B are of order 1, and w0 ~ N(0, 1) - 1: w
    spreads over (0, 1) where it moves with every term of the sums (the
    model's init, w0 = -6, keeps w near 1 whatever the sums)."""
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.randn(M, d).astype(np.float32)).to(
        getattr(torch, dtype))
    a = torch.tensor((rs.randn(d, dk.RANK) / d ** 0.5).astype(np.float32))
    b = torch.tensor((rs.randn(dk.RANK, n) / 8 ** 0.5).astype(np.float32))
    w0 = torch.tensor((rs.randn(n) - 1.0).astype(np.float32))
    return x, a, b, w0


def _reference_decay(x, a, b, w0):
    """The JAX time mix's decay: `_projections` with the token-shift mix
    set so that its decay rows are x (mu = 0, x_prev = 0)."""
    d, n = a.shape[0], b.shape[1]
    cfg = dataclasses.replace(get_smoke_config("rwkv6-3b"), d_model=n,
                              compute_dtype="float32")
    zeros = lambda *s: jnp.zeros(s, jnp.float32)
    params = {"mu": zeros(5, d), "wr": zeros(d, n), "wk": zeros(d, n),
              "wv": zeros(d, n), "wg": zeros(d, n),
              "w_lora_a": jnp.asarray(a.numpy()),
              "w_lora_b": jnp.asarray(b.numpy()),
              "w0": jnp.asarray(w0.numpy()), "u": zeros(n)}
    xj = jnp.asarray(x.float().numpy())
    call, _ = smap_env(lambda env, p, x: JR6._projections(
        cfg, env, p, x, jnp.zeros_like(x))[3])
    w = jax.jit(call)(params, xj)
    return np.asarray(w).reshape(x.shape[0], n)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.mark.parametrize("M,d,n,dtype", [
    (3, 2560, 2560, "bfloat16"), (5, 256, 256, "float32"),
    (4, 100, 128, "bfloat16"), (2, 100, 64, "float32")])
def test_emulation_matches_reference_and_plain(M, d, n, dtype):
    x, a, b, w0 = _case(M, d, n, dtype)
    got = emulate_decay(x, a, b, w0)
    _close(got, dk.rwkv_decay_ref(x, a, b, w0))
    _close(got, _reference_decay(x, a, b, w0))


@pytest.mark.parametrize("d", [2560, 100])
def test_emulation_gives_a_row_the_same_bits_whatever_rows_share_it(d):
    x, a, b, w0 = _case(6, d, 128, "bfloat16", seed=1)
    whole = emulate_decay(x, a, b, w0)
    for i in range(x.shape[0]):
        assert torch.equal(whole[i:i + 1],
                           emulate_decay(x[i:i + 1], a, b, w0))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    from repro_torch.kernels import build
    x, a, b, w0 = _case(2, 64, 64, "bfloat16")
    before = build.LAUNCHES["rwkv_decay"]
    got = dk.rwkv_decay(x.reshape(1, 2, 64), a, b, w0)
    assert build.LAUNCHES["rwkv_decay"] == before
    assert got.shape == (1, 2, 64) and got.dtype == torch.float32
    assert torch.equal(got.reshape(2, 64), dk.rwkv_decay_ref(x, a, b, w0))
    with pytest.raises(RuntimeError, match="no backward"):
        dk.rwkv_decay(x, a.requires_grad_(), b, w0)
