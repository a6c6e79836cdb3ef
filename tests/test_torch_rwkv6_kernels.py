"""The port's K5 (fused NormHead logits) and K6 (WKV6 recurrence): plain
versions against the JAX package's Pallas kernels run in interpret mode
and its jnp references, on the same numpy-made inputs; and, on a CUDA
card only, the CUDA kernels against the plain versions, with the rwkv6
decay kernel (tests/test_torch_decay_split.py holds its order against
the JAX time mix on the CPU).

Tolerances: every version sums in fp32 in its own order, so outputs are
held to 1e-5 of their largest magnitude (K6's state and y over up to 64
steps; K5's logits, where the kernels divide after the product and the
jnp references divide W before it: fp32 rounding either way).  The card
tests hold the kernels to 1e-5 of the largest output at these small
sizes.

The card-only tests import no JAX, so the file also runs where only the
port's dependencies are installed (`-m cuda` on the card)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import normhead as nh
from repro_torch.kernels import ops as tops
from repro_torch.kernels import wkv6 as wk


def _reference():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref): imported here,
    not at the top, so the card-only tests need no JAX; a reference that
    fails to import fails the test, it never skips it."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _wkv_case(seed, B, T, H, hd=64, extreme=False):
    """r, k, v ~ N(0, 1); w = exp(-exp(.)) in (0, 1); u small; a
    non-zero start state.  `extreme`: w = exp(-exp(N(0, 1) +- 3)) instead,
    each element near 0 (down to ~1e-30) or near 1 (~0.95)."""
    rs = np.random.RandomState(seed)
    r, k, v = (rs.randn(B, T, H, hd).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rs.randn(B, T, H, hd) - 1.0)).astype(np.float32)
    u = (0.5 * rs.randn(H, hd)).astype(np.float32)
    s0 = (0.1 * rs.randn(B, H, hd, hd)).astype(np.float32)
    if extreme:
        shift = rs.choice([-3.0, 3.0], size=w.shape)
        w = np.exp(-np.exp(rs.randn(*w.shape) + shift)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("T", [1, 16, 64])
def test_wkv6_plain_matches_pallas_and_jnp(T):
    jnp, jops, jref = _reference()
    case = _wkv_case(T, 2, T, 2)
    y, sT = tops.wkv6(*(torch.tensor(a) for a in case))
    jy, jsT = jops.wkv6(*(jnp.asarray(a) for a in case), interpret=True)
    ry, rsT = jref.wkv6_ref(*(jnp.asarray(a) for a in case))
    for want_y, want_s in ((jy, jsT), (ry, rsT)):
        _close(y, want_y)
        _close(sT, want_s)
    # out_state is an in-place destination
    s0 = torch.tensor(case[-1])
    y2, s2 = tops.wkv6(*(torch.tensor(a) for a in case[:-1]), s0,
                       out_state=s0)
    assert s2 is s0 and torch.equal(y2, y) and torch.equal(s2, sT)


def test_wkv6_plain_rounds_y_once_to_the_inputs_dtype():
    """bf16 r, k, v: y is the fp32 sum rounded once to bf16, as the
    reference's y.astype(cdt)."""
    r, k, v, w, u, s0 = (torch.tensor(a) for a in _wkv_case(5, 1, 9, 2))
    bf = [t.to(torch.bfloat16) for t in (r, k, v)]
    y, sT = wk.wkv6_ref(*bf, w, u, s0)
    y32, s32 = wk.wkv6_ref(*(t.float() for t in bf), w, u, s0)
    assert y.dtype == torch.bfloat16 and sT.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(sT, s32)


NH_CASES = [(T, xd, wd) for T in (1, 8, 32)
            for xd in ("float32", "bfloat16") for wd in ("float32", "bfloat16")]


@pytest.mark.parametrize("T,x_dtype,w_dtype", NH_CASES)
def test_normhead_plain_matches_pallas_and_jnp(T, x_dtype, w_dtype):
    jnp, jops, _ = _reference()
    from repro.configs.base import get_smoke_config as jcfg
    from repro.core import normhead as jnh
    from util import smap_env
    rs = np.random.RandomState(T)
    x = rs.randn(T, 256).astype(np.float32)
    w = (0.02 * rs.randn(512, 256)).astype(np.float32)
    jx, jw = jnp.asarray(x, x_dtype), jnp.asarray(w, w_dtype)
    tx = torch.tensor(x).to(getattr(torch, x_dtype))
    tw = torch.tensor(w).to(getattr(torch, w_dtype))
    got = tops.normhead_logits(tx, tw)
    assert got.dtype == torch.float32
    cfg = jcfg("rwkv6-3b")
    assert cfg.norm_head
    call, _ = smap_env(lambda env, a, b: jnh.normhead_logits(cfg, env, b, a))
    _close(got, jops.normhead_logits(jx, jw, interpret=True))
    _close(got, call(jx, jw))


def test_normhead_row_scale_invariance():
    """Scaling a row of W does not change its logits (Eq. 4)."""
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(8, 64).astype(np.float32))
    w = torch.tensor(rs.randn(32, 64).astype(np.float32))
    w2 = w.clone()
    w2[5] *= 37.0
    _close(tops.normhead_logits(x, w2), tops.normhead_logits(x, w))


def test_normhead_refuses_autograd_and_cpu_launches_nothing():
    x = torch.randn(2, 64, requires_grad=True)
    w = torch.randn(16, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.normhead_logits(x, w)
    build.reset_launches()
    with torch.no_grad():
        tops.normhead_logits(x, w)
    tops.wkv6(*(torch.tensor(a) for a in _wkv_case(0, 1, 3, 1)))
    assert build.LAUNCHES["normhead_matmul"] == 0
    assert build.LAUNCHES["wkv6"] == 0


def test_kernels_refuse_devices_without_a_kernel():
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.normhead_logits(meta(2, 64), meta(16, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        tops.wkv6(meta(1, 2, 1, 64), meta(1, 2, 1, 64), meta(1, 2, 1, 64),
                  meta(1, 2, 1, 64), meta(1, 64), meta(1, 1, 64, 64))


# ---------------------------------------------------------------------------
# on the card: CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,dtype,extreme", [
    (2, 1, "bfloat16", False), (2, 16, "bfloat16", False),
    (2, 64, "float32", False), (2, 37, "bfloat16", False),
    (2, 512, "bfloat16", False), (8, 1, "bfloat16", False),
    (2, 37, "float32", True), (8, 100, "bfloat16", True)])
def test_wkv6_cuda_kernel_matches_plain(B, T, dtype, extreme):
    """Smoke shapes (4 heads of 64) from a non-zero state, the state
    updated in place: T = 1 (decode, also at B = 8), T = 37 and 100 (not
    a multiple of the kernel's 8-step chunk), T = 512 (rwkv6-3b's
    prefill length), and decays near 0 and near 1."""
    _need_cuda()
    r, k, v, w, u, s0 = (torch.tensor(a).cuda()
                         for a in _wkv_case(T, B, T, 4, extreme=extreme))
    dt = getattr(torch, dtype)
    r, k, v = (t.to(dt) for t in (r, k, v))
    y_ref, s_ref = wk.wkv6_ref(r, k, v, w, u, s0)
    before = build.LAUNCHES["wkv6"]
    state = s0.clone()
    y, sT = tops.wkv6(r, k, v, w, u, state, out_state=state)
    torch.cuda.synchronize()
    assert build.LAUNCHES["wkv6"] == before + 1
    assert sT.data_ptr() == state.data_ptr() and y.dtype == dt
    assert (sT - s_ref).abs().max() <= 1e-5 * s_ref.abs().max()
    # y in bf16 is one rounding of the fp32 sum: one ulp either way
    tol = 1e-5 * y_ref.float().abs().max() + (
        2.0 ** -8 * y_ref.float().abs().max() if dt == torch.bfloat16 else 0)
    assert (y.float() - y_ref.float()).abs().max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("T,x_dtype,w_dtype,V,d", [
    (1, "bfloat16", "float32", 512, 256), (8, "bfloat16", "float32", 512, 256),
    (13, "float32", "bfloat16", 500, 256),
    (32, "bfloat16", "bfloat16", 512, 256),
    (64, "bfloat16", "float32", 512, 256),
    (65, "bfloat16", "float32", 500, 256),
    (8, "bfloat16", "float32", 500, 256), (24, "float32", "float32", 500, 256),
    (64, "bfloat16", "float32", 500, 576), (13, "float32", "float32", 500, 1600)])
def test_normhead_cuda_kernel_matches_plain(T, x_dtype, w_dtype, V, d):
    """On the tensor cores: V = 500, not a multiple of a block's 128 rows
    or a warp's 16; T = 13 and 24 in tiles of 8 rows, T = 64 in one pass
    over W, T = 65 in two; an fp32 x as three bf16 pieces (six piece
    products against an fp32 W).  x comes in 128-column slices: d = 576
    and 1600 end in a half-empty one."""
    _need_cuda()
    rs = np.random.RandomState(T)
    x = torch.tensor(rs.randn(T, d).astype(np.float32)).cuda() \
        .to(getattr(torch, x_dtype))
    w = torch.tensor((0.02 * rs.randn(V, d)).astype(np.float32)).cuda() \
        .to(getattr(torch, w_dtype))
    before = build.LAUNCHES["normhead_matmul"]
    out = tops.normhead_logits(x, w)
    ref = nh.normhead_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert build.LAUNCHES["normhead_matmul"] == before + 1
    assert out.shape == (T, V) and out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def _decay_case(M, d, n, dtype, seed=0):
    """As tests/test_torch_decay_split.py's cases: rows ~ N(0, 1), A ~
    N(0, 1 / d), B ~ N(0, 1 / 8), w0 ~ N(0, 1) - 1, so w spreads over
    (0, 1); on the card."""
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.randn(M, d).astype(np.float32)).cuda().to(
        getattr(torch, dtype))
    a = torch.tensor((rs.randn(d, 32) / d ** 0.5).astype(np.float32)).cuda()
    b = torch.tensor((rs.randn(32, n) / 8 ** 0.5).astype(np.float32)).cuda()
    w0 = torch.tensor((rs.randn(n) - 1.0).astype(np.float32)).cuda()
    return x, a, b, w0


@pytest.mark.cuda
@pytest.mark.parametrize("M,d,n,dtype", [
    (1, 2560, 2560, "bfloat16"), (8, 2560, 2560, "bfloat16"),
    (4096, 2560, 2560, "bfloat16"), (37, 100, 128, "float32"),
    (5, 256, 64, "bfloat16"), (3, 7, 300, "float32")])
def test_rwkv_decay_cuda_kernel_matches_plain(M, d, n, dtype):
    """rwkv6-3b's decode (8 rows) and prefill (8 x 512 rows) and a single
    row at its width; d = 100 and 7 leave chunks and warp spans short or
    empty, n = 300 a partial column tile."""
    _need_cuda()
    from repro_torch.kernels import rwkv_decay as dk
    x, a, b, w0 = _decay_case(M, d, n, dtype)
    before = build.LAUNCHES["rwkv_decay"]
    got = tops.rwkv_decay(x, a, b, w0)
    ref = dk.rwkv_decay_ref(x, a, b, w0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rwkv_decay"] == before + 1
    assert got.shape == (M, n) and got.dtype == torch.float32
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2560, 100])
def test_rwkv_decay_cuda_rows_do_not_depend_on_the_call(d):
    """A row's decay has the same bits in a call of 200 rows, of 64, of
    8 (a block's rows) and alone, as a prefill and a decode tick need."""
    _need_cuda()
    x, a, b, w0 = _decay_case(200, d, 2560, "bfloat16", seed=1)
    whole = tops.rwkv_decay(x, a, b, w0)
    for size in (64, 8, 3, 1):
        parts = torch.cat([tops.rwkv_decay(x[i:i + size], a, b, w0)
                           for i in range(0, 200, size)])
        assert torch.equal(parts, whole), size


@pytest.mark.cuda
def test_rwkv6_prefill_and_ticks_agree_bitwise_at_full_width():
    """rwkv6-3b at its full width, cut to 2 layers, bf16 activations: one
    64-token prefill and 64 decode ticks from zeroed caches give the same
    last logits, bit for bit.  Every op of the block gives a row the same
    bits whatever the number of rows in the call: K5, K6 and the decay
    kernel by design, cuBLAS's bf16 products at these shapes."""
    _need_cuda()
    import dataclasses

    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=2)
    params = api.Runner(cfg, device="cuda").init_params(0)
    tokens = torch.tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, 64))).cuda()
    with torch.no_grad():
        prefill, _ = M.prefill_logits(cfg, params, {"tokens": tokens})
        caches = M.init_caches(cfg, 1, tokens.device)
        for pos in range(tokens.shape[1]):
            tick, caches = M.decode_logits(cfg, params, caches,
                                           tokens[:, pos])
    assert bool(torch.isfinite(prefill).all())
    assert torch.equal(prefill, tick)


@pytest.mark.cuda
def test_cuda_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    x = torch.zeros((2, 30), device="cuda")          # 30 fp32: 120 bytes
    with pytest.raises(ValueError, match="16-byte"):
        tops.normhead_logits(x, torch.zeros((8, 30), device="cuda"))
    with pytest.raises(ValueError, match="a must be fp32"):
        tops.rwkv_decay(torch.zeros((2, 30), device="cuda"),
                        torch.zeros((30, 32), device="cuda").bfloat16(),
                        torch.zeros((32, 8), device="cuda"),
                        torch.zeros((8,), device="cuda"))
    r = torch.zeros((1, 2, 1, 32), device="cuda")
    with pytest.raises(ValueError, match="head_dim 64"):
        tops.wkv6(r, r, r, r, torch.zeros((1, 32), device="cuda"),
                  torch.zeros((1, 1, 32, 32), device="cuda"))
