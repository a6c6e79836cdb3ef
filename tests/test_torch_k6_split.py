"""K6's arithmetic on the CPU: an emulation of csrc/wkv6.cu's order of
operations in torch fp32, held against the JAX package's Pallas kernel
(interpret mode) and its jnp reference.

The kernel splits each (batch, head)'s 64 x 64 state over threads that
own 8 rows (a row group) by 4 columns, and computes

    y_j = sum_g (a0_gj + a1_gj) + v_j * ruk,   ruk = sum_i r_i u_i k_i

where a0 / a1 sum r_i S_ij over the group's even / odd rows, the groups
are added in the fixed order g = 0..7, and ruk is summed by 8 lanes of 8
rows each and a butterfly.  The bonus term u_i k_i v_j leaves the inner
sum (exact algebra), so the kernel differs from the reference's
sum_i r_i (S_ij + u_i k_i v_j) in fp32 summation order only.  The kernel
works in chunks of 8 steps: a chunk's ruk is computed before its steps
(while the previous chunk runs), then the steps keep their group
partials, and the chunk's y is summed after them (while the next chunk
runs); the state update S <- w_i S_ij + k_i v_j follows every step's
partials.  The emulation does the same, chunk by chunk.

Tolerance: 1e-5 of the largest y and of the largest state element, as
the port's other wkv6 tests (fp32 summation order over up to 64 steps).
Cases: T = 1 (decode), 37 (not a multiple of the chunk), 64; decays from
exp(-exp(N(0, 1) - 1)) and from exp(-exp(N(0, 1) +- 3)) (each near 0 or
near 1); r, k, v in fp32 and rounded to bf16."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import wkv6 as wk

TC = 8        # csrc/wkv6.cu: timesteps a chunk
RG = 8        # rows a thread (a row group)
BUTTERFLY = ([1, 0, 3, 2, 5, 4, 7, 6], [2, 3, 0, 1, 6, 7, 4, 5],
             [4, 5, 6, 7, 0, 1, 2, 3])


def emulate_k6(r, k, v, w, u, s0):
    """csrc/wkv6.cu's arithmetic, in fp32: (y (B, T, H, hd) fp32, sT)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    B, T, H, hd = rf.shape
    ng = hd // RG
    S = s0.float().clone().view(B, H, ng, RG, hd)        # [g, i, j]
    uf = u.float()
    ys = []
    for c0 in range(0, T, TC):
        steps = range(c0, min(c0 + TC, T))
        # staging: ruk for each step of the chunk, 8 lanes of 8 rows
        ruk = []
        for t in steps:
            ru = (rf[:, t] * uf).view(B, H, 8, 8)
            kk = kf[:, t].view(B, H, 8, 8)
            p = ru[..., 0] * kk[..., 0]
            for e in range(1, 8):
                p = p + ru[..., e] * kk[..., e]
            for perm in BUTTERFLY:
                p = p + p[..., perm]
            ruk.append(p[..., 0])
        # the steps: each group's partial of y, then the state update
        parts = []
        for t in steps:
            rg = rf[:, t].view(B, H, ng, RG, 1)
            a0 = rg[:, :, :, 0] * S[:, :, :, 0]
            a1 = rg[:, :, :, 1] * S[:, :, :, 1]
            for i in range(2, RG, 2):
                a0 = a0 + rg[:, :, :, i] * S[:, :, :, i]
                a1 = a1 + rg[:, :, :, i + 1] * S[:, :, :, i + 1]
            parts.append(a0 + a1)                        # (B, H, ng, hd)
            kv = kf[:, t].view(B, H, ng, RG, 1) * vf[:, t].view(B, H, 1,
                                                                1, hd)
            S = wf[:, t].view(B, H, ng, RG, 1) * S + kv
        # the chunk's y: partials in the order g = 0..7, then v * ruk
        for s, t in enumerate(steps):
            y = parts[s][:, :, 0]
            for g in range(1, ng):
                y = y + parts[s][:, :, g]
            ys.append(y + vf[:, t] * ruk[s][..., None])
    return torch.stack(ys, dim=1), S.view(B, H, hd, hd)


def _case(seed, T, extreme, dtype, B=2, H=2, hd=64):
    """numpy-made operands; bf16 r, k, v are rounded once and handed to
    every version as the same values."""
    rs = np.random.RandomState(seed)
    r, k, v = (torch.tensor(rs.randn(B, T, H, hd).astype(np.float32))
               for _ in range(3))
    if dtype == "bfloat16":
        r, k, v = (t.to(torch.bfloat16).float() for t in (r, k, v))
    shift = rs.choice([-3.0, 3.0], size=(B, T, H, hd)) if extreme else -1.0
    w = torch.tensor(np.exp(-np.exp(rs.randn(B, T, H, hd) + shift))
                     .astype(np.float32))
    u = torch.tensor((0.5 * rs.randn(H, hd)).astype(np.float32))
    s0 = torch.tensor((0.1 * rs.randn(B, H, hd, hd)).astype(np.float32))
    return r, k, v, w, u, s0


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("T", [1, 37, 64])
@pytest.mark.parametrize("extreme", [False, True], ids=["decay", "extreme"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_emulation_matches_pallas_and_jnp(T, extreme, dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    case = _case(T + 100 * extreme, T, extreme, dtype)
    y, sT = emulate_k6(*case)
    jcase = [jnp.asarray(t.numpy()) for t in case]
    jy, jsT = jops.wkv6(*jcase, interpret=True)
    ry, rsT = jref.wkv6_ref(*jcase)
    for want_y, want_s in ((jy, jsT), (ry, rsT)):
        _close(y, want_y)
        _close(sT, want_s)


@pytest.mark.parametrize("extreme", [False, True], ids=["decay", "extreme"])
def test_k6_emulation_matches_the_plain_version(extreme):
    """Against the port's plain version, which sums the bonus inside the
    row sum, one row after the other: the same tolerance."""
    case = _case(7, 40, extreme, "float32")
    y, sT = emulate_k6(*case)
    y_ref, s_ref = wk.wkv6_ref(*case)
    _close(y, y_ref)
    _close(sT, s_ref)


def test_k6_emulation_decays_to_zero_forget_the_state():
    """w = 0 at a step (exp(-exp(x)) underflows for x above ~4.5) leaves
    S = k v^T there, whatever came before: the emulation, like the
    kernel, never divides by a decay."""
    r, k, v, w, u, s0 = _case(3, 5, False, "float32")
    w[:, 2] = 0.0
    _, s_a = emulate_k6(r[:, :3], k[:, :3], v[:, :3], w[:, :3], u, s0)
    _, s_b = emulate_k6(r[:, :3], k[:, :3], v[:, :3], w[:, :3], u,
                        torch.randn_like(s0))
    assert torch.equal(s_a, s_b)
    assert torch.isfinite(s_a).all()
