"""K6: the WKV6 recurrence — wrapper over the CUDA kernel and its plain
PyTorch version (counterpart of `repro.kernels.wkv6.wkv6_chunked`).

Operands in the time mix's own layout: r, k, v, w (B, T, H, hd) — r, k,
v in the compute dtype (bf16 or fp32), w the fp32 per-key-channel decay
in (0, 1); u (H, hd) fp32 bonus; s0 (B, H, hd, hd) fp32 carried state.
Returns (y (B, T, H, hd) in r's dtype, sT (B, H, hd, hd) fp32):

    y_t = (S + diag(u * k_t) . v_t^T)^T r_t ;  S <- diag(w_t) S + k_t v_t^T

summed in fp32 and rounded to r's dtype once at the end, as the
reference's `y.astype(cdt)` does.  `out_state` receives sT (it may be s0:
the decode tick updates its state in place).

The wrapper takes the plain version for CPU tensors and launches
csrc/wkv6.cu for CUDA tensors, raising on anything the kernel does not
take, and on operands that require grad (inference only: training runs
the reference's plain forms, `models.rwkv6`).  The kernel splits each
(b, h) over two blocks of 64 threads (a half of the state's columns
each, 8 rows x 4 columns a thread), stages
8-timestep chunks two ahead by cp.async, sums each chunk's y while the
next one computes, and adds the row groups' partial y in a fixed order (`y = sum_i r_i S_ij +
v_j * sum_i r_i u_i k_i`); tests/test_torch_k6_split.py emulates that
order on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

HD = 64   # csrc/wkv6.cu: the head dim the kernel takes


def wkv6_ref(r, k, v, w, u, s0):
    """Plain version of K6: the sequential recurrence of `ref.wkv6_ref` /
    `rwkv6.wkv6_scan`, one step per timestep, in fp32."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[..., None]                       # (H, hd, 1)
    S = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, hd, hd)
        ys.append(torch.einsum("bhkv,bhk->bhv", S + uf * kv, rf[:, t]))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def _check(r, k, v, w, u, s0, out_state):
    B, T, H, hd = r.shape
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"wkv6: r, k, v must be bf16 or fp32, got {r.dtype}")
    for name, t, dt, shape in (("k", k, r.dtype, r.shape),
                               ("v", v, r.dtype, r.shape),
                               ("w", w, torch.float32, r.shape),
                               ("u", u, torch.float32, (H, hd)),
                               ("s0", s0, torch.float32, (B, H, hd, hd))):
        if t.dtype != dt or tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6: {name} must be {dt} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if hd != HD or T < 1:
        raise ValueError(f"wkv6: the kernel takes head_dim {HD} and T >= 1,"
                         f" got r {tuple(r.shape)}")
    if out_state is not None and (out_state.dtype != torch.float32
                                  or out_state.shape != s0.shape
                                  or not out_state.is_contiguous()):
        raise ValueError("wkv6: out_state must be a contiguous fp32 tensor "
                         "shaped like s0")


def wkv6(r, k, v, w, u, s0, *, out_state: Optional[torch.Tensor] = None):
    """K6.  CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        raise RuntimeError("wkv6 has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad (training uses "
                           "models.rwkv6.wkv6_scan / wkv6_chunked)")
    if r.device.type == "cpu":
        y, sT = wkv6_ref(r, k, v, w, u, s0)
        if out_state is not None:
            sT = out_state.copy_(sT)
        return y, sT
    _check(r, k, v, w, u, s0, out_state)
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    if out_state is not None and out_state.data_ptr() == s0.data_ptr():
        s0 = out_state                   # in place: keep the aliasing
    else:
        s0 = s0.contiguous()
    B, T, H, hd = r.shape
    y = torch.empty_like(r)
    sT = out_state if out_state is not None else torch.empty_like(s0)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = build.entry("wkv6")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, T, H, hd,
        int(r.dtype == torch.bfloat16), stream)
    build.check(err, "wkv6")
    build.LAUNCHES["wkv6"] += 1
    return y, sT
