"""K5: fused NormHead logits — wrapper over the CUDA kernel and its plain
PyTorch version (counterpart of `repro.kernels.normhead.normhead_matmul`).

x (T, d) bf16 or fp32; w (V, d) fp32 or bf16 (the LM head).  Returns
fp32 (T, V) logits x . (w / max(||w_row||, eps))^T.  The plain version is
the port's NormHead (`core.normhead`: rows normalized in fp32, then one
fp32 product); the kernel divides after the accumulation, as the TPU
kernel does, so the two differ by fp32 rounding only.

Inference only: the wrapper raises when autograd would have to track x
or w (K5 has no backward yet; training keeps `core.normhead` with
autograd), never detaching silently.  It takes the plain version for CPU
tensors and launches csrc/normhead.cu for CUDA tensors, raising on
anything the kernel does not take.
"""
from __future__ import annotations

import torch

from repro_torch.core.normhead import normalize_rows
from repro_torch.kernels import build

EPS = 1e-6
SMEM_MAX = 232448      # csrc/normhead.cu: min(T, 8) * d * 4 bytes of x
T_TILE = 8


def normhead_matmul_ref(x, w, eps: float = EPS):
    """Plain version of K5."""
    return x.float() @ normalize_rows(w, eps).T


def normhead_matmul(x, w, eps: float = EPS):
    """K5.  CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("normhead_matmul has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad (training uses core.normhead)")
    if x.device.type == "cpu":
        return normhead_matmul_ref(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"normhead_matmul: unsupported devices {x.device}, "
                         f"{w.device}")
    both = (torch.float32, torch.bfloat16)
    if x.dtype not in both or w.dtype not in both:
        raise ValueError(f"normhead_matmul: x and w must be fp32 or bf16, "
                         f"got {x.dtype}, {w.dtype}")
    T, d = x.shape
    V, d_w = w.shape
    if (d_w != d or T < 1 or (d * w.element_size()) % 16
            or min(T, T_TILE) * d * 4 > SMEM_MAX):
        raise ValueError(f"normhead_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: widths must agree, rows of w "
                         f"be 16-byte multiples and min(T, {T_TILE}) * d * 4"
                         f" <= {SMEM_MAX}")
    x, w = x.contiguous(), w.contiguous()
    if w.data_ptr() % 16:
        raise ValueError("normhead_matmul: w must be 16-byte aligned")
    out = torch.empty((T, V), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.entry("normhead_matmul")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), T, V, d,
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        eps, stream)
    build.check(err, "normhead_matmul")
    build.LAUNCHES["normhead_matmul"] += 1
    return out
