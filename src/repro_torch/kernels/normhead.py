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

The kernel runs bf16 mma.sync with W as the 16-row operand, up to 64
rows of x a pass over W.  Its pieces follow from the static dtypes: an
fp32 W is cut into three exact bf16 pieces inside the kernel, a bf16 W is
one; a bf16 x (bf16 serving) is one piece, and an fp32 x (fp32
activations: the tests and chip_smoke.py's fp32 consistency runs) is cut
here into its three bf16 pieces (`split_bf16`), so fp32 x fp32 runs the
six piece products with i + j <= 2.

Tensors on the `meta` device (the dry run) get the CUDA path's checks,
its split of an fp32 x and its output, and launch nothing.  While a
`roofline.counter()` is active each call counts as one launch with
`roofline.normhead_cost`.
"""
from __future__ import annotations

import torch

from repro_torch import roofline
from repro_torch.core.normhead import normalize_rows
from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul import split_bf16

EPS = 1e-6
K_STAGE = 64          # csrc/normhead.cu: d in whole 64-column stages


def normhead_matmul_ref(x, w, eps: float = EPS):
    """Plain version of K5."""
    return x.float() @ normalize_rows(w, eps).T


def _cost(x, w, eps: float = EPS):
    (T, d), V = x.shape, w.shape[0]
    return roofline.normhead_cost(T, V, d, x_itemsize=x.element_size(),
                                  w_itemsize=w.element_size())


@roofline.counted("normhead_matmul", _cost)
def normhead_matmul(x, w, eps: float = EPS):
    """K5.  CPU tensors: the plain version.  CUDA tensors: the kernel.
    Meta tensors: its checks and output."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("normhead_matmul has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad (training uses core.normhead)")
    if x.device.type == "cpu":
        return normhead_matmul_ref(x, w, eps)
    if x.device.type not in ("cuda", "meta") or w.device != x.device:
        raise ValueError(f"normhead_matmul: unsupported devices {x.device}, "
                         f"{w.device}")
    both = (torch.float32, torch.bfloat16)
    if x.dtype not in both or w.dtype not in both:
        raise ValueError(f"normhead_matmul: x and w must be fp32 or bf16, "
                         f"got {x.dtype}, {w.dtype}")
    T, d = x.shape
    V, d_w = w.shape
    if d_w != d or T < 1 or V < 1 or d % K_STAGE:
        raise ValueError(f"normhead_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: widths must agree and d be a "
                         f"multiple of {K_STAGE} (rows of w read in whole "
                         f"16-byte vectors, {K_STAGE} columns a stage)")
    x, w = x.contiguous(), w.contiguous()
    n_x = 1 if x.dtype == torch.bfloat16 else 3
    if n_x == 3:           # its three bf16 planes, exact where |x| >= 2^-110
        x = torch.stack([p.to(torch.bfloat16) for p in split_bf16(x, 3)])
    x_ptr, w_ptr = x.data_ptr(), w.data_ptr()
    if x_ptr % 16 or w_ptr % 16:
        raise ValueError("normhead_matmul: x and w must be 16-byte aligned")
    out = torch.empty((T, V), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.entry("normhead_matmul")(
        x_ptr, w_ptr, out.data_ptr(), T, V, d, n_x,
        int(w.dtype == torch.bfloat16), eps, stream)
    build.check(err, "normhead_matmul")
    build.LAUNCHES["normhead_matmul"] += 1
    return out
