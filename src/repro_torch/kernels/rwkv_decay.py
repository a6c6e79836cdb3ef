"""The RWKV6 time mix's data-dependent decay — wrapper over a CUDA kernel
and its plain PyTorch version (counterpart of the jnp decay in
`repro.models.rwkv6._projections`; no TPU kernel computes it).

x (..., d) bf16 or fp32, the rows the decay LoRA reads; a (d, 32), b (32,
n) and w0 (n,) fp32.  Returns w (..., n) fp32 in (0, 1):

    w = exp(-exp(w0 + tanh(x a) b))

The kernel (csrc/rwkv_decay.cu) sums every row in one order that
depends on d alone, so a token's decay has the same bits whether a
prefill computes it with the prompt's other tokens or a decode tick
computes it alone; an fp32 product's summation order changes with the
number of rows.  The plain version is the reference's two fp32
products; the two differ by fp32 rounding only.

The wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, raising on anything the kernel does not take.
Inference only: it raises where autograd would have to track an
operand.  tests/test_torch_decay_split.py emulates the kernel's order on
the CPU.

Tensors on the `meta` device (the dry run) get the CUDA path's checks,
output and scratch and launch nothing.  While a `roofline.counter()` is
active each call counts as one launch with `roofline.decay_cost`.
"""
from __future__ import annotations

import torch

from repro_torch import roofline
from repro_torch.kernels import build

RANK = 32       # csrc/rwkv_decay.cu: one lane per LoRA column
NCHUNK = 16     # csrc/rwkv_decay.cu: d's chunks, each summed by one block


def rwkv_decay_ref(x, a, b, w0):
    """Plain version: the reference's fp32 LoRA, then exp(-exp(.))."""
    dec = w0.float() + torch.tanh(x.float() @ a.float()) @ b.float()
    return torch.exp(-torch.exp(dec))


def _cost(x, a, b, w0):
    d, n = x.shape[-1], b.shape[-1]
    return roofline.decay_cost(x.numel() // max(d, 1), d, n,
                               x_itemsize=x.element_size())


@roofline.counted("rwkv_decay", _cost)
def rwkv_decay(x, a, b, w0):
    """CPU tensors: the plain version.  CUDA tensors: the kernel.  Meta
    tensors: its checks, output and scratch."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, a, b, w0)):
        raise RuntimeError("rwkv_decay has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    if x.device.type == "cpu":
        return rwkv_decay_ref(x, a, b, w0)
    if x.device.type not in ("cuda", "meta") or any(t.device != x.device
                                      for t in (a, b, w0)):
        raise ValueError(f"rwkv_decay: unsupported devices {x.device}, "
                         f"{a.device}, {b.device}, {w0.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rwkv_decay: x must be bf16 or fp32, got "
                         f"{x.dtype}")
    d, n = x.shape[-1], b.shape[-1]
    for name, t, shape in (("a", a, (d, RANK)), ("b", b, (RANK, n)),
                           ("w0", w0, (n,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"rwkv_decay: {name} must be fp32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    rows = x.reshape(-1, d).contiguous()
    M = rows.shape[0]
    if M < 1 or d < 1 or n < 1:
        raise ValueError(f"rwkv_decay: empty operands x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}")
    a, b, w0 = (t.contiguous() for t in (a, b, w0))
    out = torch.empty((M, n), dtype=torch.float32, device=x.device)
    part = torch.empty((NCHUNK, M, RANK), dtype=torch.float32,
                       device=x.device)
    if x.device.type == "meta":
        return out.reshape(x.shape[:-1] + (n,))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.entry("rwkv_decay")(
        rows.data_ptr(), a.data_ptr(), b.data_ptr(), w0.data_ptr(),
        part.data_ptr(), out.data_ptr(), M, d, n,
        int(x.dtype == torch.bfloat16), stream)
    build.check(err, "rwkv_decay")
    build.LAUNCHES["rwkv_decay"] += 1
    return out.reshape(x.shape[:-1] + (n,))
