"""PyTorch/CUDA port of the Ling reproduction (`repro`).

The package mirrors `repro`'s layout and names so each module has an
obvious counterpart.  It imports torch and numpy only: nothing from JAX
and nothing from `repro`.  Hot-path kernels are hand-written CUDA for
Hopper (`kernels/csrc`); every kernel wrapper takes its plain PyTorch
version for tensors on the CPU and launches the kernel for CUDA tensors.
"""
