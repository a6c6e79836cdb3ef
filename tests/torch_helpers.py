"""Helpers shared by the port's kernel test files."""
import torch


class Elsewhere(torch.Tensor):
    """A tensor on a device the port has no kernel for (an XPU: only a
    shape here, any op on it raises).  The `meta` device is no such
    device: the wrappers' meta branch serves the dry run."""

    @staticmethod
    def __new__(cls, *shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a device without a kernel")
