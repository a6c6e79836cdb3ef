"""Convert reference parameters, given as numpy arrays, into the port's.

The JAX package's `Runner.init_params(seed)` pytree (nested dicts, a
leading layer dim on every `blocks` leaf) maps key for key onto the
port's parameter dict, so conversion is a key walk plus a dtype choice.
The dtype of each leaf is the one the port's own `init_model` gives it:
with `masters` (training) every leaf in `cfg.param_dtype`, as the
reference stores it; for serving the compute dtype for leaves the
reference casts at use (attention, expert, shared-expert and embedding
weights), fp32 for the router, the norm scales and the LM head.  numpy
has no bf16, so the reference's fp32 master weights are handed over as
fp32 (exact) and cast once here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import model as M


def params_from_numpy(tree: Dict[str, Any], cfg, *, device="cuda",
                      masters: bool = False) -> Dict[str, Any]:
    """Reference params (numpy leaves) -> the port's params on `device`,
    in training storage when `masters`, else in serving storage.  Raises
    if the key sets or shapes differ from the port's layout."""
    layout = M.init_model(cfg, device="meta", masters=masters)

    def convert(ref, spec, path):
        if isinstance(spec, dict):
            if not isinstance(ref, dict) or set(ref) != set(spec):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                raise KeyError(f"{path or '<root>'}: reference keys {got} "
                               f"!= port keys {sorted(spec)}")
            return {k: convert(ref[k], spec[k], f"{path}/{k}") for k in spec}
        arr = np.array(ref, dtype=np.float32)          # writable copy
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{path}: reference shape {arr.shape} != port "
                             f"shape {tuple(spec.shape)}")
        return torch.from_numpy(arr).to(device=device, dtype=spec.dtype)

    return convert(tree, layout, "")
