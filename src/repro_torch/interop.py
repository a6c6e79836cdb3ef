"""Convert reference parameters, given as numpy arrays, into the port's.

The JAX package's `Runner.init_params(seed)` pytree (nested dicts; a
leading layer dim on every `blocks` leaf of a uniform decoder, lists of
per-layer trees for mixed patterns and the encoder-decoder) maps key for
key and index for index onto the port's parameters, so conversion is a
tree walk plus a dtype choice.
The dtype of each leaf is the one the port's own `init_model` gives it:
with `masters` (training) every leaf in `cfg.param_dtype`, as the
reference stores it; for serving the compute dtype for leaves the
reference casts at use (attention, expert, shared-expert and embedding
weights), fp32 for the router, the norm scales and the LM head.  numpy
has no bf16, so the reference's fp32 master weights are handed over as
fp32 (exact) and cast once here.

Over a mesh (`env`) the reference's global pytree is cut into the rank's
shards by the port's spec tree (`model.param_specs`), so the tests can
feed both packages the same weights at any mesh; `shard_tree` does the
same for any tree laid out like the parameters (gradients, moments).
Where query heads, experts, rwkv heads or vocabulary rows pad to a
multiple of tp, the global shapes are those of `env`'s tp, as the
reference's `Runner.init_params` draws them at that mesh.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.sharding import LOCAL, AxisEnv


def shard_tree(tree, specs, env: AxisEnv):
    """A global pytree of numpy arrays -> the rank's slices under the spec
    tree `specs` (same layout)."""
    if isinstance(specs, dict):
        return {k: shard_tree(tree[k], specs[k], env) for k in specs}
    if isinstance(specs, list):
        return [shard_tree(t, s, env) for t, s in zip(tree, specs)]
    return np.asarray(sharding.shard(np.asarray(tree), specs, env))


def params_from_numpy(tree: Dict[str, Any], cfg, *, device="cuda",
                      masters: bool = False,
                      env: AxisEnv = LOCAL) -> Dict[str, Any]:
    """Reference params (numpy leaves, global) -> the port's params on
    `device` (the rank's shards over `env`'s mesh), in training storage
    when `masters`, else in serving storage.  Raises if the key sets,
    list lengths or shapes differ from the port's layout.  An
    encoder-decoder's `max_seq` is read off its `pos_dec`."""
    max_seq = (np.shape(tree["pos_dec"])[0] if "pos_dec" in tree
               else 4096)
    init = L.Init(device=torch.device("meta"), masters=masters, env=env)
    layout = M.init_model(cfg, device="meta", masters=masters,
                          max_seq=max_seq, env=env, init=init)

    def convert(ref, spec, path):
        if isinstance(spec, dict):
            if not isinstance(ref, dict) or set(ref) != set(spec):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                raise KeyError(f"{path or '<root>'}: reference keys {got} "
                               f"!= port keys {sorted(spec)}")
            return {k: convert(ref[k], spec[k], f"{path}/{k}") for k in spec}
        if isinstance(spec, list):
            if not isinstance(ref, (list, tuple)) or len(ref) != len(spec):
                raise KeyError(f"{path}: reference {type(ref).__name__} "
                               f"!= port list of {len(spec)}")
            return [convert(r, t, f"{path}/{i}")
                    for i, (r, t) in enumerate(zip(ref, spec))]
        arr = np.array(sharding.shard(np.asarray(ref), init.spec_of(spec),
                                      env), dtype=np.float32)  # writable copy
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{path}: reference shape {arr.shape} != port "
                             f"shape {tuple(spec.shape)}")
        return torch.from_numpy(arr).to(device=device, dtype=spec.dtype)

    return convert(tree, layout, "")
