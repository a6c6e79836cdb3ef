#!/usr/bin/env python3
"""How far rounding alone moves the int8-SP train step's gradients.

    PYTHONPATH=src python3 scripts/torch_int8_sensitivity.py

On two gloo ranks on the CPU ((1, 2): TP, SP, the "ep" dispatch) at
Ling-Lite's smoke config with fp32 compute, from the (1, 1) runner's
`init_train_params(0)` and a numpy-seeded batch of 4 x 16 tokens, this
takes `make_loss_and_grad` at step 1 (router warmup active) three times:
with `sp_comm="int8"`, again with every parameter scaled by (1 + 1e-6 *
N(0, 1)) (numpy seed 5), and with `sp_comm="native"`.  For each
gradient leaf it prints how far the perturbed run's gradient and the
native run's lie from the first: the largest element's gap as a share
of the leaf's largest value, and the gap's L2 norm as a share of the
leaf's.

An activation near an int8 level boundary quantizes to either side
under a change of its last bits, and the gradients it feeds move with
it: the perturbed column is the bar a second implementation of the int8
step can be held to (tests/test_torch_mesh_paths.py), the native column
what int8 itself changes.
"""
from __future__ import annotations

import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k],
                                                          f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree)
                for kv in _named(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _rank(rank: int, store: str):
    from repro_torch import api, interop
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import prng
    torch.set_num_threads(2)
    tmesh.init_distributed(rank, 2, init_method=f"file://{store}",
                           backend="gloo")
    mesh = tmesh.make_local_mesh(1, 2, device="cpu")
    cfg = dataclasses.replace(get_smoke_config("ling-lite"),
                              compute_dtype="float32")
    params_np = {k: v for k, v in _named(api.Runner(
        cfg, device="cpu", max_seq=16).init_train_params(0))}
    rs = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 16)))
             .long() for k in ("tokens", "labels")}
    noise = np.random.RandomState(5)

    def tree(scale):
        out = {}
        for path, t in params_np.items():
            a = t.detach().numpy()
            if scale:
                a = (a * (1 + 1e-6 * noise.randn(*a.shape))).astype(
                    np.float32)
            node = out
            keys = path.strip("/").split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = a
        return out
    grads = []
    for comm, scale in (("int8", False), ("int8", True), ("native", False)):
        runner = api.Runner(cfg, device="cpu", max_seq=16, mesh=mesh,
                            sp_comm=comm)
        params = interop.params_from_numpy(tree(scale), cfg, device="cpu",
                                           masters=True, env=runner.env)
        _, g, _ = runner.make_loss_and_grad()(params, batch, 1,
                                              prng.prng_key(1))
        grads.append([x.numpy() for x in g])
    if rank == 0:
        print(f"{'leaf':28s} {'perturbed 1e-6':>21s} {'native':>21s}")
        print(f"{'':28s} {'max':>10s} {'L2':>10s} {'max':>10s} {'L2':>10s}"
              f"  (max: of the leaf's largest |gradient|; L2: of the "
              f"leaf's L2 norm; rank 0's shard)")
        for i, (name, _) in enumerate(_named(params)):
            g = grads[0][i]
            big = max(np.abs(g).max(), 1e-30)
            norm = max(np.linalg.norm(g), 1e-30)
            cols = []
            for other in (grads[1][i], grads[2][i]):
                cols += [np.abs(other - g).max() / big,
                         np.linalg.norm(other - g) / norm]
            print(f"{name:28s} " + " ".join(f"{c:10.3e}" for c in cols))


def main():
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(f"{tmp}/store",), nprocs=2)


if __name__ == "__main__":
    main()
