"""The port's parameters against the JAX package's: conversion of
`Runner.init_params(0)` key for key, fp32 leaves bitwise, the port's own
init at full Ling-Lite with the reference's shapes, the config copies,
and the import boundary (no module of the port imports jax or repro)."""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import api
from repro.configs import base as jbase
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.sharding import make_axis_env
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def converted():
    cfg = jbase.get_smoke_config("ling-lite")
    runner = api.Runner(cfg, make_local_mesh(1, 1), fsdp=False,
                        seq_parallel=False, max_seq=64)
    ref = jax.tree.map(np.asarray, runner.init_params(0))
    port = interop.params_from_numpy(
        ref, tbase.get_smoke_config("ling-lite"), device="cpu")
    return ref, port


def test_conversion_is_leaf_for_leaf(converted):
    ref, port = converted
    ref_leaves, port_leaves = dict(_leaves(ref)), dict(_leaves(port))
    assert set(ref_leaves) == set(port_leaves)
    assert "/blocks/moe/we3" in port_leaves
    for path, r in ref_leaves.items():
        assert tuple(port_leaves[path].shape) == r.shape, path


def test_fp32_leaves_bitwise_and_cast_leaves_rounded_once(converted):
    """fp32 leaves (router, norms, LM head) come through bitwise; the
    leaves the reference casts at use are the bf16 rounding of the fp32
    master (exact: both round to nearest even)."""
    ref, port = converted
    port_leaves = dict(_leaves(port))
    fp32 = {"/blocks/moe/router/wr", "/blocks/norm1/scale",
            "/blocks/norm2/scale", "/final_norm/scale", "/embed/lm_head"}
    for path, r in _leaves(ref):
        t = port_leaves[path]
        if path in fp32:
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), r)
        else:
            assert t.dtype == torch.bfloat16, path
            assert torch.equal(t, torch.tensor(r).to(torch.bfloat16))


def test_conversion_rejects_a_missing_key(converted):
    ref, _ = converted
    broken = dict(ref, embed={"table": ref["embed"]["table"]})
    with pytest.raises(KeyError, match="embed"):
        interop.params_from_numpy(
            broken, tbase.get_smoke_config("ling-lite"), device="cpu")


def test_full_size_init_shapes_match_reference_specs():
    """The port's init at full Ling-Lite has exactly the reference's
    parameter shapes (meta device: nothing is allocated)."""
    jcfg = jbase.get_config("ling-lite")
    env = make_axis_env(make_local_mesh(1, 1))
    _, shapes = JM.param_specs(jcfg, env, 4096)
    port = TM.init_model(tbase.get_config("ling-lite"), device="meta")
    ref_leaves = {p: tuple(s.shape) for p, s in _leaves(shapes)}
    port_leaves = {p: tuple(t.shape) for p, t in _leaves(port)}
    assert port_leaves == ref_leaves
    assert port_leaves["/blocks/moe/we1"] == (28, 64, 2048, 1408)
    assert all(t.device.type == "meta" for _, t in _leaves(port))


@pytest.mark.parametrize("arch", ["ling-lite", "rwkv6-3b", "h2o-danube-1.8b"])
def test_config_copies_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ours = dataclasses.asdict(getattr(tbase, get)(arch))
        theirs = dataclasses.asdict(getattr(jbase, get)(arch))
        assert ours == theirs, get


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tbase.get_config("recurrentgemma-2b")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
