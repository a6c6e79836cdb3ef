"""The port's dry run (`repro_torch.launch.dryrun`, `repro_torch.roofline`)
against the JAX package and against the port's own real runs, on the CPU:

  * the roofline's pure functions (`_ring_traffic`, `paged_attn_hbm_bytes`,
    `fmt_seconds`, `model_flops_per_chip`) equal the reference's on a
    grid of inputs;
  * each rank's `meta` parameters at the production meshes (16, 16) and
    (32, 16), ranks 0 and the last, have exactly the reference's global
    shapes (`param_specs` under a directly built reference `AxisEnv`: no
    devices) cut by its specs, for Ling-Lite, Ling-Plus and one
    architecture of each block family;
  * each kernel wrapper's `meta` branch returns its CPU plain version's
    shapes and dtypes, counts one launch on an active counter and none
    in `build.LAUNCHES`;
  * at (1, 1) and smoke shapes the dry run equals a real CPU run of the
    same step under the same counter: FLOPs by dtype, bytes, kernel
    launches and kernel costs, for train, prefill and decode of
    Ling-Lite, rwkv6-3b and recurrentgemma-2b (the RG-LRU and sliding
    window family);
  * the CLI writes the reference's record keys, refuses the reference's
    flags that have no counterpart, and at a mesh of several ranks gives
    non-zero compute, memory and collective terms.
(The dry run's collectives against real ranks' `stats`:
test_torch_mesh_parity.)"""
import json
import os

import jax
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as JM
from repro import roofline as jroof
from repro.sharding import AxisEnv
from repro_torch import api, roofline
from repro_torch.configs import base as tbase
from repro_torch.kernels import build
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import normhead as nh
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as pa
from repro_torch.kernels import rwkv_decay as dk
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.sharding import make_axis_env


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's torch work on one intra-op thread: the suite runs
    several files at once beside their spawned ranks, and an
    oversubscribed torch thread pool slows each of them severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS to
    force 512 host devices, which only takes effect where JAX's backend
    starts later: the backend is started first, and the variable put
    back after the import, so nothing else in this process sees it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


# ---------------------------------------------------------------------------
# the pure functions
# ---------------------------------------------------------------------------


def test_pure_functions_match_the_reference(jdryrun):
    for kind in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                 "collective-permute"):
        for b in (0.0, 1.0, 4096.0, 3.5e9):
            for g in (1, 2, 3, 8, 16, 32, 512):
                assert roofline._ring_traffic(kind, b, g) == \
                    jroof._ring_traffic(kind, b, g), (kind, b, g)
    for args in ((8, 32, 100, 16, 4, 128, 2), (1, 1, 1, 1, 1, 64, 4),
                 (128, 2048, 0, 16, 8, 128, 2), (3, 5, 7, 8, 2, 96, 1)):
        assert roofline.paged_attn_hbm_bytes(*args) == \
            jroof.paged_attn_hbm_bytes(*args)
    for s in (0.0, 3e-7, 1e-6, 9.99e-4, 1e-3, 0.5, 1.0, 7.25, 1234.5):
        assert roofline.fmt_seconds(s) == jroof.fmt_seconds(s)
    for arch in jbase.ARCH_IDS:
        for shape in jbase.INPUT_SHAPES:
            for n in (1, 256, 512):
                assert roofline.model_flops_per_chip(
                    tbase.get_config(arch), tbase.INPUT_SHAPES[shape], n) == \
                    jdryrun.model_flops_per_chip(
                        jbase.get_config(arch), jbase.INPUT_SHAPES[shape], n)


def test_roofline_terms_on_the_h100_constants():
    """Each term over its own rate: an fp32 product at the CUDA cores'
    67 TFLOP/s, bf16 at 989, the bytes at 3.35 TB/s, and each axis'
    ring bytes over its link (NVLink inside a node, InfiniBand across)."""
    rl = roofline.roofline(
        {"bfloat16": 989e12, "float32": 67e12}, 3.35e12,
        {"tp": (8, roofline.link_bytes_s(range(8)),
                {"all_reduce": {"calls": 2, "bytes": 450e9 * 8 / 7 / 2}}),
         "dp": (16, roofline.link_bytes_s(range(0, 128, 8)),
                {"all_gather": {"calls": 1, "bytes": 50e9 / 15}})},
        model_flops=528e12)
    assert rl.compute_s == pytest.approx(2.0)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == pytest.approx(2.0)
    assert rl.links == {"tp": 450e9, "dp": 50e9}
    assert rl.collective_counts == {"all-reduce": 2, "all-gather": 1}
    assert rl.useful_ratio == pytest.approx(528e12 / (989e12 + 67e12))
    assert roofline.link_bytes_s([8, 9, 15]) == roofline.NVLINK_BYTES_S
    assert roofline.link_bytes_s([7, 8]) == roofline.IB_BYTES_S


# ---------------------------------------------------------------------------
# per-rank parameter shapes at the production meshes
# ---------------------------------------------------------------------------


def _leaf_shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for name in sorted(tree)
                for k, v in _leaf_shapes(tree[name], f"{path}/{name}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, node in enumerate(tree)
                for k, v in _leaf_shapes(node, f"{path}/{i}").items()}
    return {path: tree}


def _cut(shape, spec, dp, tp):
    """A global shape cut by a reference PartitionSpec over (dp, tp)."""
    out = []
    for i, n in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        names = part if isinstance(part, tuple) else (part,)
        k = 1
        for name in names:
            k *= {None: 1, "data": dp, "model": tp}[name]
        assert n % k == 0, (shape, spec)
        out.append(n // k)
    return tuple(out)


@pytest.mark.parametrize("mesh", [(16, 16), (32, 16)])
@pytest.mark.parametrize("arch", ["ling-lite", "ling-plus", "nemotron-4-15b",
                                  "h2o-danube-1.8b", "recurrentgemma-2b",
                                  "whisper-tiny", "rwkv6-3b"])
def test_rank_parameter_shapes_match_the_reference_specs(arch, mesh):
    dp, tp = mesh
    specs, shapes = JM.param_specs(jbase.get_config(arch),
                                   AxisEnv(("data",), "model", dp, tp), 4096)
    spec_of = _leaf_shapes(specs)
    want = {k: _cut(tuple(s.shape), spec_of[k], dp, tp)
            for k, s in _leaf_shapes(shapes).items()}
    for rank in (0, dp * tp - 1):
        env = make_axis_env(Mesh.dry(dp, tp, rank))
        for masters in (True, False):
            got = TM.init_model(tbase.get_config(arch), device="meta",
                                masters=masters, env=env)
            assert {k: tuple(t.shape) for k, t in
                    _leaf_shapes(got).items()} == want, (rank, masters)


# ---------------------------------------------------------------------------
# the kernel wrappers' meta branches
# ---------------------------------------------------------------------------


def _kernel_calls():
    """(name, wrapper, CPU operands) for every kernel wrapper, small
    shapes in the dtypes the CUDA path takes."""
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g)
    T, d, ff, G, k = 6, 16, 24, 4, 2
    keys = torch.randint(0, G, (T * k,), generator=g)
    order = torch.argsort(keys, stable=True)
    gs = torch.bincount(keys, minlength=G)
    tok, gate = order // k, torch.rand(T * k, generator=g)
    row_idx, gates, tile_group = ops._fused_layout(tok, gate, gs, T, 8)
    w = lambda *s: rnd(*s).to(torch.bfloat16)
    lay = ops.align_layout(gs, T * k, 8)
    lhs = ops._take_rows(rnd(T * k, d), lay.row_map)
    B, KV, gQ, hd, n_pages, ps, n_lp = 2, 2, 3, 32, 9, 4, 3
    q = w(B, KV, gQ, hd)
    k_pool, v_pool = w(n_pages, ps, KV, hd), w(n_pages, ps, KV, hd)
    table = torch.randint(1, n_pages, (B, n_lp), generator=g,
                          dtype=torch.int32)
    mask = torch.rand(B, 1, n_lp, ps, generator=g) > 0.3
    H = 2
    r6 = [w(2, 3, H, 64) for _ in range(3)]
    return [
        ("fused_moe_ffn", gm.fused_moe_ffn,
         (w(T, d), w(G, d, ff), w(G, ff, d), w(G, d, ff), row_idx, gates,
          tile_group), {}),
        ("grouped_matmul_aligned", gm.grouped_matmul_aligned,
         (lhs, w(G, d, ff), lay.tile_group), {"bm": 8}),
        ("grouped_matmul_wgrad", gm.grouped_matmul_wgrad,
         (w(T * k, d), rnd(T * k, ff), gs), {"out_dtype": torch.bfloat16}),
        ("paged_attn_scores_max", pa.paged_attn_scores_max,
         (q, k_pool, table, mask), {}),
        ("paged_attn_accumulate", pa.paged_attn_accumulate,
         (q, k_pool, v_pool, table, mask, rnd(B, KV, gQ)), {}),
        ("normhead_matmul", nh.normhead_matmul,
         (w(5, 64), rnd(11, 64)), {}),
        ("wkv6", wk.wkv6,
         (*r6, torch.rand(2, 3, H, 64, generator=g), rnd(H, 64),
          rnd(2, H, 64, 64)), {}),
        ("rwkv_decay", dk.rwkv_decay,
         (w(2, 3, 40), rnd(40, 32), rnd(32, 24), rnd(24)), {})]


def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _sig(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype, t.device.type) for t in outs]


@pytest.mark.parametrize("case", range(8))
def test_meta_branch_gives_the_plain_versions_shapes(case):
    name, fn, args, kwargs = _kernel_calls()[case]
    plain = _sig(fn(*args, **kwargs))
    before = dict(build.LAUNCHES)
    with roofline.counter() as c:
        got = _sig(fn(*map(_meta, args), **kwargs))
    assert [s[:2] for s in got] == [s[:2] for s in plain], name
    assert all(s[2] == "meta" for s in got)
    assert c.launches == {name: 1}
    assert build.LAUNCHES == before


# ---------------------------------------------------------------------------
# the dry run against a real CPU run
# ---------------------------------------------------------------------------

SMOKE_B, SMOKE_S = 2, 32


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["ling-lite", "rwkv6-3b",
                                  "recurrentgemma-2b"])
def test_dry_run_counts_equal_a_real_cpu_run(arch, mode):
    cfg = tbase.get_smoke_config(arch)
    runs = {}
    for device in ("meta", "cpu"):
        runner = api.Runner(cfg, device=device, max_seq=SMOKE_S,
                            mesh=Mesh.dry(1, 1) if device == "meta" else None)
        params = None
        if device == "cpu":
            params = (runner.init_train_params(0) if mode == "train"
                      else runner.init_params(0))
        shape, st = tbase.ShapeConfig("smoke", SMOKE_S, SMOKE_B, mode), \
            dryrun.Step()
        args = dryrun.step_args(runner, shape, st, params=params)
        runs[device] = dryrun.count_step(runner, shape, st, args)[0]
    meta, cpu = runs["meta"], runs["cpu"]
    assert meta.flops == cpu.flops and meta.flops
    assert meta.bytes == cpu.bytes > 0
    assert meta.kernels == cpu.kernels
    # training launches K1 and K2 only in MoE layers; serving always K5
    assert bool(meta.kernels) == (mode != "train" or cfg.is_moe)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "memory", "roofline",
                  "flags", "params_total", "params_active"}


def test_cli_writes_the_reference_record_keys(tmp_path, capsys,
                                              monkeypatch):
    """decode_32k of the smoke Ling-Lite at a (2, 2) mesh through `main`:
    the record's keys, every kernel the pair launches, non-zero terms;
    the reference's flags with no counterpart raise."""
    monkeypatch.setattr(dryrun, "get_config", tbase.get_smoke_config)
    dryrun.main(["--arch", "ling-lite", "--shape", "decode_32k", "--dp",
                 "2", "--tp", "2", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "ling-lite__decode_32k__2x2.json")
                     .read_text())
    assert REFERENCE_KEYS <= set(rec) and rec["status"] == "ok"
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] > 0
    assert set(rec["kernels"]) == {"fused_moe_ffn", "paged_attn_scores_max",
                                   "paged_attn_accumulate", "normhead_matmul"}
    assert rec["memory"]["peak_bytes"] == (rec["memory"]["argument_bytes"]
                                           + rec["memory"]["peak_live_bytes"])
    assert rec["param_storage"] == "whole on each dp rank"
    assert "[dryrun] ling-lite__decode_32k__2x2: ok" in capsys.readouterr().out
    dryrun.main(["--arch", "ling-lite", "--shape", "decode_32k", "--dp",
                 "2", "--tp", "2", "--serve-fsdp", "--out", str(tmp_path),
                 "--tag", "fsdp"])
    rec = json.loads((tmp_path / "ling-lite__decode_32k__2x2__fsdp.json")
                     .read_text())
    assert rec["param_storage"] == "fsdp over dp"
    assert rec["flags"]["serve_fsdp"]
    for flag in (["--schedule", "full"], ["--attn-block", "512"],
                 ["--no-gather-cast"]):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "ling-lite", "--out", str(tmp_path)]
                        + flag)
    assert "intended departure" in capsys.readouterr().err


def test_serve_fsdp_decides_the_decode_parameters_storage():
    """As the reference's dry run: prefill parameters whole on each dp
    rank, decode parameters whole unless `serve_fsdp`, training FSDP.
    Whole, a (2, 1) rank's parameters are the (1, 1) ones and the tick
    gathers no weight over dp."""
    cfg = tbase.get_smoke_config("ling-lite")

    def leaves(fsdp, dp):
        runner = api.Runner(cfg, device="meta", max_seq=SMOKE_S,
                            mesh=Mesh.dry(dp, 1), fsdp=fsdp)
        return [tuple(t.shape) for t in adamw.leaves(TM.init_model(
            cfg, device="meta", max_seq=SMOKE_S, env=runner.env))]

    assert leaves(False, 2) == leaves(True, 1) != leaves(True, 2)
    assert [dryrun.param_fsdp(m, f) for m in ("train", "prefill", "decode")
            for f in (False, True)] == [True, True, False, False, False,
                                        True]
    shape = tbase.ShapeConfig("smoke", SMOKE_S, 4, "decode")
    whole, fsdp = (dryrun.trace(cfg, shape, 2, 1, serve_fsdp=f)
                   for f in (False, True))
    # whole: the one all-gather returns every row's token
    assert whole["collective_stats"]["all_gather"]["calls"] == 1
    assert fsdp["collective_stats"]["all_gather"]["calls"] > 1
    assert (whole["memory"]["argument_bytes"]
            > fsdp["memory"]["argument_bytes"])
