"""The port's rwkv6 training against the JAX package: the two WKV6
formulations the reference differentiates (`wkv6_scan`, `wkv6_chunked`)
on the same numpy-made inputs, values and gradients (torch.autograd
against jax.grad) with decays near 0 and near 1; `loss_fn` and its
gradients on converted smoke rwkv6-3b weights (2 layers, d 256, 4 heads
of 64, vocab 512) with `rwkv_chunk` 0 (the scan) and 4 (the chunked
form); three `Trainer` steps against the reference's `Trainer`; the
launcher on the CPU; and the kernel wrappers' refusal of autograd.

Tolerances: fp32 compute throughout, so the packages differ in fp32
summation order only.  One recurrence's outputs and gradients are held
to 1e-5 of their largest magnitude.  One exception, a property of the
reference's chunked form: it works in log w, so its gradient with
respect to w is the log-w gradient divided by w, and with decays near 0
(w ~ 1e-9) that division turns fp32 rounding into errors of 10-15 times
the exact gradient's largest value, in JAX's chunked form as in the
port's (the scan's w-gradient is the exact one).  There the test holds
the gradient with respect to log w (w * dL/dw), which agrees to 6e-6 of
its largest value.  The loss is held to 1e-5 relative and each
gradient leaf to 1e-5 of its largest value, as
tests/test_torch_train_model.py holds Ling's.  The trajectory takes
tests/test_torch_trainer.py's bars for the losses (1e-5 relative), the
grad norms (1e-4) and the final parameters (1e-6 absolute for all but
1e-4 of each leaf's elements), and its reason for a looser bar on every
element: AdamW divides an element's gradient by its own running
magnitude, so an element whose gradient is within rounding of 0 can end
a fraction of the learning rate apart.  Here one embedding element (a
token row whose gradient is 8e-8) ends 1.04e-5 apart after three steps,
1.04 % of the largest learning rate (1e-3), so every element is held to
2e-5 (that file's 1e-5 is 1 % of the same rate)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from util import smap_env as _smap_env

from repro import api as japi
from repro.configs.base import get_smoke_config as jcfg
from repro.data.pipeline import DataPipeline as JPipe
from repro.data.pipeline import PipelineConfig as JPipeCfg
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.models import rwkv6 as JR6
from repro.optim import schedule as JSCH
from repro.training.trainer import TrainConfig as JTrainConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config as tcfg
from repro_torch.data.pipeline import DataPipeline as TPipe
from repro_torch.data.pipeline import PipelineConfig as TPipeCfg
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as TR6
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedule as TSCH
from repro_torch.training.trainer import TrainConfig as TTrainConfig
from repro_torch.training.trainer import Trainer as TTrainer

B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# the two formulations of the recurrence, values and gradients
# ---------------------------------------------------------------------------


def _wkv_inputs(decay: str, Bw=2, T=16, H=2, hd=8, seed=0):
    rs = np.random.RandomState(seed)
    r, k, v = (rs.randn(Bw, T, H, hd).astype(np.float32) for _ in range(3))
    # w = exp(-exp(dec)): dec in [1, 3] puts w in [2e-9, 0.07], dec in
    # [-8, -5] in [0.9933, 0.9997]
    lo, hi = (1.0, 3.0) if decay == "near0" else (-8.0, -5.0)
    w = np.exp(-np.exp(rs.uniform(lo, hi, (Bw, T, H, hd)))).astype(
        np.float32)
    u = (0.5 * rs.randn(H, hd)).astype(np.float32)
    s0 = (0.1 * rs.randn(Bw, H, hd, hd)).astype(np.float32)
    gy = rs.randn(Bw, T, H, hd).astype(np.float32)
    gs = rs.randn(Bw, H, hd, hd).astype(np.float32)
    return (r, k, v, w, u, s0), gy, gs


@pytest.mark.parametrize("decay", ["near0", "near1"])
@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_wkv6_forms_and_grads_match_reference(form, decay):
    """y, the final state and the gradients of <y, gy> + <S', gs> with
    respect to r, k, v, w, u and the initial state."""
    args, gy, gs = _wkv_inputs(decay)
    jfn = (JR6.wkv6_scan if form == "scan" else
           lambda *a: JR6.wkv6_chunked(*a, chunk=4))
    tfn = (TR6.wkv6_scan if form == "scan" else
           lambda *a: TR6.wkv6_chunked(*a, chunk=4))

    def jloss(*a):
        y, s = jfn(*a)
        return jnp.sum(y * gy) + jnp.sum(s * gs), (y, s)

    (_, (jy, js)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(
        *(jnp.asarray(a) for a in args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    ty, ts = tfn(*targs)
    (torch.sum(ty * torch.tensor(gy)) + torch.sum(ts * torch.tensor(gs))
     ).backward()
    _close(ty.detach(), jy)
    _close(ts.detach(), js)
    for name, t, g in zip("rkvwus", targs, jg):
        assert t.grad is not None, name
        if name == "w" and form == "chunked" and decay == "near0":
            # the chunked form differentiates log w: its w-gradient is
            # that gradient divided by w (~1e-9 here), which amplifies
            # its rounding 1/w-fold in both packages; compare the
            # gradient with respect to log w, w * dL/dw
            _close(t.grad * t.detach(), np.asarray(g) * args[3])
        else:
            _close(t.grad, g)


def test_time_mix_picks_the_chunked_form_as_the_reference():
    """chunk tiles S in more than one chunk -> chunked, else the scan:
    the forms agree within fp32 order, and a chunk that does not tile S
    (or equals it) runs the scan exactly."""
    cfg = dataclasses.replace(tcfg("rwkv6-3b"), compute_dtype="float32")
    params = tapi.Runner(cfg, device="cpu").init_train_params(0)
    tm = TM.layer_params(params["blocks"], 0)["tmix"]
    x = torch.tensor(np.random.RandomState(1).randn(1, 8, cfg.d_model)
                     .astype(np.float32))
    scan, s_scan = TR6.time_mix(cfg, tm, x, train=True)
    for chunk in (3, 8):                          # no tiling / one chunk
        y, s = TR6.time_mix(cfg, tm, x, train=True, chunk=chunk)
        assert torch.equal(y, scan) and torch.equal(s["wkv"], s_scan["wkv"])
    y, s = TR6.time_mix(cfg, tm, x, train=True, chunk=4)
    assert not torch.equal(y, scan)
    _close(y, scan)
    _close(s["wkv"], s_scan["wkv"])


# ---------------------------------------------------------------------------
# loss_fn and its gradients; the trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jc = dataclasses.replace(jcfg("rwkv6-3b"), compute_dtype="float32")
    tc = dataclasses.replace(tcfg("rwkv6-3b"), compute_dtype="float32")
    runner = japi.Runner(jc, make_local_mesh(1, 1), fsdp=False,
                         seq_parallel=False, max_seq=S)
    return jc, tc, jax.tree.map(np.asarray, runner.init_params(0))


@pytest.mark.parametrize("chunk", [0, 4])
def test_loss_fn_value_and_grads_match_reference(weights, chunk):
    jc, tc, ref = weights
    rs = np.random.RandomState(2)
    toks = rs.randint(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels = rs.randint(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1                              # masked positions
    jflags = JM.RunFlags(rwkv_chunk=chunk)

    def f(env, params, t, lb):
        def lf(p):
            return JM.loss_fn(jc, env, p, {"tokens": t, "labels": lb},
                              step=jnp.int32(0), rng=None, flags=jflags)
        (loss, mets), g = jax.value_and_grad(lf, has_aux=True)(params)
        return loss, mets, g
    call, _ = _smap_env(f, out_specs=(P(), P(), P()))
    jloss, jmets, jgrads = jax.jit(call)(jax.tree.map(jnp.asarray, ref),
                                         jnp.asarray(toks),
                                         jnp.asarray(labels))
    params = interop.params_from_numpy(ref, tc, device="cpu", masters=True)
    for p in TA.leaves(params):
        p.requires_grad_()
    loss, mets = TM.loss_fn(tc, params,
                            {"tokens": torch.tensor(toks).long(),
                             "labels": torch.tensor(labels).long()},
                            step=0, flags=TM.RunFlags(rwkv_chunk=chunk))
    loss.backward()
    loss = float(loss.detach())
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert set(mets) == set(jmets)
    assert np.isfinite(loss)
    jg = _flat(jax.tree.map(np.asarray, jgrads))
    tg = {k: v.grad.numpy() for k, v in _flat(params).items()}
    assert set(jg) == set(tg)
    for k, r in jg.items():
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(tg[k], r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=k)


def test_trainer_trajectory_matches_reference(weights):
    """Three optimizer steps of both Trainers from the same weights and
    batches, rwkv_chunk 4 (seq 16: four chunks)."""
    jc, tc, ref = weights
    steps = 3

    def tcfg_(Cfg, Sched):
        return Cfg(n_steps=steps,
                   lr_schedule=Sched.WSDSchedule(max_lr=1e-3, warmup_steps=2,
                                                 total_steps=100),
                   log_every=0, seed=0)
    jrun = japi.Runner(jc, make_local_mesh(1, 1), max_seq=S,
                       flags=JM.RunFlags(rwkv_chunk=4))
    jt = JTrainer(jrun, JPipe(JPipeCfg(vocab_size=jc.vocab_size, seq_len=S,
                                       batch_size=B, seed=0)),
                  tcfg_(JTrainConfig, JSCH))
    jt.params = jax.tree.map(jnp.asarray, ref)
    tt = TTrainer(tapi.Runner(tc, flags=TM.RunFlags(rwkv_chunk=4),
                              device="cpu"),
                  TPipe(TPipeCfg(vocab_size=tc.vocab_size, seq_len=S,
                                 batch_size=B, seed=0)),
                  tcfg_(TTrainConfig, TSCH))
    tt.params = interop.params_from_numpy(ref, tc, device="cpu",
                                          masters=True)
    try:
        jh, th = jt.train(), tt.train()
    finally:
        jt.close()
        tt.close()
    assert [r["step"] for r in th] == list(range(steps))
    assert set(th[0]) == set(jh[0])
    for rj, rt in zip(jh, th):
        assert rt["skipped"] == rj["skipped"] is False
        np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=1e-5)
        np.testing.assert_allclose(rt["grad_norm"], rj["grad_norm"],
                                   rtol=1e-4)
    jp = {k: np.asarray(v) for k, v in _flat(jt.params).items()}
    tp = {k: v.detach().numpy() for k, v in _flat(tt.params).items()}
    assert set(jp) == set(tp)
    for k in jp:
        d = np.abs(tp[k] - jp[k])
        assert d.max() <= 2e-5, (k, float(d.max()))
        assert (d > 1e-6).mean() <= 1e-4, (k, int((d > 1e-6).sum()))
    assert np.abs(tp["/blocks/tmix/wr"] - ref["blocks"]["tmix"]["wr"]
                  ).max() > 1e-4


def test_train_launcher_trains_rwkv6_on_the_cpu(capsys):
    tlaunch.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                  "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "nan" not in out.split("final loss:")[1]


def test_kernel_wrappers_refuse_autograd():
    """K6 and the decay kernel have no backward: their wrappers raise on
    operands that require grad (on any device), and run under no_grad."""
    (r, k, v, w, u, s0), _, _ = _wkv_inputs("near1", T=4, hd=64)
    args = [torch.tensor(a) for a in (r, k, v, w, u, s0)]
    x = torch.randn(3, 16)
    a, b, w0 = torch.randn(16, 32), torch.randn(32, 8), torch.randn(8)
    for i in range(6):
        grad_args = list(args)
        grad_args[i] = grad_args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            kops.wkv6(*grad_args)
        with torch.no_grad():
            kops.wkv6(*grad_args)
    with pytest.raises(RuntimeError, match="no backward"):
        kops.rwkv_decay(x, a.requires_grad_(), b, w0)
    with torch.no_grad():
        kops.rwkv_decay(x, a, b, w0)
