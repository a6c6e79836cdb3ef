#!/usr/bin/env python3
"""The online engine's telemetry cost on the tick, on one card: this
checkout's port against another version of it, in one process.

    python3 scripts/torch_telemetry_cost.py --base-src DIR [--rounds 10]

DIR holds another version of the port (for instance an unpacked parent
commit's `src`, whose engine keeps no telemetry).  Both versions are
imported into this process, each its own `repro_torch` modules, and both
serve on one set of full-width Ling-Lite weights (random, from
torch.Generator(device="cuda").manual_seed(0), made by this checkout's
port) with the geometry of chip_smoke.py's phase 5 (8 slots, page 16,
prefill chunk 64, context 512).

A run builds a fresh engine, submits 16 requests (64-256-token prompts,
numpy seed 0, 32 new tokens each) at once, runs 16 ticks untimed (all 8
slots are decoding by then while prefill chunks continue), then times 12
engine ticks on the host clock: the whole tick (torch.cuda.synchronize
before and after) and, inside it, the decode tick (synchronized on both
sides too).  Each round runs base, change, change, base, so every round
gives two runs a side; a run's figure is its median over its 12 ticks.

Prints, for the decode tick and the whole tick, each side's median and
interquartile range over its runs, and the median and interquartile range
of the per-round difference (change minus base, the mean of each side's
two runs in the round).

Then the telemetry's own host time, which the host's spread between runs
hides: three more runs of this checkout's engine with every telemetry
object it calls (its metrics, request log and timer, and its per-tick
counter sampling) behind a proxy that adds up the time spent inside
their calls (outermost calls only; a timer span's entry and exit, not
its body), printed per tick beside the tick's time.  Needs a CUDA card;
prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

SKIP, TICKS, N_REQ, MAX_NEW = 16, 12, 16, 32


def load_port(src: Path):
    """Import the port found in `src` and detach its modules from
    sys.modules, so that another version can be imported beside it.
    The port imports its own modules only at module level, so each
    version keeps calling its own code."""
    sys.path.insert(0, str(src))
    try:
        from repro_torch import api
        from repro_torch.configs.base import get_config
        from repro_torch.kernels import build
        from repro_torch.serving import online
        cfg = get_config("ling-lite")
    finally:
        sys.path.remove(str(src))
        for name in [n for n in sys.modules
                     if n == "repro_torch" or n.startswith("repro_torch.")]:
            del sys.modules[name]
    return {"api": api, "online": online, "build": build, "cfg": cfg,
            "where": Path(api.__file__).parent}


class _Clock:
    """Adds up the time inside its outermost `with` blocks."""

    def __init__(self):
        self.depth, self.total = 0, 0.0

    def __enter__(self):
        if self.depth == 0:
            self.t0 = time.perf_counter()
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1
        if self.depth == 0:
            self.total += time.perf_counter() - self.t0


class _Timed:
    """A proxy whose method calls run under `clock`; a context manager
    they return has its entry and exit timed, not its body."""

    def __init__(self, obj, clock: _Clock):
        self._obj, self._clock = obj, clock

    def __getattr__(self, name):
        f = getattr(self._obj, name)
        if not callable(f):
            return f

        def call(*args, **kw):
            with self._clock:
                out = f(*args, **kw)
            return _Timed(out, self._clock) if hasattr(out, "__enter__") \
                else out
        return call

    def __enter__(self):
        with self._clock:
            return self._obj.__enter__()

    def __exit__(self, *exc):
        with self._clock:
            return self._obj.__exit__(*exc)


def instrument(eng) -> _Clock:
    """Put the engine's telemetry objects behind `_Timed` proxies."""
    clock = _Clock()
    for name, value in list(vars(eng).items()):
        if value is not None and (name in ("rlog", "timer")
                                  or name.startswith(("_m_", "_g_", "_s_"))):
            setattr(eng, name, _Timed(value, clock))
    sample = eng._sample_counters

    def timed_sample():
        with clock:
            sample()
    eng._sample_counters = timed_sample
    return clock


def one_run(port, params, prompts, telemetry: bool = False):
    """A fresh engine over the workload: per-tick (decode ms, tick ms) of
    the 12 timed ticks; with `telemetry`, per-tick (telemetry ms, tick
    ms) with the engine's telemetry objects timed."""
    import torch
    online = port["online"]
    runner = port["api"].Runner(port["cfg"], device="cuda")
    eng = online.OnlineEngine(runner, params, online.OnlineConfig(
        max_slots=8, max_context=512, page_size=16, prefill_chunk=64))
    eng.submit_many([online.OnlineRequest(rid=i, prompt=p, max_new=MAX_NEW)
                     for i, p in enumerate(prompts)])
    for _ in range(SKIP):
        eng.tick()
    if telemetry:
        clock, spent, whole = instrument(eng), [], []
        for _ in range(TICKS):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), clock.total
            eng.tick()
            torch.cuda.synchronize()
            whole.append(1e3 * (time.perf_counter() - t0))
            spent.append(1e3 * (clock.total - c0))
        del eng
        return spent, whole
    dec = []
    inner = eng._decode_tick

    def timed_decode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        dec.append(1e3 * (time.perf_counter() - t0))

    eng._decode_tick = timed_decode
    whole = []
    for _ in range(TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        whole.append(1e3 * (time.perf_counter() - t0))
    del eng
    return dec, whole


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-src", required=True,
                    help="the other version's `src` directory")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_telemetry_cost: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    here = Path(__file__).resolve().parents[1] / "src"
    ports = {"base": load_port(Path(args.base_src).resolve()),
             "change": load_port(here)}
    t0 = time.perf_counter()
    for side, port in ports.items():
        port["build"].build_all()
        print(f"[cost] {side}: port from {port['where']}")
    print(f"[cost] kernels built in {time.perf_counter() - t0:.1f}s")
    params = ports["change"]["api"].Runner(
        ports["change"]["cfg"], device="cuda").init_params(0)
    rs = np.random.RandomState(0)
    lens = rs.randint(64, 257, size=N_REQ)
    vocab = ports["change"]["cfg"].vocab_size
    prompts = [rs.randint(0, vocab, n).astype(np.int32) for n in lens]
    for side in ports:                                # warm-up
        one_run(ports[side], params, prompts)
    med = lambda xs: float(np.median(xs))
    runs = {side: {"decode": [], "tick": []} for side in ports}
    diffs = {"decode": [], "tick": []}
    for r in range(args.rounds):
        got = {side: {"decode": [], "tick": []} for side in ports}
        for side in ("base", "change", "change", "base"):
            dec, whole = one_run(ports[side], params, prompts)
            for key, xs in (("decode", dec), ("tick", whole)):
                got[side][key].append(med(xs))
                runs[side][key].append(med(xs))
        for key in diffs:
            diffs[key].append(np.mean(got["change"][key])
                              - np.mean(got["base"][key]))
        print(f"[cost] round {r}: decode base "
              f"{got['base']['decode']} change {got['change']['decode']}; "
              f"tick base {got['base']['tick']} change "
              f"{got['change']['tick']} (ms)")
    q = lambda xs: np.percentile(xs, [25, 50, 75])
    for key, label in (("decode", "decode tick"), ("tick", "engine tick")):
        for side in ports:
            lo, mid, hi = q(runs[side][key])
            print(f"[cost] {label} {side}: median {mid:.3f} ms, IQR "
                  f"{lo:.3f}-{hi:.3f} ({hi - lo:.3f}) over "
                  f"{len(runs[side][key])} runs")
        lo, mid, hi = q(diffs[key])
        print(f"[cost] {label} change - base: median {mid:+.3f} ms, IQR "
              f"{lo:+.3f} to {hi:+.3f} over {len(diffs[key])} rounds; "
              f"{sum(d > 0 for d in diffs[key])} of {len(diffs[key])} "
              f"rounds positive")
    spent, whole = [], []
    for _ in range(3):
        s_, w_ = one_run(ports["change"], params, prompts, telemetry=True)
        spent += s_
        whole += w_
    lo, mid, hi = q(spent)
    print(f"[cost] telemetry's own host time per engine tick (change, "
          f"{len(spent)} ticks): median {1e3 * mid:.1f} us, IQR "
          f"{1e3 * lo:.1f}-{1e3 * hi:.1f} us, max {1e3 * max(spent):.1f} "
          f"us; the same ticks' median {med(whole):.3f} ms "
          f"({mid / med(whole):.3%} of it)")


if __name__ == "__main__":
    main()
