"""The engines' debug sync guards (counterpart of the part of
`repro.analysis.contracts` that PyTorch has a use for).

* `env_debug_guards` — the default of the engines' ``debug_guards`` flag,
  read from the ``REPRO_DEBUG_GUARDS`` environment variable.
* `transfer_guard` — the hot loops' device→host guard, built on
  `torch.cuda.set_sync_debug_mode`.  Armed ("disallow"), any call that
  makes the host wait for the card raises: a ``.cpu()``, ``.item()``,
  ``bool(tensor)``, ``nonzero``, or a blocking host→device copy from
  pageable memory.  JAX's "disallow" blocks only *implicit* transfers, so
  the reference announces each intended drain with an explicit
  ``jax.device_get``; torch's mode also stops an explicit ``.cpu()``, so
  the port announces each drain by running it under `announced_drain`,
  which lifts the guard around that one statement.
* Without a CUDA card there is nothing to guard: `transfer_guard` then
  does nothing, as JAX's CPU backend never fires its transfer guards.

Not ported: `CompileCounter`, `compile_guard` and `donation_check`
count XLA traces and check donated buffers.  PyTorch runs eagerly and
has neither traces nor donation, so they would count nothing.  Where a
loop of small launches is bound by the host, the tool is a CUDA graph,
which belongs to a PR that makes the port faster, not to a slice of the
port (ROADMAP, "Kernel work beyond the port": the serving steps as CUDA
graphs).
"""
from __future__ import annotations

import contextlib
import os

import torch

# jax.transfer_guard levels -> torch.cuda sync debug modes
LEVELS = {"allow": "default", "log": "warn", "disallow": "error",
          "disallow_explicit": "error"}


def env_debug_guards(default: bool = False) -> bool:
    """Default for the engines' ``debug_guards`` flag: the
    ``REPRO_DEBUG_GUARDS`` env var ("1"/"true"/"yes"/"on" enable)."""
    raw = os.environ.get("REPRO_DEBUG_GUARDS")
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


@contextlib.contextmanager
def transfer_guard(level: str = "disallow"):
    """Run the block under the sync debug mode of JAX's `level` ("allow",
    "log", "disallow", "disallow_explicit"); the previous mode comes back
    on exit.  A no-op where torch has no CUDA card."""
    if level not in LEVELS:
        raise ValueError(f"transfer_guard level {level!r} not in "
                         f"{sorted(LEVELS)}")
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(LEVELS[level])
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def announced_drain():
    """An intended device→host read inside a guarded block (the
    reference's explicit ``jax.device_get``): the guard is lifted for the
    ``with`` block only."""
    return transfer_guard("allow")
