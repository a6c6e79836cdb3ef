"""Drafters for speculative decoding in the online engine (counterpart of
`repro.serving.draft`).

A drafter has ``build(runner, params) -> (draft_runner, draft_params)``;
the returned runner and params drive `api.Runner.make_paged_draft_propose`
over the drafter's OWN page pools.  The engine gives those pools the
target's page ids, page size and pool count, so admission, growth,
preemption, prefix sharing and trim carry over to the drafter's KV.

  * `SelfDrafter`: the target's first `draft_layers` blocks plus its
    embedding, final norm and head.  Its parameters are views of the
    target's (slices of the stacked leaves, no copy; over a mesh of the
    rank's shards), so it costs only its KV pool.  `draft_layers == n_layers` is the target itself: q ==
    p, and every draft is accepted.
  * `ConfigDrafter`: any small paged config with the target's vocab;
    weights given or drawn from `init_seed`.  `adapt_drafter_config`
    rewrites a foreign config into one ("swa" blocks to "attn", the
    target's vocab).

The engine is correct for any drafter (greedy streams are bit for bit
the non-speculative ones); a drafter only changes how many ticks a
token takes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch import api, sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def _draft_runner(cfg: ModelConfig, runner: "api.Runner") -> "api.Runner":
    """The drafter's runner on the target's device and mesh (its serving
    steps run with SP off, as every serving step)."""
    return api.Runner(cfg, flags=runner.flags, device=runner.device,
                      mesh=runner.mesh)


def _cut(tree, specs, env):
    """A global parameter tree -> the rank's shards under `specs` (the cut
    `init_params` applies), each a contiguous tensor."""
    if isinstance(specs, dict):
        return {k: _cut(tree[k], specs[k], env) for k in specs}
    if isinstance(specs, list):
        return [_cut(t, s, env) for t, s in zip(tree, specs)]
    return sharding.shard(tree, specs, env).contiguous()


@dataclasses.dataclass
class SelfDrafter:
    """Truncated-layer self-draft: the target's first `draft_layers`
    blocks and its embedding, final norm and head.  No new weights."""
    draft_layers: int
    name: str = "self"

    def build(self, runner: "api.Runner", params
              ) -> Tuple["api.Runner", dict]:
        cfg = runner.cfg
        n = int(self.draft_layers)
        if not 1 <= n <= cfg.n_layers:
            raise ValueError(f"draft_layers={n} out of range "
                             f"[1, {cfg.n_layers}] for {cfg.arch_id}")
        dcfg = dataclasses.replace(cfg, n_layers=n)
        M.check_paged_support(dcfg)

        def first(tree):
            if isinstance(tree, dict):
                return {k: first(v) for k, v in tree.items()}
            return tree[:n]              # a view of the stacked leaf

        dparams = {"embed": params["embed"],
                   "final_norm": params["final_norm"],
                   "blocks": first(params["blocks"])}
        return _draft_runner(dcfg, runner), dparams


@dataclasses.dataclass
class ConfigDrafter:
    """Independent small-model drafter.  `cfg` must be pageable and share
    the target's vocab_size (the accept math indexes one distribution
    with the other's tokens).  `params` holds given weights, global ones
    (cut into the rank's shards over a mesh); None draws them from
    `init_seed` (a random drafter is correct, just rarely accepted)."""
    cfg: ModelConfig
    params: Optional[dict] = None
    init_seed: int = 0
    name: str = "config"

    def build(self, runner: "api.Runner", params
              ) -> Tuple["api.Runner", dict]:
        M.check_paged_support(self.cfg)
        if self.cfg.vocab_size != runner.cfg.vocab_size:
            raise ValueError(
                f"drafter vocab_size={self.cfg.vocab_size} != target "
                f"{runner.cfg.vocab_size}; align with adapt_drafter_config")
        drunner = _draft_runner(self.cfg, runner)
        if self.params is None:
            return drunner, drunner.init_params(self.init_seed)
        if drunner.env.dp * drunner.env.tp == 1:
            return drunner, self.params
        return drunner, _cut(self.params, drunner.specs, drunner.env)


def adapt_drafter_config(cfg: ModelConfig,
                         target: ModelConfig) -> ModelConfig:
    """A foreign config rewritten into a drafter for `target`: "swa"
    blocks become plain "attn" (the paged pools hold the full context)
    and the vocab is the target's.  Weights trained for the original
    config do not carry over through this rewrite."""
    kinds = tuple("attn" if k == "swa" else k for k in cfg.block_pattern)
    return dataclasses.replace(cfg, block_pattern=kinds, attn_window=None,
                               vocab_size=target.vocab_size)
