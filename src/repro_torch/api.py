"""High-level runner for the port (counterpart of `repro.api.Runner`) at
tp=1: parameter init, the train step, the greedy prefill and the dense
decode step with their caches (rwkv models), paged KV pools, and the
paged serving steps (all-attn models: decode, prefill, and speculative
decoding's draft and verify), greedy or sampled, as plain callables.

Entry points run on the card: `device` defaults to "cuda", and asking
for it without one raises.  Pass device="cpu" for the plain PyTorch path
(every kernel wrapper then takes its plain version).  The runner turns
TF32 off for CUDA matmuls (`torch.backends.cuda.matmul.allow_tf32 =
False`, PyTorch's default): the fp32 products the port leaves to
`torch.matmul` — the router and the training loss's NormHead — stay
full fp32, as in the reference.  The serving steps' NormHead runs on
K5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spikes as spikes_lib
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import prng
from repro_torch.optim import adamw


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    return device


@dataclasses.dataclass
class Runner:
    cfg: ModelConfig
    flags: M.RunFlags = M.DEFAULT_FLAGS
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        M.check_ported_blocks(self.cfg)
        torch.backends.cuda.matmul.allow_tf32 = False

    def init_params(self, seed: int = 0):
        """Random serving parameters on the runner's device from
        `torch.Generator(device).manual_seed(seed)`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return M.init_model(self.cfg, device=self.device, generator=gen)

    def init_train_params(self, seed: int = 0):
        """Random training parameters: every leaf an fp32 master (the
        reference's `param_dtype`), cast to the compute dtype at use."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return M.init_model(self.cfg, device=self.device, generator=gen,
                            masters=True)

    # -- train step ----------------------------------------------------------
    def make_train_step(self, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                        *,
                        spike_guard: Optional[spikes_lib.SpikeConfig] = None):
        """The train step ``(params, opt_state, guard_state, batch, step,
        rng, lr) -> (params, opt_state, guard_state, metrics)``.

        params are fp32 masters (`init_train_params`); batch leaves are
        (B, S) token ids for one microbatch, or (accum, B, S) for accum
        microbatches, so one step serves every stage of the batch-size
        warmup.  The step accumulates fp32 grads over the microbatches
        (mean), clips by the global norm, runs the spike guard when
        `spike_guard` is given (``metrics["commit"]`` is then 1.0 or 0.0)
        and applies AdamW in place with the commit gate; params,
        opt_state and guard_state are updated in place and returned.
        `rng` is the step's threefry key (`models.prng`; the Trainer
        passes ``fold_in(prng_key(seed), step)``) and the router-warmup
        noise follows the reference's key schedule: the step folds in the
        dp index (0 at tp=1), then, only when accum > 1, microbatch k's
        index.  Metrics stay on the device; nothing in the step reads a
        device value on the host."""
        cfg, flags = self.cfg, self.flags

        def step_fn(params, opt_state, guard_state, batch, step: int,
                    rng: torch.Tensor, lr: float):
            leaves = adamw.leaves(params)
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None
            accum = (batch["tokens"].shape[0] if batch["tokens"].ndim == 3
                     else 1)
            micro = ([batch] if accum == 1 else
                     [{k: v[i] for k, v in batch.items()}
                      for i in range(accum)])
            rng = prng.fold_in(rng, 0)          # the dp index
            losses, mets = [], []
            for k, mb in enumerate(micro):
                loss, m = M.loss_fn(
                    cfg, params, mb, step=step, flags=flags,
                    rng=prng.fold_in(rng, k) if accum > 1 else rng)
                loss.backward()      # sums into p.grad, in fp32
                losses.append(loss.detach())
                mets.append({n: v.detach() for n, v in m.items()})
            grads = [p.grad for p in leaves]
            if accum > 1:
                for g in grads:
                    g.div_(accum)
            loss = torch.mean(torch.stack(losses))
            metrics = {n: torch.mean(torch.stack([m[n] for m in mets]))
                       for n in mets[0]}
            gnorm = adamw.global_grad_norm(grads)
            scale = torch.clamp(opt_cfg.clip_norm
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
            commit = None
            if spike_guard is not None:
                commit, new_guard = spikes_lib.guard_commit(
                    spike_guard, guard_state, loss, gnorm=gnorm)
                guard_state.update(new_guard)
            adamw.apply_updates(params, grads, opt_state, lr, opt_cfg,
                                grad_scale=scale, commit=commit)
            for p in leaves:
                p.grad = None
            metrics = dict(metrics, grad_norm=gnorm, loss=loss)
            if commit is not None:
                metrics["commit"] = commit.float()
            return params, opt_state, guard_state, metrics
        return step_fn

    # the reference's name; PyTorch runs eagerly, so nothing is compiled
    jit_train_step = make_train_step

    # -- prefill and dense decode (rwkv models) -------------------------------
    def init_caches(self, batch: int):
        """Zeroed dense decode caches for `batch` sequences (leading layer
        dim; see `models.model.init_caches`)."""
        return M.init_caches(self.cfg, batch, self.device)

    def make_prefill(self):
        """Greedy prefill: ``(params, batch) -> (next (B,) int32,
        caches)`` with batch["tokens"] (B, S); caches hold what the
        prompt leaves behind, in `init_caches`' layout."""
        cfg, flags = self.cfg, self.flags

        @torch.no_grad()
        def fn(params, batch):
            return M.prefill(cfg, params, batch, flags)
        return fn

    def make_decode_step(self, sample: bool = False):
        """Dense decode step: ``(params, caches, token (B,), pos) -> (next
        (B,) int32, caches)``; caches update in place.  With ``sample``
        it takes four more (B,) tensors ``(seeds, temperature, top_p,
        top_k)`` and draws under the online path's (seed, pos, stream)
        key schedule (bit for bit greedy at temperature <= 0)."""
        cfg = self.cfg

        if sample:
            @torch.no_grad()
            def fn(params, caches, token, pos, seeds, temp, top_p, top_k):
                return M.decode_step(cfg, params, caches, token, pos,
                                     sample=(seeds, temp, top_p, top_k))
        else:
            @torch.no_grad()
            def fn(params, caches, token, pos):
                return M.decode_step(cfg, params, caches, token, pos)
        return fn

    # -- paged serving (all-attn models) --------------------------------------
    def init_paged_pools(self, n_pages: int, page_size: int):
        """Zeroed paged KV pools; page 0 is the scratch page.  Also where
        `flags.paged_attn` is validated, before any step runs."""
        L.resolve_paged_attn(self.flags.paged_attn)
        return M.init_paged_caches(self.cfg, n_pages, page_size, self.device)

    def make_paged_decode_step(self, page_size: int, sample: bool = False):
        """Paged decode tick: ``(params, pools, token (B,), pos (B,), table
        (B, n_lp), active (B,)) -> (next (B,), pools)``; pools update in
        place.  With ``sample`` it takes four more (B,) tensors ``(seeds,
        temperature, top_p, top_k)``; slots at temperature <= 0 still
        emit the greedy token bit for bit."""
        cfg, flags = self.cfg, self.flags

        if sample:
            @torch.no_grad()
            def step(params, pools, token, pos, table, active, seeds, temp,
                     top_p, top_k):
                return M.paged_decode_step(
                    cfg, params, pools, token, pos, table, active,
                    page_size=page_size, flags=flags,
                    sample=(seeds, temp, top_p, top_k))
        else:
            @torch.no_grad()
            def step(params, pools, token, pos, table, active):
                return M.paged_decode_step(cfg, params, pools, token, pos,
                                           table, active,
                                           page_size=page_size, flags=flags)
        return step

    def make_paged_prefill(self, page_size: int, sample: bool = False):
        """Chunked-prefill step: ``(params, pools, tokens (C,), base,
        n_valid, table_row (n_lp,)) -> (next token, pools)``; pools update
        in place.  With ``sample`` it takes four more scalars ``(seed,
        temperature, top_p, top_k)`` and draws the returned token at
        position base + n_valid - 1 (bit for bit greedy at temperature
        <= 0)."""
        cfg, flags = self.cfg, self.flags

        if sample:
            @torch.no_grad()
            def step(params, pools, tokens, base, n_valid, table_row, seed,
                     temp, top_p, top_k):
                return M.paged_prefill_chunk(
                    cfg, params, pools, tokens, base, n_valid, table_row,
                    page_size=page_size, flags=flags,
                    sample=(seed, temp, top_p, top_k))
        else:
            @torch.no_grad()
            def step(params, pools, tokens, base, n_valid, table_row):
                return M.paged_prefill_chunk(cfg, params, pools, tokens,
                                             base, n_valid, table_row,
                                             page_size=page_size,
                                             flags=flags)
        return step

    # -- speculative decoding (draft proposals + verify) -----------------------
    def make_paged_draft_propose(self, page_size: int, k: int):
        """Drafter-side propose step (call on the drafter's runner):
        ``(params, pools, token (B,), pos0 (B,), table, active, seeds,
        temperature, top_p, top_k) -> (drafts (B, k), draft_probs (B, k,
        Vp), pools)``, k+1 chained sampled decode ticks over the
        drafter's own pools (stream STREAM_DRAFT)."""
        cfg, flags = self.cfg, self.flags

        @torch.no_grad()
        def step(params, pools, token, pos0, table, active, seeds, temp,
                 top_p, top_k):
            return M.paged_draft_propose(
                cfg, params, pools, token, pos0, table, active,
                (seeds, temp, top_p, top_k), k=k, page_size=page_size,
                flags=flags)
        return step

    def make_paged_verify_step(self, page_size: int, k: int):
        """Target-side verify step: ``(params, pools, tokens (B, k+1), pos0
        (B,), table, active, draft_probs (B, k, Vp), seeds, temperature,
        top_p, top_k) -> (n_acc (B,), out (B, k+1), pools)``: one
        prefill-shaped pass over all k+1 positions and the accept/reject
        on the device (`models.model.paged_verify_step`)."""
        cfg, flags = self.cfg, self.flags
        del k                      # the shape of `tokens` carries it

        @torch.no_grad()
        def step(params, pools, tokens, pos0, table, active, draft_probs,
                 seeds, temp, top_p, top_k):
            return M.paged_verify_step(
                cfg, params, pools, tokens, pos0, table, active, draft_probs,
                (seeds, temp, top_p, top_k), page_size=page_size,
                flags=flags)
        return step
