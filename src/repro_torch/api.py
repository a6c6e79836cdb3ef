"""High-level runner for the port (counterpart of `repro.api.Runner`):
parameter init, the train step, the greedy prefill and the dense
decode step with their caches (KV caches of attention layers, rolling
ones for sliding windows, cross caches of the encoder-decoder, the
state of recurrent layers), sequence scoring for the eval harness, paged KV pools,
and the paged serving steps (all-attn models: decode, prefill, and
speculative decoding's draft and verify), greedy or sampled, as plain
callables.

Entry points run on the card: `device` defaults to "cuda", and asking
for it without one raises.  Pass device="cpu" for the plain PyTorch path
(every kernel wrapper then takes its plain version).  The runner turns
TF32 off for CUDA matmuls (`torch.backends.cuda.matmul.allow_tf32 =
False`, PyTorch's default): the fp32 products the port leaves to
`torch.matmul` — the router and the training loss's NormHead — stay
full fp32, as in the reference.  The serving steps' NormHead runs on
K5.

Over a (dp, tp) mesh (`mesh`, from `launch.mesh.make_local_mesh`; every
rank builds its own Runner and calls the same steps in the same order)
the runner holds the rank's `AxisEnv` and spec tree: `init_params` gives
the rank its shards of the same global parameters as at (1, 1), the
train step takes the global batch and keeps the rank's dp rows
(`batch_sharding`), the dense prefill and decode steps and
`make_score_fn` split the rows over dp the same way (a rank's dense
caches hold its rows; every rank returns every row's result), and the
paged serving steps run on a (1, tp) mesh with every rank's tokens
equal, speculative decoding's draft and verify steps included.  The
parameters are stored FSDP over dp whenever dp > 1, in serving too;
`fsdp=False` keeps them whole on each dp rank (the reference's `fsdp`
switch, off in its dry run's prefill and, without `--serve-fsdp`, its
decode).  `sp_comm="int8"` quantizes the sequence-parallel
boundaries of the train step (`sharding.quant_rows`).  Every
architecture runs there; an encoder-decoder's `batch["enc_frames"]`
(B, S_enc, d) splits over dp with the tokens, and its encoder runs on
the rank's sequence-parallel rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.core import spikes as spikes_lib
from repro_torch.models import embedding as emb
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import prng
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import adamw
from repro_torch.sharding import AxisEnv


def batch_sharding(env: AxisEnv, global_batch: int) -> Optional[str]:
    """The batch dim's spec: "dp" when the global batch divides over dp,
    else None (replicated)."""
    return "dp" if global_batch % env.dp == 0 else None


def local_rows(env: AxisEnv, batch: Dict[str, torch.Tensor],
               dim: int = 0) -> Dict[str, torch.Tensor]:
    """The rank's rows of a global batch (its dp shard of dim `dim`, per
    `batch_sharding`)."""
    B = next(iter(batch.values())).shape[dim]
    if env.dp == 1 or batch_sharding(env, B) is None:
        return batch
    return {k: sharding.shard(v, ("dp",), env, lead=dim)
            for k, v in batch.items()}


def _all_rows(env: AxisEnv, local: torch.Tensor, B: int) -> torch.Tensor:
    """Every row's values from each rank's `local_rows` share of B rows:
    gathered over dp where the rows were split."""
    if env.dp == 1 or batch_sharding(env, B) is None:
        return local
    return env.mesh.dp_group.all_gather(local, 0)


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
    max_seq: int = 4096     # an encoder-decoder's learned decoder positions
    mesh: Optional[Mesh] = None
    sp_comm: str = "native"            # "native" | "int8"
    fsdp: bool = True                  # parameters FSDP over dp at dp > 1

    def __post_init__(self):
        self.device = resolve_device(self.device)
        M.check_ported_blocks(self.cfg)
        self.env = sharding.make_axis_env(self.mesh, sp_comm=self.sp_comm,
                                          fsdp=self.fsdp)
        if self.mesh is not None and self.mesh.size > 1 \
                and self.mesh.device != self.device:
            raise ValueError(f"the mesh works on {self.mesh.device}, the "
                             f"runner on {self.device}")
        self._specs = None
        torch.backends.cuda.matmul.allow_tf32 = False

    @property
    def specs(self):
        """The parameters' spec tree (`model.param_specs`)."""
        if self._specs is None:
            self._specs = M.param_specs(self.cfg, self.env, self.max_seq)
        return self._specs

    def init_params(self, seed: int = 0):
        """Random serving parameters on the runner's device from
        `torch.Generator(device).manual_seed(seed)` (over a mesh, the
        rank's shards of the (1, 1) parameters)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return M.init_model(self.cfg, device=self.device, generator=gen,
                            max_seq=self.max_seq, env=self.env)

    def init_train_params(self, seed: int = 0):
        """Random training parameters: every leaf an fp32 master (the
        reference's `param_dtype`), cast to the compute dtype at use."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return M.init_model(self.cfg, device=self.device, generator=gen,
                            masters=True, max_seq=self.max_seq, env=self.env)

    # -- train step ----------------------------------------------------------
    def make_train_step(self, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                        *,
                        spike_guard: Optional[spikes_lib.SpikeConfig] = None):
        """The train step ``(params, opt_state, guard_state, batch, step,
        rng, lr) -> (params, opt_state, guard_state, metrics)``.

        params are fp32 masters (`init_train_params`); batch leaves are
        (B, S) token ids for one microbatch, or (accum, B, S) for accum
        microbatches, so one step serves every stage of the batch-size
        warmup (an encoder-decoder's "enc_frames" (B, S_enc, d) take the
        same leading dim).  The step accumulates fp32 grads over the microbatches
        (mean), clips by the global norm, runs the spike guard when
        `spike_guard` is given (``metrics["commit"]`` is then 1.0 or 0.0)
        and applies AdamW in place with the commit gate; params,
        opt_state and guard_state are updated in place and returned.
        `rng` is the step's threefry key (`models.prng`; the Trainer
        passes ``fold_in(prng_key(seed), step)``) and the router-warmup
        noise follows the reference's key schedule: the step folds in the
        dp index, then, only when accum > 1, microbatch k's index.
        Over a mesh the batch is the global one (every rank passes the
        same) and the step keeps the rank's rows (`local_rows`); the raw
        gradients are reduced (`adamw.reduce_replicated_grads`), the norm
        counts each leaf once, and the metrics are the mesh's.  Metrics
        stay on the device; nothing in the step reads a device value on
        the host."""
        env = self.env
        loss_and_grads = self._loss_and_grads()
        specs = adamw.leaves(self.specs) if env.dp * env.tp > 1 else None

        def step_fn(params, opt_state, guard_state, batch, step: int,
                    rng: torch.Tensor, lr: float):
            loss, metrics, grads = loss_and_grads(params, batch, step, rng)
            gnorm = adamw.global_grad_norm(grads, specs, env)
            scale = torch.clamp(opt_cfg.clip_norm
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
            commit = None
            if spike_guard is not None:
                commit, new_guard = spikes_lib.guard_commit(
                    spike_guard, guard_state, loss, gnorm=gnorm)
                guard_state.update(new_guard)
            adamw.apply_updates(params, grads, opt_state, lr, opt_cfg,
                                grad_scale=scale, commit=commit)
            for p in adamw.leaves(params):
                p.grad = None
            metrics = dict(metrics, grad_norm=gnorm, loss=loss)
            if commit is not None:
                metrics["commit"] = commit.float()
            return params, opt_state, guard_state, metrics
        return step_fn

    # the reference's name; PyTorch runs eagerly, so nothing is compiled
    jit_train_step = make_train_step

    def _loss_and_grads(self):
        """``(params, batch, step, rng) -> (loss, metrics, grads)``: the
        accumulated (mean over microbatches) and mesh-reduced fp32
        gradients in `adamw.leaves` order, each the leaf's `.grad`
        (cleared by the caller after use)."""
        cfg, flags, env = self.cfg, self.flags, self.env
        specs = adamw.leaves(self.specs) if env.dp * env.tp > 1 else None

        def fn(params, batch, step, rng):
            leaves = adamw.leaves(params)
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None
            accum = (batch["tokens"].shape[0] if batch["tokens"].ndim == 3
                     else 1)
            batch = local_rows(env, batch, dim=1 if accum > 1 else 0)
            micro = ([batch] if accum == 1 else
                     [{k: v[i] for k, v in batch.items()}
                      for i in range(accum)])
            rng = prng.fold_in(rng, env.dp_index())
            losses, mets = [], []
            for k, mb in enumerate(micro):
                loss, m = M.loss_fn(
                    cfg, params, mb, step=step, flags=flags,
                    rng=prng.fold_in(rng, k) if accum > 1 else rng, env=env)
                loss.backward()      # sums into p.grad, in fp32
                losses.append(loss.detach())
                mets.append({n: v.detach() for n, v in m.items()})
            grads = [p.grad for p in leaves]
            if accum > 1:
                for g in grads:
                    g.div_(accum)
            if specs is not None:
                adamw.reduce_replicated_grads(grads, specs, env)
            loss = torch.mean(torch.stack(losses))
            metrics = {n: torch.mean(torch.stack([m[n] for m in mets]))
                       for n in mets[0]}
            return loss, metrics, grads
        return fn

    def make_loss_and_grad(self):
        """``(params, batch, step, rng) -> (loss, grads, metrics)``: the
        train step's loss and its reduced fp32 gradients (a list in
        `adamw.leaves(params)` order; over a mesh the rank's shards'), no
        update (the reference's `make_loss_and_grad`)."""
        fn = self._loss_and_grads()

        def loss_and_grad(params, batch, step, rng):
            loss, metrics, grads = fn(params, batch, step, rng)
            grads = [g.detach().clone() for g in grads]
            for p in adamw.leaves(params):
                p.grad = None
            return loss, grads, metrics
        return loss_and_grad

    # -- prefill and dense decode -------------------------------------------
    def init_caches(self, batch: int, seq_len: Optional[int] = None):
        """Zeroed dense decode caches for `batch` sequences (a leading
        layer dim or a list; see `models.model.init_caches`); over dp the
        rank's rows (`batch_sharding`).  An
        attention model needs `seq_len`, of any length
        (`layers.init_decode_cache`); recurrent layers ignore it.  An
        encoder-decoder's cross caches hold `cfg.encoder_seq_len`
        positions."""
        rows = (batch // self.env.dp if batch_sharding(self.env, batch)
                else batch)
        return M.init_caches(self.cfg, rows, self.device, seq_len, self.env)

    def make_prefill(self, seq_len: Optional[int] = None):
        """Greedy prefill: ``(params, batch) -> (next (B,) int32,
        caches)`` with batch["tokens"] (B, S) (and, for an
        encoder-decoder, batch["enc_frames"] (B, S_enc, d)); caches hold
        what the prompt leaves behind, in `init_caches`' layout.  An
        attention model's caches hold S positions, or `seq_len` (the
        prompt's rows, then zeros) when given, ready for
        `make_decode_step` at pos S; a sliding window's hold min(window,
        that), and a prompt longer than the window raises.  Over dp the
        rank runs its rows (`local_rows`) and keeps their caches; every
        rank returns the (B,) tokens of all rows."""
        cfg, flags, env = self.cfg, self.flags, self.env

        @torch.no_grad()
        def fn(params, batch):
            B = batch["tokens"].shape[0]
            nxt, caches = M.prefill(cfg, params, local_rows(env, batch),
                                    flags, seq_len, env)
            return _all_rows(env, nxt, B), caches
        return fn

    def make_decode_step(self, sample: bool = False):
        """Dense decode step: ``(params, caches, token (B,), pos) -> (next
        (B,) int32, caches)``; caches update in place; pos (an int) is
        the position every sequence writes.  With
        ``sample`` it takes four more (B,) tensors ``(seeds, temperature,
        top_p, top_k)`` and draws under the online path's (seed, pos,
        stream) key schedule (bit for bit greedy at temperature <= 0).
        Over dp the rank steps its rows of `token` (and of the sampling
        knobs) on its caches (`init_caches`, `make_prefill`), and every
        rank returns the (B,) tokens of all rows."""
        cfg, flags, env = self.cfg, self.flags, self.env

        if sample:
            @torch.no_grad()
            def fn(params, caches, token, pos, seeds, temp, top_p, top_k):
                rows = local_rows(env, {"token": token, "seeds": seeds,
                                        "temp": temp, "top_p": top_p,
                                        "top_k": top_k})
                nxt, caches = M.decode_step(
                    cfg, params, caches, rows["token"], pos,
                    sample=(rows["seeds"], rows["temp"], rows["top_p"],
                            rows["top_k"]), flags=flags, env=env)
                return _all_rows(env, nxt, token.shape[0]), caches
        else:
            @torch.no_grad()
            def fn(params, caches, token, pos):
                nxt, caches = M.decode_step(
                    cfg, params, caches, local_rows(env, {"t": token})["t"],
                    pos, flags=flags, env=env)
                return _all_rows(env, nxt, token.shape[0]), caches
        return fn

    # -- sequence scoring (evaluation harness) ---------------------------------
    def make_score_fn(self):
        """``(params, tokens (B, S), mask (B, S)) -> (B,) fp32``: each
        sequence's sum of log p(token_t | tokens_<t) over the positions t
        >= 1 where mask > 0 (perplexity-based evaluation,
        `evals.harness`).  The forward is the prefill's (train=False: the
        serving router); the logits come from the NormHead on K5
        (`embedding.serve_logits`), vocabulary padding is masked to -1e30
        and the log-sum-exp is fp32, as the reference's.  Any (B, S) is
        taken (the reference fixes both for its shard_map).

        Over a mesh (every rank calls it with the same global tokens)
        the rows split over dp (`batch_sharding`) and the vocabulary over
        tp: K5 runs on the rank's vocab shard, the row max is taken over
        tp (`pmax_tp`), the sum of exponentials and the picked logit
        summed over tp, and every rank returns the whole (B,) scores,
        gathered over dp.  Where the rank's B_loc * (S - 1) tokens do not
        divide over tp the forward runs with SP off (the reference's
        ``seq_parallel=False`` runner; its SP runner raises there), and
        the MoE's "auto" dispatch takes "batched"."""
        cfg, flags, dev, env = self.cfg, self.flags, self.device, self.env

        @torch.no_grad()
        def fn(params, tokens, mask):
            tokens = torch.as_tensor(tokens, device=dev).long()
            mask = torch.as_tensor(mask, device=dev)
            B = tokens.shape[0]
            rows = local_rows(env, {"tokens": tokens, "mask": mask})
            tokens, mask = rows["tokens"], rows["mask"]
            T = tokens.shape[0] * (tokens.shape[1] - 1)
            fenv = env if T % env.tp == 0 else sharding.denv(env)
            labels = torch.where(mask[:, 1:] > 0, tokens[:, 1:], -1)
            x, _, _, _ = M.forward(cfg, params, {"tokens": tokens[:, :-1]},
                                   train=False, flags=flags, env=fenv)
            logits = emb.serve_logits(cfg, params["embed"], x, env)
            v_loc = logits.shape[-1]
            lo = env.tp_index() * v_loc
            gid = lo + torch.arange(v_loc, device=dev)
            logits = torch.where(gid[None, :] < cfg.vocab_size, logits,
                                 -1e30)
            m = env.pmax_tp(logits.max(dim=-1).values)
            se = env.psum_tp(torch.exp(logits - m[:, None]).sum(dim=-1))
            lse = m + torch.log(se)
            loc = labels.reshape(-1) - lo
            in_rng = (loc >= 0) & (loc < v_loc)
            picked = torch.gather(logits, 1,
                                  loc.clamp(0, v_loc - 1)[:, None])[:, 0]
            corr = env.psum_tp(torch.where(in_rng, picked, 0.0))
            tok_lp = torch.where(labels.reshape(-1) >= 0, corr - lse, 0.0)
            scores = tok_lp.reshape(tokens.shape[0], -1).sum(dim=-1)
            return _all_rows(env, scores, B)
        return fn

    # -- paged serving (all-attn models) --------------------------------------
    def init_paged_pools(self, n_pages: int, page_size: int):
        """Zeroed paged KV pools; page 0 is the scratch page.  Over tp the
        in-page offsets are sharded (page_size % tp == 0).  Also where
        `flags.paged_attn` is validated, before any step runs."""
        if page_size % self.env.tp:
            raise ValueError(f"page_size={page_size} must be divisible by "
                             f"tp={self.env.tp} (in-page offset sharding)")
        L.resolve_paged_attn(self.flags.paged_attn)
        return M.init_paged_caches(self.cfg, n_pages, page_size, self.device,
                                   self.env)

    def make_paged_decode_step(self, page_size: int, sample: bool = False):
        """Paged decode tick: ``(params, pools, token (B,), pos (B,), table
        (B, n_lp), active (B,)) -> (next (B,), pools)``; pools update in
        place.  With ``sample`` it takes four more (B,) tensors ``(seeds,
        temperature, top_p, top_k)``; slots at temperature <= 0 still
        emit the greedy token bit for bit."""
        cfg, flags, env = self.cfg, self.flags, self.env

        if sample:
            @torch.no_grad()
            def step(params, pools, token, pos, table, active, seeds, temp,
                     top_p, top_k):
                return M.paged_decode_step(
                    cfg, params, pools, token, pos, table, active,
                    page_size=page_size, flags=flags,
                    sample=(seeds, temp, top_p, top_k), env=env)
        else:
            @torch.no_grad()
            def step(params, pools, token, pos, table, active):
                return M.paged_decode_step(cfg, params, pools, token, pos,
                                           table, active,
                                           page_size=page_size, flags=flags,
                                           env=env)
        return step

    def make_paged_prefill(self, page_size: int, sample: bool = False):
        """Chunked-prefill step: ``(params, pools, tokens (C,), base,
        n_valid, table_row (n_lp,)) -> (next token, pools)``; pools update
        in place.  With ``sample`` it takes four more scalars ``(seed,
        temperature, top_p, top_k)`` and draws the returned token at
        position base + n_valid - 1 (bit for bit greedy at temperature
        <= 0)."""
        cfg, flags, env = self.cfg, self.flags, self.env

        if sample:
            @torch.no_grad()
            def step(params, pools, tokens, base, n_valid, table_row, seed,
                     temp, top_p, top_k):
                return M.paged_prefill_chunk(
                    cfg, params, pools, tokens, base, n_valid, table_row,
                    page_size=page_size, flags=flags,
                    sample=(seed, temp, top_p, top_k), env=env)
        else:
            @torch.no_grad()
            def step(params, pools, tokens, base, n_valid, table_row):
                return M.paged_prefill_chunk(cfg, params, pools, tokens,
                                             base, n_valid, table_row,
                                             page_size=page_size,
                                             flags=flags, env=env)
        return step

    # -- speculative decoding (draft proposals + verify) -----------------------
    def make_paged_draft_propose(self, page_size: int, k: int):
        """Drafter-side propose step (call on the drafter's runner):
        ``(params, pools, token (B,), pos0 (B,), table, active, seeds,
        temperature, top_p, top_k) -> (drafts (B, k), draft_probs (B, k,
        Vp), pools)``, k+1 chained sampled decode ticks over the
        drafter's own pools (stream STREAM_DRAFT).  Over a (1, tp) mesh
        every rank gets the same drafts and the whole-vocabulary q."""
        cfg, flags, env = self.cfg, self.flags, self.env

        @torch.no_grad()
        def step(params, pools, token, pos0, table, active, seeds, temp,
                 top_p, top_k):
            return M.paged_draft_propose(
                cfg, params, pools, token, pos0, table, active,
                (seeds, temp, top_p, top_k), k=k, page_size=page_size,
                flags=flags, env=env)
        return step

    def make_paged_verify_step(self, page_size: int, k: int):
        """Target-side verify step: ``(params, pools, tokens (B, k+1), pos0
        (B,), table, active, draft_probs (B, k, Vp), seeds, temperature,
        top_p, top_k) -> (n_acc (B,), out (B, k+1), pools)``: one
        prefill-shaped pass over all k+1 positions and the accept/reject
        on the device (`models.model.paged_verify_step`).  Over a (1, tp)
        mesh K3/K4 run over the rank's in-page offsets and K5 on its
        vocabulary shard, and every rank gets the same result."""
        cfg, flags, env = self.cfg, self.flags, self.env
        del k                      # the shape of `tokens` carries it

        @torch.no_grad()
        def step(params, pools, tokens, pos0, table, active, draft_probs,
                 seeds, temp, top_p, top_k):
            return M.paged_verify_step(
                cfg, params, pools, tokens, pos0, table, active, draft_probs,
                (seeds, temp, top_p, top_k), page_size=page_size,
                flags=flags, env=env)
        return step
