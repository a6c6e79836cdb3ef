#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py     # every phase, in order (needs one card)

Phases, each failing loudly (non-zero exit, no result line):
  1. the card: name and power limit (nvidia-smi), torch / CUDA versions;
  2. build every kernel from src/repro_torch/kernels/csrc with nvcc for
     sm_90a (one nvcc per source, in parallel), timed;
  3. per-kernel checks at Ling-Lite shapes against their plain PyTorch
     versions on identical inputs, with error, tolerance, median
     CUDA-event times, the roofline bound (each kernel's cost function in
     `roofline` on the counts read from the data, over the H100
     datasheet's 3.35 TB/s and 989 TFLOP/s bf16, 67 fp32) and, where one
     PyTorch call computes the same function, its time
     (every kernel's `ms`: the wrapper from an idle queue, host dispatch
     included):
     K1 fused MoE FFN (T=8 decode, T=64 prefill, T=40 a k=4 verify pass,
     T=2048 training, T=4088 phase 6c's scoring call, routing
     from a random router; the path each shape takes, the wrapper's time
     and the C entry's alone, split by kernel with torch.profiler), K3/K4
     paged attention (PA_CASES: decode B=8 Q=1 with 2 inactive slots and
     unallocated pages on the scratch page; verify B=8 Q=5 at the same
     contexts; prefill B=1 Q=64; beside
     `ms`, the card's time for the call enqueued behind a sleep kernel
     and the wrapper's host dispatch alone, which is longer than the
     kernel), K2 grouped matmul at the MoE backward's shapes (12288
     routed rows over 64 experts: the up product 2048 -> 1408 from bf16
     rows, the down product 1408 -> 2048 from fp32 rows, the transposed
     product 1408 -> 2048 from fp32 rows) and the grouped weight
     gradient (64 x 2048 x 1408 from bf16 x fp32 rows, 64 x 1408 x 2048
     from fp32 x fp32 rows, and the first again with its bf16 output),
     each with its count of bf16 wgmma passes and, for a form with an
     fp32 operand, an fp32 `torch._grouped_mm` as its yardstick where
     this build takes one (else bf16); K5 fused NormHead logits at
     Ling-Lite's fp32 head (x bf16, T=8, T=1, T=40 and T=4088, phase
     6c's scoring call, in 64 passes over W) and rwkv6-3b's
     (T=8, T=64
     in one pass over W, T=65 in two), each also timed on the card with
     the queue held, by its host dispatch alone, and against one fp32
     cuBLAS product on a head normalized beforehand (`product_ms`); K6
     the WKV6 recurrence at rwkv6-3b's prefill (B=8, T=512, 40 heads of
     64, bf16 r/k/v, non-zero state), at decode (T=1, state updated in
     place), at T=100 in fp32 and at T=128 with decays near 0 and near 1,
     each also timed on the card with the queue held and by its host
     dispatch alone; rwkv6's decay kernel at the prefill's 8 x 512 rows,
     a tick's 8 rows and 64 fp32 rows (d = n = 2560), timed the same
     way, and each row's result held bit for bit against the kernel on
     that row alone (fp32 operations at 67 TFLOP/s in its bound); and
     the same checks at the shapes of the reference's other
     uniform-attention architectures: K1 at Ling-Plus's (96 experts
     top-4, d 8192; T=8 and 64) and granite's (40 experts top-8, ff 512;
     T=8, 64 and 2048), K2 and the weight gradient at granite's training
     shapes (2048 tokens x top-8: 16384 rows over 40 experts), K3/K4 at a
     decode tick (B=8, Q=1) on Ling-Plus's, granite's, deepseek's and
     phi3's heads (query groups of 8, 3, 1, 1; head_dim 128, 64, 128,
     96) and, on the heads phase 7b serves (Ling-Plus's and granite's),
     at the prefill chunk (B=1, Q=64) and a verify pass (B=8, Q=5), and
     K5 on Ling-Plus's (126464 x 8192) and granite's (49155 x 1536) fp32
     heads at T=8; and at the shapes of the block families phase 7c
     serves: K3/K4 at a decode tick (B=8, Q=1) over a dense cache's page
     view (PA_FAMILY_CASES: nemotron's and danube's heads at 544
     positions, recurrentgemma's head_dim 256, group 10, over its
     rolling cache of 2048, whisper's cross attention over 1504), and K5
     on nemotron's (256000 x 6144), danube's (32000 x 2560),
     recurrentgemma's (256000 x 2560) and whisper's (51865 x 384) fp32
     heads at T=8; and at the shapes a tp = 2 mesh gives them (phase
     9b's): K1 over the rows rank 0 receives in the "ep" dispatch (T=8
     and T=2048 tokens over the tp group, 32 local experts, gate 1), K2
     and the weight gradient at the step's received rows, K3/K4 at a
     decode tick over ps_loc = 8 of a page's 16 offsets (ranks 0 and 1)
     and K5 on a rank's 63232-row vocab shard of Ling-Lite's head (T=8,
     T=1); and at the shapes phase 9c gives them: K1 over rank 0's
     capacity rows of the "fused" dispatch at tp = 2 (FUSED_MESH_CASES:
     T=8, 64 and a k=4 verify pass's 40, the other rank's experts' rows
     gated 0) and over the "ep" rows of the scoring call (T=4088),
     K3/K4 at a verify pass (B=8, Q=5) over ps_loc = 8, K5 on the vocab
     shard at T=40 and T=4088 (each K1 bound counts the rows that hold a
     slot); and at the shapes padded heads, padded experts and rwkv6 over
     tp give them (phase 9d's, the time of these cases printed):
     K3/K4 through the regrouped query layout (PA_REGROUP_CASES:
     whisper-tiny's 6 heads padded to 8 for tp = 4, kv head 5 reading
     three, over ps_loc = 4, decode and prefill; granite's heads on a
     tp = 2 rank, decode and prefill; the bounds count the real heads),
     K1 and K2 with the weight gradient on the last rank of granite's "ep"
     dispatch at tp = 3 (40 experts padded to 42: two dummy experts with
     empty groups; T=48 and 2046), K5 on granite's 24704-row shard at
     tp = 2, K6 and the decay kernel at rwkv6-3b's 20 local heads (1280
     columns) at a tp = 2 prefill of 8 x 64 and a tick; and the one
     K3/K4 view phase 9e makes: rank 1's S-slice of recurrentgemma's
     rolling cache after the wrap (PA_FAMILY_MESH_CASES: 1024 of 2048
     slots at offset 1024, every slot valid, B=8, head_dim 256);
  4. gradients: one full-width MoE layer at T=256, `FusedFFN`'s grads of
     x, w1, w2, w3 and the gates on the kernels against autograd through
     a plain fp32 composition, before and after the cast to bf16;
  5. serving: full-width Ling-Lite (28 layers, bf16 weights from
     torch.Generator(device="cuda").manual_seed(0)) behind an
     OnlineEngine (8 slots, page 16, prefill chunk 64, context 512),
     16 Poisson requests with prompts of 64-256 tokens and 32 new tokens
     each, every tick under the debug sync guard (`debug_guards=True`: a
     device->host sync other than the tick's announced drains raises);
     K1, K3 and K4 must have launched once per layer and K5 once per
     prefill chunk and per decode tick;
  6. end to end: one request teacher-forced (a 64-token prefill chunk +
     8 decode steps) through the kernels and through the plain modes
     (moe_dispatch="ragged", paged_attn="gathered"), logits compared, K5
     launched once per chunk and per step;
  6b. sampling and speculative decoding on phase 5's model and prompts
     (engines fed all 16 requests at once): requests 0-7 greedy and 8-15
     at temperature 0.8, top-p 0.95, top-k 64 (the greedy streams must be
     phase 5's), again with the radix cache off and with a pool of 96
     pages that preempts (all 16 streams unchanged); speculative decoding
     at k=4 with a 4-layer self-draft (greedy streams phase 5's; K1, K3,
     K4 launched (k+1)*4 + 28 and K5 (k+1) + 1 times per spec tick, and
     28 + 4 and 2 per prefill chunk), with a 28-layer self-draft (every
     draft accepted; all 32 tokens, both waves of the 8 slots),
     and sampled at 0.8; each run's tokens/s, TTFT and
     ITL p50/p99, ticks per token and acceptance, and one sampling call
     at 8 and 40 rows of the vocabulary (CUDA events);
  6c. dense KV-cache decode, offline Flood serving, scoring and the
     serving telemetry on phase 5's model: 8 of phase 5's prompts cut to
     64 tokens, `make_prefill` into caches of 512 positions and 32
     greedy `make_decode_step` ticks (K1 28 and K5 1 launches per
     prefill, K1, K3 and K4 28 and K5 1 per tick); the same prompts fed
     token by token through the ticks and through an OnlineEngine (8
     slots, context 512, page 16, chunk 64): the greedy streams must be
     equal bit for bit (how far the prefill's last logits part from the
     ticks' is printed, not held); the Flood engine through
     `build_model_engine` (16 requests x 32 new tokens, micro-batch 8,
     dense caches of 32 positions, which the shared position counter
     passes) at temperature 0 (equal to the engine on the greedy step)
     and 0.8; `make_score_fn` on 8 sequences of 512 tokens (finite,
     negative, equal to the sums of its tokens' log p, each of which is
     held within SCORE_TOL of the largest logit from the plain modes':
     ragged MoE, the plain K5) and the eval harness (content and label perplexity evaluation,
     generation evaluation through a greedy decode built from
     `make_prefill` and the ticks; 4 items each, accuracies and ms per
     item); an engine
     with overload="slo" and a TTFT deadline below phase 5's tick p50,
     armed by one request, then 16 submitted at once: at least one shed,
     serve_tokens_total equal to the tokens emitted, admitted + shed
     equal to submitted, and a Chrome trace written and its events
     counted; then DPO with packing (`training/dpo.py`): 32 random pairs
     (numpy seed 0; prompts of 32-256 tokens, responses of 16-256) at
     max_len 1024 in the padded and the packed layout, each layout's rows
     through the scoring forward (K1 per layer, K5 head; at most 8 rows a
     call) and `segment_pooled_logps`, the same model as policy and
     reference: the padded layout's pooled sums equal `sequence_logps`
     over its rows within fp32 summation order, the DPO term is log 2,
     preference_acc 0, everything finite, the pooling repeats its bits;
     each layout's rows and card time, and the time ratio beside
     `packing_speedup`'s row ratio;
  7. rwkv6 serving: Ling-Lite freed, full-width rwkv6-3b (32 layers, bf16
     weights from torch.Generator(device="cuda").manual_seed(0)):
     `make_prefill` on 8 prompts of 512 tokens (numpy seed 0), then 32
     greedy `decode_step` ticks (K6 and the decay kernel 32 launches and
     K5 one per prefill and per tick); a 64-token prefill of one prompt against 64
     token-by-token ticks (same greedy token, logits within 2^-5 of the
     largest); the same with fp32 activations, and again through the
     plain K5 and K6 (the same greedy token in all four runs; prefill vs
     ticks and kernels vs plain within RWKV_FP32_TOL of the largest
     logit); the offline Flood engine through `launch.serve`'s
     `build_model_engine` (16 requests, 32 new tokens, micro-batch 8) on
     its sampled step at temperature 0 (the same tokens as the engine on
     the greedy step) and at temperature 0.8, seed 0.
     A miss of the prefill-vs-ticks checks is printed at once and fails
     the run after phase 8 and the kernels line, so that those still
     report;
  7b. the reference's other uniform-attention architectures (rwkv6
     freed), one after the other (ARCH_SERVE): Ling-Plus at full width cut
     to 8 of its 80 layers (~62 GB of bf16 weights, embedding and fp32
     head) and granite-moe-3b-a800m whole (32 layers), bf16 weights from
     torch.Generator(device="cuda").manual_seed(0), each behind an
     OnlineEngine (8 slots, page 16, chunk 64, context 512, greedy) with
     8 Poisson requests of 64-256 prompt tokens and 32 new tokens (K1, K3
     and K4 once per layer per chunk and tick, K5 once per chunk and
     tick), then one request teacher-forced through the kernels and
     through the plain modes (ragged MoE, gathered attention, the plain
     K5): logits within the larger of 2^-5 of the largest and twice the
     rounding floor, how far the plain modes' logits lie from a witness
     that launches no kernel either (the kernels' path with every kernel
     swapped for its plain version); tokens/s,
     TTFT and ITL p50 and peak memory (< 80 GB) beside the card line;
  7c. the block families the Ling blocks do not cover (FAMILY_SERVE), one
     after the other at full width, every layer, bf16 weights from
     torch.Generator(device="cuda").manual_seed(0): nemotron-4-15b
     (LayerNorm, squared ReLU; ~34 GB), h2o-danube-1.8b (sliding windows
     of 4096), recurrentgemma-2b (RG-LRU blocks, windows of 2048, head_dim
     256) and whisper-tiny (encoder-decoder); `make_prefill` on 8 prompts
     of 512 tokens (numpy seed 0; whisper 64 beside 8 x 1504 seeded
     frames) into dense caches of 544 positions (whisper 128) and 32
     greedy ticks, launches held (K5 once in the prefill, then per tick
     K5 once and K3, K4 32, 24, 8 and 8 times: the attention layers,
     whisper's 4 self and 4 cross); one batch teacher-forced (a 64-token
     prefill and 8 ticks) through the kernels and the plain modes,
     logits within phase 7b's bar (its witness: the plain attention in
     fp64, `fp64_attention`) over the run, and the prefill's and the
     first tick's alone each within the bar of its own floor; a 64-token
     prefill against 64 ticks (the logit gap printed, not held); for
     recurrentgemma also one prompt of 2040 tokens into caches of 2080
     positions and 32 ticks across the rolling caches' wrap at 2048, then
     that prompt teacher-forced for 16 ticks across the wrap through the
     kernels and the plain modes (the run, the first tick and the first
     tick past the wrap, each within its bar); prefill ms, tick ms,
     tokens/s and peak memory (< 80 GB) beside the card line;
  8. training: the serving models freed, Ling-Lite at full width cut to 4
     layers, fp32 masters from torch.Generator(device="cuda")
     .manual_seed(0), 4 optimizer steps of the port's Trainer (seq 1024,
     microbatch 2, accum 2, remat, fused MoE, spike guard, WSD schedule,
     router warmup active) with every step's dispatch under
     torch.cuda.set_sync_debug_mode("error"); finite losses, a reported
     commit, the launch counts per step (K1 2*L*accum, K2 6*L*accum,
     the weight gradient 3*L*accum) and peak memory under 80 GB;
  8b. checkpoint and exact resume: Ling-Lite at full width cut to 1
     layer (1.09 B parameters; a 13.09 GB checkpoint of fp32 params and
     moments), the batch-size warmup (microbatch 2, 2 -> 8 sequences
     over 4 steps: accum 1, 1, 2, 2, 4, 4) and the router warmup active
     (threefry noise every step), debug guards on; run A trains 6 steps
     checkpointing at 3 and 6 into a temporary directory (removed after;
     the phase fails, naming the bytes, if the disk lacks them) and is
     freed; a fresh Trainer B restores "latest" (step_6, equal to A's
     final state bit for bit), then step_3 (the accum stage carried) and
     trains to 6: its losses, grad norms, params, moments and guard state
     must be A's bit for bit, and the launches per step phase 8's
     formula at each step's accum.  If B parts from A, two uninterrupted
     runs are compared to tell the step from the resume.  Prints the
     saves' fetch and write seconds and GB/s, the restores' seconds and
     GB/s, the warmup noise's ms per step and the step times;
  8c. EDiT local SGD (`core.edit`, the launcher's `--edit-workers`
     worker step): Ling-Lite at full width cut to 1 layer, 2 workers
     (each a replica of fp32 masters with its own AdamW moments and
     spike guard), sync_every 4, 2 rounds (seq 1024, microbatch 2);
     each sync timed on the card against its bytes bound and checked
     against `edit_sync` on CPU copies of the same trees (norms within
     EDIT_NORM_TOL relative, params and momentum within EDIT_TREE_TOL of
     each leaf's largest); finite records, phase 8's launches per local
     step (K1 2, K2 6, the weight gradient 3 at 1 layer) and none in a
     sync, peak memory under 80 GB; local step and sync ms printed;
  8d. rwkv6 training: the K6 and decay wrappers refuse tensors that
     require grad; rwkv6-3b at full width cut to 4 of 32 layers (0.68 B
     parameters), fp32 masters, 4 Trainer steps (seq 1024, microbatch
     2, accum 2, rwkv_chunk 64, remat, debug guards on) through the
     reference's plain forms: finite losses, no kernel launched, peak
     memory under 80 GB, step time and tokens/s printed; then at T=128
     with fp32 compute the chunked form's loss and gradients against
     the scan's (RWKV_FORM_LOSS_TOL, RWKV_FORM_GRAD_TOL);
  8e. the block families trained (FAMILY_TRAIN): h2o-danube-1.8b cut to
     4 layers and recurrentgemma-2b to 3 (one rglru, rglru, swa period)
     through the Trainer, whisper-tiny whole through `make_train_step`
     with 1504 seeded frames a sequence; fp32 masters, 4 steps of seq
     1024, microbatch 2, accum 1, debug guards on: finite losses, no
     kernel launched, peak memory under 80 GB, step time and tokens/s
     printed (nemotron-4-15b trains on the CPU only: its embedding and
     head alone are 50 GB of training state);
  9a. the mesh code on NCCL at world size 1: one spawned rank builds an
     NCCL process group and a (1, 1) mesh, serves 8 of phase 5's prompts
     through the OnlineEngine (streams phase 5's bit for bit) and takes
     MESH_STEPS of phase 8's steps (losses and grad norms phase 8's bit
     for bit), then the same steps at one microbatch (9b's reference);
  9b. two ranks over gloo on the one card (`mesh_gloo`): Ling-Lite at
     full width, 28 layers, served on (1, 2) (8 of phase 5's prompts cut
     to 64 tokens, prefill and 32 greedy ticks; both ranks' streams
     equal, launches per step as phase 5's; one request teacher-forced
     through the kernels against the mesh's plain modes within phase
     7b's bar, and its gap to phase 6's (1, 1) logits printed with the
     dropped slots), then phase 8's 4-layer step at one microbatch at
     (1, 2) and (2, 1) against 9a's (1, 1) run of it, and (2, 1)'s first
     step again bit for bit; the backend, how the collectives ran
     (through the card's memory, `launch/mesh.CardExchange`; gloo's CUDA
     tensors and pinned host buffers where it cannot be set up), bytes
     and seconds per step;
  9c. two ranks over gloo on the one card (`mesh_paths`), Ling-Lite at
     full width on (1, 2), 28 layers: speculative decoding (k=4, a
     1-layer self-draft) on 9b's prompts, 9 tokens each (greedy streams
     the first 9 of 9b's bit for bit, both ranks equal, K1/K3/K4
     (k+1) + 28 and K5 (k+1) + 1 launches per spec tick, 29 and 2 per
     prefill chunk) and one request with a 28-layer self-draft (every
     draft accepted, the stream 9b's), phase 6c's 8 x 512
     `make_score_fn` (each token's log p within SCORE_TOL of the largest
     logit from the mesh's plain modes; the gap to 6c's (1, 1) scores
     printed), two harness items of 15 scored tokens (odd: each rank's
     dispatch modes printed, "batched" among them), 6c's SLO engine with
     a deadline that admits about 4 of the 16 requests (both ranks shed
     the same rids, some but not all; each rank's own tracker's verdicts
     printed); phase 8's 4-layer step at one microbatch
     with int8 SP boundaries for 2 steps (loss and grad norm within
     INT8_TOL of 9b's native (1, 2) steps; the SP collectives' bytes and
     the bytes staged through the host beside native's); and the 1-layer
     model's checkpoint (13.09 GB, into a temporary directory, removed
     after; it fails naming the bytes if the disk lacks them) saved at
     (2, 1) after a step, every rank writing its slices: fresh (2, 1)
     trainers restore it and their next step is the unbroken run's bit
     for bit, and (1, 2) ranks restore it, each slice the files' bit for
     bit;
  9d. inside 9b's two ranks, after its training (`mesh_archs`): granite
     whole (32 layers, the "ep" exchange over 40 experts, its vocabulary
     padded to 24704 rows a rank) served on (1, 2) by the OnlineEngine
     (MESH_ARCHS_PROMPTS of phase 5's prompts cut to 64 tokens, ids
     folded into the vocabulary, MESH_ARCHS_TICKS greedy ticks; both
     ranks' streams equal, launches per step as phase 5's formula) and
     one request teacher-forced (a chunk and MESH_ARCHS_TF_STEPS ticks)
     through the kernels against the mesh's plain modes within phase
     7b's bar; rwkv6-3b whole on (1, 2), 20 of its 40 heads a rank,
     through `make_prefill` on 9b's 8 prompts and the dense decode step
     (both ranks equal; K6 and the decay kernel once per layer, K5 once
     per prefill and tick), and one prompt in fp32 activations through
     the kernels against the plain K5/K6 on each rank's shard within
     RWKV_FP32_TOL; its seconds printed;
  9e. inside 9b's two ranks, after 9d (`mesh_families`): the block
     families at full width on (1, 2), depth cut as MESH_FAMILIES states
     (nemotron-4-15b 2 of 32 layers, h2o-danube-1.8b 2 of 24,
     recurrentgemma-2b 3 of 26: one rglru, rglru, swa period;
     whisper-tiny whole): `make_prefill` of MESH_ARCHS_PROMPTS of 9b's
     prompts (ids folded into each vocabulary; whisper beside 1504 seeded
     frames a sequence) into caches of MESH_FAMILY_SEQ positions (each
     rank its half, the rolling and cross caches too) and
     MESH_ARCHS_TICKS greedy ticks: both ranks' streams equal, K5 once
     per prefill and tick and K3/K4 once per attention layer and tick
     (whisper's 4 cross beside its 4 self); one request teacher-forced (a
     64-token prefill and MESH_ARCHS_TF_STEPS ticks) through the kernels
     against the mesh's plain modes within phase 7c's bar,
     max(2^-5 of the largest, twice the fp64-attention floor), and for
     recurrentgemma a 2040-token prompt teacher-forced 12 ticks across
     its windows' wrap at 2048 (1024 rolling slots a rank) on the same
     bar; its seconds printed;
  10. the dry run (`launch.dryrun.trace` on `meta`, the CLI's function)
     against the card, on one more step of phases 8, 6c and 9b each,
     run through the dry run's own `step_args` and `count_step` under
     the roofline counter, outside their timed steps: (a) phase 8's
     4-layer step: launches per step (K1 16, K2 48, weight gradient 24)
     equal to the card's, FLOPs by dtype and bytes equal to the card's
     step under the same counter, the record's argument bytes
     (parameters, AdamW state, guard, batch) and peak bytes within
     DRY_MEM_GAP (and DRY_PEAK_TOL) of what the card's allocator held
     for the arguments and of those plus max_memory_allocated over the
     step; the three terms beside the median step time (printed); (b)
     6c's dense prefill and tick: launches (K1 28 and K5 1; K1/K3/K4 28
     and K5 1), FLOPs and bytes equal to the card's; the terms beside
     6c's ms (printed); (c) 9b's (2, 1) and (1, 2) steps: rank 0's dry
     run gives the collective calls and bytes per op rank 0 counted in
     a step;
  11. the `kernels` JSON line (launches of phase 9's paths too), the
     card line, and the result line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

SERVE_KERNELS = ("fused_moe_ffn", "paged_attn_scores_max",
                 "paged_attn_accumulate")      # once per layer and step
# phase 3's paged-attention cases (`paged_case`'s arguments), also timed
# by scripts/profile_torch_kernels.py: Ling-Lite's KV heads, 32 logical
# pages of 16 per slot
PA_CASES = {
    "decode": dict(B=8, Q=1, ctx=[100, 300, 0, 171, 256, 0, 129, 233],
                   base=None, n_pages=8 * 32 + 1),
    "verify": dict(B=8, Q=5, ctx=[100, 300, 0, 171, 256, 0, 129, 233],
                   base=None, n_pages=8 * 32 + 1),
    "prefill": dict(B=1, Q=64, ctx=[192], base=128, n_pages=8 * 32 + 1)}


# phase 6c's bar on each scored token's log p against the plain modes, as
# a share of the largest plain logit: a log p moves by at most twice its
# logits' largest error, held to 2^-5 of the largest logit as phase 6
# holds the teacher-forced logits
SCORE_TOL = 2 * 2.0 ** -5

# phase 7's bounds with fp32 activations, shares of the largest logit
# (about ten times the largest reading; PERF.md, Findings)
RWKV_FP32_TOL = {"prefill vs ticks": 7.5e-4, "kernels vs plain": 4.5e-4}

# phase 3's K5 cases (the head's architecture, rows of x) and K6 cases
# (batch, T, r/k/v dtype, decays near 0 and 1), also timed by
# scripts/profile_torch_kernels.py
K5_CASES = {"ling head T=8": ("ling-lite", 8),
            "ling head T=1": ("ling-lite", 1),
            "ling head T=40": ("ling-lite", 40),
            "ling head T=4088": ("ling-lite", 4088),
            "rwkv6 head T=8": ("rwkv6-3b", 8),
            "rwkv6 head T=64": ("rwkv6-3b", 64),
            "rwkv6 head T=65": ("rwkv6-3b", 65),
            "ling-plus head T=8": ("ling-plus", 8),
            "granite head T=8": ("granite-moe-3b-a800m", 8),
            "nemotron head T=8": ("nemotron-4-15b", 8),
            "danube head T=8": ("h2o-danube-1.8b", 8),
            "recurrentgemma head T=8": ("recurrentgemma-2b", 8),
            "whisper head T=8": ("whisper-tiny", 8)}
K6_CASES = {"prefill": (8, 512, "bfloat16", False),
            "decode": (8, 1, "bfloat16", False),
            "T=100": (8, 100, "float32", False),
            "decays near 0 and 1": (8, 128, "bfloat16", True)}
# phase 3's cases at the shapes of the reference's other uniform-attention
# architectures: K1 (label -> arch, T), K3/K4 (label -> arch, PA_CASES
# shape; query groups of 8, 3, 1, 1 and head_dim 128, 64, 128, 96): a
# decode tick's B=8, Q=1 for all four, and for the two phase 7b serves,
# its 64-row prefill chunk and a speculative verify pass (Q=5) too; and
# K2 with the weight gradient at granite's training shapes
K1_ARCH_CASES = {"ling-plus T=8": ("ling-plus", 8),
                 "ling-plus T=64": ("ling-plus", 64),
                 "granite T=8": ("granite-moe-3b-a800m", 8),
                 "granite T=64": ("granite-moe-3b-a800m", 64),
                 "granite T=2048": ("granite-moe-3b-a800m", 2048)}
PA_ARCH_CASES = {
    f"{name} {shape}": (arch, shape)
    for name, arch, shapes in (
        ("ling-plus", "ling-plus", ("decode", "prefill", "verify")),
        ("granite", "granite-moe-3b-a800m", ("decode", "prefill", "verify")),
        ("deepseek", "deepseek-moe-16b", ("decode",)),
        ("phi3", "phi3-mini-3.8b", ("decode",)))
    for shape in shapes}
K2_ARCH = "granite-moe-3b-a800m"
# phase 3's cases at the shapes sharding over tp = 2 gives the kernels
# (phase 9b's serving and training): K1 over the rows a rank receives in
# the "ep" dispatch (label -> T tokens over the tp group: a decode tick of
# 8 slots, the 4-layer step's microbatch of 2 x 1024), 32 local experts,
# gate 1; K2 and the weight gradient at the step's received rows; K3/K4
# at a decode tick over ps_loc = 8 of a page's 16 in-page offsets (ranks
# 0 and 1); K5 on a rank's vocab shard of Ling-Lite's head (63232 rows)
MESH_TP = 2
EP_CASES = {"ep decode T=8 tp=2": 8, "ep train T=2048 tp=2": 2048,
            "ep score T=4088 tp=2": 4088}
EP_TRAIN_T = 2048          # the EP case K2 and the weight gradient take
PA_MESH_CASES = {f"{shape} tp=2 ps_loc=8 rank {r}": (shape, r)
                 for shape in ("decode", "verify") for r in range(2)}
K5_MESH_CASES = {"ling head shard tp=2 T=8": ("ling-lite", 8),
                 "ling head shard tp=2 T=1": ("ling-lite", 1),
                 "ling head shard tp=2 T=40": ("ling-lite", 40),
                 "ling head shard tp=2 T=4088": ("ling-lite", 4088),
                 # granite's 49155 rows padded to 49408 (phase 9d)
                 "granite head shard tp=2 T=8": ("granite-moe-3b-a800m", 8)}
# phase 3's K1 cases of the "fused" dispatch at tp = 2 (phase 9c and the
# mesh tests' mode): rank 0's 32 local experts over the capacity rows
# of all T tokens' slots sorted with the other rank's experts last (their
# rows gated 0), label -> T: a decode tick of 8, a prefill chunk of 64,
# a k = 4 verify pass of 8 x 5
FUSED_MESH_CASES = {"fused T=8 tp=2": 8, "fused T=64 tp=2": 64,
                    "fused T=40 tp=2 verify": 40}
# phase 3's cases of the shapes padded heads, padded experts and rwkv6's
# heads over tp give the kernels (phase 9d and the tp > 1 meshes): K3/K4
# through the regrouped query layout (`ops.gqa_layout`) at whisper-tiny's
# 6 heads padded to 8 for tp = 4 (kv head 5 reads three: groups of up to
# 3) over ps_loc = 4 of a page's 16 offsets, and at granite's heads (24
# over 8) on a tp = 2 rank: label -> (arch, PA_CASES shape, tp, rank)
PA_REGROUP_CASES = {
    "whisper tp=4 decode ps_loc=4 rank 1": ("whisper-tiny", "decode", 4, 1),
    "whisper tp=4 prefill ps_loc=4 rank 3": ("whisper-tiny", "prefill", 4,
                                             3),
    "granite tp=2 decode ps_loc=8 rank 0": ("granite-moe-3b-a800m",
                                            "decode", 2, 0),
    "granite tp=2 prefill ps_loc=8 rank 1": ("granite-moe-3b-a800m",
                                             "prefill", 2, 1)}
# K1, and K2 with the weight gradient, on the last rank of granite's "ep"
# dispatch at tp = 3: 40 experts padded to 42, 14 a rank, the rank's last
# two dummy experts never routed to (empty groups): label -> T tokens (a
# prefill chunk's 48 over the tp group; the training microbatch's 2046)
DUMMY_TP, DUMMY_RANK = 3, 2
DUMMY_EP_CASES = {"ep T=48 tp=3 rank 2 (2 dummy experts)": 48,
                  "ep T=2046 tp=3 rank 2 (2 dummy experts)": 2046}
DUMMY_TRAIN_T = 2046
# K6 and the decay kernel on rwkv6-3b's 20 local heads of 64 (1280
# columns) at tp = 2: a prefill of 8 x 64 and a tick of 8
K6_MESH_CASES = {"prefill tp=2 H=20": (8, 64, "bfloat16", False, 20),
                 "decode tp=2 H=20": (8, 1, "bfloat16", False, 20)}
DECAY_MESH_CASES = {"prefill tp=2 n=1280": (8 * 64, "bfloat16", 1280),
                    "decode tp=2 n=1280": (8, "bfloat16", 1280)}
# phase 7b: (arch, layers served or None for all): Ling-Plus at full
# width cut to 8 of its 80 layers (3.51 B parameters a layer, 7.02 GB in
# bf16, plus 2.07 GB of embedding and a 4.14 GB fp32 head: ~62 GB on an
# 80 GB card; all 80 layers would be ~567 GB), granite whole (~6.7 GB)
ARCH_SERVE = (("ling-plus", 8), ("granite-moe-3b-a800m", None))

# phase 3's cases of rwkv6's decay kernel (rows, their dtype) at
# rwkv6-3b's width: the prefill's 8 x 512 rows, a tick's 8, fp32 rows
DECAY_CASES = {"prefill": (8 * 512, "bfloat16"), "decode": (8, "bfloat16"),
               "fp32 rows": (64, "float32")}

# phase 3's K3/K4 cases at the decode ticks of the block families phase 7c
# serves (B=8, Q=1), through a dense cache's page view as the tick reads
# it: label -> (arch, cache positions, the tick's position; a position
# past the cache is a rolling window after its wrap, or a cross cache:
# every row valid).  Query groups of 6, 4, 10 and 1, head_dim 128, 80,
# 256 (the kernels' second instantiation) and 64.
PA_FAMILY_CASES = {
    "nemotron decode 544": ("nemotron-4-15b", 544, 543),
    "danube decode 544": ("h2o-danube-1.8b", 544, 543),
    "recurrentgemma rolling 2048": ("recurrentgemma-2b", 2048, 2071),
    "whisper cross 1504": ("whisper-tiny", 1504, 1503)}
# phase 3's K3/K4 case that only phase 9e's path makes: one rank's
# S-slice of recurrentgemma's rolling cache after the wrap (2048 slots
# over tp = 2: 1024 a rank at offset rank * 1024, every slot valid)
PA_FAMILY_MESH_CASES = {
    "recurrentgemma rolling 2048 tp=2 rank 1": ("recurrentgemma-2b", 2048,
                                                2071, 2, 1)}
# phase 7c: (arch, K3 and K4 launches a tick: its attention layers, and
# whisper's cross attention beside its 4 self-attention layers)
FAMILY_SERVE = (("nemotron-4-15b", 32), ("h2o-danube-1.8b", 24),
                ("recurrentgemma-2b", 8), ("whisper-tiny", 8))
# phase 8e: (arch, layers trained or None for all)
FAMILY_TRAIN = (("h2o-danube-1.8b", 4), ("recurrentgemma-2b", 3),
                ("whisper-tiny", None))


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median over `iters` calls of CUDA-event time around one call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median over `iters` calls of CUDA-event time around one call
    enqueued behind a sleep kernel: the host's dispatch of the call
    overlaps the sleep, so only the card's time for the call's work
    remains (cuda_ms also counts the dispatch while the card waits)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)         # ~2.5 ms: longer than dispatch
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def host_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Host time of one call of fn (its dispatch alone): the median over
    `repeats` of the mean over `iters` calls that do not wait for the
    card."""
    import torch
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def kernel_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    symbol (`..._20pa_accumulate_kernelILi256ELi128EE...` ->
    `pa_accumulate_kernel<256, 128>`), or the symbol's first 72
    characters."""
    for m in re.finditer(r"(\d+)([A-Za-z_])", mangled):
        i = m.start(2)
        ident = mangled[i:i + int(m.group(1))]
        if ident.endswith("kernel"):
            t = re.match(r"I((?:L[ibjl]\d+E)+)E", mangled[i + len(ident):])
            args = re.findall(r"L[ibjl](\d+)E", t.group(1)) if t else []
            return ident + (f"<{', '.join(args)}>" if args else "")
    return mangled[:72]


def bf16_ulp(t):
    """One bf16 ulp at each element of t (2^(e-8) for |t| in
    [2^(e-1), 2^e))."""
    import torch
    return torch.ldexp(torch.ones_like(t), torch.frexp(t).exponent - 8)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def report(name, shape, err, tol, scale, ms, plain_ms, b_ms, b_by,
           library_ms=None):
    lib = "none" if library_ms is None else f"{library_ms:.4f}ms"
    print(f"[kernels] {name} {shape}: max_abs_err={err:.3e} "
          f"max_rel_err={err / max(scale, 1e-30):.3e} (tolerance "
          f"{tol:.3e}) kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
          f"library={lib} bound={b_ms * 1e3:.2f}us ({b_by}-bound, share "
          f"{b_ms / ms:.1%})")


# ---------------------------------------------------------------------------
# phase 3: per-kernel checks
# ---------------------------------------------------------------------------


def moe_case(cfg, T: int, gen):
    """One MoE layer's bf16 weights (fp32 router) and the routing of T
    random bf16 tokens by its random router: (params, x, tok, gates,
    group_sizes)."""
    import torch
    from repro_torch.core import moe, router
    from repro_torch.models import layers as L
    p = moe.init_moe(cfg, L.Init(device=torch.device("cuda"),
                                 generator=gen))
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    top_w, top_i = router.route(cfg, p["router"], x)
    tok, gates, group_sizes, _ = moe.sort_slots(cfg, top_w, top_i)
    return p, x, tok, gates, group_sizes


def library_time(candidates):
    """Time the first of `candidates` ((label, fn) pairs: one PyTorch call
    each, a yardstick the port never calls) that runs here; (None,
    reason) when none does."""
    import torch
    reasons = []
    for label, fn in candidates:
        try:
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, AttributeError, ValueError,
                NotImplementedError) as e:
            reasons.append(f"{label}: {str(e).splitlines()[0][:120]}")
            continue
        return cuda_ms(fn), label
    return None, "; ".join(reasons)


def kernel_split(fn, prefixes, iters: int = 20):
    """Device time per call of each group of kernels whose names contain
    a prefix, summed by torch.profiler over `iters` calls of fn; None
    where the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {p: 0.0 for p in prefixes}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        for p in prefixes:
            if p in ev.key:
                out[p] += us / 1e3 / iters
    return out if any(out.values()) else None


def ep_case(cfg, T: int, gen, tp: int = MESH_TP, rank: int = 0):
    """K1's operands on rank `rank` of the "ep" dispatch over tp ranks:
    one MoE layer's bf16 weights (the rank's E_pad / tp experts: where tp
    does not divide E, the last rank's padding experts, drawn but never
    routed to), T random bf16 tokens split into tp owned slices, each
    routed by the random router and bucketed by destination
    (`moe.ep_send_layout`), and the rows every source sends the rank,
    sorted by local expert (`moe.ep_recv_layout`): (params, x_recv
    (tp*cap, d), order, gate 1 (0 for empty rows), group_sizes)."""
    import torch
    from repro_torch import sharding
    from repro_torch.core import moe, router
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    env_r = sharding.make_axis_env(Mesh.at(1, tp, rank, "cuda"))
    # each leaf drawn whole, the rank's experts kept (`L.Init` over env_r)
    p = moe.init_moe(cfg, L.Init(device=torch.device("cuda"),
                                 generator=gen, env=env_r))
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    T_loc, rows, keys = T // tp, [], []
    for s in range(tp):
        env = sharding.make_axis_env(Mesh.at(1, tp, s, "cuda"))
        xs = x[s * T_loc:(s + 1) * T_loc]
        tok_send, key_send, _, _ = moe.ep_send_layout(
            cfg, env, *router.route(cfg, p["router"], xs))
        cap = key_send.shape[1]
        rows.append(xs[tok_send].reshape(tp, cap, -1)[rank])
        keys.append(key_send[rank])
    e_loc = moe.padded_experts(cfg, env_r)[1]
    order, gs, valid = moe.ep_recv_layout(torch.cat(keys), e_loc)
    p = {k: p[k] for k in ("we1", "we2", "we3")}
    return p, torch.cat(rows), order, valid.to(torch.bfloat16), gs


def fused_tp_case(cfg, T: int, gen, tp: int = MESH_TP):
    """K1's operands on rank 0 of the "fused" dispatch over tp ranks: one
    MoE layer's bf16 weights (rank 0's E / tp experts), T random bf16
    tokens all routed by the random router, and the first `capacity` of
    the T*k slots sorted by local expert with the other ranks' experts
    last (`moe.sort_slots` at rank 0's coordinates): (params, x, tok,
    gates (0 on the trailing rows), group_sizes)."""
    import torch
    from repro_torch import sharding
    from repro_torch.core import moe, router
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    p = moe.init_moe(cfg, L.Init(device=torch.device("cuda"),
                                 generator=gen))
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    env = sharding.make_axis_env(Mesh.at(1, tp, 0, "cuda"))
    tok, gates, gs, _ = moe.sort_slots(
        cfg, *router.route(cfg, p["router"], x), env)
    e_loc = cfg.moe.n_experts // tp
    p = {k: p[k][:e_loc].contiguous() for k in ("we1", "we2", "we3")}
    return p, x, tok, gates, gs


def check_k1(cfg, T: int, gen, case=None):
    """K1 at Ling-Lite widths with a random router's routing (or on
    `case`, (params, x, tok, gates, group_sizes) as `moe_case` gives
    them: `ep_case`'s received rows).  Times the wrapper (checks,
    allocation and host dispatch included) and the C entry alone on
    prepared arguments (its kernels' time, also split by kernel with the
    profiler: up, down, and the combine with its index passes)."""
    import torch
    from repro_torch import roofline
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ops
    m = cfg.moe
    p, x, tok, gates, group_sizes = case or moe_case(cfg, T, gen)
    T = x.shape[0]
    cap = tok.shape[0]
    bm = min(128, max(8, cap))
    row_idx, g, tile_group = ops._fused_layout(tok, gates, group_sizes, T,
                                               bm)
    args = (x, p["we1"], p["we2"], p["we3"], row_idx, g, tile_group)
    path = gm.k1_path(row_idx.shape[0], bm, group_sizes.shape[0])
    out = gm.fused_moe_ffn(*args)
    ref = gm.fused_moe_ffn_ref(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # fp32 products of bf16 operands, fp32 hidden (cut exactly into three
    # bf16 pieces for the down product): the two differ only in fp32
    # summation order over d=2048 and ff=1408
    tol = 1e-4 * ref.abs().max().item()
    n_experts = int((group_sizes > 0).sum())
    # the experts routed, and the operations of the rows that hold a slot
    # (an "ep" or a tp > 1 "fused" buffer's trailing rows are empty)
    b_ms, b_by = roofline.bound_ms(roofline.k1_cost(
        T, cfg.d_model, m.expert_d_ff, group_sizes.shape[0],
        row_idx.shape[0], bm, gated=p["we3"] is not None,
        x_itemsize=x.element_size(), w_itemsize=p["we1"].element_size(),
        rows=int(group_sizes.sum()), experts=n_experts))
    ms = cuda_ms(lambda: gm.fused_moe_ffn(*args))
    plain_ms = cuda_ms(lambda: gm.fused_moe_ffn_ref(*args))
    rows = int(group_sizes.sum())
    # the C entry alone, its checks and scratch allocation done once
    out_c, c_args, _held = gm._k1_launch(*args, act="swiglu")
    entry = build.entry("fused_moe_ffn")
    build.check(entry(*c_args), "fused_moe_ffn")
    torch.cuda.synchronize()
    if not torch.equal(out_c, out):
        fail(f"fused_moe_ffn T={T}: two launches on the same inputs differ")
    entry_ms = cuda_ms(lambda: entry(*c_args))
    split = kernel_split(lambda: entry(*c_args),
                         ("moe_up", "moe_down", "moe_combine"))
    shape = (f"T={T} cap={cap} rows={rows} bm={bm} "
             f"tiles={tile_group.numel()} "
             f"experts_routed={n_experts} of {group_sizes.shape[0]} "
             f"path={path}")
    report("fused_moe_ffn", shape, err, tol, ref.abs().max().item(), ms,
           plain_ms, b_ms, b_by)
    parts = ("not measured" if split is None else
             " ".join(f"{k}={v:.4f}ms" for k, v in split.items()))
    print(f"[kernels] fused_moe_ffn T={T} path={path}: wrapper={ms:.4f}ms "
          f"kernels alone={entry_ms:.4f}ms (share of bound "
          f"{b_ms / entry_ms:.1%}; wrapper {b_ms / ms:.1%}); profiler "
          f"per call: {parts}")
    if not err <= tol:
        fail(f"fused_moe_ffn T={T}: max_abs_err {err} > tolerance {tol}")
    return dict(max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
                path=path, wrapper_ms=ms, device_ms=entry_ms,
                device_split_ms=split)


def paged_case(cfg, *, B, Q, ctx, base, n_pages, gen, tp=1, rank=0):
    """Random pools, page tables and queries for one paged-attention
    check.  ctx[b] = tokens the slot holds after this step (0 = inactive:
    its table row stays on the scratch page and every row is masked).
    Over tp the pools hold rank `rank`'s 16 / tp in-page offsets and the
    mask is that rank's (`layers.paged_valid_mask`), and the query heads
    are padded to a multiple of tp and grouped as the attention hands
    them over (`ops.gqa_layout`: padded and unevenly grouped heads fill
    groups of the largest group's size with zero rows)."""
    import torch
    from repro_torch import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.kernels import ops
    dev = "cuda"
    ps, KV, hd, H = 16, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    env = sharding.make_axis_env(Mesh.at(1, tp, rank, dev))
    Hp = sharding.pad_to_multiple(H, tp)       # query heads padded to tp
    n_lp = 512 // ps
    pool = lambda: torch.randn((n_pages, ps // tp, KV, hd), generator=gen,
                               device=dev).to(torch.bfloat16)
    k_pool, v_pool = pool(), pool()
    table = torch.zeros((B, n_lp), dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // ps)
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    pos = torch.tensor([[max(c - Q, 0) + j for j in range(Q)] for c in ctx],
                       device=dev)
    if base is not None:
        pos = base + torch.arange(Q, device=dev)[None]
    mask = L.paged_valid_mask(table, pos, page_size=ps, env=env)
    q = torch.randn((B, Q, Hp, hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    gq = ops._pa_group_q(q, KV, ops.gqa_layout(Hp, KV, H, dev))
    mask4 = mask.reshape(B, Q, n_lp, ps // tp)
    return gq, k_pool, v_pool, table, mask4


def dense_case(arch: str, S: int, pos: int, gen, B: int = 8, tp: int = 1,
               rank: int = 0):
    """A decode tick's K3/K4 operands over a dense cache of S positions
    (random bf16 rows), as `layers.decode_attention` hands them over: q
    (B, 1, H, hd) grouped per kv head, the cache's page pools and the
    tick's page view at `pos` (`layers.dense_page_view`).  Over tp the
    cache is rank `rank`'s S / tp positions, viewed at its offset."""
    import torch
    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    cfg = get_config(arch)
    env = sharding.make_axis_env(Mesh.at(1, tp, rank, "cuda"))
    cache = L.init_decode_cache(cfg, B, S, "cuda", env=env)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    s_loc = cache["k"].shape[1]
    table, valid = L.dense_page_view(B, s_loc, pos, "cuda",
                                     offset=rank * s_loc)
    q = torch.randn((B, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lay = ops.gqa_layout(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads)
    return (ops._pa_group_q(q, cfg.n_kv_heads, lay),
            L.dense_pages(cache["k"]),
            L.dense_pages(cache["v"]), table,
            valid.reshape(B, 1, table.shape[1], L.DENSE_PAGE))


def pa_bounds(gq, k_pool, table, mask4, pass2: bool, heads=None):
    """Bytes and flops the data needs: each (slot, kv head) reads the pages
    that hold a valid position; 2*hd flops per valid score (and 2*hd more
    per valid PV term in pass 2) of each of the `heads` query heads (all
    of the layout's rows by default; a regrouped layout's zero rows are
    no work the function needs, so its q, m_safe and outputs count the
    real heads' rows only): `roofline.paged_attn_cost` on the counts read
    from the mask."""
    from repro_torch import roofline
    B, KV, GQ, hd = gq.shape
    _, Q, n_lp, ps = mask4.shape
    return roofline.bound_ms(roofline.paged_attn_cost(
        B, KV, GQ, hd, ps, n_lp, Q, second_pass=pass2,
        q_itemsize=gq.element_size(), pool_itemsize=k_pool.element_size(),
        table_itemsize=table.element_size(),
        mask_itemsize=mask4.element_size(), heads=heads,
        live_pages=int(mask4.any(dim=1).any(dim=-1).sum()),
        valid=int(mask4.sum())))


def check_pa(cfg, label, case, heads=None):
    """K3 and K4 on `case` against their plain versions (`heads`: the
    real query heads of a regrouped layout, for the bounds)."""
    import torch
    from repro_torch.kernels import paged_attn as pa
    gq, k_pool, v_pool, table, mask4 = case
    m = pa.paged_attn_scores_max(gq, k_pool, table, mask4)
    m_ref = pa.paged_attn_scores_max_ref(gq, k_pool, table, mask4)
    torch.cuda.synchronize()
    inf_k, inf_r = torch.isinf(m), torch.isinf(m_ref)
    if not torch.equal(inf_k, inf_r):
        fail(f"paged_attn_scores_max {label}: -inf rows differ")
    fin = ~inf_r
    err3 = (m[fin] - m_ref[fin]).abs().max().item() if fin.any() else 0.0
    # fp32 dots of bf16 operands in another summation order
    tol3 = 1e-5 * max(m_ref[fin].abs().max().item(), 1.0)
    m_safe = torch.where(fin, m_ref, 0.0)
    num, den = pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask4,
                                        m_safe)
    num_r, den_r = pa.paged_attn_accumulate_ref(gq, k_pool, v_pool, table,
                                                mask4, m_safe)
    torch.cuda.synchronize()
    if not (torch.equal(num[inf_r], torch.zeros_like(num[inf_r]))
            and torch.equal(den[inf_r], torch.zeros_like(den[inf_r]))):
        fail(f"paged_attn_accumulate {label}: all-masked rows not 0")
    err4 = max((num - num_r).abs().max().item(),
               (den - den_r).abs().max().item())
    # fp32 summation order (1e-5 relative), plus for num one bf16 rounding
    # flip: p is rounded to bf16 before the PV product, and a score that
    # differs in its last fp32 bit can round one p (<= 1) one ulp (2^-8)
    # the other way, moving num by at most 2^-8 * max|v|
    tol4 = (1e-5 * max(num_r.abs().max().item(), den_r.abs().max().item())
            + 2.0 ** -8 * v_pool.float().abs().max().item())
    # ms and plain_ms from an idle queue, as every row; each kernel is one
    # launch shorter than the wrapper's host dispatch, so the card's time
    # for the call (queue held: device_ms) and the dispatch alone
    # (host_ms) stand beside them
    k3 = lambda: pa.paged_attn_scores_max(gq, k_pool, table, mask4)
    k4 = lambda: pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask4,
                                          m_safe)
    p3 = lambda: pa.paged_attn_scores_max_ref(gq, k_pool, table, mask4)
    p4 = lambda: pa.paged_attn_accumulate_ref(gq, k_pool, v_pool, table,
                                              mask4, m_safe)
    ms3, ms4, pl3, pl4 = cuda_ms(k3), cuda_ms(k4), cuda_ms(p3), cuda_ms(p4)
    dv3, dv4, pd3, pd4 = (device_ms(k3), device_ms(k4), device_ms(p3),
                          device_ms(p4))
    hs3, hs4 = host_ms(k3), host_ms(k4)
    b3, by3 = pa_bounds(gq, k_pool, table, mask4, pass2=False, heads=heads)
    b4, by4 = pa_bounds(gq, k_pool, table, mask4, pass2=True, heads=heads)
    shape = f"{label} q={tuple(gq.shape)} table={tuple(table.shape)}"
    report("paged_attn_scores_max", shape, err3, tol3,
           m_ref[fin].abs().max().item(), ms3, pl3, b3, by3)
    report("paged_attn_accumulate", shape, err4, tol4,
           num_r.abs().max().item(), ms4, pl4, b4, by4)
    print(f"[kernels] paged_attn {label}: the card's time (queue held) "
          f"scores_max={dv3:.4f}ms accumulate={dv4:.4f}ms (plain "
          f"{pd3:.4f} / {pd4:.4f}ms); host dispatch {hs3:.4f} / "
          f"{hs4:.4f}ms")
    if not err3 <= tol3:
        fail(f"paged_attn_scores_max {label}: {err3} > {tol3}")
    if not err4 <= tol4:
        fail(f"paged_attn_accumulate {label}: {err4} > {tol4}")
    row = lambda e, t, ms, pl, b, by, dv, pd, hs: dict(
        max_abs_err=e, tolerance=t, ms=ms, plain_ms=pl, bound_ms=b,
        bound_by=by, library_ms=None, shape=shape, device_ms=dv,
        plain_device_ms=pd, host_ms=hs)
    return (row(err3, tol3, ms3, pl3, b3, by3, dv3, pd3, hs3),
            row(err4, tol4, ms4, pl4, b4, by4, dv4, pd4, hs4))


def _passes(a_dtype, b_dtype) -> int:
    """bf16 wgmma passes per product: an fp32 operand is cut into three
    bf16 pieces; fp32 x fp32 keeps the six piece products with i + j <=
    2."""
    import torch
    return (1, 3, 6)[(a_dtype == torch.float32) + (b_dtype == torch.float32)]


def _fp32_first(fp32_operand, candidates):
    """The library yardsticks in order: for a form with an fp32 operand
    the fp32 call first (if this build of `torch._grouped_mm` takes
    fp32), then bf16; for an all-bf16 form the bf16 calls only."""
    import torch
    if fp32_operand.dtype == torch.float32:
        return candidates
    return [c for c in candidates if "fp32" not in c[0]]


def check_k2(cfg, gen, case=None):
    """K2 at the MoE backward's shapes (T=2048 tokens routed by a random
    router: at Ling-Lite 12288 rows over 64 experts, at granite 16384
    over 40, bm=128; or `case`, as `check_k1` takes it: `ep_case`'s
    12288 received rows over 32 local experts) and the grouped weight
    gradient, each in every operand form the backward launches, against
    their plain versions."""
    import torch
    from repro_torch import roofline
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ops
    p, x, tok, gates, gs = case or moe_case(cfg, 2048, gen)
    cap, G, bm = tok.shape[0], gs.shape[0], 128
    d, ff = cfg.d_model, cfg.moe.expert_d_ff
    lay = ops.align_layout(gs, cap, bm)
    xs = x[tok]                                   # (cap, d) bf16 rows
    h = torch.randn((cap, ff), generator=gen, device="cuda")    # fp32
    da = torch.randn((cap, ff), generator=gen, device="cuda")   # fp32
    d_out = torch.randn((cap, d), generator=gen, device="cuda")  # fp32
    offs = torch.cumsum(gs, 0).to(torch.int32)
    n_live = int((lay.tile_group < G).sum())
    n_routed = int((gs > 0).sum())
    rows = {}
    # xs W1 (bf16 rows), h W2 (fp32 rows), da1 W1^T (fp32 rows, trans_b)
    for label, lhs, w, trans in (("up d->ff", xs, p["we1"], False),
                                 ("down ff->d", h, p["we2"], False),
                                 ("down^T ff->d", da, p["we1"], True)):
        lhs_pad = ops._take_rows(lhs, lay.row_map)
        K = lhs.shape[1]
        N = w.shape[1] if trans else w.shape[2]
        run = lambda: gm.grouped_matmul_aligned(
            lhs_pad, w, lay.tile_group, bm=bm, trans_b=trans)
        plain = lambda: gm.grouped_matmul_aligned_ref(
            lhs_pad, w, lay.tile_group, bm=bm, trans_b=trans)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # fp32 products of operands exact in fp32 (bf16 upcast): the two
        # differ only in fp32 summation order over K
        tol = 1e-4 * ref.abs().max().item()
        b_ms, b_by = roofline.bound_ms(roofline.k2_cost(
            lhs_pad.shape[0], K, N, G, bm, lhs_itemsize=lhs.element_size(),
            rhs_itemsize=w.element_size(), rows=cap, live_tiles=n_live,
            experts=n_routed))
        ms, plain_ms = cuda_ms(run), cuda_ms(plain, iters=5, warmup=1)
        a16 = lhs.to(torch.bfloat16)
        b16 = w.transpose(1, 2) if trans else w
        b16_cm = w if trans else w.transpose(1, 2).contiguous() \
            .transpose(1, 2)
        b32 = b16.float() if lhs.dtype == torch.float32 else None
        lib_ms, lib = library_time(_fp32_first(lhs, [
            ("torch._grouped_mm fp32", lambda: torch._grouped_mm(
                lhs, b32, offs=offs)),
            ("torch._grouped_mm bf16", lambda: torch._grouped_mm(
                a16, b16, offs=offs)),
            ("torch._grouped_mm bf16, column-major rhs",
             lambda: torch._grouped_mm(a16, b16_cm, offs=offs))]))
        shape = (f"{label} M={cap} M_pad={lhs_pad.shape[0]} K={K} N={N} "
                 f"G={G} live_tiles={n_live} lhs={lhs.dtype} "
                 f"trans_b={trans} wgmma_passes="
                 f"{_passes(lhs.dtype, torch.bfloat16)} library=({lib})")
        report("grouped_matmul_aligned", shape, err, tol,
               ref.abs().max().item(), ms, plain_ms, b_ms, b_by, lib_ms)
        if not err <= tol:
            fail(f"grouped_matmul_aligned {label}: {err} > {tol}")
        rows[label] = dict(max_abs_err=err, tolerance=tol, ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, shape=shape)
        del lhs_pad, out, ref, a16, b16, b16_cm, b32

    wrows = {}
    # dW1 = xs^T da1 (bf16 x fp32), dW2 = h^T d_out (fp32 x fp32); dW1
    # again as the training step runs it, rounded to bf16 in the epilogue
    for label, lhs, rhs, odt in (
            ("train", xs, da, torch.float32),
            ("train fp32 x fp32", h, d_out, torch.float32),
            ("train bf16 output", xs, da, torch.bfloat16)):
        run = lambda: gm.grouped_matmul_wgrad(lhs, rhs, gs, out_dtype=odt)
        plain = lambda: gm.grouped_matmul_wgrad_ref(lhs, rhs, gs,
                                                    out_dtype=odt)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        # fp32 order over rows: 1e-4 of the largest value; a bf16 output
        # is each fp32 sum rounded once, so a sum near a rounding boundary
        # may round one ulp the other way: one ulp of each element on top
        ref32 = ref.float()
        err = ((out.float() - ref32).abs()
               - (bf16_ulp(ref32) if odt == torch.bfloat16 else 0.0)) \
            .max().item()
        tol = 1e-4 * ref32.abs().max().item()
        K, N = lhs.shape[1], rhs.shape[1]
        b_ms, b_by = roofline.bound_ms(roofline.wgrad_cost(
            cap, K, N, G, lhs_itemsize=lhs.element_size(),
            rhs_itemsize=rhs.element_size(), out_itemsize=out.element_size(),
            sizes_itemsize=gs.element_size(), rows=cap))
        ms, plain_ms = cuda_ms(run), cuda_ms(plain, iters=5, warmup=1)
        lt16, r16 = lhs.t().to(torch.bfloat16), rhs.to(torch.bfloat16)
        lt16_rm = lt16.contiguous()
        lt32, r32 = lhs.t().float(), rhs.float()
        cand = [("torch._grouped_mm fp32", lambda: torch._grouped_mm(
                    lt32, r32, offs=offs)),
                ("torch._grouped_mm bf16", lambda: torch._grouped_mm(
                    lt16, r16, offs=offs)),
                ("torch._grouped_mm bf16, row-major lhs^T",
                 lambda: torch._grouped_mm(lt16_rm, r16, offs=offs))]
        lib_ms, lib = library_time(_fp32_first(
            lhs if lhs.dtype == torch.float32 else rhs, cand))
        beyond = " (error beyond one ulp)" if odt == torch.bfloat16 else ""
        shape = (f"{label} M={cap} G={G} K={K} N={N} lhs={lhs.dtype} "
                 f"rhs={rhs.dtype} out={odt}{beyond} wgmma_passes="
                 f"{_passes(lhs.dtype, rhs.dtype)} library=({lib})")
        report("grouped_matmul_wgrad", shape, err, tol,
               ref.abs().max().item(), ms, plain_ms, b_ms, b_by, lib_ms)
        if not err <= tol:
            fail(f"grouped_matmul_wgrad {label}: {err} > {tol}")
        wrows[label] = dict(max_abs_err=err, tolerance=tol, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms, shape=shape)
        del out, ref, ref32, lt16, r16, lt16_rm, lt32, r32
    return rows, wrows


def k5_case(arch: str, T: int, gen, tp: int = 1):
    """A random fp32 head (V, d) of `arch`'s widths (over tp a rank's
    vocab shard: V padded to tp * 128, over tp) and bf16 x (T, d)."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    V = cfg.vocab_size if tp == 1 else -(-cfg.vocab_size // (tp * 128)) * 128
    w = 0.02 * torch.randn((V, cfg.d_model), generator=gen,
                           device="cuda")
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    return x, w


def check_k5(label, x, w):
    """K5 on x (T, d) bf16 and an fp32 head w (V, d) against its plain
    version (normalize the rows in fp32, then one fp32 product).  Beside
    `ms` (the wrapper from an idle queue): the card's time for the call
    (queue held), the host dispatch alone, and `product_ms`, one fp32
    cuBLAS product x W_n^T on a head normalized beforehand (the same
    bytes read once: a yardstick, not the same function)."""
    import torch
    from repro_torch import roofline
    from repro_torch.core.normhead import normalize_rows
    from repro_torch.kernels import normhead as nh
    (T, d), V = x.shape, w.shape[0]
    out, ref = nh.normhead_matmul(x, w), nh.normhead_matmul_ref(x, w)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # fp32 sums in another order, and the division after the product
    # where the plain version divides W first: fp32 rounding only
    tol = 1e-4 * ref.abs().max().item()
    b_ms, b_by = roofline.bound_ms(roofline.normhead_cost(
        T, V, d, x_itemsize=x.element_size(), w_itemsize=w.element_size()))
    run = lambda: nh.normhead_matmul(x, w)
    plain = lambda: nh.normhead_matmul_ref(x, w)
    ms, plain_ms = cuda_ms(run), cuda_ms(plain)
    dv, pdv, hs = device_ms(run), device_ms(plain), host_ms(run)
    wn, xf = normalize_rows(w, nh.EPS), x.float()
    product_ms = cuda_ms(lambda: torch.matmul(xf, wn.T))
    del wn, xf
    shape = f"{label} x=({T}, {d}) bf16 W=({V}, {d}) fp32"
    report("normhead_matmul", shape, err, tol, ref.abs().max().item(), ms,
           plain_ms, b_ms, b_by)
    print(f"[kernels] normhead_matmul {label}: the card's time (queue "
          f"held) {dv:.4f}ms (plain {pdv:.4f}ms); host dispatch {hs:.4f}ms; "
          f"fp32 product on a normalized head {product_ms:.4f}ms")
    if not err <= tol:
        fail(f"normhead_matmul {label} T={T}: {err} > {tol}")
    return dict(max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
                device_ms=dv, plain_device_ms=pdv, host_ms=hs,
                product_ms=product_ms)


def k6_case(B: int, T: int, dtype: str, extreme: bool, gen, H=None):
    """K6's operands at rwkv6-3b's heads (40 of 64, or a tp rank's H) from
    a non-zero state:
    r, k, v ~ N(0, 1) in `dtype`, w = exp(-exp(.)) in (0, 1) (`extreme`:
    exp(-exp(N(0, 1) +- 3)), each decay near 0 or near 1), u ~ 0.5 N(0,
    1), s0 ~ 0.1 N(0, 1)."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config("rwkv6-3b")
    H = H or cfg.d_model // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    r, k, v = (rnd(B, T, H, hd).to(getattr(torch, dtype)) for _ in range(3))
    if extreme:
        shift = 3.0 * torch.where(rnd(B, T, H, hd) > 0, 1.0, -1.0)
        w = torch.exp(-torch.exp(rnd(B, T, H, hd) + shift))
    else:
        w = torch.exp(-torch.exp(rnd(B, T, H, hd) - 1.0))
    return r, k, v, w, 0.5 * rnd(H, hd), 0.1 * rnd(B, H, hd, hd)


def check_k6(label, r, k, v, w, u, s0):
    """K6 against its plain version (the sequential recurrence in fp32);
    the state is written in place.  Beside `ms`: the card's time for the
    call (queue held) and the host dispatch alone."""
    import torch
    from repro_torch import roofline
    from repro_torch.kernels import wkv6 as wk
    (B, T, H, hd), dtype = r.shape, r.dtype
    state = s0.clone()
    y, sT = wk.wkv6(r, k, v, w, u, state, out_state=state)
    y_ref, s_ref = wk.wkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    if sT.data_ptr() != state.data_ptr():
        fail(f"wkv6 {label}: the state was not written in place")
    err_s = (sT - s_ref).abs().max().item()
    err_y = ((y.float() - y_ref.float()).abs()
             - (bf16_ulp(y_ref.float()) if dtype == torch.bfloat16
                else 0.0)).max().item()
    # fp32 sums in another order: 1e-4 of the largest output; a bf16 y is
    # the fp32 sum rounded once, as the reference's y.astype(cdt), so one
    # ulp of each element (a sum near a rounding boundary can round the
    # other way) is allowed on top
    tol_s = 1e-4 * s_ref.abs().max().item()
    tol_y = 1e-4 * y_ref.float().abs().max().item()
    st = s0.clone()
    run = lambda: wk.wkv6(r, k, v, w, u, st, out_state=st)
    plain = lambda: wk.wkv6_ref(r, k, v, w, u, s0)
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain, iters=5, warmup=1)
    dv, hs = device_ms(run), host_ms(run)
    pdv = device_ms(plain, iters=5, warmup=1)
    b_ms, b_by = roofline.bound_ms(roofline.wkv6_cost(
        B, T, H, hd, dtype=str(dtype).replace("torch.", ""),
        itemsize=r.element_size()))
    shape = (f"{label} B={B} T={T} H={H} hd={hd} r/k/v={dtype} "
             f"(y max_abs_err beyond one ulp {err_y:.3e}, tolerance "
             f"{tol_y:.3e}; state {err_s:.3e}, tolerance {tol_s:.3e})")
    report("wkv6", shape, max(err_s, err_y), max(tol_s, tol_y),
           s_ref.abs().max().item(), ms, plain_ms, b_ms, b_by)
    print(f"[kernels] wkv6 {label}: the card's time (queue held) "
          f"{dv:.4f}ms (plain {pdv:.4f}ms); host dispatch {hs:.4f}ms")
    if not (err_s <= tol_s and err_y <= tol_y):
        fail(f"wkv6 {label}: state {err_s} > {tol_s} or y {err_y} > {tol_y}")
    return dict(max_abs_err=max(err_s, err_y), tolerance=max(tol_s, tol_y),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, shape=shape, device_ms=dv,
                plain_device_ms=pdv, host_ms=hs)


def decay_case(M: int, dtype: str, gen, n=None):
    """The decay kernel's operands at rwkv6-3b's width (n output columns:
    d, or a tp rank's share): rows ~ N(0, 1) in `dtype`, A ~ N(0, 1 / d),
    B ~ N(0, 1 / 8), w0 ~ N(0, 1) - 1, so that w spreads over (0, 1) and
    moves with every term of the sums."""
    import torch
    from repro_torch.configs.base import get_config
    d = get_config("rwkv6-3b").d_model
    n = n or d
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    return (rnd(M, d).to(getattr(torch, dtype)), rnd(d, 32) / d ** 0.5,
            rnd(32, n) / 8 ** 0.5, rnd(n) - 1.0)


def check_decay(label, x, a, b, w0):
    """rwkv6's decay kernel against its plain version (the reference's
    two fp32 products), and each of up to 64 rows against the kernel on
    that row alone, bit for bit.  Beside `ms`: the card's time for the
    call (queue held) and the host dispatch alone."""
    import torch
    from repro_torch import roofline
    from repro_torch.kernels import rwkv_decay as dk
    M, d = x.shape
    n = b.shape[1]
    w = dk.rwkv_decay(x, a, b, w0)
    ref = dk.rwkv_decay_ref(x, a, b, w0)
    alone = torch.cat([dk.rwkv_decay(x[i:i + 1], a, b, w0)
                       for i in range(min(M, 64))])
    torch.cuda.synchronize()
    err = (w - ref).abs().max().item()
    # fp32 sums in another order: 1e-4 of the largest output
    tol = 1e-4 * ref.abs().max().item()
    run = lambda: dk.rwkv_decay(x, a, b, w0)
    plain = lambda: dk.rwkv_decay_ref(x, a, b, w0)
    ms, plain_ms = cuda_ms(run), cuda_ms(plain)
    dv, hs, pdv = device_ms(run), host_ms(run), device_ms(plain)
    b_ms, b_by = roofline.bound_ms(roofline.decay_cost(
        M, d, n, x_itemsize=x.element_size()))
    same = torch.equal(alone, w[:alone.shape[0]])
    shape = (f"{label} rows={M} d={d} n={n} x={x.dtype} (each of "
             f"{alone.shape[0]} rows alone gives the same bits: {same})")
    report("rwkv_decay", shape, err, tol, ref.abs().max().item(), ms,
           plain_ms, b_ms, b_by)
    print(f"[kernels] rwkv_decay {label}: the card's time (queue held) "
          f"{dv:.4f}ms (plain {pdv:.4f}ms); host dispatch {hs:.4f}ms")
    if not (err <= tol and same):
        fail(f"rwkv_decay {label}: {err} > {tol}, or a row alone gives "
             f"other bits ({same})")
    return dict(max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
                device_ms=dv, plain_device_ms=pdv, host_ms=hs)


# ---------------------------------------------------------------------------
# phase 4: FusedFFN gradients on the kernels
# ---------------------------------------------------------------------------


def check_grads(cfg, gen, T: int = 256):
    """`FusedFFN`'s grads on the kernels against autograd through a plain
    fp32 composition (per-expert fp32 matmuls), before the cast to the
    inputs' dtype (fp32 leaves in the composition) and after it (bf16
    leaves, whose .float() casts round the grads as the reference's
    astype transposes do)."""
    import torch
    from repro_torch.core import moe
    from repro_torch.models import layers as L
    p, x, tok, gates, gs = moe_case(cfg, T, gen)
    d, k = cfg.d_model, cfg.moe.top_k
    g = torch.randn((T, d), generator=gen, device="cuda")
    inputs = (x, p["we1"], p["we2"], p["we3"], gates)
    sizes = gs.tolist()

    def plain(x_, w1, w2, w3, gate):
        xs = x_[tok].float()
        outs, start = [], 0
        for e, n in enumerate(sizes):
            if n:
                r = xs[start:start + n]
                h = L._act("swiglu", r @ w1[e].float()) * (r @ w3[e].float())
                outs.append(h @ w2[e].float())
            start += n
        o = torch.cat(outs) * gate.float()[:, None]
        return torch.zeros((T, d), device="cuda").index_add(0, tok, o)

    def grads(fn, leaves):
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        fn(*leaves).backward(g)
        return [t.grad for t in leaves]

    kern = grads(lambda *a: moe.FusedFFN.apply("swiglu", a[0], a[1], a[2],
                                               a[3], tok, a[4], gs), inputs)
    dxs, dw1, dw2, dw3, dgate = moe.fused_ffn_backward(
        "swiglu", *inputs[:4], tok, gates, gs, g)
    dx = torch.zeros((T, d), device="cuda").index_add_(0, tok, dxs)
    pre = [dx, dw1, dw2, dw3, dgate]
    ref32 = grads(plain, [t.float() for t in inputs])
    ref16 = grads(plain, inputs)
    torch.cuda.synchronize()
    names = ("x", "w1", "w2", "w3", "gate")
    worst = {}
    for name, a, b, c, r in zip(names, pre, ref32, kern, ref16):
        m32, m16 = b.abs().max().item(), r.float().abs().max().item()
        e32 = (a - b).abs().max().item()
        e16 = ((c.float() - r.float()).abs()
               - bf16_ulp(r.float())).max().item()
        # before the cast: fp32 summation order, 1e-4 of the largest grad.
        # After it: one bf16 ulp of each element on top (an fp32
        # difference near a rounding boundary rounds one ulp the other
        # way); x's grad also sums its k gathered rows in bf16, in
        # another order (atomics against a sorted accumulate), so it gets
        # 2^-8 of its largest value per summand.
        tol16 = 1e-4 * m16 + (k * 2.0 ** -8 * m16 if name == "x" else 0.0)
        print(f"[grads] {name}: fp32 max_abs_err={e32:.3e} (tolerance "
              f"{1e-4 * m32:.3e}); {c.dtype} excess over one ulp="
              f"{e16:.3e} (tolerance {tol16:.3e})")
        if not (c.dtype == inputs[names.index(name)].dtype
                and e32 <= 1e-4 * m32 and e16 <= tol16):
            fail(f"FusedFFN grad of {name}: fp32 err {e32} (max {m32}), "
                 f"{c.dtype} excess {e16} > {tol16}")
        worst[name] = e32
    return worst


# ---------------------------------------------------------------------------
# phases 5-6: serving and the end-to-end check
# ---------------------------------------------------------------------------


def serve(cfg, params, n_req: int = 16, tag: str = "serve"):
    """`n_req` Poisson requests (prompts of 64-256 tokens, 32 new tokens
    each) through an OnlineEngine: launches per layer and step held,
    figures printed under `[tag]`.  Returns (report, launches)."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import build
    from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                            run_poisson_load)
    runner = api.Runner(cfg, device="cuda")
    # every tick under the debug sync guard: a device->host sync other
    # than the tick's announced drains raises
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=8, max_context=512, page_size=16, prefill_chunk=64,
        debug_guards=True))
    run_poisson_load(eng, rate=100.0, n_requests=2, prompt_len=64,
                     max_new=2, vocab_size=cfg.vocab_size, seed=7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    eng.step_calls = {k: 0 for k in eng.step_calls}
    max_new = 32
    # 1000 req/s: the arrivals land within a few ms, so all 8 slots
    # fill at once and stay busy while the queue drains
    rep = run_poisson_load(eng, rate=1000.0, n_requests=n_req,
                           prompt_len=(64, 256), max_new=max_new,
                           vocab_size=cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    calls = eng.step_calls
    steps = calls["prefill"] + calls["decode"]
    per_call = cfg.n_layers * steps
    print(f"[{tag}] prompts={rep['prompt_len']}")
    print(f"[{tag}] requests={n_req} tokens_out={rep['tokens_out']} "
          f"prefill_chunks={calls['prefill']} decode_ticks={calls['decode']}"
          f" launches={launches} expected {per_call} of K1/K3/K4 and "
          f"{steps} of normhead_matmul")
    print(f"[{tag}] tok/s={rep['tok_s']:.1f} ttft p50/p99="
          f"{rep['ttft_p50_ms']:.1f}/{rep['ttft_p99_ms']:.1f}ms itl p50/p99="
          f"{rep['itl_p50_ms']:.2f}/{rep['itl_p99_ms']:.2f}ms "
          f"wall={rep['wall_s']:.2f}s preempts={rep['preemptions']} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    tick = eng.registry.get("serve_tick_ms")
    print(f"[{tag}] telemetry on: serve_tick_ms p50={tick.percentile(50):.2f}"
          f"ms mean={tick.sum / max(tick.count, 1):.2f}ms over {tick.count} "
          f"ticks (window {tick.window_count()}), request log "
          f"{eng.rlog.counts()}")
    if rep["tokens_out"] != n_req * max_new:
        fail(f"served {rep['tokens_out']} tokens, expected {n_req * max_new}")
    for name, n in launches.items():
        want = (per_call if name in SERVE_KERNELS else
                steps * cfg.norm_head if name == "normhead_matmul" else 0)
        if n != want:
            fail(f"{name} launched {n} times in serving, expected {want} "
                 f"({cfg.n_layers} layers, {calls})")
    rep["tick_p50_ms"] = tick.percentile(50)
    return rep, launches


# ---------------------------------------------------------------------------
# phase 6b: sampling, speculative decoding, preemption replay
# ---------------------------------------------------------------------------


def _burst(runner, params, ocfg, reqs, drafter=None):
    """Serve `reqs` submitted at once through a fresh engine: (streams,
    figures, engine).  Figures on the host clock: output tokens/s, TTFT
    and ITL p50/p99, ticks per emitted token after the first."""
    import numpy as np
    import torch
    from repro_torch.serving.online import OnlineEngine
    eng = OnlineEngine(runner, params, ocfg, drafter=drafter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        r.arrival_t = t0
    eng.submit_many(reqs)
    eng.run(max_ticks=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = [1e3 * (r.first_token_t - r.arrival_t) for r in reqs]
    itl = [1e3 * (b - a) for r in reqs
           for a, b in zip(r.token_times, r.token_times[1:])]
    n_tok = sum(len(r.out) for r in reqs)
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else 0.0
    fig = dict(tok_s=n_tok / wall, ttft_p50_ms=pct(ttft, 50),
               ttft_p99_ms=pct(ttft, 99), itl_p50_ms=pct(itl, 50),
               itl_p99_ms=pct(itl, 99), tokens=n_tok, wall_s=wall,
               ticks_per_token=(sum(r.n_decode_ticks for r in reqs)
                                / max(sum(len(r.out) - 1 for r in reqs), 1)),
               acceptance=eng.spec_accepted / max(eng.spec_proposed, 1),
               preemptions=eng.n_preemptions)
    return [list(r.out) for r in reqs], fig, eng


# phase 6b's full-depth self-draft serves FULL_DRAFT_NEW tokens a request,
# all 32 of phase 5's (61-85 s of the script's 1200)
FULL_DRAFT_NEW = 32


def serve_sampled(cfg, params, base, card):
    """Phase 6b on phase 5's model and prompts: mixed-temperature serving
    (again with the radix cache off and with a pool that preempts),
    greedy speculation with a 4-layer and a 28-layer self-draft, sampled
    speculation, the launches per spec tick, and the sampling call's
    time.  Returns the launches of the greedy spec run."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.kernels import build
    from repro_torch.models import embedding as emb
    from repro_torch.serving.draft import SelfDrafter
    from repro_torch.serving.online import OnlineConfig, OnlineRequest
    runner = api.Runner(cfg, device="cuda")
    prompts = [np.asarray(p, np.int32) for p in base["prompts"]]
    greedy = base["outputs"]
    geo = dict(max_slots=8, max_context=512, page_size=16, prefill_chunk=64)
    hot = dict(temperature=0.8, top_p=0.95, top_k=64)
    K, DL = 4, 4

    def reqs(mixed=True, new=32, **knobs):
        return [OnlineRequest(
            rid=i, prompt=p, max_new=new,
            **(dict(hot, seed=1000 + i) if mixed and i >= 8 else knobs))
            for i, p in enumerate(prompts)]

    def show(label, fig):
        print(f"[sample] {label}: tok/s={fig['tok_s']:.2f} ttft p50/p99="
              f"{fig['ttft_p50_ms']:.1f}/{fig['ttft_p99_ms']:.1f}ms itl "
              f"p50/p99={fig['itl_p50_ms']:.2f}/{fig['itl_p99_ms']:.2f}ms "
              f"ticks/token={fig['ticks_per_token']:.3f} acceptance="
              f"{fig['acceptance']:.4f} preemptions={fig['preemptions']} "
              f"tokens={fig['tokens']} wall={fig['wall_s']:.2f}s [{card}]")

    # 1. mixed sampling: requests 0-7 greedy, 8-15 at temperature 0.8
    mixed, fig, _ = _burst(runner, params, OnlineConfig(**geo), reqs())
    show("mixed temperatures (0-7 greedy, 8-15 at 0.8 / 0.95 / 64)", fig)
    if mixed[:8] != greedy[:8]:
        fail("phase 6b: temperature-0 streams differ from phase 5's")
    if fig["tokens"] != 16 * 32:
        fail(f"phase 6b: mixed run emitted {fig['tokens']} tokens")
    off, fig, _ = _burst(runner, params,
                         OnlineConfig(**geo, radix_cache=False), reqs())
    show("mixed, radix cache off", fig)
    cut, fig, eng = _burst(runner, params, OnlineConfig(**geo, n_pages=97),
                           reqs())
    show("mixed, pool cut to 96 pages", fig)
    if eng.n_preemptions < 1:
        fail("phase 6b: the cut pool preempted nothing")
    for label, streams in (("radix off", off), ("preempted", cut)):
        if streams != mixed:
            bad = [i for i in range(16) if streams[i] != mixed[i]]
            fail(f"phase 6b: {label} streams differ from the first run's "
                 f"(requests {bad})")

    # 2. greedy speculation, 4-layer self-draft; 5. its launches
    torch.cuda.synchronize()
    build.reset_launches()
    spec, fig, eng = _burst(runner, params, OnlineConfig(**geo, spec_k=K),
                            reqs(mixed=False), SelfDrafter(DL))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    show(f"greedy spec k={K}, {DL}-layer self-draft", fig)
    if spec != greedy:
        bad = [i for i in range(16) if spec[i] != greedy[i]]
        fail(f"phase 6b: greedy spec streams differ from phase 5's "
             f"(requests {bad})")
    calls = eng.step_calls
    per_tick = {n: (K + 1) * DL + cfg.n_layers for n in SERVE_KERNELS}
    per_tick["normhead_matmul"] = (K + 1) + 1
    per_chunk = {n: cfg.n_layers + DL for n in SERVE_KERNELS}
    per_chunk["normhead_matmul"] = 2            # the target's and drafter's
    print(f"[sample] spec launches {launches} over {calls['prefill']} "
          f"prefill chunks (target + drafter) and {calls['verify']} spec "
          f"ticks; per spec tick expected {per_tick}")
    if calls["decode"] or calls["draft"] != calls["verify"]:
        fail(f"phase 6b: spec engine step calls {calls}")
    for name, n in launches.items():
        want = (per_chunk.get(name, 0) * calls["prefill"]
                + per_tick.get(name, 0) * calls["verify"])
        if n != want:
            fail(f"phase 6b: {name} launched {n} times, expected {want} "
                 f"({per_tick.get(name, 0)} per spec tick)")

    # 3. a full-depth self-draft accepts every draft (16 requests, two
    # waves of the 8 slots; FULL_DRAFT_NEW tokens each)
    full, fig, eng = _burst(runner, params, OnlineConfig(**geo, spec_k=K),
                            reqs(mixed=False, new=FULL_DRAFT_NEW),
                            SelfDrafter(cfg.n_layers))
    show(f"greedy spec k={K}, full-depth self-draft, {FULL_DRAFT_NEW} "
         f"tokens a request", fig)
    head = [g[:FULL_DRAFT_NEW] for g in greedy]
    if eng.spec_accepted != eng.spec_proposed or full != head:
        fail(f"phase 6b: full-depth self-draft accepted "
             f"{eng.spec_accepted} of {eng.spec_proposed} drafts, streams "
             f"equal phase 5's: {full == head}")

    # 4. sampled speculation
    _, fig, _ = _burst(runner, params, OnlineConfig(**geo, spec_k=K),
                       reqs(mixed=False, seed=7, **hot), SelfDrafter(DL))
    show(f"sampled spec k={K} at 0.8 / 0.95 / 64, {DL}-layer self-draft",
         fig)
    if fig["tokens"] != 16 * 32:
        fail(f"phase 6b: sampled spec emitted {fig['tokens']} tokens")

    # one sampling call (transforms, keys, gumbel draw) at a tick's rows
    # and at a k = 4 verify pass's
    g = torch.Generator(device="cuda").manual_seed(6)
    for T in (8, 8 * (K + 1)):
        lg = torch.randn((T, cfg.vocab_size), generator=g, device="cuda")
        knobs = (torch.arange(T, device="cuda"),
                 torch.full((T,), 0.8, device="cuda"),
                 torch.full((T,), 0.95, device="cuda"),
                 torch.full((T,), 64, device="cuda"))
        ms = cuda_ms(lambda: emb.sharded_sample(
            cfg, lg, seeds=knobs[0], pos=knobs[0], temperature=knobs[1],
            top_p=knobs[2], top_k=knobs[3]))
        print(f"[sample] one sampling call at {T} x {cfg.vocab_size}: "
              f"{ms:.4f}ms [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 6c: dense decode, Flood on Ling-Lite, scoring, telemetry
# ---------------------------------------------------------------------------


def _expect(label, got, want):
    """Fail unless the launch counts `got` equal `want` (missing = 0)."""
    names = set(got) | set(want)
    if any(got.get(n, 0) != want.get(n, 0) for n in names):
        fail(f"phase 6c: {label} launches {got}, expected {want}")


def _flood(cfg, fns, label, card, n_req=16, max_new=32, micro=8):
    """Run the Flood engine over `fns`; (token lists, head calls)."""
    import numpy as np
    import torch
    from repro_torch.serving.flood import FloodEngine, GenRequest
    from repro_torch.serving.segment_cache import SegmentCache
    embed_fn, stage_fns, head_fn = fns
    calls = []

    def head(x, reqs):
        calls.append(len(reqs))
        return head_fn(x, reqs)

    rs = np.random.RandomState(0)
    reqs = [GenRequest(rid=i, prompt=rs.randint(0, cfg.vocab_size, 8)
                       .astype(np.int32), max_new=max_new)
            for i in range(n_req)]
    eng = FloodEngine(stage_fns, head, embed_fn,
                      cache=SegmentCache(max_tokens=1 << 16,
                                         initial_segment=32,
                                         extend_chunk=32), microbatch=micro)
    eng.submit(reqs)
    stats = eng.run()
    torch.cuda.synchronize()
    print(f"[dense] Flood engine {label}: {n_req} requests x {max_new} new "
          f"tokens, micro-batch {micro}, 2 stages: tokens={stats.tokens_out}"
          f" wall={stats.wall_s:.2f}s tok/s={stats.tokens_per_s:.1f} "
          f"head calls={len(calls)} [{card}]")
    if stats.tokens_out != n_req * max_new or not all(
            len(r.out) == max_new for r in reqs):
        fail(f"phase 6c: Flood engine {label} emitted {stats.tokens_out} "
             f"tokens, expected {n_req * max_new}")
    return [r.out for r in reqs], len(calls)


def dense_serve(cfg, params, base, card):
    """Phase 6c on phase 5's model: dense prefill + ticks against the
    online engine, the Flood engine on Ling-Lite, scoring and the eval
    harness, and the SLO-shedding engine's telemetry.  Returns the
    launches of the dense prefill + ticks, of one Flood run and of one
    scoring call."""
    import json as json_
    import tempfile

    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.evals import harness as H
    from repro_torch.kernels import build
    from repro_torch.kernels import normhead as nh
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import build_model_engine
    from repro_torch.models import model as M
    from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                            OnlineRequest)
    from repro_torch.telemetry import SLOConfig, write_chrome_trace
    L_ = cfg.n_layers
    B, P, S, ticks = 8, 64, 512, 32
    runner = api.Runner(cfg, device="cuda")
    prompts = np.stack([np.asarray(p[:P], np.int32)
                        for p in base["prompts"][:B]])
    pt = torch.from_numpy(prompts).long().cuda()
    prefill, decode = runner.make_prefill(seq_len=S), runner.make_decode_step()
    tok, caches = prefill(params, {"tokens": pt})       # warm-up
    decode(params, caches, tok, P)
    del caches
    torch.cuda.synchronize()

    # 1. prefill into 512-position caches, 32 greedy ticks; launches
    build.reset_launches()
    t0 = time.perf_counter()
    tok, caches = prefill(params, {"tokens": pt})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after_prefill = dict(build.LAUNCHES)
    for pos in range(P, P + ticks):
        tok, caches = decode(params, caches, tok, pos)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dense_launches = dict(build.LAUNCHES)
    print(f"[dense] prefill B={B} S={P} into caches of {S}: "
          f"{1e3 * (t1 - t0):.2f}ms; {ticks} ticks: "
          f"{1e3 * (t2 - t1) / ticks:.2f}ms per tick; launches after the "
          f"prefill {after_prefill}, after the ticks {dense_launches} "
          f"[{card}]")
    _expect("prefill", after_prefill,
            {"fused_moe_ffn": L_, "normhead_matmul": 1})
    _expect("prefill + ticks", dense_launches,
            {"fused_moe_ffn": L_ * (1 + ticks),
             "paged_attn_scores_max": L_ * ticks,
             "paged_attn_accumulate": L_ * ticks,
             "normhead_matmul": 1 + ticks})
    del caches
    # phase 10b's card side: the dry run's prefill and tick
    # (`launch.dryrun`'s `step_args` and `count_step`) once more each on
    # the card, under the roofline counter, outside the timed ones
    from repro_torch.launch import dryrun
    base["dense_10b"] = {"prefill_ms": 1e3 * (t1 - t0),
                         "tick_ms": 1e3 * (t2 - t1) / ticks, "BPS": (B, P, S)}
    for label, shape, st in dense_dry_steps(B, P, S):
        args = dryrun.step_args(runner, shape, st, params=params)
        c, _ = dryrun.count_step(runner, shape, st, args)
        base["dense_10b"][label] = counts(c)
        del args, c
    torch.cuda.synchronize()

    # 2. token by token through the ticks vs the online engine (hard), and
    # the prefill's last logits against the ticks' (printed)
    with torch.no_grad():
        la, _ = M.prefill_logits(cfg, params, {"tokens": pt})
        caches = runner.init_caches(B, S)
        for pos in range(P):
            lb, caches = M.decode_logits(cfg, params, caches, pt[:, pos], pos)
    gap = (la - lb).abs().max().item() / la.abs().max().item()
    agree = int((la.argmax(-1) == lb.argmax(-1)).sum().item())
    print(f"[dense] prefill vs {P} ticks, last prompt position: logit gap "
          f"{gap:.3e} of the largest logit, first token agrees on {agree} "
          f"of {B}")
    tok = lb.argmax(-1).to(torch.int32)
    out = [tok]
    for pos in range(P, P + ticks - 1):
        tok, caches = decode(params, caches, tok, pos)
        out.append(tok)
    dense = torch.stack(out, 1).cpu().numpy().tolist()
    del caches
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=8, max_context=S, page_size=16, prefill_chunk=64))
    eng.submit_many([OnlineRequest(rid=i, prompt=prompts[i], max_new=ticks)
                     for i in range(B)])
    eng.run(max_ticks=10_000)
    online = [list(eng.reqs[i].out) for i in range(B)]
    same = sum(a == b for a, b in zip(dense, online))
    print(f"[dense] {B} prompts x {ticks} greedy tokens: dense ticks equal "
          f"the online engine's streams on {same} of {B}")
    if dense != online:
        fail(f"phase 6c: dense decode streams differ from the online "
             f"engine's ({B - same} of {B})")
    del eng

    # 3. the Flood engine on Ling-Lite: a shared position counter passing
    # the caches' length (the overflow rule), temperature 0 on the sampled
    # step against the greedy step, and 0.8
    seq = 32
    build.reset_launches()
    cold, n_calls = _flood(cfg, build_model_engine(runner, params, 2, 8, seq),
                           "temperature 0", card)
    flood_launches = dict(build.LAUNCHES)
    print(f"[dense] Flood: the shared position counter reaches seq_len="
          f"{seq} at head call {seq + 1} of {n_calls}; launches "
          f"{flood_launches}")
    if n_calls <= seq:
        fail(f"phase 6c: {n_calls} head calls never pass seq_len={seq}")
    _expect("Flood", flood_launches,
            {"fused_moe_ffn": L_ * n_calls,
             "paged_attn_scores_max": L_ * n_calls,
             "paged_attn_accumulate": L_ * n_calls,
             "normhead_matmul": n_calls})
    greedy_step = runner.make_decode_step()
    greedy_runner = types.SimpleNamespace(
        device=runner.device, init_caches=runner.init_caches,
        make_decode_step=lambda sample: (
            lambda p, c, t, pos, *knobs: greedy_step(p, c, t, pos)))
    if _flood(cfg, build_model_engine(greedy_runner, params, 2, 8, seq),
              "on the greedy step", card)[0] != cold:
        fail("phase 6c: Flood at temperature 0 differs from the greedy step")
    _flood(cfg, build_model_engine(runner, params, 2, 8, seq,
                                   temperature=0.8, seed=0),
           "temperature 0.8", card)

    # 4. scoring: the kernels against the plain modes, then the harness
    n_seq, s_len = 8, 512
    seqs = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                            (n_seq, s_len))
    mask = np.ones((n_seq, s_len), np.float32)
    score = runner.make_score_fn()
    score(params, seqs, mask)                      # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    got = score(params, seqs, mask)
    torch.cuda.synchronize()
    score_ms = 1e3 * (time.perf_counter() - t0)
    base["score"] = (seqs, mask, got.cpu())         # phase 9c's (1, 1)
    score_launches = dict(build.LAUNCHES)
    _expect("scoring", score_launches,
            {"fused_moe_ffn": L_, "normhead_matmul": 1})
    # per token: each log p(token_t | tokens_<t) through the kernels and
    # through the plain modes (ragged MoE, plain K5), on the forward and
    # head that make_score_fn runs
    lp, _ = token_logp(cfg, params, seqs, runner.flags)
    saved = kops.normhead_logits
    kops.normhead_logits = nh.normhead_matmul_ref
    try:
        plain = api.Runner(cfg, flags=M.RunFlags(moe_dispatch="ragged",
                                                 paged_attn="gathered"),
                           device="cuda")
        want = plain.make_score_fn()(params, seqs, mask)
        lp_plain, top = token_logp(cfg, params, seqs, plain.flags)
    finally:
        kops.normhead_logits = saved
    torch.cuda.synchronize()
    tok_err = (lp - lp_plain).abs().max().item()
    tok_tol = SCORE_TOL * top
    # make_score_fn against the sum of its own per-token log-probs: the
    # same logits, fp32 log-sum-exp and summation in another order
    sum_err = (got - lp.sum(-1)).abs().max().item()
    sum_tol = 1e-5 * (s_len - 1) * lp.abs().max().item()
    err = (got - want).abs().max().item()
    print(f"[dense] make_score_fn {n_seq} x {s_len}: {score_ms:.2f}ms "
          f"(launches {score_launches}); scores {got.cpu().numpy().round(2)}"
          f"; per token against the plain modes max_abs_err={tok_err:.4e} "
          f"nats (tolerance {tok_tol:.4e}: {SCORE_TOL:g} x largest logit "
          f"{top:.4f}), mean {(lp - lp_plain).abs().mean().item():.4e}; "
          f"per sequence {err:.4e}; scores against their per-token sums "
          f"{sum_err:.4e} (tolerance {sum_tol:.4e}) [{card}]")
    if not (bool(torch.isfinite(got).all()) and bool((got < 0).all())):
        fail(f"phase 6c: scores {got.tolist()} not finite and negative")
    if not tok_err <= tok_tol:
        fail(f"phase 6c: a token's log p is {tok_err} nats from the plain "
             f"modes' (tolerance {tok_tol})")
    if not sum_err <= sum_tol:
        fail(f"phase 6c: make_score_fn's scores are {sum_err} from the sums "
             f"of their tokens' log p (tolerance {sum_tol})")
    del lp, lp_plain

    def score_fn(t, m):
        return float(score(params, t[None], m[None])[0])

    def decode_fn(prompt, max_new):
        n = len(prompt)
        cap = -(-(n + max_new) // 16) * 16
        tok, c = runner.make_prefill(seq_len=cap)(
            params, {"tokens": torch.from_numpy(prompt[None]).long().cuda()})
        out = [tok]
        for pos in range(n, n + max_new - 1):
            tok, c = decode(params, c, tok, pos)
            out.append(tok)
        return torch.cat(out).cpu().numpy()

    n_items = 4
    items = H.make_mc_dataset(n_items, cfg.vocab_size)
    gens = H.make_gen_dataset(n_items, cfg.vocab_size)
    for label, fn in (
            ("ppl_eval_content", lambda: H.ppl_eval_content(items, score_fn)),
            ("ppl_eval_label", lambda: H.ppl_eval_label(
                items, score_fn, label_tokens=[1, 2, 3, 4])),
            ("gen_eval", lambda: H.gen_eval(gens, decode_fn, max_new=8))):
        t0 = time.perf_counter()
        rep = fn()
        ms = 1e3 * (time.perf_counter() - t0) / n_items
        print(f"[dense] harness {label} over {n_items} items: accuracy "
              f"{rep['accuracy']:.3f} (random weights: chance), "
              f"{ms:.1f}ms per item [{card}]")

    # 5. telemetry: SLO shedding with a deadline below phase 5's tick p50
    deadline = 0.5 * base["tick_p50_ms"]
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=8, max_context=S, page_size=16, prefill_chunk=64,
        overload="slo", slo=SLOConfig(ttft_p99_ms=deadline)))
    # one request arms the gate (it needs 8 tick samples in its window)
    eng.submit(OnlineRequest(rid=100, prompt=prompts[0], max_new=9))
    eng.run(max_ticks=1000)
    took = [eng.submit(OnlineRequest(rid=i, prompt=np.asarray(p, np.int32),
                                     max_new=32))
            for i, p in enumerate(base["prompts"])]
    eng.run(max_ticks=10_000)
    reg = eng.registry
    val = lambda name: reg.get(name).value
    emitted = sum(len(r.out) for r in eng.reqs.values())
    submitted = 1 + len(took)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "serve_trace.json"
        n_ev = write_chrome_trace(path, timer=eng.timer,
                                  request_log=eng.rlog, registry=reg)
        n_read = len(json_.loads(path.read_text())["traceEvents"])
    print(f"[dense] SLO engine, deadline {deadline:.2f}ms (half phase 5's "
          f"tick p50): submitted {submitted}, admitted "
          f"{val('serve_admitted_total'):g}, shed {val('serve_shed_total'):g}"
          f", tokens {val('serve_tokens_total'):g} (emitted {emitted}); "
          f"slo {eng.slo.snapshot()}; request log {eng.rlog.counts()}; "
          f"Chrome trace {n_ev} events ({n_read} read back)")
    if not (val("serve_shed_total") >= 1
            and val("serve_tokens_total") == emitted
            and val("serve_admitted_total") + val("serve_shed_total")
            == submitted and n_ev == n_read > 0):
        fail("phase 6c: the SLO engine's counters disagree with its run")
    return dense_launches, flood_launches, score_launches


def dpo_check(cfg, params, card):
    """Phase 6c's DPO with packing on phase 5's model: 32 random pairs
    (numpy seed 0; prompts of 32-256 tokens, responses of 16-256), max_len
    1024, in the padded and the packed layout; each layout's rows through
    the forward that make_score_fn runs (K1 per layer, the K5 head), at
    most 8 rows a call (8 x 1024 fp32 logits of the 126464-token
    vocabulary: 4.1 GB), pooled per (pair, chosen / rejected) by
    `segment_pooled_logps`.  The same model is policy and reference.
    Held: the padded layout's pooled sums are `sequence_logps` of its rows
    (within fp32 summation order: n * 2^-24 * the sum of the n terms'
    magnitudes), both layouts count the same chosen tokens, the DPO term
    is log 2 to fp32 rounding, preference_acc 0, everything finite, the
    pooling repeats its bits on the same logits, and the launches per
    call.  The packed sums differ from the padded ones (a packed segment
    attends to the segments before it in its row) and are printed.  Each
    layout's ms is the card's time (CUDA events) of its forwards, heads
    and poolings.  Returns the launches of the packed pass."""
    import math

    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import embedding as emb
    from repro_torch.models import model as M
    from repro_torch.training import dpo
    n_pairs, max_len, per_call = 32, 1024, 8
    rs = np.random.RandomState(0)
    draw = lambda lo, hi: rs.randint(0, cfg.vocab_size,
                                     rs.randint(lo, hi + 1)).astype(np.int32)
    pairs = [dpo.PairExample(prompt=draw(32, 256), chosen=draw(16, 256),
                             rejected=draw(16, 256)) for _ in range(n_pairs)]
    padded = dpo.pad_pairs(pairs, max_len)
    packed = dpo.pack_pairs(pairs, max_len)
    speed = dpo.packing_speedup(pairs, max_len)
    # the padded layout pooled with one segment a row
    padded["segment_ids"] = np.repeat(
        np.arange(2 * n_pairs, dtype=np.int32)[:, None], max_len, 1)

    def run(layout):
        """(chosen, rejected, counts, |token log p| at response positions
        (R, S), sequence_logps per row, ms, launches)."""
        dev = lambda a: torch.from_numpy(np.asarray(a)).cuda()
        toks, mask = dev(layout["tokens"]).long(), dev(layout["resp_mask"])
        seg = dev(layout["segment_ids"])
        R = toks.shape[0]
        zero = torch.zeros((n_pairs,), device="cuda")
        chosen, rejected, counts = zero.clone(), zero.clone(), zero.clone()
        seq_lp, mass = [], []
        torch.cuda.synchronize()
        build.reset_launches()
        events = []
        for r0 in range(0, R, per_call):
            rows = slice(r0, min(r0 + per_call, R))
            b = rows.stop - r0
            with torch.no_grad():
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                x, _, _, _ = M.forward(cfg, params, {"tokens": toks[rows]},
                                       train=False)
                logits = emb.serve_logits(cfg, params["embed"], x) \
                    .reshape(b, max_len, -1)
                del x
                (c, r), n = dpo.segment_pooled_logps(
                    logits, toks[rows], mask[rows], seg[rows], n_pairs)
                ev[1].record()
                events.append(ev)
                (c2, r2), _ = dpo.segment_pooled_logps(
                    logits, toks[rows], mask[rows], seg[rows], n_pairs)
                if not (torch.equal(c, c2) and torch.equal(r, r2)):
                    fail("phase 6c: segment_pooled_logps gave other bits on "
                         "a second run on the same logits")
                # each segment's terms lie in one call: adding the others'
                # zeros keeps its bits
                chosen, rejected, counts = chosen + c, rejected + r, counts + n
                seq_lp.append(dpo.sequence_logps(logits, toks[rows],
                                                 mask[rows]))
                tok = torch.gather(logits, -1, toks[rows][..., None])[..., 0] \
                    - torch.logsumexp(logits, dim=-1)
                mass.append((tok * mask[rows]).abs())
                del logits, tok
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in events)
        launches = dict(build.LAUNCHES)
        calls = -(-R // per_call)
        _expect(f"DPO {R} rows", launches,
                {"fused_moe_ffn": cfg.n_layers * calls,
                 "normhead_matmul": calls})
        return (chosen, rejected, counts, torch.cat(mass),
                torch.cat(seq_lp), ms, launches)

    run(dict(packed, tokens=packed["tokens"][:per_call],
             resp_mask=packed["resp_mask"][:per_call],
             segment_ids=packed["segment_ids"][:per_call]))     # warm-up
    pc, pr, pn, p_mass, p_seq, p_ms, _ = run(padded)
    kc, kr, kn, k_mass, _, k_ms, launches = run(packed)
    # fp32 summation order: n terms summed in any order differ by at most
    # n * 2^-24 * sum |terms|
    n_tok = torch.from_numpy(padded["resp_mask"].sum(1)).cuda()
    bar = n_tok * 2.0 ** -24 * p_mass.sum(1)
    pooled = torch.stack([pc, pr], 1).reshape(-1)
    err_seq = (pooled - p_seq).abs()
    # the packed layout's sums against the padded one's: the same tokens
    # after other rows' segments (the model takes no segment ids), so its
    # logits differ: printed, not held
    err_pack = torch.cat([(kc - pc).abs(), (kr - pr).abs()]).max().item()
    loss, mets = dpo.dpo_loss(kc, kr, kc, kr, chosen_token_count=kn)
    fin = all(bool(torch.isfinite(t).all()) for t in
              (pc, pr, kc, kr, loss, mets["nll"]))
    print(f"[dpo] {n_pairs} pairs, max_len {max_len}: padded {len(pooled)} "
          f"rows {p_ms:.2f}ms, packed {packed['tokens'].shape[0]} rows "
          f"{k_ms:.2f}ms (at most {per_call} rows a call); measured time "
          f"ratio {p_ms / k_ms:.3f} against packing_speedup's row ratio "
          f"{speed['speedup']:.3f} (useful fraction padded "
          f"{speed['useful_frac_padded']:.3f}, packed "
          f"{speed['useful_frac_packed']:.3f}) [{card}]")
    print(f"[dpo] padded pooled sums against sequence_logps: max "
          f"{err_seq.max().item():.3e} (bar per row, largest "
          f"{bar.max().item():.3e}); packed against padded pooled sums "
          f"(segments after others in a row): max {err_pack:.4f} nats; "
          f"chosen counts equal: {bool(torch.equal(kn, pn))}; loss "
          f"{loss.item():.6f} dpo {mets['dpo'].item():.9f} (log 2 = "
          f"{math.log(2):.9f}) nll {mets['nll'].item():.4f} preference_acc "
          f"{mets['preference_acc'].item():g}; pooling bit-equal on a "
          f"second run; launches of the packed pass {launches}")
    if not fin:
        fail("phase 6c: DPO log-probs or loss not finite")
    if not bool((err_seq <= bar).all()):
        fail(f"phase 6c: padded pooled sums differ from sequence_logps by "
             f"{err_seq.max().item()} (bar {bar.min().item()} ..)")
    if not torch.equal(kn, pn):
        fail("phase 6c: the layouts' chosen token counts differ")
    if not abs(mets["dpo"].item() - math.log(2)) <= 2.0 ** -23:
        fail(f"phase 6c: DPO term {mets['dpo'].item()} is not log 2")
    if mets["preference_acc"].item() != 0.0:
        fail("phase 6c: preference_acc is not 0 with policy = reference")
    return launches


def serve_archs(card, gen):
    """Phase 7b: ARCH_SERVE's models in turn, each from
    torch.Generator(device="cuda").manual_seed(0) in bf16, through an
    OnlineEngine (8 slots, page 16, chunk 64, context 512, greedy): 8
    requests with prompts of 64-256 tokens and 32 new tokens (`serve`:
    K1, K3, K4 once per layer per chunk and tick, K5 once per chunk and
    tick: every one of them has a NormHead), then one request
    teacher-forced through the kernels and through the plain modes
    (ragged MoE, gathered attention, plain K5), logits within the larger
    of 2^-5 of the largest and twice the plain witness's gap
    (`end_to_end`);
    peak memory under 80 GB.  Returns {arch: launches}."""
    import torch
    from repro_torch import api
    from repro_torch.configs.base import cut_depth, get_config
    out = {}
    for arch, depth in ARCH_SERVE:
        full = get_config(arch).n_layers
        cfg = cut_depth(get_config(arch), depth)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.Runner(cfg, device="cuda").init_params(0)
        torch.cuda.synchronize()
        leaves = list(_leaves(params))
        n_par = sum(t.numel() for t in leaves)
        size = sum(t.numel() * t.element_size() for t in leaves)
        m = cfg.moe
        print(f"[archs] {arch}: {cfg.n_layers} of {full} layers, d="
              f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
              f"{cfg.head_dim}, "
              f"{'dense' if m is None else f'{m.n_experts} experts top{m.top_k} ff {m.expert_d_ff} shared {m.n_shared_experts}'}"
              f", vocab {cfg.vocab_size}: {n_par / 1e9:.3f}B params, "
              f"{size / 1e9:.2f}GB, init {time.perf_counter() - t0:.1f}s")
        rep, launches = serve(cfg, params, n_req=8, tag=f"archs {arch}")
        err, agree = end_to_end(cfg, params, gen, plain_head=True,
                                witness=True, tag=f"archs {arch}")
        peak = torch.cuda.max_memory_allocated()
        print(f"[archs] {arch} ({cfg.n_layers} layers): tok/s="
              f"{rep['tok_s']:.1f} ttft p50={rep['ttft_p50_ms']:.1f}ms itl "
              f"p50={rep['itl_p50_ms']:.2f}ms peak max_memory_allocated "
              f"{peak / 1e9:.2f}GB; kernels vs plain logits {err:.4e}, "
              f"greedy agreement {agree:.3f} [{card}]")
        if not peak < 80e9:
            fail(f"phase 7b: {arch} peak memory {peak / 1e9:.2f} GB >= 80 GB")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = launches
    return out


# ---------------------------------------------------------------------------
# phase 7c: the block families the Ling blocks do not cover
# ---------------------------------------------------------------------------

def dense_teacher_forced(cfg, params, batch, toks, seq, flags, env=None):
    """Logits (1 + n, B, Vp): the prefill's (into caches of `seq`
    positions) at the prompt's last token, then one tick per column of
    toks (B, n), each feeding that token.  Over a tp mesh (`env`) each
    step's vocab shards are gathered over tp."""
    import torch
    from repro_torch import sharding
    from repro_torch.models import model as M
    env = env or sharding.LOCAL
    P = batch["tokens"].shape[1]
    with torch.no_grad():
        lg, caches = M.prefill_logits(cfg, params, batch, flags, seq, env)
        out = [env.all_gather_tp(lg, axis=1)]
        for i in range(toks.shape[1]):
            lg, caches = M.decode_logits(cfg, params, caches, toks[:, i],
                                         P + i, flags, env)
            out.append(env.all_gather_tp(lg, axis=1))
    return torch.stack(out)


def hold_logits(label, kern, plain, other, steps, phase="7c",
                tag="families"):
    """Phase 7c's bar on teacher-forced logits (1 + n, B, Vp): the
    kernels' against the plain modes' within the larger of 2^-5 of the
    largest and twice the rounding floor (the plain modes against the
    fp64-attention witness `other`), over the whole run and, each on its
    own bar, at the steps named in `steps` (label -> index), which
    rounding has amplified less."""
    import torch
    parts = [("the run", slice(None))] + [(n, i) for n, i in steps.items()]
    for name, at in parts:
        k, p, o = kern[at], plain[at], other[at]
        big = p.abs().max().item()
        err = (k - p).abs().max().item()
        flo = (o - p).abs().max().item()
        tol = max(2.0 ** -5 * big, 2 * flo)
        agree = (k.argmax(-1) == p.argmax(-1)).float().mean().item()
        ratio = f"{err / flo:.3f}" if flo > 0 else "n/a (floor 0)"
        print(f"[{tag}] {label}, {name}: kernels vs plain modes logits "
              f"max_abs_err={err:.4e} = {err / big:.4f} of the largest "
              f"(tolerance {tol:.4e}); rounding floor (the fp64-attention "
              f"witness vs plain) {flo:.4e} = {flo / big:.4f}, gap / floor "
              f"{ratio}; greedy agreement {agree:.3f}")
        if not (err <= tol and torch.isfinite(k).all()):
            fail(f"phase {phase}: {label}, {name}: kernels vs plain logits "
                 f"{err} > {tol}")


def serve_families(card):
    """Phase 7c: FAMILY_SERVE's models in turn at full width, every layer,
    bf16 weights from torch.Generator(device="cuda").manual_seed(0),
    greedy through `make_prefill` and `make_decode_step`: 8 prompts of
    512 tokens (numpy seed 0) into dense caches of 544 positions and 32
    ticks; whisper 8 prompts of 64 tokens beside 8 x 1504 seeded frames,
    caches of 128 positions.  Launches held: K5 once in the prefill and
    none of K3/K4 (the prefill attends on SDPA), then per tick K5 once and
    K3, K4 once per attention layer (whisper's cross attention too).
    Then one batch teacher-forced (a 64-token prefill, 8 ticks; whisper
    56 and 8) through the kernels and through the plain modes (gathered
    attention, the plain K5), logits within phase 7b's bar (the larger
    of 2^-5 of the largest and twice the gap between the plain modes and
    a witness that launches no kernel: here `fp64_attention`, as a dense
    model's `plain_kernels` is the plain modes bit for bit), and the
    prefill's and the first tick's logits each on the bar of its own
    floor (`hold_logits`); how far a prefill's last logits lie from the
    same 64 tokens fed tick by tick (printed, not held); for
    recurrentgemma one prompt of 2040 tokens into caches of 2080
    positions (its windows roll at 2048) and 32 ticks across the wrap,
    then that prompt teacher-forced for 16 ticks across the wrap through
    the kernels and the plain modes, held as above and at the first tick
    past the wrap; peak memory under 80 GB.  Returns {arch: launches of
    the main run}."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    out = {}
    pa_names = ("paged_attn_scores_max", "paged_attn_accumulate")

    def expect(label, got, per_tick, ticks, prefills=1):
        want = {n: 0 for n in got}
        want.update({n: per_tick * ticks for n in pa_names},
                    normhead_matmul=prefills + ticks)
        if got != want:
            fail(f"phase 7c: {label} launches {got}, expected {want}")

    for arch, per_tick in FAMILY_SERVE:
        cfg = get_config(arch)
        encdec = cfg.is_encoder_decoder
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = api.Runner(cfg, device="cuda")
        params = runner.init_params(0)
        torch.cuda.synchronize()
        leaves = list(_leaves(params))
        kinds = sorted({cfg.block_kind(i) for i in range(cfg.n_layers)})
        print(f"[families] {arch}: {cfg.n_layers} layers {kinds}"
              f"{' + %d encoder layers' % cfg.encoder_layers if encdec else ''}"
              f", d={cfg.d_model}, {cfg.n_heads} heads over "
              f"{cfg.n_kv_heads} of {cfg.head_dim}, {cfg.norm_type}, "
              f"{cfg.mlp_act} {cfg.d_ff}, window {cfg.attn_window}, vocab "
              f"{cfg.vocab_size}: {sum(t.numel() for t in leaves) / 1e9:.3f}"
              f"B params, {nbytes(*leaves) / 1e9:.2f}GB, init "
              f"{time.perf_counter() - t0:.1f}s (depth not cut)")
        B, ticks = 8, 32
        P, seq = (64, 128) if encdec else (512, 544)
        rs = np.random.RandomState(0)
        prompts = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, P))) \
            .cuda()
        batch = {"tokens": prompts}
        if encdec:
            batch["enc_frames"] = torch.from_numpy(rs.randn(
                B, cfg.encoder_seq_len, cfg.d_model).astype(np.float32)) \
                .cuda().to(torch.bfloat16)
        prefill, decode = runner.make_prefill(seq_len=seq), \
            runner.make_decode_step()
        # warm-up: cuBLAS handles and the allocator at these shapes
        tok, caches = prefill(params, batch)
        decode(params, caches, tok, P)
        del caches
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        tok, caches = prefill(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = dict(build.LAUNCHES)
        toks = [tok]
        for pos in range(P, P + ticks):
            tok, caches = decode(params, caches, tok, pos)
            toks.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(build.LAUNCHES)
        toks = torch.stack(toks).cpu()
        expect(f"{arch} prefill", after_prefill, per_tick, 0)
        expect(f"{arch} prefill + {ticks} ticks", launches, per_tick, ticks)
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"phase 7c: {arch} tokens out of the vocabulary")
        del caches
        prefill_ms, tick_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / ticks
        print(f"[families] {arch} prefill B={B} S={P} into caches of {seq}: "
              f"{prefill_ms:.2f}ms ({B * P / (t1 - t0):.0f} prompt "
              f"tokens/s); {ticks} ticks: {tick_ms:.2f}ms per tick "
              f"({B * ticks / (t2 - t1):.1f} tokens/s); K3/K4 {per_tick} "
              f"and K5 1 launches a tick [{card}]")

        # the kernels against the plain modes, teacher-forced
        n_tf = 8
        p_tf = P - n_tf if encdec else 64
        tf_batch = dict(batch, tokens=prompts[:, :p_tf])
        tf_toks = prompts[:, p_tf:p_tf + n_tf]
        build.reset_launches()
        kern = dense_teacher_forced(cfg, params, tf_batch, tf_toks, seq,
                                    M.RunFlags())
        n_k = dict(build.LAUNCHES)
        with plain_k5_k6():
            plain = dense_teacher_forced(cfg, params, tf_batch, tf_toks,
                                         seq, M.RunFlags(paged_attn=
                                                         "gathered"))
        with fp64_attention():
            other = dense_teacher_forced(cfg, params, tf_batch, tf_toks,
                                         seq, M.RunFlags())
        torch.cuda.synchronize()
        expect(f"{arch} teacher-forced", n_k, per_tick, n_tf)
        if dict(build.LAUNCHES) != n_k:
            fail(f"phase 7c: {arch}'s plain runs launched a kernel")
        hold_logits(f"{arch} 1 prefill + {n_tf} ticks teacher-forced "
                    f"(B={B})", kern, plain, other,
                    {"the prefill": 0, "the first tick": 1})
        del kern, plain, other

        # a prefill's last logits against the same tokens fed tick by tick
        n = 64
        one = {k: v[:1] for k, v in batch.items()}
        one["tokens"] = prompts[:1, :n]
        with torch.no_grad():
            la, pc = M.prefill_logits(cfg, params, one, seq_len=seq)
            c1 = runner.init_caches(1, seq)
            if encdec:
                for c, src in zip(c1, pc):
                    for name in ("k", "v"):
                        c["cross"][name].copy_(src["cross"][name])
            for pos in range(n):
                lb, c1 = M.decode_logits(cfg, params, c1,
                                         one["tokens"][:, pos], pos)
        gap = (la - lb).abs().max().item()
        print(f"[families] {arch} prefill of {n} tokens vs {n} ticks: last "
              f"logits gap {gap:.4e} = {gap / la.abs().max().item():.4f} of "
              f"the largest, same greedy token "
              f"{int(la.argmax(-1)) == int(lb.argmax(-1))} (printed only)")
        del pc, c1

        if arch == "recurrentgemma-2b":
            long_p, long_seq = 2040, 2080
            lp = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                             (1, long_p))).cuda()
            pre = runner.make_prefill(seq_len=long_seq)
            build.reset_launches()
            t0 = time.perf_counter()
            tok, caches = pre(params, {"tokens": lp})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = {c["self"]["k"].shape[1] for c in caches if "self" in c}
            ltoks = [tok]
            for pos in range(long_p, long_p + ticks):
                tok, caches = decode(params, caches, tok, pos)
                ltoks.append(tok)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            expect(f"{arch} {long_p}-token prompt", dict(build.LAUNCHES),
                   per_tick, ticks)
            ltoks = torch.stack(ltoks).cpu()
            if rows != {2048} or not bool(
                    ((ltoks >= 0) & (ltoks < cfg.vocab_size)).all()):
                fail(f"phase 7c: {arch} rolling caches of {rows} rows, or "
                     f"tokens out of the vocabulary")
            print(f"[families] {arch} 1 prompt of {long_p} tokens into "
                  f"caches of {long_seq} (windows rolling at {rows}): "
                  f"prefill {1e3 * (t1 - t0):.1f}ms, {ticks} ticks across "
                  f"the wrap at 2048 {1e3 * (t2 - t1) / ticks:.2f}ms per "
                  f"tick [{card}]")
            del caches
            # the same prompt teacher-forced across the wrap: the rolling
            # write at slot pos % 2048, then K3/K4 over the rolled rows
            n_w = 16
            lt = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                             (1, n_w))).cuda()
            lb = {"tokens": lp}
            build.reset_launches()
            kern = dense_teacher_forced(cfg, params, lb, lt, long_seq,
                                        M.RunFlags())
            n_k = dict(build.LAUNCHES)
            with plain_k5_k6():
                plain = dense_teacher_forced(cfg, params, lb, lt, long_seq,
                                             M.RunFlags(paged_attn=
                                                        "gathered"))
            with fp64_attention():
                other = dense_teacher_forced(cfg, params, lb, lt, long_seq,
                                             M.RunFlags())
            torch.cuda.synchronize()
            expect(f"{arch} teacher-forced across the wrap", n_k, per_tick,
                   n_w)
            if dict(build.LAUNCHES) != n_k:
                fail(f"phase 7c: {arch}'s plain runs launched a kernel")
            hold_logits(f"{arch} 1 prefill of {long_p} + {n_w} ticks "
                        f"teacher-forced across the wrap (B=1)", kern, plain,
                        other, {"the first tick": 1,
                                "the first tick past the wrap":
                                1 + 2048 - long_p})
            del kern, plain, other

        peak = torch.cuda.max_memory_allocated()
        print(f"[families] {arch}: peak max_memory_allocated "
              f"{peak / 1e9:.2f}GB [{card}]")
        if not peak < 80e9:
            fail(f"phase 7c: {arch} peak memory {peak / 1e9:.2f} GB >= 80 GB")
        del params, leaves, runner, prefill, decode
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = launches
    return out


# ---------------------------------------------------------------------------
# phase 7: rwkv6 serving
# ---------------------------------------------------------------------------


def prefill_and_ticks(cfg, params, tokens):
    """Last-position logits of rwkv6 over `tokens` (1, n): one prefill,
    and n decode ticks from zeroed caches."""
    import torch
    from repro_torch.models import model as M
    with torch.no_grad():
        la, _ = M.prefill_logits(cfg, params, {"tokens": tokens})
        c1 = M.init_caches(cfg, 1, tokens.device)
        for pos in range(tokens.shape[1]):
            lb, c1 = M.decode_logits(cfg, params, c1, tokens[:, pos])
    return la, lb


@contextlib.contextmanager
def plain_k5_k6():
    """Serve through the plain versions of K5 and K6 on CUDA tensors, the
    witness the kernels' logits are held against (no launch counted)."""
    from repro_torch.kernels import normhead as nh
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wkv6 as wk

    def wkv6_plain(r, k, v, w, u, state, *, out_state=None):
        y, sT = wk.wkv6_ref(r, k, v, w, u, state)
        return y, (sT if out_state is None else out_state.copy_(sT))

    saved = kops.normhead_logits, kops.wkv6
    kops.normhead_logits, kops.wkv6 = nh.normhead_matmul_ref, wkv6_plain
    try:
        yield
    finally:
        kops.normhead_logits, kops.wkv6 = saved


@contextlib.contextmanager
def plain_kernels():
    """Every serving kernel's plain version in place of the kernel on
    CUDA tensors: K1 (fp32 products and hidden, the combine in ascending
    row order), K3/K4 (fp32 scores over the gathered pages, p rounded to
    bf16 as K4 rounds it), K5 and K6 (`plain_k5_k6`).  The kernels' path
    computed by plain PyTorch alone; no launch counted."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import paged_attn as pa
    saved = (gm.fused_moe_ffn, pa.paged_attn_scores_max,
             pa.paged_attn_accumulate)
    gm.fused_moe_ffn = gm.fused_moe_ffn_ref
    pa.paged_attn_scores_max = pa.paged_attn_scores_max_ref
    pa.paged_attn_accumulate = pa.paged_attn_accumulate_ref
    try:
        with plain_k5_k6():
            yield
    finally:
        (gm.fused_moe_ffn, pa.paged_attn_scores_max,
         pa.paged_attn_accumulate) = saved


@contextlib.contextmanager
def fp64_attention():
    """K3/K4's plain versions with the scores, exponentials and sums in
    fp64, each result rounded once to fp32 (p still rounded to bf16
    before the PV product, as K4 and the plain versions round it), and
    the plain K5: the kernels' function in another rounding, launching no
    kernel.  A dense model's plain modes and `plain_kernels` are one
    computation bit for bit (no MoE to route otherwise), so this is phase
    7c's witness of how far rounding alone moves the logits."""
    import torch
    from repro_torch.kernels import paged_attn as pa

    def scores(q, k_pool, table, mask):
        B, KV, GQ, hd = q.shape
        n_q, n_lp, ps = mask.shape[1:]
        S, g = n_lp * ps, GQ // n_q
        kg = k_pool[table.long()].reshape(B, S, KV, hd).double()
        s = torch.einsum("bkrd,bskd->bkrs", q.double(), kg) * hd ** -0.5
        mskg = mask.reshape(B, 1, 1, n_q, S).expand(B, KV, g, n_q, S) \
            .reshape(B, KV, GQ, S)
        return torch.where(mskg, s, float("-inf")), mskg

    def scores_max(q, k_pool, table, mask):
        return scores(q, k_pool, table, mask)[0].amax(dim=-1).float()

    def accumulate(q, k_pool, v_pool, table, mask, m_safe):
        s, mskg = scores(q, k_pool, table, mask)
        p = torch.where(mskg, torch.exp(s - m_safe.double()[..., None]),
                        0.0)
        B, KV, _, hd = q.shape
        vg = v_pool[table.long()].reshape(B, -1, KV, hd).double()
        num = torch.einsum("bkrs,bskd->bkrd", p.to(v_pool.dtype).double(),
                           vg)
        return num.float(), p.sum(dim=-1).float()

    saved = pa.paged_attn_scores_max, pa.paged_attn_accumulate
    pa.paged_attn_scores_max, pa.paged_attn_accumulate = (scores_max,
                                                          accumulate)
    try:
        with plain_k5_k6():
            yield
    finally:
        pa.paged_attn_scores_max, pa.paged_attn_accumulate = saved


def rwkv_serve(card):
    """Full-width rwkv6-3b: prefill + greedy decode through the Runner,
    the prefill/decode consistency on the card, and the offline Flood
    engine.  Returns the launches of the prefill + ticks run and the
    prefill-vs-ticks checks that failed."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_model_engine
    from repro_torch.serving.flood import FloodEngine, GenRequest
    from repro_torch.serving.segment_cache import SegmentCache
    cfg = get_config("rwkv6-3b")
    B, S, ticks = 8, 512, 32
    t0 = time.perf_counter()
    runner = api.Runner(cfg, device="cuda")
    params = runner.init_params(0)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    print(f"[rwkv] rwkv6-3b {cfg.n_layers} layers d={cfg.d_model} heads="
          f"{cfg.d_model // cfg.rwkv_head_dim}x{cfg.rwkv_head_dim} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size}: "
          f"{sum(t.numel() for t in leaves) / 1e9:.3f}B params, "
          f"{nbytes(*leaves) / 2**30:.2f}GiB, init "
          f"{time.perf_counter() - t0:.1f}s (depth not cut)")
    prefill, decode = runner.make_prefill(), runner.make_decode_step()
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S))).cuda()
    # warm-up: cuBLAS handles and the allocator at these shapes
    tok, caches = prefill(params, {"tokens": prompts})
    decode(params, caches, tok, S)
    del caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    tok, caches = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after_prefill = dict(build.LAUNCHES)
    out = [tok]
    for pos in range(S, S + ticks):
        tok, caches = decode(params, caches, tok, pos)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    toks = torch.stack(out).cpu()
    prefill_ms, tick_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / ticks
    print(f"[rwkv] prefill B={B} S={S}: {prefill_ms:.2f}ms "
          f"({B * S / (t1 - t0):.0f} prompt tokens/s); {ticks} decode ticks:"
          f" {tick_ms:.2f}ms per tick ({B * ticks / (t2 - t1):.1f} tokens/s);"
          f" peak max_memory_allocated {peak / 2**30:.2f}GiB; launches "
          f"after the prefill {after_prefill}, after the ticks {launches} "
          f"[{card}]")
    want_prefill = {n: 0 for n in launches}
    want_prefill.update(wkv6=cfg.n_layers, normhead_matmul=1,
                        rwkv_decay=cfg.n_layers)
    want_all = dict(want_prefill, wkv6=cfg.n_layers * (1 + ticks),
                    normhead_matmul=1 + ticks,
                    rwkv_decay=cfg.n_layers * (1 + ticks))
    if after_prefill != want_prefill or launches != want_all:
        fail(f"rwkv6 serving launches {after_prefill} / {launches}, "
             f"expected {want_prefill} / {want_all}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("rwkv6 serving: tokens out of the vocabulary")
    del caches

    # consistency on the card: one 64-token prefill vs 64 decode ticks
    n = 64
    p1 = prompts[:1, :n]
    la, lb = prefill_and_ticks(cfg, params, p1)
    err = (la - lb).abs().max().item()
    # bf16 activations: every op of the block gives a row the same bits
    # whatever the rows in the call (the decay on its kernel), so the two
    # agree; 2^-5 of the largest logit
    tol = 2.0 ** -5 * la.abs().max().item()
    same = int(la.argmax(-1).item()) == int(lb.argmax(-1).item())
    print(f"[rwkv] prefill {n} tokens vs {n} decode ticks: logits "
          f"max_abs_err={err:.4e} (tolerance {tol:.4e}) same greedy token="
          f"{same}")
    ok16 = same and err <= tol and bool(torch.isfinite(la).all())
    # the same with fp32 activations, where rounding stays far below a
    # fault: prefill vs ticks, and the kernels' logits (prefill and last
    # tick) against the same runs through the plain K5 and K6, each bound
    # RWKV_FP32_TOL of the largest logit
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    fa, fb = prefill_and_ticks(c32, params, p1)
    with plain_k5_k6():
        pa, pb = prefill_and_ticks(c32, params, p1)
    top = pa.abs().max().item()
    err32 = (fa - fb).abs().max().item()
    errk = max((fa - pa).abs().max().item(), (fb - pb).abs().max().item())
    tol32 = {k: v * top for k, v in RWKV_FP32_TOL.items()}
    same32 = len({int(t.argmax(-1).item()) for t in (fa, fb, pa, pb)}) == 1
    print(f"[rwkv] fp32 activations: prefill vs ticks max_abs_err="
          f"{err32:.4e} ({err32 / top:.3e} of the largest, tolerance "
          f"{tol32['prefill vs ticks']:.4e}); kernels vs plain K5/K6 "
          f"max_abs_err={errk:.4e} ({errk / top:.3e} of the largest, "
          f"tolerance {tol32['kernels vs plain']:.4e}); same greedy token="
          f"{same32}")
    ok32 = (same32 and err32 <= tol32["prefill vs ticks"]
            and errk <= tol32["kernels vs plain"]
            and all(bool(torch.isfinite(t).all()) for t in (fa, fb)))
    failed = []
    if not ok16:
        failed.append(f"rwkv6 prefill vs decode: {err} > {tol} or token "
                      f"differs")
    if not ok32:
        failed.append(f"rwkv6 fp32: prefill vs decode {err32}, kernels vs "
                      f"plain {errk} (tolerances {tol32}) or a token "
                      f"differs")
    for msg in failed:
        print(f"chip_smoke: FAIL (the run fails at its end): {msg}",
              file=sys.stderr)

    # the offline Flood engine, through launch.serve's build_model_engine
    # (its sampled decode step): at temperature 0, against the same
    # engine on the greedy step, and at temperature 0.8
    def flood(fns, label):
        rs = np.random.RandomState(0)
        reqs = [GenRequest(rid=i, prompt=rs.randint(0, cfg.vocab_size, 8)
                           .astype(np.int32), max_new=32) for i in range(16)]
        embed_fn, stage_fns, head_fn = fns
        eng = FloodEngine(stage_fns, head_fn, embed_fn,
                          cache=SegmentCache(max_tokens=1 << 16,
                                             initial_segment=32,
                                             extend_chunk=32), microbatch=8)
        eng.submit(reqs)
        stats = eng.run()
        torch.cuda.synchronize()
        print(f"[rwkv] Flood engine {label}: 16 requests x 32 new tokens, "
              f"micro-batch 8, 2 stages: tokens={stats.tokens_out} wall="
              f"{stats.wall_s:.2f}s tok/s={stats.tokens_per_s:.1f} "
              f"ticks={stats.ticks} [{card}]")
        if stats.tokens_out != 16 * 32 or not all(len(r.out) == 32
                                                  for r in reqs):
            fail(f"Flood engine {label} emitted {stats.tokens_out} tokens, "
                 f"expected {16 * 32}")
        return [r.out for r in reqs]

    cold = flood(build_model_engine(runner, params, 2, 8), "temperature 0")
    greedy_step = runner.make_decode_step()
    greedy_runner = types.SimpleNamespace(
        device=runner.device, init_caches=runner.init_caches,
        make_decode_step=lambda sample: (
            lambda p, c, t, pos, *knobs: greedy_step(p, c, t, pos)))
    if flood(build_model_engine(greedy_runner, params, 2, 8),
             "on the greedy step") != cold:
        fail("Flood engine: temperature 0 differs from the greedy step")
    flood(build_model_engine(runner, params, 2, 8, temperature=0.8,
                             seed=0), "temperature 0.8")
    return launches, failed


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------


def train(card):
    """4 optimizer steps of the port's Trainer on Ling-Lite at full width,
    depth cut to 4 layers: 16 B/param of training state (fp32 master,
    grad, two moments) is ~45 GB at 4 layers against ~269 GB at 28.
    Returns (launches, the Trainer's history)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.optim import adamw
    steps = 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    trainer, cfg, (B, S, accum) = train_setup(steps)
    torch.cuda.synchronize()
    setup_bytes = torch.cuda.memory_allocated() - held0
    n_par = sum(t.numel() for t in adamw.leaves(trainer.params))
    print(f"[train] ling-lite d={cfg.d_model} layers={cfg.n_layers} (of 28) "
          f"experts={cfg.moe.n_experts} top{cfg.moe.top_k} vocab="
          f"{cfg.vocab_size}: {n_par / 1e9:.3f}B params, fp32 masters, init "
          f"{time.perf_counter() - t0:.1f}s; seq={S} microbatch={B} "
          f"accum={accum} remat=True router_warmup_steps="
          f"{cfg.moe.router_warmup_steps}")
    build.reset_launches()
    times = []
    try:
        for k in range(1, steps + 1):
            t0 = time.perf_counter()
            trainer.train(k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        trainer.close()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    step_s = sum(times[-2:]) / 2               # the median of two
    dev = trainer.timer.stats["device/step"].durations
    dev_ms = sum(list(dev)[-2:]) / 2e3
    for r in hist:
        print(f"[train] step={r['step']} loss={r['loss']:.4f} "
              f"ce={r['loss/ce']:.4f} aux={r['loss/aux']:.4f} "
              f"grad_norm={r['grad_norm']:.3f} lr={r['lr']:.2e} "
              f"skipped={r['skipped']} max_expert_frac="
              f"{r['router/max_expert_frac']:.3f}")
    per_step = {n: v / steps for n, v in launches.items()}
    want = step_launches(cfg, [accum])
    tok_s = B * S * accum / step_s
    print(f"[train] step times {[round(t, 3) for t in times]}s; median of "
          f"the last 2 {step_s:.3f}s (device time {dev_ms:.1f}ms); "
          f"{tok_s:.0f} tokens/s; peak max_memory_allocated "
          f"{peak / 2**30:.2f}GiB ({peak / 1e9:.2f}GB); launches per step "
          f"{per_step} expected {want}; commit_frac "
          f"{trainer.timer.gauges.get('commit_frac')} guard_n "
          f"{int(trainer.guard_state['n'])} [{card}]")
    if len(hist) != steps or not all(
            torch.isfinite(torch.tensor(r["loss"])) for r in hist):
        fail(f"training: losses {[r['loss'] for r in hist]}")
    if int(trainer.guard_state["n"]) != steps or \
            "commit_frac" not in trainer.timer.gauges:
        fail("training: the spike guard's commit was not reported per step")
    if per_step != want:
        fail(f"training launches per step {per_step} != {want}")
    if not peak < 80e9:
        fail(f"training peak memory {peak / 1e9:.2f} GB >= 80 GB")
    # phase 10a's card side: one more step under the roofline counter,
    # outside the timed ones
    counted = counted_train_step(trainer, B, S, accum, steps, setup_bytes)
    return launches, hist, dict(
        counted=counted, cfg=cfg, step_s=step_s,
        dry=train_dry_step(trainer, B, S, accum, steps),
        dry_mesh=train_dry_step(trainer, B, S, MESH_ACCUM, MESH_STEPS - 1))


def counts(c) -> dict:
    """A roofline counter's totals: flops by dtype, bytes, launches."""
    return {"flops": dict(c.flops), "bytes": c.bytes,
            "launches": c.launches}


def dense_dry_steps(B: int, P: int, S: int):
    """Phase 6c's dense prefill (B x P into caches of S) and tick (at
    position P) as the dry run's shapes and `Step`s (phase 10b)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    return (("prefill", ShapeConfig("dense_prefill", P, B, "prefill"),
             dryrun.Step(cache_len=S)),
            ("tick", ShapeConfig("dense_tick", S, B, "decode"),
             dryrun.Step(pos=P)))


def train_dry_step(trainer, B: int, S: int, accum: int, step: int):
    """Phase 8's step as the dry run's shape and `Step`: B x S a
    microbatch, accum microbatches, the Trainer's AdamW and spike guard,
    step index `step` (phases 10a and 10c)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    return (ShapeConfig("phase8_train", S, B, "train"),
            dryrun.Step(accum=accum, opt=trainer.cfg.opt,
                        spike=trainer.cfg.spike, index=step))


def counted_train_step(trainer, B: int, S: int, accum: int, step: int,
                       setup_bytes: int):
    """The dry run's train step (`launch.dryrun`'s `step_args` and
    `count_step`, at phase 8's shape and `Step`) once on the card with
    the Trainer's parameters and state and a zero batch: its counts under
    the roofline counter, the launches the wrappers made, and what the
    card's allocator measured: the step's arguments (`setup_bytes`, what
    building the Trainer left allocated, and the batch) and its peak over
    the bytes held before it (phase 10a)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    shape, st = train_dry_step(trainer, B, S, accum, step)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    args = dryrun.step_args(trainer.runner, shape, st, params=trainer.params,
                            opt_state=trainer.opt_state,
                            guard=trainer.guard_state)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    c, _ = dryrun.count_step(trainer.runner, shape, st, args)
    torch.cuda.synchronize()
    del args
    return dict(counts(c), card_launches={k: v for k, v in
                                          build.LAUNCHES.items() if v},
                live_peak=c.peak,
                card_args=setup_bytes + held - before,
                card_peak=torch.cuda.max_memory_allocated() - held)


def train_setup(steps: int, mesh=None, debug_guards: bool = True,
                accum: int = 2, sp_comm: str = "native"):
    """Phase 8's Trainer: Ling-Lite at full width cut to 4 layers, fp32
    masters from seed 0, seq 1024, microbatch 2, accum 2 (phase 9b: 1),
    the default spike guard, WSD schedule and router warmup; on `mesh`
    (phase 9) each rank's shards.  Returns (trainer, cfg, (B, S,
    accum))."""
    import dataclasses
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config("ling-lite"), n_layers=4)
    B, S = 2, 1024
    runner = api.Runner(cfg, device=mesh.device if mesh else "cuda",
                        mesh=mesh, sp_comm=sp_comm)
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=S, batch_size=B, seed=0))
    trainer = Trainer(runner, pipe, TrainConfig(
        n_steps=steps, accum_steps=accum, log_every=1, seed=0,
        debug_guards=debug_guards))
    return trainer, cfg, (B, S, accum)


# ---------------------------------------------------------------------------
# phase 8b: checkpoint and exact resume mid-warmup
# ---------------------------------------------------------------------------


def step_launches(cfg, accums) -> dict:
    """Phase 8's launches per step, summed over steps at these accums."""
    n = sum(accums) * cfg.n_layers
    return {"fused_moe_ffn": 2 * n, "grouped_matmul_aligned": 6 * n,
            "grouped_matmul_wgrad": 3 * n, "paged_attn_scores_max": 0,
            "paged_attn_accumulate": 0, "normhead_matmul": 0, "wkv6": 0,
            "rwkv_decay": 0}


def train_resume(card):
    """Run A trains Ling-Lite (full width, 1 layer) 6 steps through the
    batch-size warmup with the router warmup active, checkpointing at 3
    and 6; a fresh Trainer B restores step_3 and trains to 6.  B's losses,
    params, moments and guard state must be A's bit for bit."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models import prng
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import AccumWarmup
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config("ling-lite"), n_layers=1)
    B, S, steps, every = 2, 1024, 6, 3
    bw = AccumWarmup(microbatch=B, start=2, end=8, warmup_steps=4,
                     increments=2)
    accums = [bw.accum_for(i) for i in range(steps)]
    n_par = sum(t.numel() for t in adamw.leaves(
        M.init_model(cfg, device="meta", masters=True)))
    ck_bytes = 12 * n_par                 # fp32 params and two moments
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))

    def make(ckpt_dir=True, every_=0):
        return Trainer(
            api.Runner(cfg, device="cuda"),
            DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        seq_len=S, batch_size=B, seed=0)),
            TrainConfig(n_steps=steps, bs_warmup=bw, log_every=1, seed=0,
                        debug_guards=True,
                        checkpoint_dir=str(root) if ckpt_dir else None,
                        checkpoint_every=every_))

    def run(trainer, saves=None):
        """Step by step to `steps`; host-clock seconds per step (each
        ends synchronized; a checkpoint step includes its save's fetch)."""
        times = []
        for k in range(trainer.step + 1, steps + 1):
            t0 = time.perf_counter()
            trainer.train(k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if saves is not None and k % every == 0:
                saves.append(trainer.pcache.last_save)
        return times

    def state(trainer):
        return (adamw.leaves(trainer.params)
                + adamw.leaves(trainer.opt_state)
                + adamw.leaves(trainer.guard_state))

    def ndiff(xs, ys) -> int:
        return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                   for x, y in zip(xs, ys))

    try:
        free = shutil.disk_usage(root).free
        need = 2 * ck_bytes + (1 << 30)
        print(f"[resume] ling-lite d={cfg.d_model} layers=1 (of 28): "
              f"{n_par / 1e9:.3f}B params, a checkpoint of "
              f"{ck_bytes / 1e9:.2f}GB (fp32 params, m, v); {root} has "
              f"{free / 1e9:.1f}GB free; seq={S} microbatch={B} accum "
              f"{accums} router_warmup_steps={cfg.moe.router_warmup_steps}")
        if free < need:
            fail(f"phase 8b: {root} has {free / 1e9:.2f} GB free; two "
                 f"checkpoints need {need / 1e9:.2f} GB")
        # the warmup noise: the step's key schedule and draws alone
        key = prng.prng_key(0, "cuda")
        T = B * S

        def draws(accum):
            rng = prng.fold_in(prng.fold_in(key, 1), 0)
            for k in range(accum):
                M.warmup_noise(cfg, prng.fold_in(rng, k) if accum > 1
                               else rng, 1, T)
        noise_ms = {a: cuda_ms(lambda: draws(a), iters=10)
                    for a in sorted(set(accums))}

        # run A: 6 steps, checkpoints at 3 and 6
        a = make(every_=every)
        saves = []
        build.reset_launches()
        try:
            times_a = run(a, saves)
        finally:
            a.close()                     # waits for the writers
        launches_a = dict(build.LAUNCHES)
        hist_a = [(r["loss"], r["grad_norm"]) for r in a.history]
        final_a = [t.detach().clone() for t in state(a)]
        del a
        gc.collect()
        torch.cuda.empty_cache()

        # run B: a fresh Trainer restores "latest", then step_3
        b = make()
        t0 = time.perf_counter()
        latest = b.restore("latest")
        torch.cuda.synchronize()
        latest_s = time.perf_counter() - t0
        n_latest = ndiff(final_a, state(b))
        t0 = time.perf_counter()
        b.restore(f"step_{every}")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        load_s = b.pcache.last_load["seconds"]
        stage = b._accum
        build.reset_launches()
        try:
            times_b = run(b)
        finally:
            b.close()
        launches_b = dict(build.LAUNCHES)
        hist_b = [(r["loss"], r["grad_norm"]) for r in b.history]
        n_diff = ndiff(final_a, state(b))
        del b
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for i, (k, (loss, gn)) in enumerate(zip(accums, hist_a)):
        print(f"[resume] A step={i} accum={k} loss={loss:.6f} "
              f"grad_norm={gn:.4f} {times_a[i]:.3f}s"
              + (f" (with the step_{i + 1} save's fetch)"
                 if (i + 1) % every == 0 else ""))
    for i, (loss, gn) in enumerate(hist_b):
        print(f"[resume] B step={every + i} loss={loss:.6f} "
              f"grad_norm={gn:.4f} {times_b[i]:.3f}s")
    for name, s in zip(("step_3", "step_6"), saves):
        print(f"[resume] save {name}: {s['bytes'] / 1e9:.2f}GB fetch "
              f"{s['fetch_s']:.2f}s ({s['bytes'] / s['fetch_s'] / 1e9:.2f}"
              f"GB/s) write {s['write_s']:.2f}s "
              f"({s['bytes'] / s['write_s'] / 1e9:.2f}GB/s, background)")
    print(f"[resume] restore latest={latest}: {latest_s:.2f}s "
          f"({ck_bytes / latest_s / 1e9:.2f}GB/s), {n_latest} elements "
          f"apart from A's final state; restore step_{every}: "
          f"{restore_s:.2f}s ({ck_bytes / restore_s / 1e9:.2f}GB/s; the "
          f"load from disk to the card {load_s:.2f}s); stage carried "
          f"{stage}")
    print(f"[resume] warmup noise (keys and draws, {cfg.n_layers} layer(s) "
          f"of ({T}, {cfg.moe.n_experts})) per step: " + ", ".join(f"accum {k} {v:.3f}ms"
                                   for k, v in noise_ms.items())
          + f"; B's launches {launches_b}; [{card}]")
    failed = []
    if latest != f"step_{steps}" or n_latest:
        failed.append(f"restore('latest') gave {latest} with {n_latest} "
                      f"elements apart from A's final state")
    if stage != bw.accum_for(every):
        failed.append(f"accum stage {stage} != {bw.accum_for(every)}")
    if launches_a != step_launches(cfg, accums) or \
            launches_b != step_launches(cfg, accums[every:]):
        failed.append(f"launches A {launches_a} B {launches_b}, expected "
                      f"{step_launches(cfg, accums)} and "
                      f"{step_launches(cfg, accums[every:])}")
    if hist_b != hist_a[every:] or n_diff:
        failed.append(f"B parts from A: losses {hist_b} vs "
                      f"{hist_a[every:]}, {n_diff} state elements")
        # tell the step apart from the resume: two uninterrupted runs
        runs = []
        for _ in range(2):
            c = make(ckpt_dir=False)
            try:
                run(c)
            finally:
                c.close()
            runs.append([t.detach().clone() for t in state(c)])
            del c
        print(f"[resume] two uninterrupted runs differ in "
              f"{ndiff(*runs)} state elements")
    if failed:
        fail("phase 8b: " + "; ".join(failed))
    return {"a": launches_a, "b": launches_b}


# ---------------------------------------------------------------------------
# phase 8c: EDiT local SGD on Ling-Lite
# ---------------------------------------------------------------------------

# phase 8c's bars on each sync against the port's `edit_sync` on CPU
# copies of the same trees: the norms (and the averaged norm) 1e-5
# relative, params and outer momentum 1e-6 of each leaf's largest
# magnitude (fp32 summation order: the card's reductions against the
# CPU's)
EDIT_NORM_TOL, EDIT_TREE_TOL = 1e-5, 1e-6


def train_edit(card):
    """Two EDiT workers (`core.edit.EDiTTrainer` over the launcher's
    worker step) on Ling-Lite at full width, depth cut to 1 layer: 2
    rounds of 4 local steps a worker, each sync checked against
    `edit_sync` on CPU copies of its inputs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import api, roofline
    from repro_torch.configs.base import get_config
    from repro_torch.core import edit as E
    from repro_torch.core import spikes as spikes_lib
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.kernels import build
    from repro_torch.launch.train import edit_worker_step
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config("ling-lite"), n_layers=1)
    K, H, rounds, B, S = 2, 4, 2, 2, 1024
    torch.cuda.reset_peak_memory_stats()
    runner = api.Runner(cfg, device="cuda")
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=S, batch_size=B, seed=0))
    step = edit_worker_step(runner, spikes_lib.SpikeConfig())
    step_events = []

    def timed_step(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(*a)
        e1.record()
        step_events.append((e0, e1))
        return out

    syncs = []
    real_sync = E.edit_sync

    def checked_sync(base, workers, ema, outer_m, ecfg):
        """The card's sync, timed, then the same sync on CPU copies."""
        to_cpu = lambda tree: E.tree_map(lambda t: t.detach().cpu(), tree)
        host = (to_cpu(base), [to_cpu(w) for w in workers], to_cpu(ema),
                to_cpu(outer_m))
        n_bytes = sum(nbytes(*adamw.leaves(t)) for t in
                      [base, outer_m] + list(workers))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = real_sync(base, workers, ema, outer_m, ecfg)
        e1.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = real_sync(*host, ecfg)
        cpu_s = time.perf_counter() - t0
        got_info, want_info = out[3], want[3]
        rel = {k: float(((got_info[k].cpu() - want_info[k]).abs()
                         / want_info[k].abs().clamp(min=1e-30)).max())
               for k in ("pg_norms", "pg_avg_norm", "weights")}
        tree_err = 0.0
        for got_t, want_t in ((out[0], want[0]), (out[2], want[2])):
            for g, w in zip(adamw.leaves(got_t), adamw.leaves(want_t)):
                scale = float(w.float().abs().max())
                tree_err = max(tree_err, float(
                    (g.cpu().float() - w.float()).abs().max())
                    / max(scale, 1e-30))
        # bytes: base, K workers, momentum read; params, momentum written
        out_bytes = n_bytes + sum(nbytes(*adamw.leaves(t))
                                  for t in (out[0], out[2]))
        syncs.append({"ms": e0.elapsed_time(e1), "cpu_s": cpu_s,
                      "bound_ms": roofline.bound_ms(
                          roofline.Cost({}, out_bytes))[0], "rel": rel,
                      "tree_err": tree_err,
                      "kept": got_info["kept"].cpu().tolist(),
                      "count": int(out[1]["count"])})
        return out

    t0 = time.perf_counter()
    params = runner.init_train_params(0)
    n_par = sum(t.numel() for t in adamw.leaves(params))
    edit = E.EDiTTrainer(params, timed_step, E.EDiTConfig(sync_every=H), K)
    del params
    torch.cuda.synchronize()
    print(f"[edit] ling-lite d={cfg.d_model} layers=1 (of 28): "
          f"{n_par / 1e9:.3f}B params, fp32 masters; {K} workers, "
          f"sync_every={H}, {rounds} rounds; seq={S} microbatch={B} "
          f"accum=1; init {time.perf_counter() - t0:.1f}s")
    build.reset_launches()
    E.edit_sync = checked_sync
    recs, round_s = [], []
    try:
        for _ in range(rounds):
            batches = [[pipe.next_macrobatch(1) for _ in range(H)]
                       for _ in range(K)]
            t0 = time.perf_counter()
            recs.append(edit.round(batches, lr=1e-3))
            round_s.append(time.perf_counter() - t0)
    finally:
        E.edit_sync = real_sync
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(a.elapsed_time(b) for a, b in step_events)
    want = step_launches(cfg, [1] * (K * H * rounds))
    for r, rec in enumerate(recs):
        print(f"[edit] round={r} {rec} host {round_s[r]:.2f}s (with the "
              f"CPU check)")
    for i, sy in enumerate(syncs):
        print(f"[edit] sync {i}: card {sy['ms']:.2f}ms against a bytes "
              f"bound of {sy['bound_ms']:.2f}ms (share "
              f"{sy['bound_ms'] / sy['ms']:.1%}); CPU sync {sy['cpu_s']:.1f}s;"
              f" vs CPU: norms {sy['rel']} (bar {EDIT_NORM_TOL:.0e}), "
              f"params/momentum {sy['tree_err']:.3e} of each leaf's largest "
              f"(bar {EDIT_TREE_TOL:.0e}); kept {sy['kept']}")
    print(f"[edit] local step (CUDA events) median "
          f"{step_ms[len(step_ms) // 2]:.2f}ms, min {step_ms[0]:.2f}ms, "
          f"max {step_ms[-1]:.2f}ms over {len(step_ms)} steps; "
          f"{B * S / step_ms[len(step_ms) // 2] * 1e3:.0f} tokens/s a "
          f"worker; peak max_memory_allocated {peak / 1e9:.2f}GB; launches "
          f"{launches} expected {want} [{card}]")
    failed = []
    if len(step_events) != K * H * rounds:
        failed.append(f"{len(step_events)} local steps, expected "
                      f"{K * H * rounds}")
    if not all(np.isfinite(r["mean_loss"]) and np.isfinite(r["pg_avg_norm"])
               for r in recs):
        failed.append(f"records not finite: {recs}")
    if len(syncs) != rounds or any(
            max(sy["rel"].values()) > EDIT_NORM_TOL
            or sy["tree_err"] > EDIT_TREE_TOL for sy in syncs):
        failed.append(f"the card's syncs part from the CPU's: {syncs}")
    if launches != want:
        failed.append(f"launches {launches} != {want}")
    if not peak < 80e9:
        failed.append(f"peak memory {peak / 1e9:.2f} GB >= 80 GB")
    if failed:
        fail("phase 8c: " + "; ".join(failed))
    del edit
    return launches


# ---------------------------------------------------------------------------
# phase 8d: rwkv6 training
# ---------------------------------------------------------------------------

# phase 8d's bar on the chunked WKV6 form against the scan at T=128,
# fp32 compute, through 4 full-width layers: the loss 1e-5 relative,
# each gradient leaf 1e-4 of its largest magnitude (fp32 summation
# order compounding through the layers: 7.2e-6 on a CPU)
RWKV_FORM_LOSS_TOL, RWKV_FORM_GRAD_TOL = 1e-5, 1e-4


def train_rwkv(card):
    """rwkv6-3b at full width cut to 4 layers trained by the port's
    Trainer on the chunked WKV6 form (no kernel: K6 and the decay kernel
    have no backward); the chunked form against the scan at T=128; the
    two wrappers' refusal of autograd."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=4)
    B, S, accum, steps, chunk = 2, 1024, 2, 4, 64
    failed = []

    # the wrappers raise on operands that require grad
    gen = torch.Generator(device="cuda").manual_seed(8)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    rkv = [torch.randn((1, 8, H, hd), device="cuda", generator=gen)
           for _ in range(3)]
    w = torch.rand((1, 8, H, hd), device="cuda", generator=gen)
    u = torch.randn((H, hd), device="cuda", generator=gen)
    s0 = torch.zeros((1, H, hd, hd), device="cuda")
    x = torch.randn((8, cfg.d_model), device="cuda", generator=gen)
    la = torch.randn((cfg.d_model, 32), device="cuda", generator=gen)
    lb = torch.randn((32, cfg.d_model), device="cuda", generator=gen)
    w0 = torch.zeros((cfg.d_model,), device="cuda")
    refused = []
    for name, call in (
            ("wkv6", lambda: kops.wkv6(rkv[0].requires_grad_(), *rkv[1:],
                                       w, u, s0)),
            ("rwkv_decay", lambda: kops.rwkv_decay(
                x, la.requires_grad_(), lb, w0))):
        build.reset_launches()
        try:
            call()
        except RuntimeError as e:
            refused.append(name)
            print(f"[rwkv-train] {name} on tensors that require grad: "
                  f"refused ({e})")
        if sum(build.LAUNCHES.values()):
            failed.append(f"{name} launched under autograd")
    if refused != ["wkv6", "rwkv_decay"]:
        failed.append(f"wrappers refused autograd: {refused}")
    del rkv, w, u, s0, x, la, lb, w0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = api.Runner(cfg, flags=M.RunFlags(rwkv_chunk=chunk),
                        device="cuda")
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=S, batch_size=B, seed=0))
    trainer = Trainer(runner, pipe, TrainConfig(
        n_steps=steps, accum_steps=accum, log_every=1, seed=0,
        debug_guards=True))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in adamw.leaves(trainer.params))
    print(f"[rwkv-train] rwkv6-3b d={cfg.d_model} layers={cfg.n_layers} "
          f"(of 32) heads={H}x{hd} vocab={cfg.vocab_size}: "
          f"{n_par / 1e9:.3f}B params, fp32 masters, init "
          f"{time.perf_counter() - t0:.1f}s; seq={S} microbatch={B} "
          f"accum={accum} rwkv_chunk={chunk} remat=True")
    build.reset_launches()
    times = []
    try:
        for k in range(1, steps + 1):
            t0 = time.perf_counter()
            trainer.train(k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        trainer.close()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    step_s = sum(times[-2:]) / 2
    dev = trainer.timer.stats["device/step"].durations
    dev_ms = sum(list(dev)[-2:]) / 2e3
    for r in hist:
        print(f"[rwkv-train] step={r['step']} loss={r['loss']:.4f} "
              f"grad_norm={r['grad_norm']:.3f} lr={r['lr']:.2e} "
              f"skipped={r['skipped']}")
    print(f"[rwkv-train] step times {[round(t, 3) for t in times]}s; median "
          f"of the last 2 {step_s:.3f}s (device time {dev_ms:.1f}ms); "
          f"{B * S * accum / step_s:.0f} tokens/s; peak max_memory_allocated "
          f"{peak / 1e9:.2f}GB; launches {launches} [{card}]")
    if len(hist) != steps or not all(np.isfinite(r["loss"]) for r in hist):
        failed.append(f"losses {[r['loss'] for r in hist]}")
    if sum(launches.values()):
        failed.append(f"a kernel launched in a train step: {launches}")
    if not peak < 80e9:
        failed.append(f"peak memory {peak / 1e9:.2f} GB >= 80 GB")

    # the chunked form against the scan, T=128, fp32 compute
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = trainer.params
    del trainer
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 128), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[0], "labels": toks[1]}
    res = {}
    for c in (0, chunk):
        for p in adamw.leaves(params):
            p.requires_grad_(True)
            p.grad = None
        t0 = time.perf_counter()
        loss, _ = M.loss_fn(cfg32, params, batch,
                            flags=M.RunFlags(rwkv_chunk=c))
        loss.backward()
        torch.cuda.synchronize()
        res[c] = (float(loss.detach()),
                  [p.grad for p in adamw.leaves(params)],
                  time.perf_counter() - t0)
        for p in adamw.leaves(params):
            p.grad = None
    loss_rel = abs(res[chunk][0] - res[0][0]) / abs(res[0][0])
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp(
        min=1e-30)) for a, b in zip(res[chunk][1], res[0][1]))
    print(f"[rwkv-train] T=128 fp32, chunked (chunk {chunk}) vs scan: loss "
          f"{res[chunk][0]:.6f} vs {res[0][0]:.6f} (rel {loss_rel:.2e}, bar "
          f"{RWKV_FORM_LOSS_TOL:.0e}); grads {grad_rel:.2e} of each leaf's "
          f"largest (bar {RWKV_FORM_GRAD_TOL:.0e}); forward+backward "
          f"{res[chunk][2]:.2f}s chunked, {res[0][2]:.2f}s scan (host clock)")
    if not (loss_rel <= RWKV_FORM_LOSS_TOL and grad_rel <= RWKV_FORM_GRAD_TOL):
        failed.append(f"chunked vs scan: loss {loss_rel:.3e}, grads "
                      f"{grad_rel:.3e}")
    del params, res
    if failed:
        fail("phase 8d: " + "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 8e: the block families trained
# ---------------------------------------------------------------------------

def train_families(card):
    """FAMILY_TRAIN's models at full width (danube cut to 4 layers,
    recurrentgemma to one (rglru, rglru, swa) period of 3, whisper
    whole), fp32 masters from torch.Generator(device="cuda")
    .manual_seed(0), 4 optimizer steps each (seq 1024, microbatch 2,
    accum 1, remat, spike guard) with every step's dispatch under the
    debug sync guard: danube and recurrentgemma through the port's
    Trainer, whisper (whose batches carry 1504 encoder frames the
    launcher's pipeline does not make) through `make_train_step` on
    batches from numpy seed 0.  Finite losses, no kernel launched (a
    dense model's train step has none), peak memory under 80 GB; step
    time and tokens/s printed.  Returns {arch: launches}."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.analysis import contracts
    from repro_torch.configs.base import cut_depth, get_config
    from repro_torch.core import spikes as spikes_lib
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.kernels import build
    from repro_torch.models import prng
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import TrainConfig, Trainer
    B, S, steps = 2, 1024, 4
    out, failed = {}, []
    for arch, depth in FAMILY_TRAIN:
        cfg = cut_depth(get_config(arch), depth)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = api.Runner(cfg, device="cuda")
        times, losses = [], []
        build.reset_launches()
        if cfg.is_encoder_decoder:
            spike = spikes_lib.SpikeConfig()
            params = runner.init_train_params(0)
            opt = adamw.init_opt_state(params)
            guard = spikes_lib.init_guard_state(spike, "cuda")
            step = runner.make_train_step(spike_guard=spike)
            rs = np.random.RandomState(0)
            batches, keys = [], []
            for k in range(1, steps + 1):
                t = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                                (B, S + 1))).cuda()
                f = torch.from_numpy(rs.randn(
                    B, cfg.encoder_seq_len, cfg.d_model).astype(np.float32))
                batches.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                                "enc_frames": f.cuda()})
                keys.append(prng.fold_in(prng.prng_key(0, "cuda"), k))
            torch.cuda.synchronize()
            n_par = sum(t.numel() for t in adamw.leaves(params))
            build.reset_launches()
            for k in range(steps):
                t0s = time.perf_counter()
                with contracts.transfer_guard("disallow"):
                    params, opt, guard, mets = step(params, opt, guard,
                                                    batches[k], k + 1,
                                                    keys[k], 1e-4)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0s)
                losses.append(mets["loss"])
            losses = [float(v) for v in losses]
            del params, opt, guard, batches
        else:
            pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                               seq_len=S, batch_size=B,
                                               seed=0))
            trainer = Trainer(runner, pipe, TrainConfig(
                n_steps=steps, accum_steps=1, log_every=1, seed=0,
                debug_guards=True))
            torch.cuda.synchronize()
            n_par = sum(t.numel() for t in adamw.leaves(trainer.params))
            build.reset_launches()
            try:
                for k in range(1, steps + 1):
                    t0s = time.perf_counter()
                    trainer.train(k)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0s)
            finally:
                trainer.close()
            losses = [r["loss"] for r in trainer.history]
            del trainer
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        step_s = sum(times[-2:]) / 2
        print(f"[families-train] {arch}: {cfg.n_layers} of "
              f"{get_config(arch).n_layers} layers, d={cfg.d_model}: "
              f"{n_par / 1e9:.3f}B params, fp32 masters; seq={S} "
              f"microbatch={B} accum=1 remat=True, debug guards on; losses "
              f"{[round(v, 4) for v in losses]}; step times "
              f"{[round(t, 3) for t in times]}s, the last 2's mean "
              f"{step_s:.3f}s ({B * S / step_s:.0f} tokens/s); peak "
              f"max_memory_allocated {peak / 1e9:.2f}GB; init and steps "
              f"{time.perf_counter() - t0:.1f}s [{card}]")
        if len(losses) != steps or not all(np.isfinite(v) for v in losses):
            failed.append(f"{arch} losses {losses}")
        if sum(launches.values()):
            failed.append(f"{arch}: a kernel launched in a train step: "
                          f"{launches}")
        if not peak < 80e9:
            failed.append(f"{arch} peak memory {peak / 1e9:.2f} GB >= 80 GB")
        del runner
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = launches
    if failed:
        fail("phase 8e: " + "; ".join(failed))
    return out


E2E_CHUNK, E2E_STEPS = 64, 8     # the teacher-forced request's shape


def teacher_forced(cfg, params, tokens, flags, env=None, steps=E2E_STEPS):
    """Logits (1 + steps, Vp) of one request teacher-forced through the
    paged serving steps with `flags`: a prefill chunk of the first
    E2E_CHUNK tokens, then a decode tick per following token (slot 0 of
    8 active, pages of 16, a 512-position table).  Over a tp mesh (`env`)
    the pools hold the rank's in-page offsets and each step's vocab
    shards are gathered over tp."""
    import torch
    from repro_torch import sharding
    from repro_torch.models import model as M
    env = env or sharding.LOCAL
    dev = tokens.device
    B, C, ps, n_lp = 8, E2E_CHUNK, 16, 32
    table = torch.zeros((B, n_lp), dtype=torch.int32, device=dev)
    table[0, :(C + steps + ps - 1) // ps] = torch.arange(
        1, 1 + (C + steps + ps - 1) // ps, dtype=torch.int32, device=dev)
    active = torch.zeros((B,), dtype=torch.bool, device=dev)
    active[0] = True
    pools = M.init_paged_caches(cfg, 1 + n_lp, ps, dev, env)
    out = []
    with torch.no_grad():
        lg, _ = M._paged_prefill_logits(cfg, params, pools, tokens[:C], 0,
                                        C, table[0], page_size=ps,
                                        flags=flags, env=env)
        out.append(env.all_gather_tp(lg, axis=1)[0])
        for i in range(steps):
            tok = torch.zeros((B,), dtype=torch.long, device=dev)
            tok[0] = tokens[C + i]
            pos = torch.zeros((B,), dtype=torch.long, device=dev)
            pos[0] = C + i
            lg, _ = M._paged_decode_logits(cfg, params, pools, tok, pos,
                                           table, active, page_size=ps,
                                           flags=flags, env=env)
            out.append(env.all_gather_tp(lg, axis=1)[0])
    return torch.stack(out)


def end_to_end(cfg, params, gen, plain_head: bool = False,
               witness: bool = False, tag: str = "e2e"):
    """Teacher-force one request through the kernels and through the
    plain modes (with `plain_head`, the plain K5 too); compare the logits
    of every step, within 2^-5 of the largest.  With `witness` the bar is
    the larger of that and twice the rounding floor: how far the plain
    modes' logits lie from a second run that launches no kernel either,
    the kernels' path with every kernel swapped for its plain version
    (`plain_kernels`).  If the kernels are right, their path and that
    witness are one computation in two roundings, no farther apart than
    the two plain runs (which differ in more: bf16 against fp32 MoE
    hidden and combine, another attention), so the kernels' gap to the
    plain modes is at most their gap to the witness plus the witness's
    gap to the plain modes: twice the floor.  A kernel fault adds to the
    gap and nothing to the floor."""
    import torch
    from repro_torch.models import model as M
    steps = E2E_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (E2E_CHUNK + steps,),
                           generator=gen, device="cuda")

    def run(flags):
        return teacher_forced(cfg, params, tokens, flags)

    from repro_torch.kernels import build
    build.reset_launches()
    fused = run(M.RunFlags())
    torch.cuda.synchronize()
    n_k5 = build.LAUNCHES["normhead_matmul"]
    if n_k5 != (1 + steps) * cfg.norm_head:
        fail(f"end to end: normhead_matmul launched {n_k5} times, expected "
             f"{1 + steps} (one per chunk and per step)")
    with (plain_k5_k6() if plain_head else contextlib.nullcontext()):
        plain = run(M.RunFlags(moe_dispatch="ragged", paged_attn="gathered"))
    err = (fused - plain).abs().max().item()
    # "ragged" rounds the expert hidden and its scatter-add to bf16 where
    # K1 keeps fp32; over 28 layers that is bf16-level drift in the
    # residual stream, so the logits are held to 2^-5 of their largest
    tol = 2.0 ** -5 * plain.abs().max().item()
    floor_msg = ""
    if witness:
        # at random weights a wide model (Ling-Plus: d 8192, attention
        # and router logits twice Ling-Lite's spread) turns one bf16 ulp
        # flipped in a layer's output into percents of the logits, so two
        # plain runs in other roundings lie that far apart too
        with plain_kernels():
            other = run(M.RunFlags())
        big = plain.abs().max().item()
        flo = (other - plain).abs().max().item()
        mid = (fused - other).abs().max().item()
        tol = max(tol, 2 * flo)
        floor_msg = (f"; rounding floor (the plain witness against the "
                     f"plain modes) {flo:.4e} = {flo / big:.4f} of the "
                     f"largest logit, kernels against the witness "
                     f"{mid:.4e} = {mid / big:.4f}, gap / floor "
                     f"{err / max(flo, 1e-30):.3f}; the bar max(2^-5 of "
                     f"the largest, twice the floor)")
    agree = (fused.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"[{tag}] 1 prefill chunk + {steps} decode steps: logits "
          f"max_abs_err={err:.4e} = {err / plain.abs().max().item():.4f} of "
          f"the largest (tolerance {tol:.4e}) greedy agreement="
          f"{agree:.3f}; normhead_matmul launches {n_k5}{floor_msg}")
    if not err <= tol:
        fail(f"end-to-end logits ({cfg.arch_id}): {err} > {tol}")
    return err, agree


# ---------------------------------------------------------------------------
# phase 9: Ling-Lite on a mesh of torch.distributed ranks
# ---------------------------------------------------------------------------

MESH_TIMEOUT_S = 600.0     # every process group's and every join's limit
MESH_PROMPTS, MESH_TICKS, MESH_STEPS = 8, 32, 2
# phase 9b's prompts: phase 5's cut to one 64-token chunk each (as phase
# 6c cuts them): two ranks on one card exchange every collective through
# gloo, ~2 ms a call (phase 9b's counters print it), ~7 calls a layer and
# step
MESH_PROMPT_LEN = 64
# phase 9b's training bars against the (1, 1) run: (loss, grad norm)
# relative; (1, 2) at the reference's own cross-mesh bound
# (tests/test_sharded_parity.py: 5e-2)
MESH_TRAIN_TOL = {"2x1": (1e-3, 1e-2), "1x2": (5e-2, 5e-2)}
# phase 9b's steps take one microbatch (phase 8's accum 2 would double the
# ~12 GB of FSDP gathers and gradient reduce-scatters a microbatch that
# two ranks on one card exchange through gloo, well under 1 GB/s: phase
# 9b's counters print it); phase 9a takes the same steps at (1, 1) as
# their reference
MESH_ACCUM = 1


def _spawn(fn, world: int, *args):
    """fn(rank, world, tmp, *args) in `world` spawned processes that meet
    at a file store in a fresh temporary directory (removed after); each
    returns a picklable result.  Fails the phase if a rank raises, exits
    non-zero or outlives MESH_TIMEOUT_S (it is killed then)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_run, args=(fn, r, world, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.time() + MESH_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, end - time.time()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            fail(f"{fn.__name__}: ranks {hung} outlived {MESH_TIMEOUT_S}s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            fail(f"{fn.__name__}: ranks exited with {bad}")
        out = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
    return out


def _rank_run(fn, rank, world, tmp, args):
    """A spawned rank: the one card, fp32 products in fp32, the kernels
    the parent built (loaded, never rebuilt), fn's result pickled."""
    import torch
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = fn(rank, world, tmp, *args)
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _serve_prompts(runner, params, prompts, max_new: int,
                   debug_guards: bool):
    """The prompts submitted at once to an OnlineEngine of phase 5's
    geometry (8 slots, context 512, page 16, chunk 64), greedy: (streams,
    step calls, wall seconds, the tick p50 in ms)."""
    import numpy as np
    import torch
    from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                            OnlineRequest)
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=8, max_context=512, page_size=16, prefill_chunk=64,
        debug_guards=debug_guards))
    eng.submit_many([OnlineRequest(rid=i, prompt=np.asarray(p, np.int32),
                                   max_new=max_new)
                     for i, p in enumerate(prompts)])
    t0 = time.perf_counter()
    eng.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [list(eng.reqs[i].out) for i in range(len(prompts))]
    return (streams, dict(eng.step_calls), wall,
            eng.registry.get("serve_tick_ms").percentile(50))


@contextlib.contextmanager
def count_drops():
    """Counts the "ep" dispatch's routed slots and the ones it kept (each
    call of `moe._ep_moe_ffn`) into the yielded dict, read on exit."""
    from repro_torch.core import moe
    orig, calls = moe._ep_moe_ffn, []

    def counted(*a, **k):
        out = orig(*a, **k)
        calls.append((out[2], out[3]))
        return out
    box = {}
    moe._ep_moe_ffn = counted
    try:
        yield box
    finally:
        moe._ep_moe_ffn = orig
        box["slots"] = sum(n for _, n in calls)
        box["dropped"] = box["slots"] - sum(int(k) for k, _ in calls)


@contextlib.contextmanager
def plain_moe_head():
    """The plain modes of the mesh's serving path (the "ep" dispatch is
    its one MoE mode): K1's and K5's plain versions on CUDA tensors,
    beside paged_attn="gathered"; no launch counted."""
    from repro_torch.kernels import grouped_matmul as gm
    saved = gm.fused_moe_ffn
    gm.fused_moe_ffn = gm.fused_moe_ffn_ref
    try:
        with plain_k5_k6():
            yield
    finally:
        gm.fused_moe_ffn = saved


def _nccl_rank(rank, world, tmp, prompts):
    """Phase 9a's one rank: NCCL at world size 1, the process group code
    on Ling-Lite's serving (phase 5's prompts) and phase 8's step."""
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as tmesh
    tmesh.init_distributed(rank, world, init_method=f"file://{tmp}/store",
                           backend="nccl", timeout_s=MESH_TIMEOUT_S)
    mesh = tmesh.make_local_mesh(1, 1, device="cuda:0",
                                 timeout_s=MESH_TIMEOUT_S)
    print(f"[mesh-9a] {mesh.describe()}; world "
          f"{torch.distributed.get_world_size()} over "
          f"{torch.distributed.get_backend()}", flush=True)
    runner = api.Runner(get_config("ling-lite"), device="cuda", mesh=mesh)
    params = runner.init_params(0)
    build.reset_launches()
    streams, calls, wall, tick = _serve_prompts(runner, params, prompts, 32,
                                                debug_guards=True)
    out = {"streams": streams, "calls": calls, "serve_s": wall,
           "tick_ms": tick, "serve_launches": dict(build.LAUNCHES)}
    del params, runner
    gc.collect()
    torch.cuda.empty_cache()
    build.reset_launches()
    trainer, _, _ = train_setup(MESH_STEPS, mesh=mesh)
    try:
        trainer.train(MESH_STEPS)
    finally:
        trainer.close()
    out["hist"] = [(r["loss"], r["grad_norm"]) for r in trainer.history]
    out["train_launches"] = dict(build.LAUNCHES)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    trainer, _, _ = train_setup(MESH_STEPS, mesh=mesh, accum=MESH_ACCUM)
    try:
        trainer.train(MESH_STEPS)
    finally:
        trainer.close()
    out["hist_9b"] = [{k: r[k] for k in ("loss", "grad_norm")}
                      for r in trainer.history]
    torch.distributed.destroy_process_group()
    return out


def _gloo_rank(rank, world, tmp, prompts, tf_tokens):
    """Phase 9b's rank: two of them over gloo on the one card.  Serving on
    (1, 2) at full depth (the prompts, prefill and MESH_TICKS greedy
    ticks; one request teacher-forced through the kernels, the plain
    modes and the fp64-attention witness), then phase 8's step at (1, 2),
    at (2, 1), and (2, 1)'s first step again."""
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    tmesh.init_distributed(rank, world, init_method=f"file://{tmp}/store",
                           backend="gloo", timeout_s=MESH_TIMEOUT_S)
    mesh = tmesh.make_local_mesh(1, 2, device="cuda:0",
                                 timeout_s=MESH_TIMEOUT_S)
    cfg = get_config("ling-lite")
    t0 = time.perf_counter()
    runner = api.Runner(cfg, device=mesh.device, mesh=mesh)
    params = runner.init_params(0)
    torch.cuda.synchronize()
    out = {"describe": mesh.describe(), "init_s": time.perf_counter() - t0}
    build.reset_launches()
    streams, calls, wall, tick = _serve_prompts(
        runner, params, prompts, MESH_TICKS + 1, debug_guards=False)
    out.update(streams=streams, calls=calls, serve_s=wall, tick_ms=tick,
               serve_stats={k: dict(v) for k, v in mesh.stats.items()},
               serve_launches=dict(build.LAUNCHES),
               serve_peak=torch.cuda.max_memory_allocated())
    tf = torch.as_tensor(tf_tokens, device=mesh.device)
    with count_drops() as drops:
        fused = teacher_forced(cfg, params, tf, M.RunFlags(), runner.env)
    with plain_moe_head():
        plain = teacher_forced(cfg, params, tf,
                               M.RunFlags(paged_attn="gathered"), runner.env)
        with fp64_attention():
            other = teacher_forced(cfg, params, tf, M.RunFlags(),
                                   runner.env)
    out.update(fused=fused.cpu(), plain=plain.cpu(), other=other.cpu(),
               drops=drops)
    del params, runner, fused, plain, other
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = {}
    keep = None
    # (2, 1) runs MESH_STEPS steps, then its first step again: ~24 GB of
    # FSDP gathers and gradient reduce-scatters a step go through gloo
    for label, shape, n_steps in (("1x2", (1, 2), MESH_STEPS),
                                  ("2x1", (2, 1), MESH_STEPS),
                                  ("2x1 again", (2, 1), 1)):
        m = tmesh.make_local_mesh(*shape, device="cuda:0",
                                  timeout_s=MESH_TIMEOUT_S)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        trainer, _, _ = train_setup(n_steps, mesh=m, debug_guards=False,
                                    accum=MESH_ACCUM)
        times = []
        try:
            for k in range(1, n_steps + 1):
                before = {op: dict(v) for op, v in m.stats.items()}
                t1 = time.perf_counter()
                trainer.train(k)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                if label == "2x1" and k == 1:
                    keep = [t.detach().clone()
                            for t in adamw.leaves(trainer.params)]
        finally:
            trainer.close()
        rec = {"hist": [(r["loss"], r["grad_norm"], r["moe/dropped_frac"])
                        for r in trainer.history],
               "times": times,
               "stats": {k: dict(v) for k, v in m.stats.items()},
               # the last step's collectives (phase 10c)
               "step_stats": {op: {n: v[n] - before.get(op, {}).get(n, 0)
                                   for n in ("calls", "bytes")}
                              for op, v in m.stats.items()
                              if v["calls"] > before.get(op, {})
                              .get("calls", 0)},
               "launches": dict(build.LAUNCHES),
               "peak": torch.cuda.max_memory_allocated(),
               "describe": m.describe()}
        if label == "2x1 again":
            rec["same_params"] = all(
                torch.equal(a, b)
                for a, b in zip(keep, adamw.leaves(trainer.params)))
            keep = None
        out["train"][label] = rec
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    # phases 9d and 9e on the same two ranks
    out["archs"] = _archs_rank(mesh, prompts)
    out["families"] = _families_rank(mesh, prompts)
    torch.distributed.destroy_process_group()
    return out


# phase 9d, inside 9b's two ranks: granite whole and rwkv6-3b whole on
# (1, 2), MESH_ARCHS_TICKS greedy ticks after one 64-token chunk of the
# first MESH_ARCHS_PROMPTS of 9b's prompts (phase 5's, their ids folded
# into each vocabulary; rwkv6 prefills all 8 in one call), granite's
# teacher-forced request a chunk and MESH_ARCHS_TF_STEPS ticks.  Each
# granite step is 1-2 s of gloo collectives: at 8 prompts, 4 ticks and
# 8 steps 9d took 47.2 s of a script that took 1186.2 s of its 1200 on
# a slow host, at 8, 2 and 2 41.1 s of 1164.1 s (NVIDIA H100 80GB HBM3,
# 700.00 W)
MESH_ARCHS_PROMPTS, MESH_ARCHS_TICKS, MESH_ARCHS_TF_STEPS = 4, 2, 2
MESH_ARCHS = (("granite-moe-3b-a800m", "paged"), ("rwkv6-3b", "dense"))


def _archs_rank(mesh, prompts):
    """Phase 9d on one of 9b's ranks, on its (1, 2) mesh.  granite
    (32 layers, 40 experts over the "ep" exchange, 24 heads over 8 kv
    heads, its 49155-row vocabulary padded to 24704 rows a rank) through
    an OnlineEngine of phase 5's geometry, then one request teacher-forced
    through the kernels, the plain modes and the fp64-attention witness
    (9b's three runs); rwkv6-3b (32 layers, 20 of its 40 heads a rank)
    through `make_prefill` and the dense decode step, then one prompt in
    fp32 activations through the kernels and through the plain K5/K6
    (phase 7's check), its prefill and every tick.  Returns each model's
    streams, step calls, launches (counts set to 0 just before each
    serve), logits and seconds."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    out = {}
    t0 = time.perf_counter()
    cfg = get_config("granite-moe-3b-a800m")
    runner = api.Runner(cfg, device=mesh.device, mesh=mesh)
    params = runner.init_params(0)
    g_prompts = [list(np.asarray(p) % cfg.vocab_size)
                 for p in prompts[:MESH_ARCHS_PROMPTS]]
    build.reset_launches()
    streams, calls, wall, tick = _serve_prompts(
        runner, params, g_prompts, MESH_ARCHS_TICKS + 1, debug_guards=False)
    rec = {"streams": streams, "calls": calls, "serve_s": wall,
           "tick_ms": tick, "launches": dict(build.LAUNCHES)}
    tf = torch.randint(0, cfg.vocab_size, (E2E_CHUNK + MESH_ARCHS_TF_STEPS,),
                       generator=torch.Generator(device="cuda").manual_seed(9),
                       device="cuda")
    steps = MESH_ARCHS_TF_STEPS
    with count_drops() as drops:
        fused = teacher_forced(cfg, params, tf, M.RunFlags(), runner.env,
                               steps)
    with plain_moe_head():
        plain = teacher_forced(cfg, params, tf,
                               M.RunFlags(paged_attn="gathered"), runner.env,
                               steps)
        with fp64_attention():
            other = teacher_forced(cfg, params, tf, M.RunFlags(),
                                   runner.env, steps)
    rec.update(fused=fused.cpu(), plain=plain.cpu(), other=other.cpu(),
               drops=drops, seconds=time.perf_counter() - t0)
    out["granite-moe-3b-a800m"] = rec
    del params, runner, fused, plain, other
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = get_config("rwkv6-3b")
    runner = api.Runner(cfg, device=mesh.device, mesh=mesh)
    params = runner.init_params(0)
    toks = torch.as_tensor(np.stack([np.asarray(p) % cfg.vocab_size
                                     for p in prompts]), device="cuda")
    prefill, decode = runner.make_prefill(), runner.make_decode_step()
    build.reset_launches()
    tok, caches = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    after_prefill = dict(build.LAUNCHES)
    got = [tok]
    S = toks.shape[1]
    for pos in range(S, S + MESH_ARCHS_TICKS):
        tok, caches = decode(params, caches, tok, pos)
        got.append(tok)
    torch.cuda.synchronize()
    rec = {"streams": torch.stack(got, 1).tolist(),
           "after_prefill": after_prefill,
           "launches": dict(build.LAUNCHES)}
    del caches
    # one prompt in fp32 activations: the kernels against the plain K5/K6
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    one = toks[:1]

    def logits_run():
        with torch.no_grad():
            lg, c = M.prefill_logits(c32, params, {"tokens": one},
                                     env=runner.env)
            rows = [lg]
            for i in range(MESH_ARCHS_TICKS):
                lg, c = M.decode_logits(c32, params, c, one[:, i], S + i,
                                        env=runner.env)
                rows.append(lg)
        return torch.cat(rows).cpu()
    rec["fused"] = logits_run()
    with plain_k5_k6():
        rec["plain"] = logits_run()
    rec["seconds"] = time.perf_counter() - t0
    out["rwkv6-3b"] = rec
    del params, runner
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_archs(card, r0, r1):
    """Phase 9d's checks on 9b's two ranks' results (`_archs_rank`): both
    ranks' streams equal and in the vocabulary; granite's launches per
    step as phase 5's formula (K1, K3, K4 once per layer per chunk and
    tick, K5 once per chunk and tick) and its teacher-forced logits within
    phase 7b's bar, max(2^-5 of the largest, twice the fp64 witness's
    gap); rwkv6's K6 and decay kernel once per layer and K5 once per
    prefill and tick, its fp32 logits within RWKV_FP32_TOL["kernels vs
    plain"] of the plain K5/K6's on each rank's vocabulary shard.
    Returns the launches for the kernels line."""
    from repro_torch.configs.base import get_config
    a, b = r0["archs"], r1["archs"]
    g, gb = a["granite-moe-3b-a800m"], b["granite-moe-3b-a800m"]
    cfg = get_config("granite-moe-3b-a800m")
    n = g["calls"]["prefill"] + g["calls"]["decode"]
    want_k = cfg.n_layers * n
    print(f"[mesh-9d] granite on (1, 2), {cfg.n_layers} layers: step calls "
          f"{g['calls']}, wall {g['serve_s']:.2f}s, tick p50 "
          f"{g['tick_ms']:.2f}ms; launches {g['launches']} (expected "
          f"{want_k} of K1/K3/K4, {n} of K5) [{card}]")
    if g["streams"] != gb["streams"]:
        fail("phase 9d: granite's two ranks' streams differ")
    # greedy takes the argmax over the padded table's rows, as the
    # reference's `sharded_argmax` (ROADMAP queue 3, breakage d): a
    # token lies below the padded size, and the padding ids are counted
    vp = -(-cfg.vocab_size // (MESH_TP * 128)) * MESH_TP * 128
    flat = [t for s in g["streams"] for t in s]
    print(f"[mesh-9d] granite: {sum(t >= cfg.vocab_size for t in flat)} of "
          f"{len(flat)} greedy tokens are padding ids ({cfg.vocab_size} "
          f"of {vp} rows are the vocabulary)")
    if any(len(s) != MESH_ARCHS_TICKS + 1 for s in g["streams"]) or not all(
            0 <= t < vp for t in flat):
        fail(f"phase 9d: granite streams {g['streams']}")
    for name, got in g["launches"].items():
        want = (want_k if name in SERVE_KERNELS else
                n if name == "normhead_matmul" else 0)
        if got != want:
            fail(f"phase 9d: granite {name} launched {got} times, expected "
                 f"{want}")
    fused, plain, other = g["fused"], g["plain"], g["other"]
    big = plain.abs().max().item()
    err = (fused - plain).abs().max().item()
    flo = (other - plain).abs().max().item()
    tol = max(2.0 ** -5 * big, 2 * flo)
    d = g["drops"]
    print(f"[mesh-9d] granite teacher-forced (1 chunk + "
          f"{MESH_ARCHS_TF_STEPS} ticks): "
          f"kernels vs plain modes {err:.4e} = {err / big:.4f} of the "
          f"largest (bar {tol:.4e}: rounding floor {flo:.4e}); "
          f"{d['dropped']} of {d['slots']} routed slots dropped; "
          f"{g['seconds']:.1f}s")
    if not err <= tol:
        fail(f"phase 9d: granite kernels vs plain logits {err} > {tol}")

    w, wb = a["rwkv6-3b"], b["rwkv6-3b"]
    cfg = get_config("rwkv6-3b")
    steps = 1 + MESH_ARCHS_TICKS
    want_p = {k: 0 for k in w["launches"]}
    want_p.update(wkv6=cfg.n_layers, rwkv_decay=cfg.n_layers,
                  normhead_matmul=1)
    want_all = dict(want_p, wkv6=cfg.n_layers * steps,
                    rwkv_decay=cfg.n_layers * steps, normhead_matmul=steps)
    print(f"[mesh-9d] rwkv6-3b on (1, 2), {cfg.n_layers} layers, 20 of 40 "
          f"heads a rank: launches after the prefill {w['after_prefill']}, "
          f"after {MESH_ARCHS_TICKS} ticks {w['launches']} [{card}]")
    if w["streams"] != wb["streams"]:
        fail("phase 9d: rwkv6's two ranks' streams differ")
    if any(not all(0 <= t < cfg.vocab_size for t in s)
           for s in w["streams"]):
        fail(f"phase 9d: rwkv6 streams {w['streams']}")
    if w["after_prefill"] != want_p or w["launches"] != want_all:
        fail(f"phase 9d: rwkv6 launches {w['after_prefill']} / "
             f"{w['launches']}, expected {want_p} / {want_all}")
    for r, rec in enumerate((w, wb)):
        top = rec["plain"].abs().max().item()
        errk = (rec["fused"] - rec["plain"]).abs().max().item()
        tolk = RWKV_FP32_TOL["kernels vs plain"] * top
        print(f"[mesh-9d] rwkv6 rank {r}, fp32 activations, prefill + "
              f"{MESH_ARCHS_TICKS} ticks on its vocabulary shard: kernels "
              f"vs plain K5/K6 {errk:.4e} = {errk / top:.3e} of the largest "
              f"(tolerance {tolk:.4e})")
        if not errk <= tolk:
            fail(f"phase 9d: rwkv6 rank {r} kernels vs plain {errk} > "
                 f"{tolk}")
    print(f"[mesh-9d] rwkv6 {w['seconds']:.1f}s; phase 9d took "
          f"{g['seconds'] + w['seconds']:.1f}s of 9b's ranks")
    return {"mesh_granite": g["launches"], "mesh_rwkv6": w["launches"]}


# phase 9e, inside 9b's two ranks after 9d: the block families at full
# width on (1, 2), depth cut to (arch, layers kept; None: whole) so that
# 9e stays within ~20 s of gloo ticks beside 9b-9d, and each one's key
# in the kernels line's launches
MESH_FAMILIES = (("nemotron-4-15b", 2, "mesh_nemotron"),
                 ("h2o-danube-1.8b", 2, "mesh_danube"),
                 ("recurrentgemma-2b", 3, "mesh_recurrentgemma"),
                 ("whisper-tiny", None, "mesh_whisper"))
# the caches' positions (each rank holds half), the teacher-forced
# request's prompt, and recurrentgemma's long prompt across its wrap
MESH_FAMILY_SEQ, MESH_FAMILY_TF_PROMPT = 128, 64
MESH_FAMILY_LONG, MESH_FAMILY_LONG_SEQ, MESH_FAMILY_LONG_TICKS = (2040,
                                                                  2080, 12)


def _attention_layers(cfg) -> int:
    """K3/K4 launches a dense tick: one per self-attention layer, and one
    per cross attention of an encoder-decoder's decoder layer."""
    n = sum(cfg.block_kind(i) in ("attn", "swa") for i in range(cfg.n_layers))
    return n + (cfg.n_layers if cfg.is_encoder_decoder else 0)


def _families_rank(mesh, prompts):
    """Phase 9e on one of 9b's ranks, on its (1, 2) mesh: MESH_FAMILIES in
    turn at full width (bf16 weights from seed 0, each rank its shards:
    heads, ff, RG-LRU channels and vocabulary over tp), `make_prefill` of
    the first MESH_ARCHS_PROMPTS of 9b's prompts (ids folded into the
    vocabulary; whisper beside seeded frames, the same on both ranks)
    into caches of MESH_FAMILY_SEQ positions, MESH_ARCHS_TICKS greedy
    ticks (launch counts set to 0 just before the prefill), then one
    request teacher-forced (a MESH_FAMILY_TF_PROMPT-token prefill and
    MESH_ARCHS_TF_STEPS ticks) through the kernels, the plain modes
    (gathered attention, the plain K5) and the fp64-attention witness;
    for recurrentgemma also its MESH_FAMILY_LONG-token prompt
    teacher-forced MESH_FAMILY_LONG_TICKS ticks across the wrap of its
    rolling caches at 2048.  Returns each model's streams, launches,
    logits and seconds."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import cut_depth, get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    out = {}
    for arch, layers, _ in MESH_FAMILIES:
        t0 = time.perf_counter()
        cfg = cut_depth(get_config(arch), layers)
        runner = api.Runner(cfg, device=mesh.device, mesh=mesh)
        params = runner.init_params(0)
        toks = torch.as_tensor(
            np.stack([np.asarray(p) % cfg.vocab_size
                      for p in prompts[:MESH_ARCHS_PROMPTS]]), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(11)
        batch = {"tokens": toks}
        if cfg.is_encoder_decoder:
            batch["enc_frames"] = torch.randn(
                (toks.shape[0], cfg.encoder_seq_len, cfg.d_model),
                generator=gen, device="cuda").to(torch.bfloat16)
        prefill = runner.make_prefill(seq_len=MESH_FAMILY_SEQ)
        decode = runner.make_decode_step()
        build.reset_launches()
        tok, caches = prefill(params, batch)
        torch.cuda.synchronize()
        after_prefill = dict(build.LAUNCHES)
        got = [tok]
        S = toks.shape[1]
        t1 = time.perf_counter()
        for pos in range(S, S + MESH_ARCHS_TICKS):
            tok, caches = decode(params, caches, tok, pos)
            got.append(tok)
        torch.cuda.synchronize()
        rec = {"streams": torch.stack(got, 1).tolist(),
               "after_prefill": after_prefill,
               "launches": dict(build.LAUNCHES),
               "tick_ms": 1e3 * (time.perf_counter() - t1) / MESH_ARCHS_TICKS,
               "rows": sorted({c[k]["k"].shape[-3] for c in
                               (caches if isinstance(caches, list)
                                else [caches]) for k in ("self", "cross")
                               if k in c})}
        del caches
        # one request teacher-forced: the kernels, the plain modes, the
        # fp64-attention witness
        P = MESH_FAMILY_TF_PROMPT
        tf = torch.randint(0, cfg.vocab_size, (1, P + MESH_ARCHS_TF_STEPS),
                           generator=gen, device="cuda")
        one = {k: v[:1] for k, v in batch.items()}
        one["tokens"] = tf[:, :P]
        rest = tf[:, P:]

        def runs(one, rest, seq):
            kern = dense_teacher_forced(cfg, params, one, rest, seq,
                                        M.RunFlags(), runner.env)
            with plain_k5_k6():
                plain = dense_teacher_forced(
                    cfg, params, one, rest, seq,
                    M.RunFlags(paged_attn="gathered"), runner.env)
            with fp64_attention():
                other = dense_teacher_forced(cfg, params, one, rest, seq,
                                             M.RunFlags(), runner.env)
            return kern.cpu(), plain.cpu(), other.cpu()
        rec["tf"] = runs(one, rest, MESH_FAMILY_SEQ)
        if arch == "recurrentgemma-2b":
            long = torch.randint(
                0, cfg.vocab_size,
                (1, MESH_FAMILY_LONG + MESH_FAMILY_LONG_TICKS),
                generator=gen, device="cuda")
            rec["tf_long"] = runs({"tokens": long[:, :MESH_FAMILY_LONG]},
                                  long[:, MESH_FAMILY_LONG:],
                                  MESH_FAMILY_LONG_SEQ)
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        out[arch] = rec
        del params, runner
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_families(card, r0, r1):
    """Phase 9e's checks on 9b's two ranks' results (`_families_rank`):
    both ranks' streams equal and in the vocabulary; K5 once per prefill
    and tick, K3/K4 once per attention layer per tick and none in the
    prefill; each rank's caches of MESH_FAMILY_SEQ / 2 positions (whisper's
    cross caches 1504 / 2); the teacher-forced logits within phase 7c's
    bar (`hold_logits`), over the run and at the prefill and the first
    tick, and recurrentgemma's across the wrap, at the first tick past
    it too.  Returns the launches for the kernels line."""
    from repro_torch.configs.base import cut_depth, get_config
    from repro_torch.models import layers as L
    a, b = r0["families"], r1["families"]
    pa = ("paged_attn_scores_max", "paged_attn_accumulate")
    out, total = {}, 0.0
    for arch, layers, key in MESH_FAMILIES:
        cfg = cut_depth(get_config(arch), layers)
        w, wb = a[arch], b[arch]
        per_tick = _attention_layers(cfg)
        steps = 1 + MESH_ARCHS_TICKS
        want_p = {k: 0 for k in w["launches"]}
        want_p["normhead_matmul"] = 1
        want_all = dict(want_p, normhead_matmul=steps,
                        **{n: per_tick * MESH_ARCHS_TICKS for n in pa})
        rows = {L.cache_len(MESH_FAMILY_SEQ, cfg.attn_window
                            if cfg.block_kind(i) == "swa" else None)
                // MESH_TP for i in range(cfg.n_layers)
                if cfg.block_kind(i) in ("attn", "swa")}
        if cfg.is_encoder_decoder:
            rows.add(cfg.encoder_seq_len // MESH_TP)
        print(f"[mesh-9e] {arch} on (1, 2), {cfg.n_layers} layers"
              f"{'' if layers is None else ' (cut)'}: prefill of "
              f"{MESH_ARCHS_PROMPTS} x {MESH_PROMPT_LEN} into caches of "
              f"{w['rows']} rows a rank, {MESH_ARCHS_TICKS} ticks at "
              f"{w['tick_ms']:.2f}ms a tick; launches after the prefill "
              f"{w['after_prefill']}, after the ticks {w['launches']} "
              f"(expected {per_tick} of K3/K4 a tick, 1 of K5 a step) "
              f"[{card}]")
        if w["streams"] != wb["streams"]:
            fail(f"phase 9e: {arch}'s two ranks' streams differ")
        if any(len(s) != steps or not all(0 <= t < cfg.vocab_size
                                           for t in s)
               for s in w["streams"]):
            fail(f"phase 9e: {arch} streams {w['streams']}")
        if w["after_prefill"] != want_p or w["launches"] != want_all:
            fail(f"phase 9e: {arch} launches {w['after_prefill']} / "
                 f"{w['launches']}, expected {want_p} / {want_all}")
        if set(w["rows"]) != rows:
            fail(f"phase 9e: {arch} caches of {w['rows']} rows a rank, "
                 f"expected {sorted(rows)}")
        hold_logits(f"{arch} (1, 2) 1 prefill of {MESH_FAMILY_TF_PROMPT} + "
                    f"{MESH_ARCHS_TF_STEPS} ticks teacher-forced",
                    *w["tf"], {"the prefill": 0, "the first tick": 1},
                    phase="9e", tag="mesh-9e")
        if "tf_long" in w:
            W = cfg.attn_window
            hold_logits(f"{arch} (1, 2) 1 prefill of {MESH_FAMILY_LONG} + "
                        f"{MESH_FAMILY_LONG_TICKS} ticks teacher-forced "
                        f"across the wrap at {W} ({W // MESH_TP} rolling "
                        f"slots a rank)", *w["tf_long"],
                        {"the first tick": 1,
                         "the first tick past the wrap":
                         1 + W - MESH_FAMILY_LONG},
                        phase="9e", tag="mesh-9e")
        print(f"[mesh-9e] {arch}: {w['seconds']:.1f}s")
        total += w["seconds"]
        out[key] = w["launches"]
    print(f"[mesh-9e] phase 9e took {total:.1f}s of 9b's ranks")
    return out


def _collective_line(stats, n: int, what: str) -> str:
    """Per-`what` figures of the collectives: calls, bytes, bytes staged
    through the host and host seconds (peers' waits included)."""
    parts = []
    for op, v in sorted(stats.items()):
        parts.append(f"{op}: {v['calls'] / n:.1f} calls {v['bytes'] / n / 1e6:.3f}MB "
                     f"(host {v['host_bytes'] / n / 1e6:.3f}MB) "
                     f"{1e3 * v['seconds'] / n:.2f}ms")
    host = sum(v["host_bytes"] for v in stats.values()) / n
    secs = sum(v["seconds"] for v in stats.values()) / n
    return (f"per {what}: {'; '.join(parts)}; staged through the host "
            f"{host / 1e6:.3f}MB, collectives {1e3 * secs:.2f}ms")


def mesh_nccl(card, base, train_hist):
    """Phase 9a: one spawned rank with an NCCL process group of world size
    1 (the mesh code at (1, 1)): 8 of phase 5's prompts through the
    OnlineEngine, streams equal to phase 5's bit for bit; phase 8's
    4-layer step from the same seed, MESH_STEPS steps, losses and grad
    norms equal to phase 8's bit for bit; then the same steps at
    MESH_ACCUM microbatches, phase 9b's (1, 1) reference.  Returns (the
    launches, that reference's history)."""
    t0 = time.perf_counter()
    prompts = base["prompts"][:MESH_PROMPTS]
    (r,) = _spawn(_nccl_rank, 1, prompts)
    want = base["outputs"][:MESH_PROMPTS]
    same = sum(a == b for a, b in zip(r["streams"], want))
    ref = [(h["loss"], h["grad_norm"]) for h in train_hist[:MESH_STEPS]]
    print(f"[mesh-9a] NCCL world 1: {same}/{MESH_PROMPTS} streams equal "
          f"phase 5's; step calls {r['calls']}, tick p50 "
          f"{r['tick_ms']:.2f}ms; training {r['hist']} vs phase 8's {ref}; "
          f"launches serve {r['serve_launches']} train "
          f"{r['train_launches']}; {time.perf_counter() - t0:.1f}s [{card}]")
    if same != MESH_PROMPTS:
        fail(f"phase 9a: {MESH_PROMPTS - same} streams differ from phase 5's")
    if r["hist"] != ref:
        fail(f"phase 9a: losses and grad norms {r['hist']} != phase 8's {ref}")
    return ({"nccl_serve": r["serve_launches"],
             "nccl_train": r["train_launches"]}, r["hist_9b"])


def mesh_gloo(card, base, tf_tokens, tf_one, train_hist):
    """Phase 9b: two ranks over gloo on the one card (NCCL refuses two
    ranks on one device).  Serving Ling-Lite at full width, all 28
    layers, on (1, 2): 8 of phase 5's prompts cut to MESH_PROMPT_LEN
    tokens, prefill and MESH_TICKS greedy ticks on the "ep" dispatch (K1,
    K3/K4 on 8 of 16 in-page offsets, K5 on a 63232-row head shard), both
    ranks' streams equal bit for bit and the launches phase 5's formula;
    one request teacher-forced through the kernels, the plain modes
    (gathered attention, K1's and K5's plain versions) and a witness in
    another rounding that launches no kernel (those plain versions with
    the attention in fp64, `fp64_attention`): logits within phase 7b's
    bar, max(2^-5 of the largest, twice the rounding floor), and their
    gap to phase 6's (1, 1) run printed with the dropped-slot count.
    Then phase 8's 4-layer step at MESH_ACCUM microbatches, MESH_STEPS
    steps from the same parameters and batches, at (1, 2) and at (2, 1),
    against phase 9a's (1, 1) run of the same steps (`train_hist`) within
    MESH_TRAIN_TOL, and (2, 1)'s first step again (the same bits: loss,
    grad norm, parameters).  Prints the backend, how the collectives ran
    (the card exchange, or gloo on CUDA tensors and host buffers), the
    bytes and seconds per tick and per step.  Returns the launches."""
    import torch
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    cfg = get_config("ling-lite")
    prompts = [p[:MESH_PROMPT_LEN] for p in base["prompts"][:MESH_PROMPTS]]
    r0, r1 = _spawn(_gloo_rank, 2, prompts, tf_tokens)
    print(f"[mesh-9b] {r0['describe']}; init {r0['init_s']:.1f}s")
    n = r0["calls"]["prefill"] + r0["calls"]["decode"]
    want_k = cfg.n_layers * n
    print(f"[mesh-9b] serving (1, 2), {cfg.n_layers} layers: step calls "
          f"{r0['calls']}, wall {r0['serve_s']:.2f}s, tick p50 "
          f"{r0['tick_ms']:.2f}ms, peak {r0['serve_peak'] / 1e9:.2f}GB a "
          f"rank; launches {r0['serve_launches']} (expected {want_k} of "
          f"K1/K3/K4, {n} of K5) [{card}]")
    print(f"[mesh-9b] collectives, rank 0, "
          f"{_collective_line(r0['serve_stats'], n, 'serving step')}")
    if r0["streams"] != r1["streams"]:
        fail("phase 9b: the two ranks' streams differ")
    if any(len(s) != MESH_TICKS + 1 for s in r0["streams"]):
        fail(f"phase 9b: stream lengths {[len(s) for s in r0['streams']]}")
    for name, got in r0["serve_launches"].items():
        want = (want_k if name in SERVE_KERNELS else
                n if name == "normhead_matmul" else 0)
        if got != want:
            fail(f"phase 9b: {name} launched {got} times, expected {want}")
    fused, plain, other = r0["fused"], r0["plain"], r0["other"]
    big = plain.abs().max().item()
    err = (fused - plain).abs().max().item()
    flo = (other - plain).abs().max().item()
    tol = max(2.0 ** -5 * big, 2 * flo)
    gap = (fused - tf_one).abs().max().item()
    d = r0["drops"]
    print(f"[mesh-9b] teacher-forced (1 chunk + {E2E_STEPS} ticks): kernels "
          f"vs plain modes {err:.4e} = {err / big:.4f} of the largest "
          f"(bar {tol:.4e}: rounding floor {flo:.4e}); gap to the (1, 1) "
          f"kernels' logits {gap:.4e} = {gap / big:.4f} with "
          f"{d['dropped']} of {d['slots']} routed slots dropped; greedy "
          f"agreement {(fused.argmax(-1) == tf_one.argmax(-1)).float().mean():.3f}")
    if not err <= tol:
        fail(f"phase 9b: kernels vs plain logits {err} > {tol}")
    ref = train_hist[:MESH_STEPS]
    for label, rec in r0["train"].items():
        steps = len(rec["hist"])
        print(f"[mesh-9b] training {label}: {rec['describe']}; (loss, grad "
              f"norm, dropped frac) {rec['hist']} vs (1, 1) "
              f"{[(h['loss'], h['grad_norm']) for h in ref]}; step times "
              f"{[round(t, 3) for t in rec['times']]}s; peak "
              f"{rec['peak'] / 1e9:.2f}GB a rank; launches "
              f"{rec['launches']} [{card}]")
        print(f"[mesh-9b] collectives, rank 0, "
              f"{_collective_line(rec['stats'], steps, 'step')}")
        tl, tg = MESH_TRAIN_TOL[label.split()[0]]
        for (loss, gn, _), h in zip(rec["hist"], ref):
            if not (abs(loss - h["loss"]) <= tl * abs(h["loss"])
                    and abs(gn - h["grad_norm"]) <= tg * h["grad_norm"]):
                fail(f"phase 9b: training {label} (loss, grad norm) "
                     f"{(loss, gn)} vs (1, 1) {(h['loss'], h['grad_norm'])}"
                     f" past ({tl}, {tg}) relative")
    a, b = r0["train"]["2x1"], r0["train"]["2x1 again"]
    if a["hist"][:1] != b["hist"] or not (b["same_params"]
                                          and r1["train"]["2x1 again"]
                                          ["same_params"]):
        fail(f"phase 9b: the (2, 1) step run twice differs: {a['hist']} vs "
             f"{b['hist']}, params equal {b['same_params']}")
    archs = mesh_archs(card, r0, r1)
    archs.update(mesh_families(card, r0, r1))
    print(f"[mesh-9b] phase 9b took {time.perf_counter() - t0:.1f}s (9d "
          f"and 9e included)")
    base["mesh_9b"] = {"streams": r0["streams"], "tick_ms": r0["tick_ms"],
                       "train_1x2": r0["train"]["1x2"],
                       "step_stats": {label: r0["train"][label]["step_stats"]
                                      for label in ("1x2", "2x1")}}
    return {"mesh_serve": r0["serve_launches"],
            "mesh_train_2x1": a["launches"],
            "mesh_train_1x2": r0["train"]["1x2"]["launches"], **archs}


# phase 9c: the rest of Ling-Lite's paths on (1, 2), and checkpoints
# ---------------------------------------------------------------------------

MESH_SPEC_K, MESH_DRAFT_LAYERS = 4, 1
# phase 9c's spec run emits the first MESH_SPEC_NEW tokens of 9b's
# greedy streams (9b's 33 a prompt; the spec ticks' collectives go through
# the card exchange)
MESH_SPEC_NEW = 9
# phase 9c's bar on the int8-SP step against 9b's native (1, 2) step:
# loss and grad norm relative, the reference's own int8 bar
# (tests/test_sharded_parity.py)
INT8_TOL = 0.08
# harness items of 12 context and 4 option tokens: 15 scored tokens, odd,
# so the MoE's "auto" dispatch takes "batched" at tp = 2
MESH_HARNESS_ITEMS = 2
# phase 9c's SLO deadline: the gate's forward TTFT estimate for the first
# MESH_SLO_ADMIT of phase 5's 16 prompts (cut to MESH_PROMPT_LEN: a
# prefill chunk each) queued at once, at 9b's tick p50, so that rank 0's
# tracker admits about that many and sheds the rest; each admitted
# request decodes MESH_SLO_NEW tokens
MESH_SLO_ADMIT, MESH_SLO_NEW = 4, 2


def token_logp(cfg, params, seqs, flags, env=None):
    """Each token's log p(token_t | tokens_<t) from make_score_fn's
    forward and K5 head (over `env`'s mesh: the vocab shards gathered over
    tp), and the largest |logit| (phases 6c and 9c)."""
    import torch
    from repro_torch import sharding
    from repro_torch.models import embedding as emb
    from repro_torch.models import model as M
    env = env or sharding.LOCAL
    tt = torch.as_tensor(seqs).long().to(params["embed"]["table"].device)
    n, s = tt.shape
    with torch.no_grad():
        x, _, _, _ = M.forward(cfg, params, {"tokens": tt[:, :-1]},
                               train=False, flags=flags, env=env)
        lg = env.all_gather_tp(emb.serve_logits(cfg, params["embed"], x,
                                                env), axis=1)
        del x
        lg = lg.reshape(n, s - 1, -1)[..., :cfg.vocab_size]
        lp = torch.log_softmax(lg, dim=-1).gather(-1, tt[:, 1:, None])[..., 0]
        return lp, lg.abs().max().item()


def _paths_rank(rank, world, tmp, prompts, seqs, mask, deadline,
                slo_prompts, ck_root):
    """Phase 9c's rank: two of them over gloo on the one card.  On (1, 2)
    at full depth: speculative decoding (1-layer self-draft, k = 4),
    make_score_fn on 8 x 512 (and the per-token log p through the
    kernels and the plain modes), harness items of odd length, the SLO
    engine; then phase 8's 4-layer step with sp_comm="int8"; then the
    1-layer model's checkpoint saved at (2, 1), restored by fresh (2, 1)
    trainers and by (1, 2) ranks."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.checkpoint import pcache as PC
    from repro_torch.configs.base import get_config
    from repro_torch.core import moe
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.evals import harness as H
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.serving.draft import SelfDrafter
    from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                            OnlineRequest)
    from repro_torch.telemetry.slo import SLOConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    tmesh.init_distributed(rank, world, init_method=f"file://{tmp}/store",
                           backend="gloo", timeout_s=MESH_TIMEOUT_S)
    mesh = tmesh.make_local_mesh(1, 2, device="cuda:0",
                                 timeout_s=MESH_TIMEOUT_S)
    cfg = get_config("ling-lite")
    runner = api.Runner(cfg, device=mesh.device, mesh=mesh)
    params = runner.init_params(0)
    geo = dict(max_slots=8, max_context=512, page_size=16, prefill_chunk=64)
    out = {}

    # 1. speculative decoding, a 1-layer self-draft
    eng = OnlineEngine(runner, params, OnlineConfig(**geo,
                                                    spec_k=MESH_SPEC_K),
                       drafter=SelfDrafter(draft_layers=MESH_DRAFT_LAYERS))
    eng.submit_many([OnlineRequest(rid=i, prompt=np.asarray(p, np.int32),
                                   max_new=MESH_SPEC_NEW)
                     for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    eng.run(max_ticks=10_000)
    torch.cuda.synchronize()
    out["spec"] = {"streams": [list(eng.reqs[i].out)
                               for i in range(len(prompts))],
                   "wall": time.perf_counter() - t0,
                   "launches": dict(build.LAUNCHES),
                   "calls": dict(eng.step_calls),
                   "tick_ms": eng.registry.get("serve_tick_ms")
                   .percentile(50),
                   "accept": eng.spec_accepted / max(eng.spec_proposed, 1)}
    del eng
    # ... and one request through a full-depth self-draft, whose drafts
    # are all accepted: commits and page trims over each rank's offsets
    eng = OnlineEngine(runner, params, OnlineConfig(**geo,
                                                    spec_k=MESH_SPEC_K),
                       drafter=SelfDrafter(draft_layers=cfg.n_layers))
    eng.submit(OnlineRequest(rid=0, prompt=np.asarray(prompts[0], np.int32),
                             max_new=MESH_SPEC_NEW))
    t0 = time.perf_counter()
    eng.run(max_ticks=1000)
    torch.cuda.synchronize()
    out["spec_full"] = {"stream": list(eng.reqs[0].out),
                        "wall": time.perf_counter() - t0,
                        "accepted": eng.spec_accepted,
                        "proposed": eng.spec_proposed,
                        "calls": dict(eng.step_calls)}
    del eng

    # 2. scoring 8 x 512, per token against the mesh's plain modes
    score = runner.make_score_fn()
    score(params, seqs[:1, :16], mask[:1, :16])           # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    got = score(params, seqs, mask)
    torch.cuda.synchronize()
    rec = {"got": got.cpu(), "ms": 1e3 * (time.perf_counter() - t0),
           "launches": dict(build.LAUNCHES)}
    lp, _ = token_logp(cfg, params, seqs, runner.flags, runner.env)
    with plain_moe_head():
        lp_plain, top = token_logp(
            cfg, params, seqs, M.RunFlags(paged_attn="gathered"), runner.env)
    rec.update(tok_err=(lp - lp_plain).abs().max().item(), top=top,
               tok_mean=(lp - lp_plain).abs().mean().item(),
               sum_err=(got - lp.sum(-1)).abs().max().item(),
               lp_max=lp.abs().max().item())
    out["score"] = rec
    del lp, lp_plain

    # 3. harness items of odd length: "auto" takes "batched"
    modes, orig = [], moe.resolve_dispatch

    def seen(*a, **k):
        mode = orig(*a, **k)
        modes.append(mode)
        return mode
    moe.resolve_dispatch = seen
    try:
        items = H.make_mc_dataset(MESH_HARNESS_ITEMS, cfg.vocab_size)
        t0 = time.perf_counter()
        rep = H.ppl_eval_content(items, lambda t, m: float(
            score(params, t[None], m[None])[0]))
    finally:
        moe.resolve_dispatch = orig
    out["harness"] = {"accuracy": rep["accuracy"], "modes": sorted(set(modes)),
                      "ms": 1e3 * (time.perf_counter() - t0) / len(items),
                      "lens": sorted({len(it.context) + len(o) for it in items
                                      for o in it.options})}

    # 4. the SLO engine: rank 0's tracker decides for both ranks
    eng = OnlineEngine(runner, params, OnlineConfig(
        **geo, overload="slo", slo=SLOConfig(ttft_p99_ms=deadline)))
    eng.submit(OnlineRequest(rid=100, prompt=np.asarray(prompts[0], np.int32),
                             max_new=9))
    eng.run(max_ticks=1000)
    own, should_shed = [], eng.slo.should_shed

    def own_verdict(*a, **k):
        v = should_shed(*a, **k)
        own.append(v is not None)
        return v
    eng.slo.should_shed = own_verdict
    took = [eng.submit(OnlineRequest(rid=i, prompt=np.asarray(p, np.int32),
                                     max_new=MESH_SLO_NEW))
            for i, p in enumerate(slo_prompts)]
    eng.run(max_ticks=10_000)
    out["slo"] = {"shed": [i for i, t in enumerate(took) if not t],
                  "own": [i for i, v in enumerate(own) if v],
                  "done": sum(len(eng.reqs[i].out) == MESH_SLO_NEW
                              for i, t in enumerate(took) if t),
                  "snapshot": eng.slo.snapshot()}
    del eng, params, runner, score
    gc.collect()
    torch.cuda.empty_cache()

    # 5. phase 8's step at (1, 2), one microbatch, int8 SP boundaries
    m = tmesh.make_local_mesh(1, 2, device="cuda:0", timeout_s=MESH_TIMEOUT_S)
    build.reset_launches()
    trainer, _, _ = train_setup(MESH_STEPS, mesh=m, debug_guards=False,
                                accum=MESH_ACCUM, sp_comm="int8")
    times = []
    try:
        for k in range(1, MESH_STEPS + 1):
            t1 = time.perf_counter()
            trainer.train(k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
    finally:
        trainer.close()
    out["int8"] = {"hist": [(r["loss"], r["grad_norm"])
                            for r in trainer.history],
                   "times": times, "launches": dict(build.LAUNCHES),
                   "stats": {k: dict(v) for k, v in m.stats.items()}}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 6. checkpoints of the 1-layer model: saved at (2, 1) after a step
    cfg1 = dataclasses.replace(cfg, n_layers=1)

    def make(mesh_):
        return Trainer(
            api.Runner(cfg1, device=mesh_.device, mesh=mesh_),
            DataPipeline(PipelineConfig(vocab_size=cfg1.vocab_size,
                                        seq_len=1024, batch_size=2, seed=0)),
            TrainConfig(n_steps=2, log_every=1, seed=0, debug_guards=False,
                        checkpoint_dir=ck_root))
    m21 = tmesh.make_local_mesh(2, 1, device="cuda:0",
                                timeout_s=MESH_TIMEOUT_S)
    a = make(m21)
    try:
        a.train(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.save("step_1")
        a.pcache.wait()
        ck = {"save_s": time.perf_counter() - t0,
              "save_bytes": a.pcache.last_save["bytes"]}
        a.train(2)
    finally:
        a.close()
    a_hist = [(r["loss"], r["grad_norm"]) for r in a.history]
    a_params = [t.detach().clone() for t in adamw.leaves(a.params)]
    del a
    gc.collect()
    torch.cuda.empty_cache()
    b = make(m21)
    try:
        t0 = time.perf_counter()
        ck["restored"] = b.restore("latest")
        ck["restore_s"] = time.perf_counter() - t0
        ck["restore_bytes"] = b.pcache.last_load["bytes"]
        b.train(2)
    finally:
        b.close()
    ck["same_step"] = [(r["loss"], r["grad_norm"])
                       for r in b.history] == a_hist[1:]
    ck["same_params"] = all(torch.equal(x, y) for x, y in zip(
        a_params, adamw.leaves(b.params)))
    ck["hist"] = (a_hist, [(r["loss"], r["grad_norm"]) for r in b.history])
    del b, a_params
    gc.collect()
    torch.cuda.empty_cache()
    m12 = tmesh.make_local_mesh(1, 2, device="cuda:0",
                                timeout_s=MESH_TIMEOUT_S)
    c = make(m12)
    try:
        t0 = time.perf_counter()
        c.restore("step_1")
        ck["restore_12_s"] = time.perf_counter() - t0
        pc = PC.PCache(ck_root)
        files = pc.manifest("step_1")["leaves"]
        specs = adamw.leaves(c._state_specs())
        bad = 0
        for e, t, spec in zip(files, adamw.leaves(c._state_tree()), specs):
            mm = np.load(os.path.join(ck_root, "step_1", e["file"]),
                         mmap_mode="r")
            want = np.array(mm[PC.slice_index(
                tuple(spec), tuple(t.shape), c.runner.env)])
            bad += not torch.equal(t.cpu(), torch.from_numpy(want))
            del mm
        ck["slices_equal"] = bad == 0
        ck["n_leaves"] = len(files)
    finally:
        c.close()
    out["ckpt"] = ck
    del c
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return out


def mesh_paths(card, base):
    """Phase 9c: two ranks over gloo on the one card.  On (1, 2) at full
    depth (28 layers): speculative decoding with a 1-layer self-draft at
    k = 4 on 9b's prompts (greedy streams the first MESH_SPEC_NEW tokens
    of 9b's bit for bit, both ranks equal, launches per spec tick and
    chunk held) and one request with a full-depth self-draft (every
    draft accepted, its stream 9b's), phase 6c's 8 x 512
    make_score_fn (each token's log p within SCORE_TOL of the largest
    logit from the mesh's plain modes; the gap to 6c's (1, 1) scores
    printed), harness items of 15 scored tokens (each rank's dispatch
    modes printed: "batched" must be among them), 6c's SLO engine with
    a deadline of MESH_SLO_ADMIT prompts' chunks at 9b's tick p50 (both
    ranks shed the same rids, some but not all 16); then phase 8's 4-layer step
    at one microbatch with int8 SP boundaries (loss and grad norm within
    INT8_TOL of 9b's native (1, 2) steps; the SP collectives' bytes and
    those staged through the host beside native's); then the 1-layer
    model's checkpoint (13 GB) saved at (2, 1) after one step: fresh (2,
    1) trainers restore it and their next step is the unbroken run's bit
    for bit, and (1, 2) ranks restore it with every slice the files' bit
    for bit.  Returns the launches."""
    import dataclasses
    import math
    import shutil
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    cfg = get_config("ling-lite")
    prompts = [p[:MESH_PROMPT_LEN] for p in base["prompts"][:MESH_PROMPTS]]
    seqs, mask, got11 = base["score"]
    slo_prompts = [p[:MESH_PROMPT_LEN] for p in base["prompts"]]
    deadline = base["mesh_9b"]["tick_ms"] * math.ceil(
        sum(len(p) for p in slo_prompts[:MESH_SLO_ADMIT]) / 64)
    n_par = sum(t.numel() for t in adamw.leaves(M.init_model(
        dataclasses.replace(cfg, n_layers=1), device="meta", masters=True)))
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_"))
    try:
        free, need = shutil.disk_usage(root).free, 12 * n_par + (1 << 30)
        if free < need:
            fail(f"phase 9c: {root} has {free / 1e9:.2f} GB free; the "
                 f"checkpoint needs {need / 1e9:.2f} GB")
        r0, r1 = _spawn(_paths_rank, 2, prompts, seqs, mask, deadline,
                        slo_prompts, str(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    L_ = cfg.n_layers
    failed = []

    # 1. speculative decoding
    sp = r0["spec"]
    want = [s[:MESH_SPEC_NEW] for s in base["mesh_9b"]["streams"]]
    calls = sp["calls"]
    per_tick = {n: (MESH_SPEC_K + 1) * MESH_DRAFT_LAYERS + L_
                for n in SERVE_KERNELS}
    per_tick["normhead_matmul"] = (MESH_SPEC_K + 1) + 1
    per_chunk = {n: L_ + MESH_DRAFT_LAYERS for n in SERVE_KERNELS}
    per_chunk["normhead_matmul"] = 2
    print(f"[mesh-9c] spec k={MESH_SPEC_K}, {MESH_DRAFT_LAYERS}-layer "
          f"self-draft on (1, 2), {L_} layers: {calls}, wall "
          f"{sp['wall']:.2f}s, tick p50 {sp['tick_ms']:.2f}ms, acceptance "
          f"{sp['accept']:.3f}, {sum(map(len, sp['streams']))} tokens; "
          f"launches {sp['launches']} [{card}]")
    if sp["streams"] != r1["spec"]["streams"]:
        failed.append("the ranks' spec streams differ")
    if sp["streams"] != want:
        bad = [i for i, (a, b) in enumerate(zip(sp["streams"], want))
               if a != b]
        failed.append(f"greedy spec streams differ from 9b's (requests "
                      f"{bad})")
    for name, n in sp["launches"].items():
        w = (per_chunk.get(name, 0) * calls["prefill"]
             + per_tick.get(name, 0) * calls["verify"])
        if n != w:
            failed.append(f"spec {name} launched {n} times, expected {w}")
    fu = r0["spec_full"]
    print(f"[mesh-9c] spec k={MESH_SPEC_K}, full-depth self-draft on (1, 2),"
          f" request 0: {fu['calls']}, wall {fu['wall']:.2f}s, accepted "
          f"{fu['accepted']} of {fu['proposed']} drafts [{card}]")
    if fu["stream"] != r1["spec_full"]["stream"]:
        failed.append("the ranks' full-depth spec streams differ")
    if not (fu["proposed"] > 0 and fu["accepted"] == fu["proposed"]
            and fu["stream"] == want[0]):
        failed.append(f"full-depth self-draft accepted {fu['accepted']} of "
                      f"{fu['proposed']} drafts, stream equals 9b's: "
                      f"{fu['stream'] == want[0]}")

    # 2. scoring
    sc = r0["score"]
    gap = (sc["got"] - got11).abs().max().item()
    tok_tol = SCORE_TOL * sc["top"]
    sum_tol = 1e-5 * (seqs.shape[1] - 1) * sc["lp_max"]
    print(f"[mesh-9c] make_score_fn {seqs.shape[0]} x {seqs.shape[1]} on "
          f"(1, 2): {sc['ms']:.2f}ms (launches {sc['launches']}); per token "
          f"against the mesh's plain modes max {sc['tok_err']:.4e} nats "
          f"(tolerance {tok_tol:.4e}), mean {sc['tok_mean']:.4e}; scores "
          f"against their tokens' sums {sc['sum_err']:.4e} (tolerance "
          f"{sum_tol:.4e}); gap to 6c's (1, 1) scores {gap:.4e} nats of "
          f"{got11.abs().max().item():.2f} [{card}]")
    if not torch.equal(sc["got"], r1["score"]["got"]):
        failed.append("the ranks' scores differ")
    if not (bool(torch.isfinite(sc["got"]).all())
            and bool((sc["got"] < 0).all())):
        failed.append(f"scores {sc['got'].tolist()} not finite and negative")
    if not sc["tok_err"] <= tok_tol:
        failed.append(f"a token's log p is {sc['tok_err']} from the plain "
                      f"modes' (tolerance {tok_tol})")
    if not sc["sum_err"] <= sum_tol:
        failed.append(f"scores {sc['sum_err']} from their tokens' sums")

    # 3. the harness at odd lengths
    for r, rr in enumerate((r0, r1)):
        h = rr["harness"]
        print(f"[mesh-9c] harness ppl_eval_content rank {r}: {len(h['lens'])}"
              f" scored lengths {h['lens']}, dispatch modes {h['modes']}, "
              f"accuracy {h['accuracy']:.3f}, {h['ms']:.1f}ms per item")
        if "batched" not in h["modes"]:
            failed.append(f"rank {r}'s odd-length items took {h['modes']}")

    # 4. the SLO gate
    sl, n_slo = r0["slo"], len(slo_prompts)
    print(f"[mesh-9c] SLO engine on (1, 2), deadline {deadline:.2f}ms (the "
          f"first {MESH_SLO_ADMIT} prompts' prefill chunks at 9b's tick "
          f"p50): shed {sl['shed']} of {n_slo} (rank 1 {r1['slo']['shed']});"
          f" each rank's own tracker would shed {sl['own']} / "
          f"{r1['slo']['own']}; {sl['done']} admitted requests finished; "
          f"slo {sl['snapshot']} (rank 1 {r1['slo']['snapshot']}) [{card}]")
    if sl["shed"] != r1["slo"]["shed"] or not 0 < len(sl["shed"]) < n_slo:
        failed.append(f"SLO sheds {sl['shed']} vs {r1['slo']['shed']} of "
                      f"{n_slo}")
    if sl["shed"] != sl["own"]:
        failed.append(f"rank 0 shed {sl['shed']}, its tracker said "
                      f"{sl['own']}")
    if sl["done"] != n_slo - len(sl["shed"]):
        failed.append(f"{sl['done']} of {n_slo - len(sl['shed'])} admitted "
                      f"SLO requests finished")

    # 5. the int8 step against 9b's native (1, 2) step
    i8, nat = r0["int8"], base["mesh_9b"]["train_1x2"]
    steps = len(i8["hist"])
    sp_ops = ("all_gather", "reduce_scatter", "all_to_all")

    def sp_bytes(stats):
        return (sum(stats.get(o, {}).get("bytes", 0) for o in sp_ops) / steps,
                sum(v["host_bytes"] for v in stats.values()) / steps)
    ib, ih = sp_bytes(i8["stats"])
    nb, nh_ = sp_bytes(nat["stats"])
    print(f"[mesh-9c] int8 SP step (1, 2), 4 layers: (loss, grad norm) "
          f"{i8['hist']} vs native {[h[:2] for h in nat['hist']]}; step times "
          f"{[round(t, 3) for t in i8['times']]}s (native "
          f"{[round(t, 3) for t in nat['times']]}s); all-gather + "
          f"reduce-scatter + all-to-all {ib / 1e6:.1f}MB a step (native "
          f"{nb / 1e6:.1f}MB), staged through the host {ih / 1e6:.1f}MB "
          f"(native {nh_ / 1e6:.1f}MB); launches {i8['launches']} [{card}]")
    print(f"[mesh-9c] collectives, rank 0, "
          f"{_collective_line(i8['stats'], steps, 'int8 step')}")
    for (loss, gn), h in zip(i8["hist"], nat["hist"]):
        if not (abs(loss - h[0]) <= INT8_TOL * abs(h[0])
                and abs(gn - h[1]) <= INT8_TOL * h[1]):
            failed.append(f"int8 (loss, grad norm) {(loss, gn)} vs native "
                          f"{h[:2]} past {INT8_TOL} relative")

    # 6. checkpoints
    for r, rr in enumerate((r0, r1)):
        ck = rr["ckpt"]
        print(f"[mesh-9c] checkpoint rank {r}: saved at (2, 1) "
              f"{ck['save_bytes'] / 1e9:.2f}GB of its slices in "
              f"{ck['save_s']:.2f}s ({ck['save_bytes'] / 1e9 / ck['save_s']:.2f}"
              f" GB/s), restored {ck['restore_bytes'] / 1e9:.2f}GB in "
              f"{ck['restore_s']:.2f}s at (2, 1) ({ck['restored']}), "
              f"{ck['restore_12_s']:.2f}s at (1, 2); resumed step = "
              f"unbroken {ck['same_step']} ({ck['hist']}), params "
              f"{ck['same_params']}; (1, 2) slices = files "
              f"{ck['slices_equal']} ({ck['n_leaves']} leaves)")
        if not (ck["same_step"] and ck["same_params"]
                and ck["slices_equal"]):
            failed.append(f"checkpoint rank {r}: step {ck['same_step']} "
                          f"params {ck['same_params']} slices "
                          f"{ck['slices_equal']}")
    print(f"[mesh-9c] phase 9c took {time.perf_counter() - t0:.1f}s")
    if failed:
        fail("phase 9c: " + "; ".join(failed))
    return {"mesh_spec": sp["launches"], "mesh_score": sc["launches"],
            "mesh_train_int8": i8["launches"]}


# ---------------------------------------------------------------------------
# phase 10: the dry run against the card
# ---------------------------------------------------------------------------

# phase 10a's bars on the dry run's memory against the card's allocator:
# the ceiling the dry run must stay within, and the tight one it is held
# to.  The allocator rounds each block up to 512 bytes and may hand out a
# cached block up to 1 MiB longer than asked; at ~34 GB of arguments and
# ~28 GB of step, a lost AdamW temporary, or the fp32 gradients of one
# layer, is tens to hundreds of times the tight bar.
DRY_PEAK_TOL = 0.15
DRY_MEM_GAP = 1e-3


def rec_counts(rec) -> dict:
    """A dry-run record's totals, as `counts` gives a counter's."""
    return {"flops": rec["roofline"]["flops_by_dtype"],
            "bytes": rec["roofline"]["hbm_bytes"],
            "launches": {k: v["launches"] for k, v in rec["kernels"].items()}}


def terms_line(c, ms: float) -> str:
    """The roofline's compute and memory terms of a one-rank count beside
    a measured time, each with its share of it."""
    from repro_torch import roofline
    r = roofline.roofline(c["flops"], c["bytes"], {})
    return (f"compute {1e3 * r.compute_s:.3f}ms ({1e3 * r.compute_s / ms:.1%}"
            f" of {ms:.3f}ms), memory {1e3 * r.memory_s:.3f}ms "
            f"({1e3 * r.memory_s / ms:.1%}), collective 0 (one rank); "
            f"bottleneck {r.bottleneck}; flops by dtype "
            f"{ {k: f'{v:.4e}' for k, v in r.flops_by_dtype.items()} }, "
            f"bytes {r.hbm_bytes:.4e}")


def dry_run_check(card, base, p8):
    """Phase 10: the dry run (`launch.dryrun.trace` on `meta`, the
    function the CLI runs) held against the card, on runs phases 6c, 8
    and 9b made (each one more step under the counter, outside their
    timed steps, through `dryrun.step_args` and `count_step`).
      (a) phase 8's 4-layer step: launches per step equal to
          `build.LAUNCHES` of the card's step and to phase 8's formula,
          FLOPs by dtype and bytes equal to the card's step under the
          same counter; the record's argument bytes (parameters, AdamW
          state, spike guard, batch) against what the card's allocator
          holds for them, and its peak bytes against the arguments plus
          `max_memory_allocated` over the step above what the card held
          before it, each within DRY_MEM_GAP (and DRY_PEAK_TOL); the
          three terms beside phase 8's median step time (printed);
      (b) phase 6c's dense prefill (8 x 64 into caches of 512) and tick
          (B = 8): launches equal to 6c's counts and to the card's under
          the counter, FLOPs and bytes equal to the card's; the terms
          beside 6c's measured ms (printed);
      (c) phase 9b's (2, 1) and (1, 2) steps: rank 0's dry run gives the
          collective calls and bytes per op rank 0 counted in its last
          step."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    # (a)
    card_c, cfg8 = p8["counted"], p8["cfg"]
    shape, st = p8["dry"]
    rec = dryrun.trace(cfg8, shape, 1, 1, st=st)
    dry = rec_counts(rec)
    mem = rec["memory"]
    want = {k: v for k, v in step_launches(cfg8, [st.accum]).items() if v}
    card_peak = card_c["card_args"] + card_c["card_peak"]
    gaps = {"arguments": (mem["argument_bytes"], card_c["card_args"]),
            "peak": (mem["peak_bytes"], card_peak)}
    print(f"[dry-10a] phase 8's step ({cfg8.n_layers} layers, seq "
          f"{shape.seq_len}, microbatch {shape.global_batch}, accum "
          f"{st.accum}): launches dry {dry['launches']} card "
          f"{card_c['card_launches']} counter {card_c['launches']} (formula "
          f"{want}); flops dry {dry['flops']} card {card_c['flops']}; bytes "
          f"dry {dry['bytes']:.6e} card {card_c['bytes']:.6e}; the record's "
          f"memory {mem}; the card's allocator: arguments "
          f"{card_c['card_args']} B, peak {card_peak} B (arguments + "
          f"max_memory_allocated {card_c['card_peak']} B over the held "
          f"bytes; the counter on the card {card_c['live_peak']} B); gaps "
          f"dry - card "
          + ", ".join(f"{k} {d - c:+d} B ({(d - c) / max(c, 1):+.2e})"
                      for k, (d, c) in gaps.items())
          + f" [{card}]")
    print(f"[dry-10a] terms of the step: "
          f"{terms_line(dry, 1e3 * p8['step_s'])}")
    if not (dry["launches"] == card_c["card_launches"]
            == card_c["launches"] == want):
        fail(f"phase 10a: launches dry {dry['launches']}, card "
             f"{card_c['card_launches']}, counter {card_c['launches']}, "
             f"formula {want}")
    if dry["flops"] != card_c["flops"] or dry["bytes"] != card_c["bytes"]:
        fail(f"phase 10a: the dry run's flops {dry['flops']} / bytes "
             f"{dry['bytes']} differ from the card's step under the counter "
             f"({card_c['flops']} / {card_c['bytes']})")
    for k, (d, c) in gaps.items():
        if not (abs(d - c) <= DRY_PEAK_TOL * c
                and abs(d - c) <= DRY_MEM_GAP * c):
            fail(f"phase 10a: the record's {k} bytes {d} are past "
                 f"{DRY_MEM_GAP:.0e} of the card's {c}")
    # (b)
    d = base["dense_10b"]
    cfg = get_config("ling-lite")
    L_ = cfg.n_layers
    want = {"prefill": {"fused_moe_ffn": L_, "normhead_matmul": 1},
            "tick": {"fused_moe_ffn": L_, "paged_attn_scores_max": L_,
                     "paged_attn_accumulate": L_, "normhead_matmul": 1}}
    for label, shape, st in dense_dry_steps(*d["BPS"]):
        dry = rec_counts(dryrun.trace(cfg, shape, 1, 1, st=st))
        on_card, ms = d[label], d[f"{label}_ms"]
        print(f"[dry-10b] dense {label}: launches dry {dry['launches']} "
              f"card {on_card['launches']} (6c's {want[label]}); flops dry "
              f"{dry['flops']} card {on_card['flops']}; bytes dry "
              f"{dry['bytes']:.6e} card {on_card['bytes']:.6e}; terms: "
              f"{terms_line(dry, ms)} [{card}]")
        if not dry["launches"] == on_card["launches"] == want[label]:
            fail(f"phase 10b: dense {label} launches dry {dry['launches']}, "
                 f"card {on_card['launches']}, 6c's {want[label]}")
        if dry["flops"] != on_card["flops"] or \
                dry["bytes"] != on_card["bytes"]:
            fail(f"phase 10b: dense {label} flops / bytes dry "
                 f"{dry['flops']} / {dry['bytes']}, card {on_card['flops']} "
                 f"/ {on_card['bytes']}")
    # (c)
    shape, st = p8["dry_mesh"]
    for label, (dp, tp) in (("2x1", (2, 1)), ("1x2", (1, 2))):
        stats = dryrun.trace(cfg8, shape, dp, tp, 0,
                             st=st)["collective_stats"]
        got = base["mesh_9b"]["step_stats"][label]
        print(f"[dry-10c] ({dp}, {tp}) rank 0's step: collectives dry "
              f"{stats} card {got}")
        if stats != got:
            fail(f"phase 10c: ({dp}, {tp}) rank 0's collectives dry {stats} "
                 f"!= the rank's {got}")
    print(f"[dry] phase 10 took {time.perf_counter() - t0:.1f}s")


def main():
    t_script = time.perf_counter()
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "a CUDA card")
    # fp32 products (plain versions, router, NormHead) stay full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from repro_torch.configs.base import get_config
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import the port from {src}: {e}")

    def mark(phase: str):
        # where the script's time goes: each phase's start since launch
        print(f"[time] phase {phase} starts at "
              f"{time.perf_counter() - t_script:.1f}s", flush=True)

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices={torch.cuda.device_count()}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in build.SIGNATURES:
        build.entry(name)
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f}s: "
          f"{sorted(p.name for p in libs.values())}")
    for p in libs.values():
        log = p.with_suffix(".log")
        if log.exists():
            # each kernel's registers and spills, under its name
            fn = ""
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    fn = kernel_name(line.split("'")[1] if "'" in line
                                     else line)
                elif "Used" in line or "spill" in line:
                    print(f"[build] {p.stem} {fn}: {line.strip()}")

    mark("3")
    # -- 3. per-kernel checks ----------------------------------------------
    cfg = get_config("ling-lite")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = {"decode": check_k1(cfg, 8, gen), "prefill": check_k1(cfg, 64, gen),
          "verify": check_k1(cfg, 40, gen),
          "train": check_k1(cfg, 2048, gen),
          "score": check_k1(cfg, 4088, gen)}
    torch.cuda.empty_cache()
    for label, (arch, T) in K1_ARCH_CASES.items():
        k1[label] = check_k1(get_config(arch), T, gen)
        torch.cuda.empty_cache()
    k3, k4 = {}, {}
    for label, kw in PA_CASES.items():
        k3[label], k4[label] = check_pa(cfg, label,
                                        paged_case(cfg, gen=gen, **kw))
    for label, (arch, shape) in PA_ARCH_CASES.items():
        acfg = get_config(arch)
        k3[label], k4[label] = check_pa(acfg, label, paged_case(
            acfg, gen=gen, **PA_CASES[shape]))
    for label, (arch, S, pos) in PA_FAMILY_CASES.items():
        k3[label], k4[label] = check_pa(get_config(arch), label,
                                        dense_case(arch, S, pos, gen))
    for label, (arch, S, pos, tp, rank) in PA_FAMILY_MESH_CASES.items():
        k3[label], k4[label] = check_pa(get_config(arch), label, dense_case(
            arch, S, pos, gen, tp=tp, rank=rank))
    for label, (shape, rank) in PA_MESH_CASES.items():
        k3[label], k4[label] = check_pa(cfg, label, paged_case(
            cfg, gen=gen, tp=MESH_TP, rank=rank, **PA_CASES[shape]))
    k2, wgrad = check_k2(cfg, gen)
    rows, wrows = check_k2(get_config(K2_ARCH), gen)
    k2.update({f"granite {k}": v for k, v in rows.items()})
    wgrad.update({f"granite {k}": v for k, v in wrows.items()})
    for label, T in EP_CASES.items():
        case = ep_case(cfg, T, gen)
        k1[label] = check_k1(cfg, T, gen, case=case)
        if T == EP_TRAIN_T:
            rows, wrows = check_k2(cfg, gen, case=case)
            k2.update({f"{label} {k}": v for k, v in rows.items()})
            wgrad.update({f"{label} {k}": v for k, v in wrows.items()})
        del case
        torch.cuda.empty_cache()
    del rows, wrows
    for label, T in FUSED_MESH_CASES.items():
        k1[label] = check_k1(cfg, T, gen, case=fused_tp_case(cfg, T, gen))
    torch.cuda.empty_cache()
    k5 = {label: check_k5(label, *k5_case(arch, T, gen))
          for label, (arch, T) in K5_CASES.items()}
    k5.update({label: check_k5(label, *k5_case(arch, T, gen, tp=MESH_TP))
               for label, (arch, T) in K5_MESH_CASES.items()})
    k6 = {label: check_k6(label, *k6_case(*case, gen))
          for label, case in K6_CASES.items()}
    decay = {label: check_decay(label, *decay_case(M, dt, gen))
             for label, (M, dt) in DECAY_CASES.items()}
    # the shapes of padded heads and experts and of rwkv6 over tp
    t3 = time.perf_counter()
    for label, (arch, shape, tp, rank) in PA_REGROUP_CASES.items():
        acfg = get_config(arch)
        k3[label], k4[label] = check_pa(acfg, label, paged_case(
            acfg, gen=gen, tp=tp, rank=rank, **PA_CASES[shape]),
            heads=-(-acfg.n_heads // tp) * tp)
    gcfg = get_config(K2_ARCH)
    for label, T in DUMMY_EP_CASES.items():
        case = ep_case(gcfg, T, gen, tp=DUMMY_TP, rank=DUMMY_RANK)
        if int(case[4][-2:].sum()) != 0:
            fail(f"{label}: a dummy expert received rows")
        k1[label] = check_k1(gcfg, T, gen, case=case)
        if T == DUMMY_TRAIN_T:
            rows, wrows = check_k2(gcfg, gen, case=case)
            k2.update({f"{label} {k}": v for k, v in rows.items()})
            wgrad.update({f"{label} {k}": v for k, v in wrows.items()})
        del case
        torch.cuda.empty_cache()
    k6.update({label: check_k6(label, *k6_case(*case[:4], gen, H=case[4]))
               for label, case in K6_MESH_CASES.items()})
    decay.update({label: check_decay(label, *decay_case(M, dt, gen, n=n))
                  for label, (M, dt, n) in DECAY_MESH_CASES.items()})
    print(f"[kernels] phase 3's padded-head, dummy-expert and tp = 2 rwkv6 "
          f"cases took {time.perf_counter() - t3:.1f}s (granite's head "
          f"shard among K5_MESH_CASES)")
    results = {"fused_moe_ffn": k1,
               "grouped_matmul_aligned": k2,
               "grouped_matmul_wgrad": wgrad,
               "paged_attn_scores_max": k3, "paged_attn_accumulate": k4,
               "normhead_matmul": k5, "wkv6": k6, "rwkv_decay": decay}
    gc.collect()
    torch.cuda.empty_cache()

    mark("4")
    # -- 4. gradients --------------------------------------------------------
    check_grads(cfg, gen)
    gc.collect()
    torch.cuda.empty_cache()

    mark("5")
    # -- 5. serving ---------------------------------------------------------
    from repro_torch import api
    t0 = time.perf_counter()
    params = api.Runner(cfg, device="cuda").init_params(0)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"[serve] ling-lite {cfg.n_layers} layers d={cfg.d_model} "
          f"experts={cfg.moe.n_experts} top{cfg.moe.top_k}: {n_par / 1e9:.2f}B "
          f"params, {sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.1f}GiB, "
          f"init {time.perf_counter() - t0:.1f}s (depth not cut)")
    base, serve_launches = serve(cfg, params)

    mark("6")
    # -- 6. end to end ------------------------------------------------------
    end_to_end(cfg, params, gen)
    # phase 9b's teacher-forced request, here at (1, 1) on the kernels
    from repro_torch.models import model as M
    tf_tokens = torch.randint(
        0, cfg.vocab_size, (E2E_CHUNK + E2E_STEPS,),
        generator=torch.Generator(device="cuda").manual_seed(9),
        device="cuda")
    tf_one = teacher_forced(cfg, params, tf_tokens, M.RunFlags()).cpu()
    tf_tokens = tf_tokens.tolist()

    mark("6b")
    # -- 6b. sampling and speculative decoding -------------------------------
    spec_launches = serve_sampled(cfg, params, base, card)

    # -- 6c. dense decode, Flood on Ling-Lite, scoring, telemetry ----------
    t0 = time.perf_counter()
    dense_launches, flood_launches, score_launches = dense_serve(
        cfg, params, base, card)
    dpo_launches = dpo_check(cfg, params, card)
    print(f"[dense] phase 6c took {time.perf_counter() - t0:.1f}s")

    mark("7")
    # -- 7. rwkv6 serving ---------------------------------------------------
    del params          # 31 GiB of bf16 serving weights
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_launches, rwkv_failed = rwkv_serve(card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7b. the reference's other uniform-attention architectures ----------
    t0 = time.perf_counter()
    arch_launches = serve_archs(card, gen)
    print(f"[archs] phase 7b took {time.perf_counter() - t0:.1f}s")

    # -- 7c. the block families: LayerNorm, windows, RG-LRU, whisper --------
    t0 = time.perf_counter()
    family_launches = serve_families(card)
    print(f"[families] phase 7c took {time.perf_counter() - t0:.1f}s")

    mark("8")
    # -- 8. training --------------------------------------------------------
    train_launches, train_hist, p8 = train(card)
    gc.collect()
    torch.cuda.empty_cache()

    mark("8b")
    # -- 8b. checkpoint and exact resume ---------------------------------------
    resume_launches = train_resume(card)

    gc.collect()
    torch.cuda.empty_cache()

    # -- 8c. EDiT local SGD ----------------------------------------------------
    t0 = time.perf_counter()
    edit_launches = train_edit(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[edit] phase 8c took {time.perf_counter() - t0:.1f}s")

    # -- 8d. rwkv6 training ----------------------------------------------------
    t0 = time.perf_counter()
    rwkv_train_launches = train_rwkv(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[rwkv-train] phase 8d took {time.perf_counter() - t0:.1f}s")

    # -- 8e. the block families trained ------------------------------------------
    t0 = time.perf_counter()
    family_train_launches = train_families(card)
    print(f"[families-train] phase 8e took {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()

    mark("9")
    # -- 9. Ling-Lite on a mesh of ranks ------------------------------------------
    t0 = time.perf_counter()
    mesh_launches, hist_9b = mesh_nccl(card, base, train_hist)
    print(f"[mesh-9a] phase 9a took {time.perf_counter() - t0:.1f}s")
    mesh_launches.update(mesh_gloo(card, base, tf_tokens, tf_one, hist_9b))
    mesh_launches.update(mesh_paths(card, base))

    mark("10")
    # -- 10. the dry run against the card -------------------------------------
    dry_run_check(card, base, p8)

    # -- 11. results --------------------------------------------------------
    # (source, TPU kernel it replaces, the row's shape, the path whose
    # launch count the row reports)
    meta = {"fused_moe_ffn": ("src/repro_torch/kernels/csrc/fused_moe_ffn.cu",
                              "src/repro/kernels/grouped_matmul.py:264",
                              "train", "train"),
            "grouped_matmul_aligned": (
                "src/repro_torch/kernels/csrc/grouped_matmul.cu",
                "src/repro/kernels/grouped_matmul.py:124", "up d->ff",
                "train"),
            "grouped_matmul_wgrad": (
                "src/repro_torch/kernels/csrc/grouped_matmul.cu",
                "src/repro/core/moe.py:179", "train", "train"),
            "paged_attn_scores_max": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                                      "src/repro/kernels/paged_attn.py:182",
                                      "decode", "serve"),
            "paged_attn_accumulate": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                                      "src/repro/kernels/paged_attn.py:229",
                                      "decode", "serve"),
            "normhead_matmul": ("src/repro_torch/kernels/csrc/normhead.cu",
                                "src/repro/kernels/normhead.py:54",
                                "rwkv6 head T=8", "rwkv_serve"),
            "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6.py:62", "prefill",
                     "rwkv_serve"),
            # no TPU kernel: the reference's jnp decay
            "rwkv_decay": ("src/repro_torch/kernels/csrc/rwkv_decay.cu",
                           "src/repro/models/rwkv6.py:112", "prefill",
                           "rwkv_serve")}
    launches = {"serve": serve_launches, "spec": spec_launches,
                "dense": dense_launches, "flood_ling": flood_launches,
                "score": score_launches, "dpo": dpo_launches,
                "rwkv_serve": rwkv_launches,
                "serve_ling_plus": arch_launches["ling-plus"],
                "serve_granite": arch_launches["granite-moe-3b-a800m"],
                "train": train_launches,
                "resume_a": resume_launches["a"],
                "resume_b": resume_launches["b"],
                "edit": edit_launches, "rwkv_train": rwkv_train_launches,
                **{f"serve_{a}": family_launches[a]
                   for a, _ in FAMILY_SERVE},
                **{f"train_{a}": family_train_launches[a]
                   for a, _ in FAMILY_TRAIN},
                **mesh_launches}
    rows = []
    for name, shapes in results.items():
        src_path, replaces, main_shape, path = meta[name]
        d = shapes[main_shape]
        rows.append({"name": name, "route": "cuda", "source": src_path,
                     "replaces": replaces,
                     "launches": launches[path][name],
                     "launches_by_path": {p: launches[p].get(name, 0)
                                          for p in launches},
                     "max_abs_err": max(s["max_abs_err"]
                                        for s in shapes.values()),
                     "tolerance": d["tolerance"],
                     "ms": d["ms"], "plain_ms": d["plain_ms"],
                     "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                     "library_ms": d["library_ms"],
                     **{key: d[key] for key in ("device_ms", "host_ms",
                                                "product_ms") if key in d},
                     "shapes": shapes})
    print(json.dumps({"kernels": rows}))
    if rwkv_failed:
        fail("; ".join(rwkv_failed))
    print(f"[time] chip_smoke.py took {time.perf_counter() - t_script:.1f}s"
          f" [{card}]")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
