"""Direct Preference Optimization with the paper's data-packing strategy
(§4.2, C14); the port's counterpart of `repro.training.dpo`.

The paper's claim: padding chosen/rejected pairs to max length wastes most
of the batch; packing keeps the chosen-rejected pairing paradigm while
packing sequences, a **3.7x** DPO throughput win.

  * `sequence_logps`, `dpo_loss` — vanilla DPO with the NLL
    regularization term (weight 0.05, §4.2 'Robustness optimization')
    that keeps chosen log-probs from collapsing; torch ops on (B, S, V)
    fp32 logits;
  * `pad_pairs` vs `pack_pairs` — the two batch layouts, numpy (own copies
    of the reference's builders, equal array for array), and
    `packing_speedup`, their row ratio;
  * `segment_pooled_logps` — per-(pair, chosen/rejected) sums of a packed
    batch's token log-probs.  The sums are `index_put_` with accumulate,
    which on a card sorts the entries by segment and adds each segment's
    in a fixed order, so two runs give the same bits (`index_add_` adds by
    atomics there, in no fixed order).

As in the reference, the model takes no segment ids: a packed row's
segments attend to the earlier segments of the same row (causally), and
`segment_ids` fence only the pooling.  The reference has no DPO train
step, so neither has the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def sequence_logps(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Sum log p(label) over masked positions.  logits (B, S, V) fp32."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((picked - logz) * mask, dim=-1)


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1
    nll_weight: float = 0.05          # §4.2 NLL regularization


def dpo_loss(policy_chosen_lp, policy_rejected_lp,
             ref_chosen_lp, ref_rejected_lp,
             cfg: DPOConfig = DPOConfig(),
             chosen_token_count: Optional[torch.Tensor] = None):
    """Vanilla DPO + NLL regularization on the chosen responses:
    (loss, {"dpo", "nll", "preference_acc"})."""
    ratio = (policy_chosen_lp - ref_chosen_lp
             - (policy_rejected_lp - ref_rejected_lp))
    dpo = -torch.mean(F.logsigmoid(cfg.beta * ratio))
    nll = -torch.mean(policy_chosen_lp
                      / torch.clamp(chosen_token_count, min=1.0)
                      if chosen_token_count is not None
                      else policy_chosen_lp)
    loss = dpo + cfg.nll_weight * nll
    acc = torch.mean((ratio > 0).float())
    return loss, {"dpo": dpo, "nll": nll, "preference_acc": acc}


# ---------------------------------------------------------------------------
# batch layouts: padded pairs vs packed pairs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PairExample:
    prompt: np.ndarray
    chosen: np.ndarray
    rejected: np.ndarray
    format_mask_chosen: Optional[np.ndarray] = None   # DPO-format masking


def pad_pairs(examples: Sequence[PairExample], max_len: int
              ) -> Dict[str, np.ndarray]:
    """Baseline: each of chosen/rejected padded to max_len -> 2B rows."""
    B = len(examples)
    tokens = np.zeros((2 * B, max_len), np.int32)
    mask = np.zeros((2 * B, max_len), np.float32)
    for i, ex in enumerate(examples):
        for j, resp in ((0, ex.chosen), (1, ex.rejected)):
            seq = np.concatenate([ex.prompt, resp])[:max_len]
            row = 2 * i + j
            tokens[row, :len(seq)] = seq
            mask[row, len(ex.prompt):len(seq)] = 1.0
    return {"tokens": tokens, "resp_mask": mask,
            "useful_frac": float(mask.sum() / mask.size)}


def pack_pairs(examples: Sequence[PairExample], max_len: int
               ) -> Dict[str, np.ndarray]:
    """Paper strategy: pack multiple (prompt+chosen+rejected) groups into
    shared rows, keeping each pair's segments adjacent so the
    chosen-rejected pairing paradigm survives.  Segment ids fence the
    per-pair logp pooling (segment 2 i chosen, 2 i + 1 rejected; -1
    padding)."""
    rows: List[List[Tuple[int, np.ndarray, np.ndarray]]] = [[]]
    used = [0]
    pair_id = 0
    for ex in examples:
        group = []
        for j, resp in ((0, ex.chosen), (1, ex.rejected)):
            seq = np.concatenate([ex.prompt, resp])[:max_len]
            m = np.zeros(len(seq), np.float32)
            m[len(ex.prompt):] = 1.0
            group.append((2 * pair_id + j, seq, m))
        need = sum(len(s) for _, s, _ in group)
        if used[-1] + need > max_len and used[-1] > 0:
            rows.append([])
            used.append(0)
        rows[-1].extend(group)
        used[-1] += need
        pair_id += 1
    R = len(rows)
    tokens = np.zeros((R, max_len), np.int32)
    mask = np.zeros((R, max_len), np.float32)
    seg = np.full((R, max_len), -1, np.int32)
    for r, row in enumerate(rows):
        off = 0
        for sid, seq, m in row:
            n = len(seq)
            tokens[r, off:off + n] = seq
            mask[r, off:off + n] = m
            seg[r, off:off + n] = sid
            off += n
    return {"tokens": tokens, "resp_mask": mask, "segment_ids": seg,
            "n_pairs": pair_id,
            "useful_frac": float((seg >= 0).sum() / seg.size)}


def packing_speedup(examples: Sequence[PairExample], max_len: int) -> Dict:
    """Rows processed per pair under each layout: compute cost is ~ rows *
    max_len^2 (attention) + rows * max_len * d, so the row ratio is the
    throughput ratio (the paper's 3.7x)."""
    padded = pad_pairs(examples, max_len)
    packed = pack_pairs(examples, max_len)
    rows_padded = padded["tokens"].shape[0]
    rows_packed = packed["tokens"].shape[0]
    return {"rows_padded": rows_padded, "rows_packed": rows_packed,
            "speedup": rows_padded / rows_packed,
            "useful_frac_padded": padded["useful_frac"],
            "useful_frac_packed": packed["useful_frac"]}


def segment_pooled_logps(logits: torch.Tensor, tokens: torch.Tensor,
                         resp_mask: torch.Tensor, segment_ids: torch.Tensor,
                         n_pairs: int):
    """Per-(pair, chosen/rejected) summed log-probs from packed rows:
    ((chosen (n_pairs,), rejected (n_pairs,)), chosen token counts
    (n_pairs,)), fp32.  logits (R, S, V) fp32; tokens, resp_mask and
    segment_ids (R, S); positions with segment -1 add nothing."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tokens.long()[..., None])[..., 0]
    tok_lp = (picked - logz) * resp_mask
    flat_seg = segment_ids.reshape(-1).long()
    live = flat_seg >= 0
    idx = (flat_seg.clamp_min(0),)
    zeros = torch.zeros((2 * n_pairs,), dtype=torch.float32,
                        device=logits.device)
    sums = zeros.clone().index_put_(
        idx, torch.where(live, tok_lp.reshape(-1).float(), 0.0),
        accumulate=True)
    counts = zeros.index_put_(
        idx, torch.where(live, resp_mask.reshape(-1).float(), 0.0),
        accumulate=True)
    return (sums[0::2], sums[1::2]), counts[0::2]
