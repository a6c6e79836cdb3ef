"""Model-evaluation efficiency subsystem (paper §2.4 "Flood"-backed
evaluation + §5.1.2 benchmark optimization, the third headline
optimization: C-eval); the port's own copy of the framework-free
`repro.evals.harness`.  Its score and decode functions come from the
port's `Runner.make_score_fn` and dense `make_prefill` /
`make_decode_step`.

Implements the paper's three mechanisms:

  1. **Optimized perplexity-based evaluation** (Luan et al. 2025 as cited):
     score option *content* instead of option *labels* ("A"/"B"/...).
     Early in training the model cannot bind labels to options, so
     label-target accuracy is noisy ~chance; content scoring is
     discriminative from the start (reproduced in bench_fig18_eval).
  2. **Optimized generation-based evaluation**: explicit task
     specification in the prompt, answer prefixes to guide continuation,
     and early stopping on a stop token; an extraction step reads the
     answer out of the continuation (the paper's code/math fixes).
  3. **Cross-cluster consistency** (<0.5% average deviation) and the
     **evaluation -> training-data attribution** loop (Fig. 19): eval
     samples and training domains share ability-dimension tags so a score
     regression pinpoints the responsible data segment.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# datasets (synthetic, generated against the synthetic corpus vocabulary)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MCItem:
    """Multiple-choice item: context + K options (token sequences)."""
    context: np.ndarray
    options: List[np.ndarray]          # content sequences
    answer: int
    ability: str = "knowledge"


@dataclasses.dataclass
class GenItem:
    """Generation item: prompt -> expected answer tokens."""
    prompt: np.ndarray
    answer: np.ndarray
    ability: str = "reasoning"


def make_mc_dataset(n: int, vocab: int, seed: int = 0, k: int = 4,
                    ctx_len: int = 12, opt_len: int = 4) -> List[MCItem]:
    """Learnable synthetic MC: the correct option continues the context's
    pattern (tokens shifted by a fixed stride); distractors are random."""
    rs = np.random.RandomState(seed)
    items = []
    for i in range(n):
        stride = 7 + (i % 5)
        base = rs.randint(0, vocab - 64)
        ctx = (base + stride * np.arange(ctx_len)) % vocab
        correct = (base + stride * (ctx_len + np.arange(opt_len))) % vocab
        options = [rs.randint(0, vocab, opt_len) for _ in range(k)]
        ans = rs.randint(k)
        options[ans] = correct
        items.append(MCItem(ctx.astype(np.int32),
                            [o.astype(np.int32) for o in options], ans,
                            ability=["knowledge", "math", "code"][i % 3]))
    return items


def make_gen_dataset(n: int, vocab: int, seed: int = 1,
                     prompt_len: int = 10, ans_len: int = 3
                     ) -> List[GenItem]:
    rs = np.random.RandomState(seed)
    items = []
    for i in range(n):
        stride = 3 + (i % 4)
        base = rs.randint(0, vocab - 64)
        prompt = (base + stride * np.arange(prompt_len)) % vocab
        ans = (base + stride * (prompt_len + np.arange(ans_len))) % vocab
        items.append(GenItem(prompt.astype(np.int32), ans.astype(np.int32),
                             ability=["math", "code"][i % 2]))
    return items


# ---------------------------------------------------------------------------
# perplexity-based evaluation
# ---------------------------------------------------------------------------

ScoreFn = Callable[[np.ndarray, np.ndarray], float]
# score_fn(tokens (S,), mask (S,)) -> sum log p(tokens[t] | tokens[<t])
# over masked positions.


def ppl_eval_content(items: Sequence[MCItem], score_fn: ScoreFn
                     ) -> Dict[str, float]:
    """Paper-optimized: rank options by (length-normalized) content
    log-likelihood given the context."""
    correct = 0
    per_ability: Dict[str, List[int]] = {}
    for it in items:
        scores = []
        for opt in it.options:
            seq = np.concatenate([it.context, opt])
            mask = np.zeros(len(seq))
            mask[len(it.context):] = 1.0
            scores.append(score_fn(seq, mask) / max(len(opt), 1))
        pred = int(np.argmax(scores))
        hit = int(pred == it.answer)
        correct += hit
        per_ability.setdefault(it.ability, []).append(hit)
    return {"accuracy": correct / len(items),
            **{f"ability/{a}": float(np.mean(v))
               for a, v in per_ability.items()}}


def ppl_eval_label(items: Sequence[MCItem], score_fn: ScoreFn,
                   label_tokens: Sequence[int]) -> Dict[str, float]:
    """Baseline: append all options to the context and score only the
    single *label token* ("A"/"B"/...) — the unstable early-training
    evaluation the paper replaces."""
    correct = 0
    for it in items:
        body = np.concatenate([it.context] + [
            np.concatenate([[label_tokens[j]], o])
            for j, o in enumerate(it.options)])
        scores = []
        for j in range(len(it.options)):
            seq = np.concatenate([body, [label_tokens[j]]]).astype(np.int32)
            mask = np.zeros(len(seq))
            mask[-1] = 1.0
            scores.append(score_fn(seq, mask))
        correct += int(int(np.argmax(scores)) == it.answer)
    return {"accuracy": correct / len(items)}


# ---------------------------------------------------------------------------
# generation-based evaluation
# ---------------------------------------------------------------------------

DecodeFn = Callable[[np.ndarray, int], np.ndarray]
# decode_fn(prompt (S,), max_new) -> generated tokens (<= max_new,)


def gen_eval(items: Sequence[GenItem], decode_fn: DecodeFn, *,
             task_prefix: Optional[np.ndarray] = None,
             stop_token: Optional[int] = None,
             max_new: int = 8) -> Dict[str, float]:
    """Generation eval with the paper's fixes: explicit task prefix,
    early stopping, and answer extraction (first len(answer) tokens)."""
    correct = 0
    for it in items:
        prompt = it.prompt
        if task_prefix is not None:
            prompt = np.concatenate([task_prefix, prompt])
        out = decode_fn(prompt.astype(np.int32), max_new)
        if stop_token is not None:
            stop = np.where(out == stop_token)[0]
            if len(stop):
                out = out[:stop[0]]
        ans = out[:len(it.answer)]
        correct += int(len(ans) == len(it.answer)
                       and np.array_equal(ans, it.answer))
    return {"accuracy": correct / len(items)}


# ---------------------------------------------------------------------------
# cross-cluster consistency (paper: average deviation < 0.5%)
# ---------------------------------------------------------------------------


def consistency(run_a: Dict[str, float], run_b: Dict[str, float]
                ) -> Dict[str, float]:
    keys = sorted(set(run_a) & set(run_b))
    devs = [abs(run_a[k] - run_b[k]) for k in keys]
    return {"mean_abs_deviation": float(np.mean(devs)) if devs else 0.0,
            "max_abs_deviation": float(np.max(devs)) if devs else 0.0}


# ---------------------------------------------------------------------------
# evaluation -> training-data attribution (Fig. 19)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AttributionReport:
    regressed_abilities: List[str]
    suspect_domains: List[str]
    details: Dict[str, float]


# ability dimension -> the training domains that feed it
DOMAIN_ABILITIES = {
    "web": ["knowledge"],
    "books": ["knowledge"],
    "code": ["code"],
    "math": ["math", "reasoning"],
    "encyclopedia": ["knowledge"],
}


def attribute_regression(before: Dict[str, float], after: Dict[str, float],
                         threshold: float = 0.05) -> AttributionReport:
    """Map per-ability score drops back to the training-data domains that
    carry those abilities (the paper's real-time feedback loop)."""
    regressed = []
    details = {}
    for k, v in after.items():
        if not k.startswith("ability/"):
            continue
        drop = before.get(k, v) - v
        details[k] = drop
        if drop > threshold:
            regressed.append(k.split("/", 1)[1])
    suspects = sorted({d for d, abl in DOMAIN_ABILITIES.items()
                       if any(a in abl for a in regressed)})
    return AttributionReport(regressed, suspects, details)
