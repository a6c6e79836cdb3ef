"""Synthetic pre-training data pipeline (paper §3.1 mechanisms; own copy
of `repro.data.pipeline`, numpy only: the same seed gives the same
batches as the reference's).

  * multi-domain mixture sampling with adjustable weights;
  * quality tiers per domain with tier-weighted selection;
  * sample-level online deduplication during mixing (§3.4.1), via
    content hashing;
  * sequence packing to fixed seq_len with document separators;
  * batch-size warmup (§3.4.1) — `next_macrobatch(accum)` serves the
    engine's scheduled-accumulation warmup at a fixed microbatch shape;
  * a retry lane for spike-affected batches (§3.4.4): saved samples are
    randomly re-injected into subsequent batches, regranulated when the
    warmup stage changed in between.

Each synthetic domain is a distinct Zipfian token distribution with
domain-specific n-gram structure.  `set_mixture` adjusts the mixture
live; `state_dict` / `load_state_dict` and the `Prefetcher`'s `preload`
and `paused` let a checkpoint continue the stream exactly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, \
    Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DomainSpec:
    name: str
    weight: float
    quality: float = 1.0        # quality tier in [0, 1]
    zipf_a: float = 1.3         # token distribution skew
    seed: int = 0
    doc_len_mean: int = 512


class SyntheticDomain:
    """A stream of documents with a domain-specific token distribution."""

    def __init__(self, spec: DomainSpec, vocab_size: int):
        self.spec = spec
        self.vocab = vocab_size
        self.rng = np.random.RandomState(spec.seed)
        # domain signature: a fixed permutation makes token stats distinct
        self.perm = np.random.RandomState(spec.seed + 9999).permutation(
            vocab_size)

    def next_doc(self) -> np.ndarray:
        n = max(8, int(self.rng.exponential(self.spec.doc_len_mean)))
        # Zipf over a domain-permuted vocabulary + simple bigram structure
        raw = self.rng.zipf(self.spec.zipf_a, size=n)
        toks = self.perm[np.clip(raw, 1, self.vocab - 1)]
        # inject repetition structure (makes LM loss learnable)
        for i in range(2, n, 7):
            toks[i] = toks[i - 2]
        return toks.astype(np.int32)


class DedupFilter:
    """Sample-level online dedup (hash of token content)."""

    def __init__(self, max_entries: int = 1_000_000):
        self.seen: set = set()
        self.max = max_entries
        self.dropped = 0

    def admit(self, tokens: np.ndarray) -> bool:
        h = hashlib.blake2b(tokens.tobytes(), digest_size=8).digest()
        if h in self.seen:
            self.dropped += 1
            return False
        if len(self.seen) < self.max:
            self.seen.add(h)
        return True


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    domains: Sequence[DomainSpec] = ()
    dedup: bool = True
    seed: int = 0
    bos_token: int = 1
    retry_injection_prob: float = 0.25


def default_domains(seed: int = 0) -> List[DomainSpec]:
    return [
        DomainSpec("web", 0.5, quality=0.6, zipf_a=1.25, seed=seed + 1),
        DomainSpec("books", 0.15, quality=0.9, zipf_a=1.4, seed=seed + 2),
        DomainSpec("code", 0.2, quality=0.85, zipf_a=1.15, seed=seed + 3,
                   doc_len_mean=1024),
        DomainSpec("math", 0.1, quality=0.95, zipf_a=1.5, seed=seed + 4),
        DomainSpec("encyclopedia", 0.05, quality=0.9, zipf_a=1.35,
                   seed=seed + 5),
    ]


class DataPipeline:
    """All public methods are safe to call concurrently from the trainer's
    main thread and the `Prefetcher` worker: every mutation of the shared
    stream state (rng, packing buffer, dedup set, retry lane, stats) runs
    under one internal re-entrant lock.  Previously the worker held only
    the *prefetcher's* lock, so a main-thread `push_retry` (spike drain)
    or `state_dict` (non-prefetching checkpoint) raced the producer."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        domains = list(cfg.domains) or default_domains(cfg.seed)
        self.domains = [SyntheticDomain(d, cfg.vocab_size) for d in domains]
        total = sum(d.weight * d.quality for d in domains)
        self.probs = np.array([d.weight * d.quality for d in domains]) / total
        self.rng = np.random.RandomState(cfg.seed)
        self.dedup = DedupFilter() if cfg.dedup else None
        self.buffer = np.zeros((0,), np.int32)
        # retry lane entries are (accum, batch): the accumulation count
        # the batch was packed for, so re-injection can replay at a
        # compatible granularity after a batch-size-warmup stage change
        self.retry_queue: Deque[Tuple[int, Dict[str, np.ndarray]]] = deque()
        self.stats = {"docs": 0, "dedup_dropped": 0, "retry_injected": 0}
        self._lock = threading.RLock()

    def set_mixture(self, weights: Dict[str, float]):
        """Adjust the data mixture live (§3.4.1 'adjustments to the mix')."""
        with self._lock:
            w = np.array([weights.get(d.spec.name, d.spec.weight)
                          * d.spec.quality for d in self.domains])
            self.probs = w / w.sum()

    def _fill(self, n_tokens: int):
        parts = [self.buffer]
        have = len(self.buffer)
        while have < n_tokens:
            di = self.rng.choice(len(self.domains), p=self.probs)
            doc = self.domains[di].next_doc()
            self.stats["docs"] += 1
            if self.dedup is not None and not self.dedup.admit(doc):
                self.stats["dedup_dropped"] += 1
                continue
            parts.append(np.array([self.cfg.bos_token], np.int32))
            parts.append(doc)
            have += len(doc) + 1
        self.buffer = np.concatenate(parts)

    def push_retry(self, batch: Dict[str, np.ndarray],
                   accum_steps: Optional[int] = None):
        """Queue a spike-skipped batch for later re-injection (§3.4.4).
        `accum_steps` is the granularity the batch was packed for;
        omitted, it is inferred from the leading macrobatch dim."""
        if accum_steps is None:
            t = batch["tokens"]
            accum_steps = int(t.shape[0]) if t.ndim == 3 else 1
        with self._lock:
            self.retry_queue.append((int(accum_steps), batch))

    def _pop_retry(self) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
        if (self.retry_queue
                and self.rng.rand() < self.cfg.retry_injection_prob):
            self.stats["retry_injected"] += 1
            return self.retry_queue.popleft()
        return None

    def _fresh_batch(self, batch_size: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
        """One freshly-packed (B, S) batch, bypassing the retry lane."""
        B = batch_size or self.cfg.batch_size
        S = self.cfg.seq_len
        need = B * (S + 1)
        self._fill(need)
        flat = self.buffer[:need].reshape(B, S + 1)
        self.buffer = self.buffer[need:]
        return {"tokens": flat[:, :-1].copy(),
                "labels": flat[:, 1:].copy()}

    @staticmethod
    def _split_micro(accum: int, batch: Dict[str, np.ndarray]
                     ) -> List[Dict[str, np.ndarray]]:
        if accum <= 1:
            return [batch]
        return [{k: v[i] for k, v in batch.items()} for i in range(accum)]

    @staticmethod
    def _stack_micro(mbs: List[Dict[str, np.ndarray]]
                     ) -> Dict[str, np.ndarray]:
        return {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}

    def next_batch(self, batch_size: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """(B, S) packed tokens + next-token labels."""
        with self._lock:
            entry = self._pop_retry()
            if entry is not None:
                accum, batch = entry
                if accum <= 1:
                    return batch
                # macrobatch retry replayed at batch granularity: hand out
                # the first microbatch, requeue the remainder
                micros = self._split_micro(accum, batch)
                self._requeue(micros[1:])
                return micros[0]
            return self._fresh_batch(batch_size)

    def _requeue(self, micros: List[Dict[str, np.ndarray]]):
        if not micros:
            return
        if len(micros) == 1:
            self.retry_queue.appendleft((1, micros[0]))
        else:
            self.retry_queue.appendleft((len(micros),
                                         self._stack_micro(micros)))

    def next_macrobatch(self, accum_steps: int = 1) -> Dict[str, np.ndarray]:
        """Batch for one engine step.  ``accum_steps == 1`` is exactly
        `next_batch`; otherwise leaves gain a leading microbatch dim
        ``(accum, B, S)``.  Retry-lane entries remember the accum count
        they were packed for: an exact match replays whole; a mismatch
        (batch-size-warmup stage change between skip and re-injection) is
        regranulated — split into microbatches, topped up with fresh
        data, the overflow requeued — so no stream positions are lost."""
        A = max(1, int(accum_steps))
        if A == 1:
            return self.next_batch()
        with self._lock:
            entry = self._pop_retry()
            if entry is None:
                return self._stack_micro(
                    [self._fresh_batch() for _ in range(A)])
            accum, batch = entry
            if accum == A:
                return batch
            micros = self._split_micro(accum, batch)
            if len(micros) > A:
                self._requeue(micros[A:])
                micros = micros[:A]
            while len(micros) < A:
                micros.append(self._fresh_batch())
            return self._stack_micro(micros)

    # -- checkpoint resume (exact stream continuation) ----------------------
    def state_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "rng": self.rng.get_state(),
                "buffer": self.buffer.copy(),
                "retry_queue": list(self.retry_queue),
                "stats": dict(self.stats),
                "dedup_seen": (set(self.dedup.seen) if self.dedup else None),
                "dedup_dropped": (self.dedup.dropped if self.dedup else 0),
                "domain_rngs": [d.rng.get_state() for d in self.domains],
                "probs": self.probs.copy(),
            }

    def load_state_dict(self, s: Dict[str, Any]):
        with self._lock:
            self.rng.set_state(s["rng"])
            self.buffer = s["buffer"].copy()
            self.retry_queue = deque(s["retry_queue"])
            self.stats = dict(s["stats"])
            if self.dedup is not None and s["dedup_seen"] is not None:
                self.dedup.seen = set(s["dedup_seen"])
                self.dedup.dropped = s["dedup_dropped"]
            for d, st in zip(self.domains, s["domain_rngs"]):
                d.rng.set_state(st)
            self.probs = s["probs"].copy()

    def batches(self, n: int, bs_schedule=None) -> Iterator[Dict]:
        for i in range(n):
            bs = bs_schedule(i) if bs_schedule else None
            yield self.next_batch(bs)

class Prefetcher:
    """Background-thread batch prefetch: host packing for step i+1..i+depth
    runs while the device executes step i (jax dispatch is async, so the
    trainer's `get()` typically returns a ready batch without blocking).

    The producer thread holds `lock` while calling `fn` (which mutates the
    pipeline's rng/buffer), so `snapshot()` can atomically capture
    (pipeline state, queued-but-unconsumed batches) for exact checkpoint
    resume — the queued batches are persisted and re-seeded via `preload`.
    """

    def __init__(self, fn: Callable[[], Dict[str, np.ndarray]],
                 depth: int = 2, preload: Optional[List[Dict]] = None):
        self.fn = fn
        self.lock = threading.Lock()
        self._q: Deque = deque(preload or [])
        self._items = threading.Semaphore(len(self._q))
        self._space = threading.Semaphore(max(0, depth - len(self._q)))
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            self._space.acquire()
            if self._stop:
                return
            try:
                with self.lock:
                    if self._stop:
                        return
                    b = self.fn()
                    self._q.append(b)
            except BaseException as e:  # noqa: BLE001 — re-raised in get()
                self._error = e
                self._items.release()   # wake the consumer to see it
                return
            self._items.release()

    def get(self) -> Dict[str, np.ndarray]:
        self._items.acquire()
        if self._error is not None:
            self._items.release()   # keep later get() calls failing fast
            raise RuntimeError("prefetch producer failed") from self._error
        with self.lock:
            b = self._q.popleft()
        self._space.release()
        return b

    @contextlib.contextmanager
    def paused(self):
        """Context manager quiescing the producer; yields the queued
        (prefetched but unconsumed) batches.  Call the pipeline's
        `state_dict()` inside the block so checkpointed pipeline state and
        pending batches are mutually consistent."""
        with self.lock:
            yield list(self._q)

    def stop(self):
        """Blocks until the producer thread has fully exited — callers
        (e.g. Trainer.restore) mutate the pipeline right after."""
        # deliberately lock-free: a GIL-atomic bool flip the worker polls;
        # taking self.lock here could deadlock against a producer blocked
        # inside the locked produce section
        self._stop = True          # flopcheck: disable=FC-LOCK
        self._space.release()      # unblock the worker
        self._thread.join()
