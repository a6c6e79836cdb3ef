"""The serving engines' memory managers (the port's own copy of
`repro.serving.segment_cache`; host-side numpy only).

`SegmentCache` (paper §2.4, C12) is the offline Flood engine's: the KV
cache is one contiguous range of token rows carved into segments; on
overflow a request's segment is extended if the next range is free, else
another segment is appended, else the request waits.  A shared prompt
prefix is a refcounted segment-list prefix.

`PageAllocator` and `RadixNode` are the online engine's: its device KV
lives in pools of fixed-size pages indexed by per-slot page tables, and
the allocator owns the physical pages: admission,
`ensure_capacity` growth, refcounted prefix-page sharing, and
preempt-and-requeue support when the pool runs dry.  On top sits the
radix prefix cache: a trie keyed by page-aligned token blocks, so a
node's root path spells the exact token prefix whose KV its page holds.
Requests attach matching pages at admission, full pages are published
into the trie when a request finishes prefill / releases / is
preempted, and a deterministic leaf-first LRU sweep evicts unreferenced
cached pages only when an allocation would otherwise fail.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Segment:
    start: int
    length: int
    refcount: int = 1

    @property
    def end(self) -> int:
        return self.start + self.length


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new: int
    segments: List[Segment] = dataclasses.field(default_factory=list)
    used: int = 0                      # tokens written so far
    prefix_key: Optional[str] = None   # shared-prefix cache key

    @property
    def capacity(self) -> int:
        return sum(s.length for s in self.segments)

    def slot(self, token_idx: int) -> int:
        """Global cache row for this request's token_idx."""
        off = token_idx
        for s in self.segments:
            if off < s.length:
                return s.start + off
            off -= s.length
        raise IndexError(token_idx)


class SegmentCache:
    def __init__(self, max_tokens: int, initial_segment: int = 256,
                 extend_chunk: int = 256):
        self.max_tokens = max_tokens
        self.initial = initial_segment
        self.chunk = extend_chunk
        self.free: List[Tuple[int, int]] = [(0, max_tokens)]  # (start, len)
        self.requests: Dict[int, Request] = {}
        self.wait_list: Deque[int] = deque()
        self.prefix_index: Dict[str, List[Segment]] = {}
        self.stats = {"extends": 0, "appends": 0, "waits": 0,
                      "prefix_hits": 0}

    # -- free-list helpers --------------------------------------------------
    def _alloc_range(self, length: int) -> Optional[Tuple[int, int]]:
        for i, (start, flen) in enumerate(self.free):
            if flen >= length:
                if flen == length:
                    self.free.pop(i)
                else:
                    self.free[i] = (start + length, flen - length)
                return (start, length)
        return None

    def _release_range(self, start: int, length: int):
        self.free.append((start, length))
        self.free.sort()
        merged: List[Tuple[int, int]] = []
        for s, l in self.free:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + l)
            else:
                merged.append((s, l))
        self.free = merged

    def _range_free_at(self, start: int, length: int) -> bool:
        for s, l in self.free:
            if s <= start and start + length <= s + l:
                return True
        return False

    # -- admission -----------------------------------------------------------
    def admit(self, rid: int, prompt_len: int, max_new: int,
              prefix_key: Optional[str] = None,
              conservative: bool = True) -> bool:
        """Allocate an initial segment.  With `conservative` (the paper's
        strategy for huge user-specified max_output_len), the first segment
        covers the prompt plus a modest chunk rather than prompt+max_new."""
        req = Request(rid, prompt_len, max_new, prefix_key=prefix_key)
        need = prompt_len
        if prefix_key and prefix_key in self.prefix_index:
            # prefix cache hit: share the refcounted prefix segments
            shared = self.prefix_index[prefix_key]
            for s in shared:
                s.refcount += 1
            req.segments.extend(shared)
            req.used = sum(s.length for s in shared)
            need = max(prompt_len - req.used, 0)
            self.stats["prefix_hits"] += 1
        grow = self.initial if conservative else max_new
        rng = self._alloc_range(need + grow)
        if rng is None:
            self.stats["waits"] += 1
            self.wait_list.append(rid)
            return False
        req.segments.append(Segment(*rng))
        self.requests[rid] = req
        return True

    def register_prefix(self, rid: int, key: str, upto_segment: int = 1):
        req = self.requests[rid]
        shared = req.segments[:upto_segment]
        for s in shared:
            s.refcount += 1
        self.prefix_index[key] = shared

    # -- token append ----------------------------------------------------------
    def ensure_capacity(self, rid: int, n_tokens: int) -> bool:
        """Grow the request to hold n_tokens; extend > append > wait."""
        req = self.requests[rid]
        while req.capacity < n_tokens:
            last = req.segments[-1]
            # 1. extend in place if the adjacent range is free
            if last.refcount == 1 and self._range_free_at(last.end,
                                                          self.chunk):
                # carve the adjacent chunk out of the free list
                for i, (s, l) in enumerate(self.free):
                    if s <= last.end < s + l:
                        before = last.end - s
                        after = l - before - self.chunk
                        repl = []
                        if before:
                            repl.append((s, before))
                        if after:
                            repl.append((last.end + self.chunk, after))
                        self.free[i:i + 1] = repl
                        break
                last.length += self.chunk
                self.stats["extends"] += 1
                continue
            # 2. append a new segment anywhere
            rng = self._alloc_range(self.chunk)
            if rng is not None:
                req.segments.append(Segment(*rng))
                self.stats["appends"] += 1
                continue
            # 3. wait
            self.stats["waits"] += 1
            self.wait_list.append(rid)
            return False
        return True

    def write_token(self, rid: int) -> Optional[int]:
        """Reserve the next cache row; None if the request must wait."""
        req = self.requests[rid]
        if not self.ensure_capacity(rid, req.used + 1):
            return None
        slot = req.slot(req.used)
        req.used += 1
        return slot

    def write_tokens(self, rid: int, n: int) -> Optional[List[int]]:
        """Multi-token advance (speculative decode commits n accepted
        tokens at once): reserve the next n rows atomically; None if the
        request must wait (nothing reserved on failure)."""
        req = self.requests[rid]
        if not self.ensure_capacity(rid, req.used + n):
            return None
        rows = [req.slot(req.used + i) for i in range(n)]
        req.used += n
        return rows

    def rewind(self, rid: int, n: int):
        """Multi-token rewind (rejected speculative drafts): forget the
        last n written rows.  Rows written beyond a shared prefix only —
        a consumer never writes into refcounted shared segments, so the
        floor is the shared capacity it attached at admission."""
        req = self.requests[rid]
        floor = sum(s.length for s in req.segments if s.refcount > 1)
        req.used = max(req.used - n, floor, req.prompt_len)

    # -- preemption ----------------------------------------------------------
    def preempt(self, rid: int) -> List[int]:
        """Evict a live request mid-generation (pool pressure): frees its
        ranges exactly like `release` (refcount-aware, waiters revived);
        the caller owns re-admission — `admit` the same rid again later
        and re-prefill.  Returns the revived waiter rids."""
        self.stats["preempts"] = self.stats.get("preempts", 0) + 1
        return self.release(rid)

    # -- release -------------------------------------------------------------
    def release(self, rid: int) -> List[int]:
        """Free a finished request; returns rids revived from the wait
        list."""
        req = self.requests.pop(rid)
        for s in req.segments:
            s.refcount -= 1
            if s.refcount == 0:
                self._release_range(s.start, s.length)
        revived = []
        still_waiting: Deque[int] = deque()
        while self.wait_list:
            w = self.wait_list.popleft()
            if w in self.requests:
                revived.append(w)       # parked mid-generation
            else:
                still_waiting.append(w)
        self.wait_list = still_waiting
        return revived

    # -- invariants (used by property tests) -----------------------------------
    def live_ranges(self) -> List[Tuple[int, int]]:
        seen = {}
        out = []
        for req in self.requests.values():
            for s in req.segments:
                if id(s) not in seen:
                    seen[id(s)] = True
                    out.append((s.start, s.length))
        return sorted(out)

    def check_invariants(self):
        ranges = self.live_ranges() + sorted(self.free)
        ranges.sort()
        pos = 0
        total = 0
        for s, l in ranges:
            assert s >= pos, f"overlap at {s} (pos={pos})"
            pos = s + l
            total += l
        assert pos <= self.max_tokens
        # free list coalesced
        for (s1, l1), (s2, _) in zip(self.free, self.free[1:]):
            assert s1 + l1 < s2, "free list not coalesced"


# ---------------------------------------------------------------------------
# Page-table allocator — the online engine's memory manager
# ---------------------------------------------------------------------------
#
# `SegmentCache` above is Flood's host-side bookkeeping over one contiguous
# token arena: segments are variable-length ranges and the device cache
# stays a dense tensor the host indexes into.  The *online* engine
# (serving/online.py) instead stores KV on device as a pool of fixed-size
# pages indexed by per-slot page tables, so this allocator is the
# page-granular refactor of the same responsibilities: admission,
# `ensure_capacity` growth, prefix-cache sharing (refcounted *pages*
# instead of refcounted segments), and preempt-and-requeue when the pool
# runs dry.  Fixed-size pages trade SegmentCache's large contiguous
# blocks for O(1) allocation and zero external fragmentation — the trade
# vLLM made, and the right one once the device side gathers pages anyway.
#
# On top of the page pool sits the **radix prefix cache**: a trie keyed
# by page-aligned token blocks, so a node's root-path spells the exact
# token prefix whose KV its page holds.  Requests attach matching pages
# at admission with no caller coordination (content addressing replaces
# the explicit `prefix_key` registry, which survives for legacy callers),
# full pages are *published* into the trie when a request finishes
# prefill / releases / is preempted, and a deterministic leaf-first LRU
# sweep evicts unreferenced cached pages only when an allocation would
# otherwise fail — caching can never cause an OOM an uncached run would
# not hit.


@dataclasses.dataclass
@dataclasses.dataclass
class RadixNode:
    """One cached KV page.  `key` is the page's own token block; the
    concatenated keys on the root path are the full token prefix the
    page's KV was computed under (depth == logical page index, so
    absolute positions match by construction)."""
    key: Tuple[int, ...]
    page: int
    parent: Optional["RadixNode"]
    node_id: int                     # creation order (LRU tie-break)
    children: Dict[Tuple[int, ...], "RadixNode"] = \
        dataclasses.field(default_factory=dict)
    last_used: int = 0


class PageAllocator:
    """Host-side physical-page allocator for the paged device KV pools.

    Page 0 is reserved as the device scratch page (masked lanes write
    there) and is never handed out; page ids in tables are therefore
    always >= 1 for allocated logical pages and 0 for "unallocated".
    Free pages are recycled LIFO from a deterministic stack so identical
    op sequences produce identical page tables (the compile-count and
    parity tests rely on this).
    """

    def __init__(self, n_pages: int, page_size: int, reserved: int = 1):
        if n_pages <= reserved:
            raise ValueError(f"n_pages={n_pages} <= reserved={reserved}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.reserved = reserved
        self.free_list: List[int] = list(range(n_pages - 1, reserved - 1,
                                               -1))   # pop() -> lowest id
        self.refcount: Dict[int, int] = {}
        self.pages: Dict[int, List[int]] = {}         # rid -> logical order
        self.shared_len: Dict[int, int] = {}          # rid -> prefix tokens
        self.prefix_index: Dict[str, List[int]] = {}
        # radix prefix cache: trie over page-aligned token blocks; each
        # node holds one refcount on its page
        self.radix_root = RadixNode(key=(), page=-1, parent=None,
                                    node_id=0)
        self._clock = 0                # LRU timestamp (bumped per op)
        self._next_node_id = 1
        self.stats = {"allocs": 0, "frees": 0, "prefix_hits": 0,
                      "preempts": 0, "alloc_failures": 0, "trims": 0,
                      "radix_hit_tokens": 0, "published": 0, "dedups": 0,
                      "evictions": 0}
        # telemetry hook: called with the page id for every radix-cache
        # eviction (the OnlineEngine wires this to its request log /
        # metrics registry; see docs/observability.md).  Host-side only.
        self.on_evict: Optional[Callable[[int], None]] = None

    # -- queries --------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self.free_list)

    @property
    def pages_in_use(self) -> int:
        """Allocatable pages currently held (by requests, the trie, or
        pinned prefixes) — the occupancy number the engine samples into
        its `page_pool_occupancy` counter track every tick."""
        return self.n_pages - self.reserved - len(self.free_list)

    def capacity(self, rid: int) -> int:
        """Tokens the request's current pages can hold."""
        return len(self.pages[rid]) * self.page_size

    def table_row(self, rid: int, width: int):
        """The request's page table padded to `width` logical pages with
        the 0 sentinel (ready to land in the device table)."""
        row = np.zeros((width,), np.int32)
        pages = self.pages[rid]
        if len(pages) > width:
            raise ValueError(f"request {rid} holds {len(pages)} pages > "
                             f"table width {width}")
        row[:len(pages)] = pages
        return row

    # -- radix trie helpers ---------------------------------------------------
    def _blocks(self, tokens) -> List[Tuple[int, ...]]:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(len(tokens) // ps)]

    def _iter_radix(self):
        stack = list(self.radix_root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    @property
    def n_cached_pages(self) -> int:
        """Pages currently held by the radix trie (some may also be
        attached to live requests)."""
        return sum(1 for _ in self._iter_radix())

    def match_radix(self, tokens) -> List[RadixNode]:
        """Longest trie match over the page-aligned blocks of `tokens`
        (read-only: no refcounts or LRU stamps change)."""
        node, out = self.radix_root, []
        for key in self._blocks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def publish_radix(self, rid: int, tokens) -> int:
        """Publish the request's leading full pages into the trie, keyed
        by the token content (`tokens` = the token whose KV each written
        row holds, in row order).  Content-duplicate pages — a second
        request that raced the same prefix through prefill — are deduped
        against the existing node, so identical prefixes are stored once
        no matter how many requests computed them.  Returns the number of
        pages newly published."""
        pages = self.pages[rid]
        n_full = min(len(tokens) // self.page_size, len(pages))
        self._clock += 1
        node, new = self.radix_root, 0
        for i, key in enumerate(self._blocks(tokens)[:n_full]):
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key=key, page=pages[i], parent=node,
                                  node_id=self._next_node_id)
                self._next_node_id += 1
                node.children[key] = child
                self.refcount[pages[i]] += 1
                new += 1
                self.stats["published"] += 1
            elif child.page != pages[i]:
                # same content already cached under a different physical
                # page (the _prefill_tick auto-publish race, content-
                # addressed): keep the cached copy, the request's private
                # duplicate recycles normally on release
                self.stats["dedups"] += 1
            child.last_used = self._clock
            node = child
        return new

    def _drop_node(self, node: RadixNode):
        del node.parent.children[node.key]
        self._free_page_ref(node.page)

    def evict_radix(self, n: int) -> int:
        """Evict up to `n` unreferenced cached pages, deterministic
        leaf-first LRU: only childless nodes whose page no live request
        (or explicit prefix entry) still references are candidates; the
        least-recently-used goes first (node_id breaks ties).  Interior
        nodes become evictable as their subtrees drain, so a cold chain
        dies tail-first while its hot prefix survives."""
        freed = 0
        while freed < n:
            best = None
            for node in self._iter_radix():
                if node.children or self.refcount[node.page] != 1:
                    continue
                if (best is None
                        or (node.last_used, node.node_id)
                        < (best.last_used, best.node_id)):
                    best = node
            if best is None:
                return freed
            evicted_page = best.page
            self._drop_node(best)
            freed += 1
            self.stats["evictions"] += 1
            if self.on_evict is not None:
                self.on_evict(evicted_page)
        return freed

    def flush_radix(self) -> int:
        """Drop every cached trie entry (pages still attached to live
        requests survive until those release).  Returns nodes dropped."""
        n = 0
        for node in list(self._iter_radix()):
            self._free_page_ref(node.page)
            n += 1
        self.radix_root.children.clear()
        return n

    # -- admission ------------------------------------------------------------
    def admit(self, rid: int, prefix_key: Optional[str] = None,
              prompt_len: Optional[int] = None, tokens=None) -> int:
        """Bind a request; attach refcounted prefix pages on a hit.

        With `tokens` (the token sequence the request will prefill), the
        attach is **content-addressed**: the radix trie is walked with
        the page-aligned blocks of `tokens` and every matching cached
        page attaches automatically — no caller coordination.  The match
        is exact by construction, so no clamp is needed beyond full-page
        coverage of the request's own tokens.

        The legacy path attaches `prefix_key`'s published pages, capped
        by `prompt_len` — a consumer whose prompt is shorter than the
        published prefix must not attach (and later decode-write into)
        shared pages beyond it.

        Returns the number of tokens already covered (0 on a miss) —
        the engine starts prefilling there."""
        assert rid not in self.pages, f"rid {rid} already admitted"
        self.pages[rid] = []
        self.shared_len[rid] = 0
        if tokens is not None:
            matched = self.match_radix(tokens)
            self._clock += 1
            for node in matched:
                self.refcount[node.page] += 1
                node.last_used = self._clock
            self.pages[rid] = [n.page for n in matched]
            self.shared_len[rid] = len(matched) * self.page_size
            if matched:
                self.stats["prefix_hits"] += 1
                self.stats["radix_hit_tokens"] += self.shared_len[rid]
        elif prefix_key and prefix_key in self.prefix_index:
            shared = self.prefix_index[prefix_key]
            if prompt_len is not None:
                shared = shared[:prompt_len // self.page_size]
            for p in shared:
                self.refcount[p] += 1
            self.pages[rid] = list(shared)
            self.shared_len[rid] = len(shared) * self.page_size
            self.stats["prefix_hits"] += 1
        return self.shared_len[rid]

    def register_prefix(self, rid: int, key: str, n_tokens: int):
        """Publish the request's leading full pages as a shared prefix.
        Only complete pages are shared (a partial page would need
        copy-on-write for the writes that follow it).  Re-registering a
        key first releases the old entry's refcounts."""
        if key in self.prefix_index:
            self.drop_prefix(key)
        full = n_tokens // self.page_size
        shared = self.pages[rid][:full]
        for p in shared:
            self.refcount[p] += 1
        self.prefix_index[key] = shared

    # -- growth ---------------------------------------------------------------
    def ensure_capacity(self, rid: int, n_tokens: int) -> bool:
        """Grow the request to hold n_tokens; all-or-nothing so a failed
        grow never strands half an allocation.  When the free list is
        short, unreferenced radix-cached pages are evicted (leaf-first
        LRU) to cover the gap — cached pages never block an allocation
        an uncached run could satisfy.  False = pool genuinely exhausted
        (caller preempts a victim and retries, or parks the request)."""
        need = -(-n_tokens // self.page_size) - len(self.pages[rid])
        if need <= 0:
            return True
        if need > len(self.free_list):
            self.evict_radix(need - len(self.free_list))
        if need > len(self.free_list):
            self.stats["alloc_failures"] += 1
            return False
        for _ in range(need):
            p = self.free_list.pop()
            self.refcount[p] = 1
            self.pages[rid].append(p)
            self.stats["allocs"] += 1
        return True

    def trim(self, rid: int, n_tokens: int):
        """Rewind the page-table tail to exactly the pages n_tokens need
        (speculative decode: the verify pass grows a slot by k+1
        positions up front; rejected drafts hand the surplus pages
        back).  Tail pages pop back onto the LIFO free list in reverse,
        so an immediate regrow of the same slot reacquires the identical
        pages in the identical order — page-table determinism (and with
        it the compile-count/parity contracts) survives reject/regrow
        churn.  Never trims below the shared-prefix pages, and never
        reclaims a page something else still references (a published
        prefix tail)."""
        keep = -(-n_tokens // self.page_size)
        keep = max(keep, self.shared_len[rid] // self.page_size)
        pages = self.pages[rid]
        while len(pages) > keep:
            p = pages[-1]
            if self.refcount[p] > 1:
                break                    # published page: leave it bound
            pages.pop()
            del self.refcount[p]
            self.free_list.append(p)
            self.stats["frees"] += 1
            self.stats["trims"] += 1

    def _free_page_ref(self, p: int):
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            del self.refcount[p]
            self.free_list.append(p)
            self.stats["frees"] += 1

    def release(self, rid: int, tokens=None):
        """Free a finished request's pages (shared prefix pages survive
        while other holders — or the prefix index / radix trie — still
        reference them).  With `tokens` (the request's written token
        history), the leading full pages are *published* into the radix
        trie instead of recycled, so the next request with the same
        prefix attaches them for free."""
        if tokens is not None:
            self.publish_radix(rid, tokens)
        for p in self.pages.pop(rid):
            self._free_page_ref(p)
        del self.shared_len[rid]

    def preempt(self, rid: int, tokens=None):
        """Pool-pressure eviction: identical to release at the allocator
        level; the engine requeues the request for deterministic FCFS
        re-admission and re-prefills on its next turn.  With `tokens`
        the victim's full pages are published first, so re-admission
        re-attaches them (unless the sweep had to evict them in the
        meantime) and the re-prefill shrinks to the tail."""
        self.stats["preempts"] += 1
        self.release(rid, tokens=tokens)

    def drop_prefix(self, key: str):
        """Unpublish a shared prefix (its pages free once no request
        still holds them)."""
        for p in self.prefix_index.pop(key):
            self._free_page_ref(p)

    # -- invariants -----------------------------------------------------------
    def check_invariants(self):
        refs: Dict[int, int] = {}
        for pages in self.pages.values():
            for p in pages:
                refs[p] = refs.get(p, 0) + 1
        for pages in self.prefix_index.values():
            for p in pages:
                refs[p] = refs.get(p, 0) + 1
        cached = []
        for node in self._iter_radix():
            refs[node.page] = refs.get(node.page, 0) + 1
            cached.append(node.page)
        assert len(set(cached)) == len(cached), \
            "page cached at two trie nodes"
        assert refs == self.refcount, (refs, self.refcount)
        live = set(refs)
        free = set(self.free_list)
        assert len(free) == len(self.free_list), "free list has dupes"
        assert not (live & free), f"live∩free: {live & free}"
        assert not any(p < self.reserved for p in live | free), \
            "reserved page leaked into circulation"
        assert live | free == set(range(self.reserved, self.n_pages)), \
            "pages leaked"
        for pages in self.pages.values():
            assert len(set(pages)) == len(pages), "duplicate page in table"
