# Copyright 2026 The kubeflow-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Cross-request prefix KV cache: a content-addressed radix index
over the paged pool.

The port's own copy of ``kubeflow_tpu/inference/engine/prefix_cache.py``
(numpy and hashlib only), held against it by tests/test_torch_copies.py.

At fleet scale most prompts share a long common prefix (system
prompt, few-shot header, chat history), yet every admission
re-prefills it from scratch — the dominant TTFT cost. This module is
the host-side half of the fix: an index mapping **hashed token
blocks** to **resident pool pages**, so admission can match the
longest cached prefix, share those pages read-only (ref-counted by
:class:`~.paged_kv.PageAllocator`), and prefill only the tail.

Design:

- **Chain-hashed blocks.** A prompt is split into page-sized token
  blocks; block ``j``'s key is ``H(key_{j-1} ‖ tokens[j·P,(j+1)·P))``
  — the chain makes the flat dict a radix tree (a block key encodes
  its whole prefix), and the stored tokens are compared on match so a
  hash collision degrades to a miss, never to wrong K/V. This is
  sound because K/V at position ``i`` is a pure function of tokens
  ``[0, i]`` — exactly what the chain key addresses.
- **One partial boundary child per node.** Prompts rarely end on a
  page boundary; the final partial block is indexed too (longest
  fill wins), and a match into it triggers a **copy-on-write fork**
  at admission: the matched head rows are copied into a private page
  (via the tail-prefill cache) because the new request's tail prefill
  and decode will write past them. Full-block pages are never
  written by sharers (decode writes land at positions strictly past
  the matched prefix), so full blocks share zero-copy.
- **LRU eviction of zero-ref pages only.** A page referenced by any
  live slot is pinned; when its last slot retires it moves to
  *retained* custody (resident, evictable, counted as allocator
  headroom). ``reclaim`` pops least-recently-used idle pages when
  ``alloc`` outruns the free list. Pinning an idle page consumes
  availability, so the allocator refuses pins that would starve an
  outstanding reservation — the FIFO admission queue can always make
  progress against cached pages (no-deadlock rule, fuzz-tested).

Engine-thread only (same single-mutator discipline as the allocator
and slot scheduler); readers of the counters see GIL-consistent ints.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PrefixCache", "PrefixMatch"]

_ROOT = b"prefix-root"


def _block_key(parent: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


@dataclasses.dataclass
class _Entry:
    key: bytes  # chain key (full blocks) / parent chain key (partial)
    tokens: Tuple[int, ...]  # block content (== page_size iff full)
    page: int
    full: bool


@dataclasses.dataclass
class PrefixMatch:
    """Longest cached prefix for one prompt: ``entries`` are the
    matched FULL blocks in chain order; ``fork`` is the partially
    matched boundary entry (``fork_len`` of its tokens are common) —
    its page is read once for the CoW copy, never placed in the
    sharer's table. ``matched`` counts prefix tokens covered.

    ``host_entries`` are host-tier blocks continuing the
    chain past the last HBM-resident block: their K/V is spliced into
    the gathered prefill cache and re-adopted into PRIVATE pages, so
    they appear after ``entries`` in chain order but never in
    ``shared_pages`` (they hold no allocator custody and need no
    pin — the match's Python reference keeps the arrays alive)."""

    entries: List[_Entry]
    fork: Optional[_Entry]
    fork_len: int
    matched: int
    host_entries: List[Any] = dataclasses.field(default_factory=list)

    @property
    def shared_pages(self) -> List[int]:
        return [e.page for e in self.entries]


class PrefixCache:
    """The index + LRU; implements the allocator's retained-page
    protocol (``holds`` / ``on_idle`` / ``on_pinned`` / ``reclaim``).
    """

    def __init__(self, page_size: int, allocator):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.allocator = allocator
        self._full: Dict[bytes, _Entry] = {}
        self._partial: Dict[bytes, _Entry] = {}  # parent key -> entry
        self._by_page: Dict[int, _Entry] = {}
        # Zero-ref resident pages, least-recently-used first. Order is
        # maintained by the pin/idle transitions: matching pins a page
        # out of here; retiring re-inserts it at the MRU end.
        self._idle: "OrderedDict[int, None]" = OrderedDict()
        # Monotonic counters (stats()/metrics).
        self.hits = 0
        self.misses = 0
        self.evicted_pages = 0
        self.saved_tokens_total = 0
        # Tiered KV memory: the host-RAM tier behind this
        # index, and the spill hook ``reclaim`` calls for each FULL
        # entry BEFORE its page returns to the free list (the page's
        # K/V is still valid there — the snapshot races nothing).
        # Both stay None on a single-tier engine, which keeps every
        # single-tier path bitwise untouched.
        self.host = None
        self._spill = None
        allocator.set_cache(self)

    def set_host_tier(self, tier) -> None:
        """Attach the host-RAM tier ``match`` continues into."""
        self.host = tier

    def set_spill(self, fn) -> None:
        """Install the evict-to-host hook (``fn(entry)``); the callee
        must never raise — a failed spill degrades to a plain drop."""
        self._spill = fn

    # -- queries ---------------------------------------------------------

    def resident_pages(self) -> int:
        return len(self._by_page)

    def idle_pages(self) -> List[int]:
        return list(self._idle)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "enabled": True,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate(), 4),
            "cached_pages": len(self._by_page),
            "cached_idle_pages": len(self._idle),
            "evicted_pages": self.evicted_pages,
            "saved_prefill_tokens": self.saved_tokens_total,
        }

    # -- matching (engine thread) ----------------------------------------

    def match(self, prompt: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``prompt``: whole blocks down the
        chain, then at most one partial boundary block. Capped at
        ``len(prompt) - 1``: at least one prompt token must prefill
        so the admission has next-token logits to sample from."""
        tokens = [int(t) for t in prompt]
        limit = len(tokens) - 1
        p = self.page_size
        entries: List[_Entry] = []
        parent = _ROOT
        covered = 0
        while covered + p <= limit:
            block = tuple(tokens[covered:covered + p])
            entry = self._full.get(_block_key(parent, block))
            if entry is None or entry.tokens != block:
                break
            entries.append(entry)
            parent = entry.key
            covered += p
        # Tier continuation: where the HBM chain ends, the
        # host tier may carry the next blocks (they were evicted
        # here, or fleet-fetched in). Once the walk goes host it
        # STAYS host — shared pages must be a contiguous table
        # prefix, so a deeper HBM block past a host block cannot be
        # shared in place (rare by construction: children idle, and
        # therefore evict, before their parents).
        host_entries: List[Any] = []
        if self.host is not None:
            while covered + p <= limit:
                block = tuple(tokens[covered:covered + p])
                hb = self.host.get(_block_key(parent, block), block)
                if hb is None:
                    break
                host_entries.append(hb)
                parent = hb.key
                covered += p
        fork = None
        fork_len = 0
        partial = self._partial.get(parent)
        if partial is not None:
            tail = tokens[covered:limit]
            common = 0
            for a, b in zip(partial.tokens, tail):
                if a != b:
                    break
                common += 1
            if common > 0:
                fork, fork_len = partial, common
        return PrefixMatch(entries=entries, fork=fork,
                           fork_len=fork_len,
                           matched=covered + fork_len,
                           host_entries=host_entries)

    def chain_blocks(self, prompt: Sequence[int]):
        """Full-block chain walk WITHOUT :meth:`match`'s ``len-1``
        cap — the fleet export side (serving/kv_store.py) wants every
        resident full block of ``prompt``, including one ending
        exactly at the prompt's end. Yields ``(block_tokens, entry,
        is_hbm)`` in chain order, stopping at the first gap; entries
        are HBM ``_Entry`` (``is_hbm=True``) until the chain crosses
        into the host tier, then host blocks (same stickiness rule
        as ``match``). Engine thread only (reads the live index)."""
        tokens = [int(t) for t in prompt]
        p = self.page_size
        parent = _ROOT
        covered = 0
        in_host = False
        while covered + p <= len(tokens):
            block = tuple(tokens[covered:covered + p])
            key = _block_key(parent, block)
            entry = None if in_host else self._full.get(key)
            if entry is not None and entry.tokens == block:
                yield block, entry, True
            else:
                hb = (self.host.get(key, block)
                      if self.host is not None else None)
                if hb is None:
                    return
                in_host = True
                yield block, hb, False
            parent = key
            covered += p

    def pin(self, match: PrefixMatch) -> PrefixMatch:
        """Take a slot reference on every matched page, shallowest
        first. A pin the allocator refuses (reservation starvation
        guard) TRUNCATES the match there — the caller admits with the
        shorter prefix instead of waiting on pages it may never get.
        Returns the effectively pinned match."""
        pinned: List[_Entry] = []
        for e in match.entries:
            if not self.allocator.ref(e.page):
                # The chain is broken at an unpinnable HBM block —
                # host blocks hanging past it are unreachable too.
                return PrefixMatch(entries=pinned, fork=None,
                                   fork_len=0,
                                   matched=len(pinned) * self.page_size)
            pinned.append(e)
        if match.fork is not None and \
                not self.allocator.ref(match.fork.page):
            # Host blocks need no pin (no allocator custody): a
            # refused FORK pin only sheds the fork, never the host
            # chain already matched under it.
            covered = (len(pinned) + len(match.host_entries)) * \
                self.page_size
            return PrefixMatch(entries=pinned, fork=None, fork_len=0,
                               matched=covered,
                               host_entries=list(match.host_entries))
        return match

    def unpin(self, match: PrefixMatch,
              include_fork: bool = True) -> None:
        """Drop the references :meth:`pin` took (admission failed, or
        the fork donor's copy is done)."""
        for e in match.entries:
            self.allocator.unref(e.page)
        if include_fork and match.fork is not None:
            self.allocator.unref(match.fork.page)

    def unpin_fork(self, match: PrefixMatch) -> None:
        if match.fork is not None:
            self.allocator.unref(match.fork.page)

    # -- registration (engine thread) ------------------------------------

    def register(self, prompt: Sequence[int],
                 pages: Sequence[int]) -> int:
        """Index an admitted prompt's resident pages: ``pages[j]``
        backs token block ``j``. Blocks already present just stay
        (their existing page serves future matches); new full blocks
        insert; a partial boundary block replaces the node's existing
        partial only when it fills strictly more tokens (longest
        wins). Returns the number of NEW pages indexed."""
        tokens = [int(t) for t in prompt]
        p = self.page_size
        n_full = len(tokens) // p
        parent = _ROOT
        added = 0
        for j in range(n_full):
            block = tuple(tokens[j * p:(j + 1) * p])
            key = _block_key(parent, block)
            entry = self._full.get(key)
            if entry is None and int(pages[j]) not in self._by_page:
                entry = _Entry(key=key, tokens=block,
                               page=int(pages[j]), full=True)
                self._full[key] = entry
                self._by_page[entry.page] = entry
                added += 1
            elif entry is None:
                # The page already backs another entry (it was matched
                # shared); a chain that diverges earlier cannot reuse
                # it — stop indexing this prompt here.
                return added
            parent = key
        rest = tuple(tokens[n_full * p:])
        if rest and n_full < len(pages):
            page = int(pages[n_full])
            existing = self._partial.get(parent)
            if existing is not None and \
                    len(existing.tokens) >= len(rest):
                return added  # keep the longer (or equal) fill
            if page in self._by_page:
                return added  # page is a shared full block elsewhere
            if existing is not None:
                self._drop_entry(existing, free_idle=True)
            entry = _Entry(key=parent, tokens=rest, page=page,
                           full=False)
            self._partial[parent] = entry
            self._by_page[page] = entry
            added += 1
        return added

    # -- allocator protocol ----------------------------------------------

    def holds(self, page: int) -> bool:
        return int(page) in self._by_page

    def on_idle(self, page: int) -> None:
        self._idle[int(page)] = None
        self._idle.move_to_end(int(page))

    def on_pinned(self, page: int) -> None:
        self._idle.pop(int(page), None)

    def reclaimable(self) -> int:
        return len(self._idle)

    def reclaim(self, n: int) -> List[int]:
        """Evict up to ``n`` least-recently-used idle pages: drop
        their index entries and hand the page ids back to the
        allocator (which moves them retained → free). With a host
        tier attached a FULL entry's K/V is spilled to
        host buffers FIRST — the page is still resident here, so the
        snapshot reads exactly the bytes a sharer would have; the
        drop then proceeds as before (evict-to-host, not drop)."""
        out: List[int] = []
        while len(out) < n and self._idle:
            page, _ = self._idle.popitem(last=False)
            entry = self._by_page.get(page)
            if entry is not None:
                if self._spill is not None and entry.full:
                    self._spill(entry)
                self._drop_entry(entry, free_idle=False)
            out.append(page)
            self.evicted_pages += 1
        return out

    def _drop_entry(self, entry: _Entry, *, free_idle: bool) -> None:
        """Remove one entry from the index. Children chained under a
        dropped full block become unreachable for matching but stay
        in the LRU — they evict on their own (reverse-order retire
        idling makes children older than parents, so in practice
        children leave first)."""
        if entry.full:
            if self._full.get(entry.key) is entry:
                del self._full[entry.key]
        elif self._partial.get(entry.key) is entry:
            del self._partial[entry.key]
        self._by_page.pop(entry.page, None)
        if free_idle and entry.page in self._idle:
            self._idle.pop(entry.page, None)
            self.allocator.discard_retained(entry.page)

    # -- lifecycle -------------------------------------------------------

    def clear(self) -> int:
        """Drop every index entry; idle pages return to the free list
        immediately, pinned ones when their last slot retires (the
        allocator's ``holds`` check then finds nothing). Returns the
        number of pages released to the free list. Engine-thread /
        quiesced callers only (warmup teardown, tests, stop())."""
        released = 0
        for entry in list(self._by_page.values()):
            idle = entry.page in self._idle
            self._drop_entry(entry, free_idle=True)
            released += int(idle)
        self._idle.clear()
        return released

    def check_invariants(self) -> None:
        """Index-side half of the fuzz harness's per-step check."""
        for key, e in self._full.items():
            assert e.full and e.key == key and \
                len(e.tokens) == self.page_size, f"bad full entry {e}"
            assert self._by_page.get(e.page) is e, \
                f"full entry page {e.page} not in by_page"
        for key, e in self._partial.items():
            assert not e.full and e.key == key and \
                0 < len(e.tokens) < self.page_size, \
                f"bad partial entry {e}"
            assert self._by_page.get(e.page) is e, \
                f"partial entry page {e.page} not in by_page"
        assert len(self._by_page) == \
            len(self._full) + len(self._partial), \
            "by_page count drifted from entry maps"
        for page in self._idle:
            assert page in self._by_page, \
                f"idle page {page} has no index entry"
            assert self.allocator.refcount(page) == 0, \
                f"idle page {page} has live refs"
