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

"""Paged KV cache: a shared page pool + per-slot page tables.

Port of ``kubeflow_tpu/inference/engine/paged_kv.py``:

- **Physical storage** per layer is ``[num_pages, page_size, kv_heads,
  head_dim]`` — one shared pool, page 0 reserved as the *null page*
  (unallocated page-table entries point at it; its contents are only
  ever read through masked attention positions and written by retired
  or overshooting slots, so it just has to stay finite).
- **Page tables** map each slot's logical time axis onto pool pages
  (``tables[slot, j]`` backs logical positions ``[j·P, (j+1)·P)``).
  The decode slice gathers a slot-batch logical view ``[N, C', ...]``
  (``C' = pages_per_slot × page_size``), runs the model on it, and
  scatters only the newly written token range back — one gather and
  one scatter per slice.
- **Allocation** is reservation-based (:class:`PageAllocator`, copied
  from the reference): a request reserves its worst case at admission,
  allocates lazily as its sequence crosses page boundaries, and frees
  everything at retire.

The pool is a list of :class:`~kubeflow_tpu_torch.models.llama.LayerCache`
(one per layer, ``k``/``v`` pools; the scalar ``index`` is unused), the
port's form of the reference's cache pytree. The gather, scatter and
adopt are torch indexing on the pool's device, updated in place. Two
rules keep the in-place scatter exact on CUDA, where ``index_put_``
with repeated targets keeps an arbitrary one: a slot's positions map to
distinct cells of its own pages, and every position a slot cannot own
(an unallocated table entry, or a position past the logical end, which
only an overshooting row reaches) lands on the null page, the one cell
set that may be written twice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.models.llama import LayerCache


class PageAllocator:
    """Host-side free list + reservation + ref-count accounting.

    Only the engine thread mutates it; readers (metrics callbacks,
    admission estimates) see GIL-consistent ints. Page 0 is the null
    page and is never handed out.

    Ref counts (prefix sharing): every allocated page
    carries a count of the slots using it. ``alloc`` hands pages out
    at ref 1; a slot adopting another request's resident prefix pages
    ``ref``\\ s them instead of allocating copies, and ``unref`` at
    retire is the ONLY decrementer. A page whose count reaches zero
    either returns to the free list or — when the attached prefix
    cache still indexes it — moves to *retained* custody: resident,
    evictable, counted as headroom by ``available()`` and reclaimed
    LRU-first when ``alloc`` outruns the free list. The FIFO
    no-deadlock rule lives in two guards here: ``reserve`` admits
    against free+retained (retained pages are always reclaimable, so
    a reservation can never wait on a page only a live slot can
    release), and ``ref`` refuses to pin a retained page when that
    would eat a page an outstanding reservation was promised.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 null + 1 usable), "
                             f"got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._reserved = 0
        self._refs: dict = {}  # page id -> live slot count (>= 1)
        self._retained: set = set()  # zero-ref pages the cache holds
        self._cache = None  # prefix cache (holds/on_idle/on_pinned/
        #                     reclaim/reclaimable protocol) or None

    def set_cache(self, cache) -> None:
        """Attach the prefix cache that may retain zero-ref pages."""
        self._cache = cache

    @property
    def free_pages(self) -> int:
        """Pages physically free (some may be spoken for)."""
        return len(self._free)

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    @property
    def retained_pages(self) -> int:
        """Zero-ref pages kept resident by the prefix cache
        (evictable on demand — headroom, not pressure)."""
        return len(self._retained)

    @property
    def inuse_pages(self) -> int:
        """Pages referenced by at least one live slot."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def available(self) -> int:
        """Pages neither allocated nor reserved — the admission gate's
        number. Retained (zero-ref cached) pages count: they reclaim
        on demand inside ``alloc``."""
        return len(self._free) + len(self._retained) - self._reserved

    def reserve(self, n: int) -> bool:
        """Promise ``n`` pages to a slot (allocated later, lazily).
        False = pool can't cover it; the caller must not admit."""
        if self.available() < n:
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if n > self._reserved:
            raise ValueError(
                f"unreserve({n}) exceeds outstanding reservation "
                f"{self._reserved}")
        self._reserved -= n

    def alloc(self, n: int) -> List[int]:
        """Convert ``n`` pages of reservation into concrete page ids
        (each at ref count 1), evicting LRU retained pages when the
        free list alone can't cover it. The reservation invariant
        makes this infallible for reserved callers; misuse raises
        rather than corrupting the pool."""
        if n > self._reserved:
            raise ValueError(
                f"alloc({n}) without reservation (reserved="
                f"{self._reserved})")
        if n > len(self._free) and self._cache is not None:
            for p in self._cache.reclaim(n - len(self._free)):
                self._retained.discard(int(p))
                self._free.append(int(p))
        if n > len(self._free):
            raise RuntimeError(
                f"pool corrupted: {n} pages reserved but only "
                f"{len(self._free)} free + {len(self._retained)} "
                f"retained")
        self._reserved -= n
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def ref(self, page: int) -> bool:
        """Pin one more user onto a resident page. Pinning a RETAINED
        page consumes a unit of availability, so it fails (False) when
        outstanding reservations have already spoken for every
        reclaimable page — the caller must treat the page as a miss,
        never hold the admission line on it (FIFO no-deadlock rule)."""
        page = int(page)
        if page in self._refs:
            self._refs[page] += 1
            return True
        if page in self._retained:
            if self.available() < 1:
                return False
            self._retained.discard(page)
            self._refs[page] = 1
            if self._cache is not None:
                self._cache.on_pinned(page)
            return True
        raise ValueError(f"ref({page}): page is neither allocated "
                         f"nor retained")

    def unref(self, page: int) -> None:
        """Drop one user. At zero the page returns to the free list,
        or to retained custody when the prefix cache still indexes
        it."""
        page = int(page)
        count = self._refs.get(page)
        if count is None:
            raise ValueError(f"unref({page}): page has no refs")
        if count > 1:
            self._refs[page] = count - 1
            return
        del self._refs[page]
        if self._cache is not None and self._cache.holds(page):
            self._retained.add(page)
            self._cache.on_idle(page)
        else:
            self._free.append(page)

    def discard_retained(self, page: int) -> None:
        """The prefix cache dropped its entry for an idle page —
        return it to the free list."""
        page = int(page)
        if page not in self._retained:
            raise ValueError(f"discard_retained({page}): not retained")
        self._retained.discard(page)
        self._free.append(page)

    def free(self, pages: Sequence[int]) -> None:
        """Force-return pages to the free list regardless of count
        (legacy single-owner paths and tests; shared pages must go
        through ``unref``)."""
        for p in pages:
            if p == 0:
                raise ValueError("page 0 is the null page")
            self._refs.pop(int(p), None)
            self._free.append(int(p))

    def check_invariants(self) -> None:
        """Raise AssertionError on any accounting violation — the
        eviction-fuzz harness calls this after every step."""
        usable = self.num_pages - 1
        free = set(self._free)
        assert len(free) == len(self._free), \
            f"duplicate pages on the free list: {sorted(self._free)}"
        inuse = set(self._refs)
        assert not (free & inuse), f"free∩inuse: {free & inuse}"
        assert not (free & self._retained), \
            f"free∩retained: {free & self._retained}"
        assert not (inuse & self._retained), \
            f"inuse∩retained: {inuse & self._retained}"
        total = len(free) + len(inuse) + len(self._retained)
        assert total == usable, \
            f"page leak: {len(free)} free + {len(inuse)} inuse + " \
            f"{len(self._retained)} retained != {usable} usable"
        assert all(c >= 1 for c in self._refs.values()), \
            f"non-positive refcount: {self._refs}"
        assert 0 not in free | inuse | self._retained, \
            "null page escaped into circulation"
        assert self._reserved >= 0, f"negative reservation " \
            f"{self._reserved}"
        assert self._reserved <= len(free) + len(self._retained), \
            f"reservation {self._reserved} exceeds reclaimable " \
            f"{len(free)} free + {len(self._retained)} retained"
        if self._cache is not None:
            assert self._retained == set(self._cache.idle_pages()), \
                "allocator retained set drifted from the cache's " \
                "idle set"


def kv_leaf_order(num_layers: int) -> List[Tuple[int, str]]:
    """The order of one page's KV leaves wherever they leave the pool
    (the host tier, fleet blocks on the wire): ``(layer, "k" | "v")``
    in the reference's tree-flatten order of its cache collection, whose
    ``layer_{i}`` keys sort as strings (``layer_0, layer_1, layer_10,
    ..., layer_19, layer_2, ...``), K before V in a layer (the scalar
    ``index`` is not a KV leaf). Blocks either package writes then
    splice into the other's cache at the right layer."""
    return [(i, name)
            for i in sorted(range(num_layers), key=lambda i: f"layer_{i}")
            for name in ("k", "v")]


def _is_kv(leaf) -> bool:
    """KV leaves are [*, time, heads, dim]; the per-layer scalar
    ``index`` is not a tensor in the port."""
    return getattr(leaf, "ndim", 0) == 4


def _gather_logical(physical: List[LayerCache],
                    tables: torch.Tensor) -> List[LayerCache]:
    """Page-table gather: physical pools → the slot-batch logical cache
    the model decodes over (``[N, C', heads, dim]`` per layer, fresh
    tensors; ``index`` 0 — the per-row decode path never reads it)."""
    n, mpp = tables.shape
    flat = tables.reshape(-1).long()

    def g(pool):
        _, p, h, d = pool.shape
        return pool[flat].reshape(n, mpp * p, h, d)

    return [LayerCache(g(c.k), g(c.v)) for c in physical]


def _token_cells(tables: torch.Tensor, start_pos: torch.Tensor,
                 num_steps: int, page_size: int):
    """``(page_idx, offset, pos)`` ``[N, K]`` for logical positions
    ``[start_pos_i, start_pos_i + num_steps)`` of every slot: a
    position past the logical end, or on an unallocated table entry,
    maps to the null page."""
    n, mpp = tables.shape
    pos = start_pos.long()[:, None] + torch.arange(
        num_steps, device=tables.device)[None, :]
    page_col = pos // page_size
    page_idx = torch.gather(tables.long(), 1,
                            torch.clamp(page_col, 0, mpp - 1))
    page_idx = torch.where(page_col < mpp, page_idx,
                           torch.zeros_like(page_idx))
    return page_idx, pos % page_size, pos


def _scatter_token_range(physical: List[LayerCache],
                         logical: List[LayerCache], tables: torch.Tensor,
                         start_pos: torch.Tensor, *,
                         num_steps: int) -> List[LayerCache]:
    """Write the slice's freshly decoded token range ``[start_pos_i,
    start_pos_i + num_steps)`` of every slot back into the pool, in
    place. Positions beyond a slot's allocated pages resolve to the
    null page (table entries are 0 there), so retired/overshooting rows
    scribble harmlessly instead of needing per-row masks."""
    n = tables.shape[0]
    page_size = physical[0].k.shape[1]
    page_idx, offset, pos = _token_cells(tables, start_pos, num_steps,
                                         page_size)
    rows = torch.arange(n, device=tables.device)[:, None]
    src = torch.clamp(pos, 0, logical[0].k.shape[1] - 1)
    for ph, lg in zip(physical, logical):
        ph.k[page_idx, offset] = lg.k[rows, src]
        ph.v[page_idx, offset] = lg.v[rows, src]
    return physical


def _adopt_prefill(physical: List[LayerCache],
                   prefill_cache: List[LayerCache],
                   page_ids: torch.Tensor, first_page: int, *,
                   n_pages: int) -> List[LayerCache]:
    """Copy ``n_pages`` pages of a B=1 prefill cache, starting at
    logical page ``first_page``, into the pool pages just allocated to
    the admitting slot, in place. Rows past the prefill cache's end
    (a cache length that is not a page multiple) land as zeros."""
    for ph, pc in zip(physical, prefill_cache):
        _, p, h, d = ph.k.shape
        lo, hi = first_page * p, (first_page + n_pages) * p
        for pool, row in ((ph.k, pc.k[0]), (ph.v, pc.v[0])):
            seg = row[lo:hi]
            if seg.shape[0] < hi - lo:
                seg = torch.cat([seg, seg.new_zeros(
                    (hi - lo - seg.shape[0], h, d))])
            pool[page_ids] = seg.reshape(n_pages, p, h, d).to(pool.dtype)
    return physical


def _gather_pages_to_cache(physical: List[LayerCache], page_ids: torch.Tensor,
                           cache_len: int, fill_len: int) -> List[LayerCache]:
    """Materialize a slot-shaped page list as a contiguous B=1 cache of
    ``cache_len`` positions: page ``j`` of ``page_ids`` lands at cache
    rows ``[j·P, (j+1)·P)`` (null-page entries contribute the null
    page's rows, which only masked positions ever read), and ``index``
    is ``fill_len``, so the model's scalar append path continues the
    sequence there — the continuation-prefill half of a prefix-cache
    hit. Fresh tensors: the pool is never written through them."""
    flat = page_ids.reshape(-1).long()

    def g(pool):
        _, _, h, d = pool.shape
        return pool[flat].reshape(-1, h, d)[:cache_len][None]

    return [LayerCache(g(c.k), g(c.v), fill_len) for c in physical]


class PagedKVCache:
    """The pool tensors + table bookkeeping for one decode engine.

    ``physical`` holds one page pool per layer (``LayerCache`` of
    ``[num_pages, page_size, kv_heads, head_dim]`` tensors in the
    template's dtype, on its device). Host-side ``tables`` is the
    source of truth (numpy); ``device_tables()`` copies it into one
    device buffer for a slice, the same tensor every call, so a captured
    slice reads its page tables at one address.
    """

    def __init__(self, cache_template: List[LayerCache], *, num_slots: int,
                 page_size: int, cache_size: int,
                 num_pages: Optional[int] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.cache_size = cache_size
        self.num_slots = num_slots
        self.pages_per_slot = -(-cache_size // page_size)
        self.logical_len = self.pages_per_slot * page_size
        if num_pages is None:
            # Default: every slot can hold a full-length sequence,
            # plus the null page. Sizing it smaller is the memory
            # lever (admission then gates on reservations).
            num_pages = num_slots * self.pages_per_slot + 1
        self.allocator = PageAllocator(num_pages)

        def to_pages(t: torch.Tensor) -> torch.Tensor:
            _, _, h, d = t.shape
            return torch.zeros((num_pages, page_size, h, d), dtype=t.dtype,
                               device=t.device)

        self.physical = [LayerCache(to_pages(c.k), to_pages(c.v))
                         for c in cache_template]
        self.device = cache_template[0].k.device
        self.tables = np.zeros((num_slots, self.pages_per_slot), np.int32)
        self._device_tables = torch.zeros(self.tables.shape,
                                          dtype=torch.int64,
                                          device=self.device)

    # -- accounting ------------------------------------------------------

    def pages_for(self, length: int) -> int:
        """Pages needed to back ``length`` cache slots."""
        return -(-length // self.page_size)

    def device_tables(self) -> torch.Tensor:
        """The host tables copied into the pool's one device buffer
        (``copy_``, in stream order after the work that read it last),
        which is returned."""
        self._device_tables.copy_(torch.from_numpy(
            self.tables.astype(np.int64)))
        return self._device_tables

    # -- slot operations (engine thread only) ----------------------------

    def extend_slot(self, slot_index: int, allocated: int,
                    upto_position: int, budget_pages: int) -> int:
        """Allocate pages so slot ``slot_index`` can write through
        cache position ``upto_position`` (exclusive), never past its
        ``budget_pages`` reservation. Returns the new allocated count;
        page ids land in the host table (push with device_tables)."""
        need = min(self.pages_for(upto_position), budget_pages)
        if need <= allocated:
            return allocated
        new_pages = self.allocator.alloc(need - allocated)
        self.tables[slot_index, allocated:need] = new_pages
        return need

    def adopt(self, slot_index: int, prefill_cache: List[LayerCache],
              prompt_width: int, budget_pages: int,
              shared_pages: Sequence[int] = ()) -> int:
        """Admission: point the slot's leading table rows at the
        already-resident ``shared_pages`` (the caller ref-counted
        them), allocate private pages for the rest of the prompt, and
        copy that tail range of the B=1 prefill cache into them.
        Returns the total table rows filled (shared + private)."""
        shared = len(shared_pages)
        n_pages = min(self.pages_for(prompt_width), budget_pages)
        if shared:
            self.tables[slot_index, :shared] = list(shared_pages)
        n_priv = n_pages - shared
        if n_priv > 0:
            pages = self.allocator.alloc(n_priv)
            self.tables[slot_index, shared:n_pages] = pages
            _adopt_prefill(
                self.physical, prefill_cache,
                torch.tensor(pages, dtype=torch.int64, device=self.device),
                shared, n_pages=n_priv)
        return n_pages

    def read_page_layers(self, page: int) -> List[torch.Tensor]:
        """Snapshot one pool page's K/V to host memory: one
        ``[page_size, heads, dim]`` CPU tensor per KV leaf (the pool's
        dtype; numpy has no bf16) in :func:`kv_leaf_order`, the order a
        host-tier splice writes back in, in one device-to-host copy. The
        evict-to-host copy: called while the page still holds valid
        K/V; the copy makes the snapshot exact whatever the pool does
        next."""
        page = int(page)
        leaves = [getattr(self.physical[i], name)[page]
                  for i, name in kv_leaf_order(len(self.physical))]
        return list(torch.stack(leaves).to("cpu", copy=True).unbind(0))

    def gather_prefix_cache(self, page_ids: Sequence[int],
                            fill_len: int) -> List[LayerCache]:
        """Shared prefix pages (padded with the null page to the full
        slot row) → a contiguous B=1 cache of ``cache_size`` positions
        with ``index = fill_len``, ready for a continuation prefill of
        the unmatched tail."""
        row = np.zeros((self.pages_per_slot,), np.int64)
        row[: len(page_ids)] = list(page_ids)
        return _gather_pages_to_cache(
            self.physical, torch.from_numpy(row).to(self.device),
            self.cache_size, fill_len)

    def truncate_slot(self, slot_index: int, allocated: int,
                      keep_upto_position: int) -> int:
        """Roll back a speculative multi-token append: keep only the
        pages backing cache positions ``[0, keep_upto_position)`` and
        hand the over-allocated tail back — each dropped page loses
        this slot's reference (a privately allocated decode page goes
        straight back to the free list; ``unref`` keeps shared /
        prefix-retained custody correct if a caller ever truncates
        into shared territory) and its page worth of reservation is
        restored, so the slot can re-extend over the same range as
        its sequence re-advances. Rejected K/V left in KEPT pages
        past ``keep_upto_position`` needs no scrubbing: the decode
        validity mask never attends past a row's write position, and
        the next append overwrites it. Returns the new allocated
        count. Engine thread only."""
        keep = self.pages_for(max(0, keep_upto_position))
        if keep >= allocated:
            return allocated
        dropped = self.tables[slot_index, keep:allocated].tolist()
        for p in reversed(dropped):
            self.allocator.unref(int(p))
        if not self.allocator.reserve(len(dropped)):
            # Unreachable: unref just returned len(dropped) pages of
            # availability (free or retained custody) — surface
            # loudly rather than silently under-reserving.
            raise RuntimeError(
                f"truncate_slot: could not restore {len(dropped)} "
                f"pages of reservation")
        self.tables[slot_index, keep:allocated] = 0
        return keep

    def release_slot(self, slot_index: int, allocated: int,
                     unreserved_remainder: int) -> None:
        """Retire: drop the slot's reference on every table row
        (shared prefix pages survive under their other users or the
        prefix cache's custody; single-owner pages free), drop its
        remaining reservation, null its table row. Rows unref in
        REVERSE so deeper prefix blocks go idle — and therefore evict
        — before their parents."""
        for p in reversed(self.tables[slot_index, :allocated].tolist()):
            self.allocator.unref(int(p))
        if unreserved_remainder:
            self.allocator.unreserve(unreserved_remainder)
        self.tables[slot_index, :] = 0

    def gather(self, tables: torch.Tensor) -> List[LayerCache]:
        return _gather_logical(self.physical, tables)

    def scatter(self, logical: List[LayerCache], tables: torch.Tensor,
                start_pos: torch.Tensor, num_steps: int) -> None:
        _scatter_token_range(self.physical, logical, tables, start_pos,
                             num_steps=num_steps)
