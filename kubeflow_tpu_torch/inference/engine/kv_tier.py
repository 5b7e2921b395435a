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

"""Tier 1 of the tiered KV memory: a byte-budgeted host-RAM pool behind
the HBM prefix cache.

Port of ``kubeflow_tpu/inference/engine/kv_tier.py``. Under page
pressure ``PrefixCache.reclaim`` evicts zero-ref retained pages; with a
host tier attached an evicted full block's K/V is first snapshotted to
host memory (one ``[page_size, heads, dim]`` CPU tensor per KV leaf, in
:func:`~.paged_kv.kv_leaf_order`), indexed under the same chain hash
the radix index uses, and spliced back into a later admission's
gathered B=1 cache on a match: a host-to-device copy in place of a
re-prefill.

Custody, as the reference's: a host block has no refcounts and no pins.
A match hands back the :class:`_HostBlock` itself, and the admission
holds a Python reference until the splice lands, so an eviction between
match and splice only makes the block unmatchable for the next request.
Only FULL blocks spill (a partial boundary block is one request's
private tail). The tier is locked because fleet imports land from
request threads while the engine thread matches and spills.

Bits: a spill snapshot is taken inside ``reclaim`` before the page
returns to the free list, so it copies exactly the bytes a sharer would
have read; splicing them back is indistinguishable from having kept the
page, and a tier hit equals its cold run wherever a pure HBM hit does.
Layers are kept as CPU tensors (numpy has no bfloat16); a numpy array
from the wire is copied into one at ``put``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.inference.engine.paged_kv import kv_leaf_order
from kubeflow_tpu_torch.models.llama import LayerCache

__all__ = ["HostKVTier", "splice_host_blocks"]


def _host_tensor(a) -> torch.Tensor:
    """A layer as a CPU tensor of its own (a wire array is read-only)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu")
    return torch.from_numpy(np.array(a))


@dataclasses.dataclass
class _HostBlock:
    """One spilled (or fleet-fetched) full token block: the chain key it
    is indexed under, its tokens (compared on match, so a hash collision
    degrades to a miss) and one CPU tensor per KV leaf in
    :func:`~.paged_kv.kv_leaf_order`."""

    key: bytes
    tokens: Tuple[int, ...]
    layers: List[torch.Tensor]  # [page_size, heads, dim] per KV leaf
    nbytes: int


class HostKVTier:
    """Byte-budgeted LRU of host-resident KV blocks, keyed by the prefix
    cache's chain hashes. ``put`` inserts at the MRU end and evicts
    LRU-first past the budget; ``get`` is a token-compared lookup that
    refreshes recency. Thread-safe."""

    def __init__(self, budget_bytes: int):
        if budget_bytes < 0:
            raise ValueError(
                f"host cache budget must be >= 0 bytes, got "
                f"{budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.RLock()
        self._blocks: "OrderedDict[bytes, _HostBlock]" = OrderedDict()
        self._bytes = 0
        # Monotonic counters (stats()/metrics families).
        self.spilled_blocks = 0
        self.imported_blocks = 0
        self.evicted_blocks = 0
        self.readopted_blocks = 0

    # -- queries ---------------------------------------------------------

    def resident_blocks(self) -> int:
        with self._lock:
            return len(self._blocks)

    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, key: bytes, tokens: Sequence[int]):
        """Token-compared lookup; a hit refreshes LRU recency. Returns
        the :class:`_HostBlock` or None."""
        block = tuple(int(t) for t in tokens)
        with self._lock:
            hb = self._blocks.get(key)
            if hb is None or hb.tokens != block:
                return None
            self._blocks.move_to_end(key)
            return hb

    # -- mutation --------------------------------------------------------

    def put(self, key: bytes, tokens: Sequence[int], layers: Sequence[Any],
            *, imported: bool = False) -> bool:
        """Insert one full block (the spill path, or ``imported=True``
        for a fleet fetch landing). A key already resident just
        refreshes recency. Returns True only on a real insert."""
        block = tuple(int(t) for t in tokens)
        tensors = [_host_tensor(a) for a in layers]
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        with self._lock:
            if self.budget_bytes <= 0 or nbytes > self.budget_bytes:
                return False
            if key in self._blocks:
                self._blocks.move_to_end(key)
                return False
            self._blocks[key] = _HostBlock(key=key, tokens=block,
                                           layers=tensors, nbytes=nbytes)
            self._bytes += nbytes
            if imported:
                self.imported_blocks += 1
            else:
                self.spilled_blocks += 1
            while self._bytes > self.budget_bytes and self._blocks:
                _, victim = self._blocks.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evicted_blocks += 1
            return True

    def note_readopted(self, n: int) -> None:
        """The admission path spliced ``n`` host blocks device-ward."""
        with self._lock:
            self.readopted_blocks += int(n)

    def clear(self) -> int:
        """Drop every resident block (engine stop, tests). Returns the
        number of blocks released."""
        with self._lock:
            n = len(self._blocks)
            self._blocks.clear()
            self._bytes = 0
            return n

    # -- reporting -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self._bytes,
                "resident_blocks": len(self._blocks),
                "spilled_blocks": self.spilled_blocks,
                "imported_blocks": self.imported_blocks,
                "evicted_blocks": self.evicted_blocks,
                "readopted_blocks": self.readopted_blocks,
            }

    def check_accounting(self) -> None:
        """Fuzz-harness half for the host pool: byte ledger against the
        resident set, budget respected, every block well formed."""
        with self._lock:
            total = sum(b.nbytes for b in self._blocks.values())
            assert total == self._bytes, \
                f"host byte ledger drifted: {self._bytes} != {total}"
            assert self._bytes <= max(0, self.budget_bytes), \
                f"host pool over budget: {self._bytes} > " \
                f"{self.budget_bytes}"
            for key, b in self._blocks.items():
                assert b.key == key, f"host block keyed under a " \
                    f"foreign key: {b.key!r} != {key!r}"
                assert b.nbytes == sum(t.numel() * t.element_size()
                                       for t in b.layers), \
                    f"host block {key!r} nbytes drifted"
                assert b.tokens, f"host block {key!r} carries no tokens"


def splice_host_blocks(cache: List[LayerCache],
                       blocks_layers: Sequence[Sequence[torch.Tensor]],
                       first_block: int, page_size: int
                       ) -> List[LayerCache]:
    """Land consecutive host blocks in a gathered B=1 prefix cache, in
    place: block ``i`` covers cache rows ``[(first_block + i)·P,
    (first_block + i + 1)·P)``, the null-page rows the gather left
    there. Every block's leaves go to the device in one copy, then one
    indexed copy a KV leaf; nothing waits on the device in between. The
    result is byte-equal to the cache a pure HBM match of the same depth
    would have gathered."""
    if not blocks_layers:
        return cache
    order = kv_leaf_order(len(cache))
    n = len(blocks_layers)
    # [leaves, blocks, P, h, d] on the host, then on the device at once.
    host = torch.stack([torch.stack([blk[j] for blk in blocks_layers])
                        for j in range(len(order))])
    dev = host.to(cache[0].k.device, cache[0].k.dtype)
    lo, hi = first_block * page_size, (first_block + n) * page_size
    for j, (layer, name) in enumerate(order):
        rows = dev[j].reshape(n * page_size, *dev.shape[3:])
        getattr(cache[layer], name)[0, lo:hi] = rows
    return cache
