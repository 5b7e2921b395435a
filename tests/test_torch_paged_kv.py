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

"""The port's paged KV cache against the reference's.

The page gather, the token-range scatter, the prefill adoption and the
prefix lane's page operations (pages to a contiguous cache, a page's
host snapshot, the slot rollback) run on random pools and tables
through both packages and must agree exactly (they only move values).
The copied ``PageAllocator`` is driven through the same random
operation sequence as the reference's and must end in the same state,
and its ref-count twins of tests/test_prefix_cache.py hold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.inference.engine import paged_kv as jax_paged_kv
from kubeflow_tpu_torch.inference.engine import paged_kv
from kubeflow_tpu_torch.inference.engine.paged_kv import (
    PageAllocator,
    PagedKVCache,
)
from kubeflow_tpu_torch.models.llama import LayerCache

LAYERS, PAGES, P, H, D = 2, 9, 4, 2, 3


def _pools(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((LAYERS, 2, PAGES, P, H, D)).astype(
        np.float32)


def _jax_tree(arrs):
    """The reference's cache pytree: k, v and a scalar index a layer."""
    return {f"layer_{i}": {"attention": {
        "k": jnp.asarray(arrs[i][0]), "v": jnp.asarray(arrs[i][1]),
        "index": jnp.zeros((), jnp.int32)}} for i in range(len(arrs))}


def _torch_layers(arrs):
    return [LayerCache(torch.from_numpy(np.array(a[0])),
                       torch.from_numpy(np.array(a[1]))) for a in arrs]


def _check(port_layers, jax_tree):
    for i, c in enumerate(port_layers):
        ref = jax_tree[f"layer_{i}"]["attention"]
        np.testing.assert_array_equal(c.k.numpy(), np.asarray(ref["k"]))
        np.testing.assert_array_equal(c.v.numpy(), np.asarray(ref["v"]))


def _tables(seed, n=3, mpp=4):
    # Distinct pages per slot (page 0 = unallocated), as the engine's.
    rng = np.random.default_rng(seed)
    tables = np.zeros((n, mpp), np.int32)
    pages = rng.permutation(np.arange(1, PAGES))
    for s in range(n):
        k = int(rng.integers(0, mpp + 1))
        tables[s, :k] = pages[:k]
        pages = pages[k:]
        if len(pages) < mpp:
            pages = rng.permutation(np.arange(1, PAGES))
    return tables


@pytest.mark.parametrize("seed", range(4))
def test_gather_logical_matches_reference(seed):
    pools = _pools(seed)
    tables = _tables(seed)
    got = paged_kv._gather_logical(_torch_layers(pools),
                                   torch.from_numpy(tables))
    want = jax_paged_kv._gather_logical(_jax_tree(pools),
                                        jnp.asarray(tables))
    _check(got, want)
    assert all(c.index == 0 for c in got)


@pytest.mark.parametrize("seed,num_steps", [(0, 1), (1, 3), (2, 4), (3, 2)])
def test_scatter_token_range_matches_reference(seed, num_steps):
    pools = _pools(seed)
    rng = np.random.default_rng(100 + seed)
    n, mpp = 3, 4
    # Every slot owns distinct pages, so no cell but the null page's is
    # written twice; start positions keep each range inside the
    # logical cache (the reference's positions past it read NaN).
    pages = rng.permutation(np.arange(1, PAGES))[:n * 2].reshape(n, 2)
    tables = np.zeros((n, mpp), np.int32)
    tables[:, :2] = pages
    logical = rng.standard_normal((LAYERS, 2, n, mpp * P, H, D)).astype(
        np.float32)
    start = rng.integers(0, mpp * P - num_steps + 1, n).astype(np.int32)
    got = paged_kv._scatter_token_range(
        _torch_layers(pools), _torch_layers(logical),
        torch.from_numpy(tables), torch.from_numpy(start),
        num_steps=num_steps)
    want = jax_paged_kv._scatter_token_range(
        _jax_tree(pools), _jax_tree(logical), jnp.asarray(tables),
        jnp.asarray(start), num_steps=num_steps)
    # The null page takes the writes of positions on unallocated table
    # entries, duplicates included: only pages 1.. are held equal.
    for i, c in enumerate(got):
        ref = want[f"layer_{i}"]["attention"]
        np.testing.assert_array_equal(c.k.numpy()[1:],
                                      np.asarray(ref["k"])[1:])
        np.testing.assert_array_equal(c.v.numpy()[1:],
                                      np.asarray(ref["v"])[1:])


def test_scatter_past_the_logical_end_lands_on_the_null_page():
    pools = _pools(7)
    tables = np.asarray([[1, 2], [3, 4]], np.int32)
    logical = np.ones((LAYERS, 2, 2, 2 * P, H, D), np.float32)
    before = [np.array(a) for a in pools]
    got = paged_kv._scatter_token_range(
        _torch_layers(pools), _torch_layers(logical),
        torch.from_numpy(tables), torch.tensor([2 * P - 1, 0]),
        num_steps=3)
    for layer, ref in zip(got, before):
        k = layer.k.numpy()
        # Row 0 writes its last position, then two past the end.
        np.testing.assert_array_equal(k[2, P - 1], 1.0)
        np.testing.assert_array_equal(k[1], ref[0][1])
        np.testing.assert_array_equal(k[2, :P - 1], ref[0][2, :P - 1])
        assert np.isfinite(k).all()


@pytest.mark.parametrize("first_page,n_pages,length", [
    (0, 2, 8), (0, 3, 10), (1, 2, 12), (0, 3, 9)])
def test_adopt_prefill_matches_reference(first_page, n_pages, length):
    pools = _pools(first_page * 10 + n_pages)
    rng = np.random.default_rng(length)
    prefill = rng.standard_normal((LAYERS, 2, 1, length, H, D)).astype(
        np.float32)
    page_ids = rng.permutation(np.arange(1, PAGES))[:n_pages].astype(
        np.int32)
    got = paged_kv._adopt_prefill(
        _torch_layers(pools), _torch_layers(prefill),
        torch.from_numpy(page_ids).long(), first_page, n_pages=n_pages)
    want = jax_paged_kv._adopt_prefill(
        _jax_tree(pools), _jax_tree(prefill), jnp.asarray(page_ids),
        jnp.asarray(first_page, jnp.int32), n_pages=n_pages)
    _check(got, want)


def test_paged_cache_round_trip_through_adopt_gather_scatter():
    template = [LayerCache(torch.zeros(1, 16, H, D), torch.zeros(1, 16, H, D))
                for _ in range(LAYERS)]
    kv = PagedKVCache(template, num_slots=2, page_size=P, cache_size=16)
    assert kv.pages_per_slot == 4 and kv.logical_len == 16
    assert kv.allocator.num_pages == 2 * 4 + 1
    prefill = [LayerCache(torch.arange(16 * H * D, dtype=torch.float32)
                          .reshape(1, 16, H, D) + i, torch.zeros(1, 16, H, D))
               for i in range(LAYERS)]
    assert kv.allocator.reserve(3)
    n = kv.adopt(1, prefill, prompt_width=6, budget_pages=3)
    assert n == 2 and kv.allocator.reserved_pages == 1
    logical = kv.gather(kv.device_tables())
    for i in range(LAYERS):
        torch.testing.assert_close(logical[i].k[1, :8], prefill[i].k[0, :8],
                                   rtol=0, atol=0)
        assert torch.all(logical[i].k[0] == 0)
    n = kv.extend_slot(1, n, upto_position=10, budget_pages=3)
    assert n == 3 and kv.allocator.reserved_pages == 0
    for c in logical:
        c.k[1, 8:10] = 7.0
    kv.scatter(logical, kv.device_tables(), torch.tensor([0, 8]), 2)
    again = kv.gather(kv.device_tables())
    assert torch.all(again[0].k[1, 8:10] == 7.0)
    kv.release_slot(1, n, 0)
    assert kv.allocator.free_pages == 8 and not kv.tables.any()
    kv.allocator.check_invariants()


@pytest.mark.parametrize("seed,cache_len,fill_len", [
    (0, 16, 5), (1, 14, 8), (2, 16, 0), (3, 10, 9)])
def test_gather_pages_to_cache_matches_reference(seed, cache_len, fill_len):
    """Pages → a contiguous B=1 cache (null-page entries included) with
    ``index`` at ``fill_len``, the same values as the reference's."""
    pools = _pools(seed)
    rng = np.random.default_rng(200 + seed)
    row = np.zeros((4,), np.int32)
    k = int(rng.integers(1, 5))
    row[:k] = rng.permutation(np.arange(1, PAGES))[:k]
    template = _jax_tree(np.zeros((LAYERS, 2, 1, cache_len, H, D),
                                  np.float32))
    got = paged_kv._gather_pages_to_cache(
        _torch_layers(pools), torch.from_numpy(row), cache_len, fill_len)
    want = jax_paged_kv._gather_pages_to_cache(
        _jax_tree(pools), jnp.asarray(row), template,
        jnp.asarray(fill_len, jnp.int32))
    _check(got, want)
    for i, c in enumerate(got):
        assert c.index == int(want[f"layer_{i}"]["attention"]["index"])


def _twin_caches(seed, num_slots=2, cache_size=16):
    """A port and a reference PagedKVCache over the same random pools."""
    pools = _pools(seed)
    template = [LayerCache(torch.zeros(1, cache_size, H, D),
                           torch.zeros(1, cache_size, H, D))
                for _ in range(LAYERS)]
    ours = PagedKVCache(template, num_slots=num_slots, page_size=P,
                        cache_size=cache_size, num_pages=PAGES)
    ours.physical = _torch_layers(pools)
    ref = jax_paged_kv.PagedKVCache(
        _jax_tree(np.zeros((LAYERS, 2, 1, cache_size, H, D), np.float32)),
        num_slots=num_slots, page_size=P, cache_size=cache_size,
        num_pages=PAGES)
    ref.physical = _jax_tree(pools)
    return ours, ref


@pytest.mark.parametrize("page", [0, 3, PAGES - 1])
def test_read_page_layers_matches_reference(page):
    ours, ref = _twin_caches(page)
    got, want = ours.read_page_layers(page), ref.read_page_layers(page)
    assert len(got) == len(want) == 2 * LAYERS
    for a, b in zip(got, want):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("pages,fill_len", [([], 0), ([4], 3),
                                            ([2, 7], 6), ([1, 5, 8], 11)])
def test_gather_prefix_cache_matches_reference(pages, fill_len):
    ours, ref = _twin_caches(len(pages) + fill_len)
    template = _jax_tree(np.zeros((LAYERS, 2, 1, 16, H, D), np.float32))
    got = ours.gather_prefix_cache(pages, fill_len)
    want = ref.gather_prefix_cache(pages, template, fill_len)
    _check(got, want)
    assert all(c.index == fill_len for c in got)
    # A gathered cache is a copy: writing it leaves the pool alone.
    before = ours.physical[0].k.clone()
    got[0].k.fill_(9.0)
    assert torch.equal(ours.physical[0].k, before)


@pytest.mark.parametrize("keep", [0, 3, 4, 9, 16])
def test_truncate_slot_matches_reference(keep):
    """The same admission, extension and rollback through both caches:
    the same kept count, page table and allocator counts."""
    ours, ref = _twin_caches(keep)
    for kv in (ours, ref):
        assert kv.allocator.reserve(4)
        kv.tables[1, :1] = kv.allocator.alloc(1)
        kv.extend_slot(1, 1, 15, 4)
    got = ours.truncate_slot(1, 4, keep)
    want = ref.truncate_slot(1, 4, keep)
    assert got == want
    np.testing.assert_array_equal(ours.tables, ref.tables)
    for attr in ("free_pages", "reserved_pages", "inuse_pages"):
        assert getattr(ours.allocator, attr) == \
            getattr(ref.allocator, attr), attr
    ours.allocator.check_invariants()
    ours.release_slot(1, got, 4 - got)
    assert ours.allocator.free_pages == PAGES - 1


# -- the copied PageAllocator ----------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_allocator_follows_the_reference_op_for_op(seed):
    """The same random reserve/alloc/ref/unref/unreserve sequence
    through both allocators: every return value and every count
    equal."""
    rng = np.random.default_rng(seed)
    ours, ref = PageAllocator(12), jax_paged_kv.PageAllocator(12)
    held = []
    for _ in range(300):
        op = rng.integers(0, 5)
        if op == 0:
            n = int(rng.integers(1, 4))
            assert ours.reserve(n) == ref.reserve(n)
        elif op == 1 and ours.reserved_pages:
            n = int(rng.integers(1, ours.reserved_pages + 1))
            a, b = ours.alloc(n), ref.alloc(n)
            assert a == b
            held += a
        elif op == 2 and held:
            p = held[int(rng.integers(len(held)))]
            assert ours.ref(p) == ref.ref(p)
            held.append(p)
        elif op == 3 and held:
            p = held.pop(int(rng.integers(len(held))))
            ours.unref(p)
            ref.unref(p)
        elif op == 4 and ours.reserved_pages:
            ours.unreserve(1)
            ref.unreserve(1)
        for attr in ("free_pages", "reserved_pages", "retained_pages",
                     "inuse_pages"):
            assert getattr(ours, attr) == getattr(ref, attr), attr
        assert ours.available() == ref.available()
        ours.check_invariants()


class _StubCache:
    def __init__(self):
        self.idle = []

    def holds(self, page):
        return True

    def on_idle(self, page):
        self.idle.append(page)

    def on_pinned(self, page):
        self.idle.remove(page)

    def idle_pages(self):
        return list(self.idle)

    def reclaim(self, n):
        out, self.idle = self.idle[:n], self.idle[n:]
        return out

    def reclaimable(self):
        return len(self.idle)


def test_allocator_ref_retain_reclaim_cycle():
    alloc = PageAllocator(6)  # null + 5 usable
    cache = _StubCache()
    alloc.set_cache(cache)
    assert alloc.reserve(3)
    pages = alloc.alloc(3)
    assert all(alloc.refcount(p) == 1 for p in pages)
    alloc.ref(pages[0])
    assert alloc.refcount(pages[0]) == 2
    alloc.unref(pages[0])
    alloc.unref(pages[0])  # 0 → retained (cache holds it)
    assert alloc.refcount(pages[0]) == 0
    assert alloc.retained_pages == 1 and cache.idle == [pages[0]]
    assert alloc.available() == 3  # 2 free + 1 retained
    alloc.check_invariants()
    assert alloc.ref(pages[0])
    assert alloc.refcount(pages[0]) == 1 and alloc.retained_pages == 0
    alloc.unref(pages[0])
    assert alloc.reserve(3)
    got = alloc.alloc(3)  # 2 free + 1 reclaimed
    assert pages[0] in got
    alloc.check_invariants()
    for p in got + pages[1:]:
        alloc.unref(p)
    alloc.check_invariants()


def test_allocator_pin_refuses_to_starve_reservations():
    alloc = PageAllocator(4)  # 3 usable
    alloc.set_cache(_StubCache())
    assert alloc.reserve(1)
    pages = alloc.alloc(1)
    alloc.unref(pages[0])  # retained
    assert alloc.reserve(3)  # 2 free + 1 retained, all promised
    assert alloc.available() == 0
    assert not alloc.ref(pages[0])
    alloc.check_invariants()


def test_check_invariants_catches_a_leak():
    alloc = PageAllocator(5)
    assert alloc.reserve(2)
    alloc.alloc(2)
    alloc._refs.clear()  # lose two pages
    with pytest.raises(AssertionError, match="page leak"):
        alloc.check_invariants()
