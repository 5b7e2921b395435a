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

"""The port's prefix-cache lane against the reference's.

Twins of tests/test_prefix_cache.py on ``llama-test`` fp32 with the
reference's params carried across. The engine half: with
``EngineConfig.prefix_cache`` on, every request's stream equals the
same request run alone through the port's ``generate`` at B=1 (the
prompt unpadded, as the pad-0 layout holds it) — cold, then warm
against shared pages and the copy-on-write fork of a partly matched
boundary page, sampled requests joining a live decode, eviction under
page pressure, a cancel storm — and the port engine's tokens equal the
reference ``DecodeEngine``'s on the same requests. The host half: the
copied ``PrefixCache`` driven beside the reference's through the same
operations gives the same matches, registrations and counts.
"""

import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.inference.engine import DecodeEngine as JaxDecodeEngine
from kubeflow_tpu.inference.engine import EngineConfig as JaxEngineConfig
from kubeflow_tpu.inference.engine import PageAllocator as JaxPageAllocator
from kubeflow_tpu.inference.engine import PrefixCache as JaxPrefixCache
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.obs import metrics as ref_metrics
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import (
    DecodeEngine,
    EngineConfig,
    PageAllocator,
    PrefixCache,
)
from kubeflow_tpu_torch.inference.generate import generate
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import llama_test
from kubeflow_tpu_torch.obs import metrics as obs_metrics

CACHE = 64
MAX_PROMPT = 24
PAGE = 4


@pytest.fixture(scope="module")
def jax_model():
    return jax_llama_test(dtype=jnp.float32, cache_size=CACHE)


@pytest.fixture(scope="module")
def jax_params(jax_model):
    ids = jnp.zeros((1, 8), jnp.int32)
    return nn.meta.unbox(jax_model.init(jax.random.PRNGKey(0), ids)["params"])


@pytest.fixture(scope="module")
def model():
    return llama_test(dtype="float32", cache_size=CACHE)


@pytest.fixture(scope="module")
def params(model, jax_params):
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(jax_params, sep="/").items()}
    return convert.params_from_flax(flat, model, device="cpu")


def _engine(model, params, name, **kw):
    cfg = EngineConfig(max_prompt_len=MAX_PROMPT, page_size=PAGE,
                       prefix_cache=True, **kw)
    return DecodeEngine(model, params, cfg, name=name, device="cpu")


def _reference(model, params, prompt, key, max_new_tokens, **sampling):
    """B=1 ``generate`` of the unpadded prompt with the request's key."""
    tokens, _ = generate(
        model, params, torch.from_numpy(prompt)[None],
        max_new_tokens=max_new_tokens, rng=key[None],
        prompt_lengths=torch.tensor([len(prompt)]), **sampling)
    return tokens[0].numpy()


def _prefixed_prompts(prefix_len, suffix_lens, seed=0):
    """Prompts sharing a common ``prefix_len``-token head with
    per-request random suffixes (the reference test's generator)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 512, (prefix_len,)).astype(np.int32)
    out = []
    for i, n in enumerate(suffix_lens):
        r = np.random.RandomState(1000 + seed * 100 + i)
        suffix = r.randint(0, 512, (n,)).astype(np.int32)
        out.append(np.concatenate([prefix, suffix]) if n else
                   prefix.copy())
    return out


def _keys(n, base=100):
    return [prng.PRNGKey(base + i) for i in range(n)]


def _assert_drained(engine):
    """Quiesced engine: no slots, no queue, no reservations; cached
    pages are the only residents and a clear releases them all."""
    st = engine.stats()
    assert st["active_slots"] == 0 and st["queue_depth"] == 0, st
    assert st["reserved_pages"] == 0, st
    engine.kv.allocator.check_invariants()
    engine.prefix.check_invariants()
    assert st["free_pages"] + st["retained_pages"] == st["total_pages"], st
    engine.clear_prefix_cache()
    st = engine.stats()
    assert st["free_pages"] == st["total_pages"], f"leaked pages: {st}"
    engine.kv.allocator.check_invariants()


# -- the engine: streams equal B=1 on shared pages ------------------------


def test_prefix_hits_bitwise_equal_greedy_including_cow_fork(model, params):
    """11 shared tokens over 4-token pages (2 full blocks + a partial
    boundary), cold then warm: full-block sharing, the CoW fork of the
    boundary page and the whole-prompt-cached case."""
    engine = _engine(model, params, "px-greedy", max_new_tokens=9,
                     temperature=0.0, num_slots=2, slice_tokens=4)
    try:
        prompts = _prefixed_prompts(11, [3, 5, 2, 0], seed=1)
        keys = _keys(4)
        cold = engine.submit(prompts[0], rng=keys[0])
        assert cold.next_event(timeout=120.0) is not None
        streams = [engine.submit(p, rng=k)
                   for p, k in zip(prompts[1:], keys[1:])]
        results = [cold.result(120.0)] + [s.result(120.0) for s in streams]
        for i in range(4):
            np.testing.assert_array_equal(
                results[i], _reference(model, params, prompts[i], keys[i], 9),
                err_msg=f"prefix-shared row {i} diverged from B=1")
        st = engine.stats()["prefix_cache"]
        assert st["hits"] == 3 and st["misses"] == 1, st
        assert st["saved_prefill_tokens"] > 0
        _assert_drained(engine)
    finally:
        engine.stop()


def test_prefix_hits_bitwise_equal_sampled_mid_decode_join(model, params):
    """Sampled requests joining a LIVE decode pin the donor's prompt
    pages (ref count > 1 while it decodes) without perturbing any
    stream."""
    sampling = dict(temperature=0.8, top_k=50, top_p=0.95)
    engine = _engine(model, params, "px-sampled", max_new_tokens=13,
                     num_slots=2, slice_tokens=3, **sampling)
    try:
        prompts = _prefixed_prompts(9, [4, 6, 2], seed=5)
        keys = _keys(3, base=500)
        donor = engine.submit(prompts[0], rng=keys[0])
        assert donor.next_event(timeout=120.0) is not None
        joiners = [engine.submit(p, rng=k)
                   for p, k in zip(prompts[1:], keys[1:])]
        results = [donor.result(120.0)] + [s.result(120.0) for s in joiners]
        for i in range(3):
            np.testing.assert_array_equal(
                results[i], _reference(model, params, prompts[i], keys[i],
                                       13, **sampling),
                err_msg=f"sampled prefix-shared row {i} diverged")
        assert engine.stats()["prefix_cache"]["hits"] >= 1
        _assert_drained(engine)
    finally:
        engine.stop()


def test_eviction_under_page_pressure_stays_correct(model, params):
    """A pool too small to retain every prompt evicts LRU zero-ref
    cached pages: admissions never deadlock, later requests still equal
    B=1, and a re-run of an evicted prefix re-registers it."""
    engine = _engine(model, params, "px-evict", max_new_tokens=7,
                     temperature=0.0, num_slots=1, slice_tokens=3,
                     num_pages=10)
    try:
        groups = [_prefixed_prompts(10, [2, 1], seed=s) for s in (11, 12, 13)]
        keys = _keys(6, base=900)
        k = 0
        for group in groups:
            for prompt in group:
                got = engine.submit(prompt, rng=keys[k]).result(180.0)
                np.testing.assert_array_equal(
                    got, _reference(model, params, prompt, keys[k], 7),
                    err_msg=f"request {k} diverged under eviction pressure")
                engine.kv.allocator.check_invariants()
                engine.prefix.check_invariants()
                k += 1
        st = engine.stats()["prefix_cache"]
        assert st["evicted_pages"] > 0, st
        assert st["hits"] >= 1, st
        _assert_drained(engine)
    finally:
        engine.stop()


def test_cancel_storm_releases_pages_exactly_once(model, params):
    """Streams cancelled while queued or mid-decode release their
    reservations and shared pages exactly once; every stream sees one
    terminal event."""
    engine = _engine(model, params, "px-cancel", max_new_tokens=9,
                     temperature=0.0, num_slots=2, slice_tokens=3,
                     num_pages=12)
    try:
        rng = np.random.RandomState(17)
        prompts = _prefixed_prompts(9, [2, 3, 1, 4, 2, 3, 1, 2], seed=23)
        keys = _keys(len(prompts), base=1700)
        for _ in range(3):
            streams = []
            for p, k in zip(prompts, keys):
                streams.append(engine.submit(p, rng=k))
                roll = rng.rand()
                if roll < 0.35:
                    streams[-1].cancel()  # often still queued
                elif roll < 0.55:
                    streams[-1].next_event(timeout=120.0)
                    streams[-1].cancel()  # mid-decode
            for s in streams:
                try:
                    s.result(timeout=180.0)
                except RuntimeError:
                    pass  # cancelled
                assert s.done
            deadline = time.monotonic() + 30.0
            while (engine.scheduler.occupancy()
                   or engine.scheduler.queue_depth()) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            engine.kv.allocator.check_invariants()
            engine.prefix.check_invariants()
            assert engine.kv.allocator.reserved_pages == 0
        _assert_drained(engine)
    finally:
        engine.stop()


def test_prefix_metrics_exposed_and_strictly_parseable(model, params):
    """The prefix families render on the port's registry in a form the
    reference's strict parser accepts."""
    engine = _engine(model, params, "px-metrics", max_new_tokens=5,
                     temperature=0.0, num_slots=1, slice_tokens=4)
    try:
        prompts = _prefixed_prompts(9, [1, 2], seed=41)
        for p, k in zip(prompts, _keys(2, base=3100)):
            engine.submit(p, rng=k).result(120.0)
        parsed = ref_metrics.parse_exposition(obs_metrics.render())
        for family in ("kft_engine_prefix_hits_total",
                       "kft_engine_prefix_misses_total",
                       "kft_engine_prefix_evicted_pages_total",
                       "kft_engine_prefix_saved_tokens",
                       "kft_engine_prefix_cached_pages",
                       "kft_engine_page_occupancy"):
            assert any(family in name for name in parsed), family
        stats = engine.stats()
        assert 0.0 <= stats["page_occupancy"] <= 1.0
        assert stats["prefix_cache"]["hits"] == 1
        assert engine.probe_prefix(prompts[1]) >= 9
        _assert_drained(engine)
        assert engine.probe_prefix(prompts[1]) == 0
    finally:
        engine.stop()


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.0), dict(temperature=0.8, top_k=50, top_p=0.95)],
    ids=["greedy", "sampled"])
def test_prefix_tokens_equal_the_jax_engine(model, params, jax_model,
                                            jax_params, sampling):
    """The same prefix mix (a cold request, then hits with full-block
    sharing and a boundary fork) through the port's engine and the
    reference's gives the same tokens and the same prefix stats."""
    kw = dict(max_new_tokens=9, max_prompt_len=MAX_PROMPT, num_slots=2,
              page_size=PAGE, slice_tokens=4, prefix_cache=True, **sampling)
    prompts = _prefixed_prompts(11, [3, 5, 2, 0], seed=1)
    keys = _keys(4)
    results, stats = {}, {}
    for name, make in (
            ("port", lambda: DecodeEngine(model, params, EngineConfig(**kw),
                                          name="pxj-port", device="cpu")),
            ("jax", lambda: JaxDecodeEngine(
                jax_model, jax_params, JaxEngineConfig(**kw),
                name="pxj-jax"))):
        engine = make()
        try:
            first = engine.submit(prompts[0], rng=keys[0])
            out = [first.result(120.0)]
            streams = [engine.submit(p, rng=k)
                       for p, k in zip(prompts[1:], keys[1:])]
            results[name] = out + [s.result(120.0) for s in streams]
            stats[name] = engine.stats()
        finally:
            engine.stop()
    for i, (a, b) in enumerate(zip(results["port"], results["jax"])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert set(stats["port"]) == set(stats["jax"])
    assert stats["port"]["prefix_cache"] == stats["jax"]["prefix_cache"]


# -- the copied PrefixCache beside the reference's -------------------------


def _twins(num_pages):
    ours, ref = PageAllocator(num_pages), JaxPageAllocator(num_pages)
    return (ours, PrefixCache(PAGE, ours)), (ref, JaxPrefixCache(PAGE, ref))


def _same_match(a, b):
    assert [e.page for e in a.entries] == [e.page for e in b.entries]
    assert (a.fork is None) == (b.fork is None)
    if a.fork is not None:
        assert a.fork.page == b.fork.page
    assert (a.fork_len, a.matched) == (b.fork_len, b.matched)


def test_radix_match_register_partial_and_collision_guard():
    """Twin of the reference's radix test, run on both caches: the same
    matches, registrations, custody counts and clear."""
    results = []
    for alloc, cache in _twins(12):
        prompt = list(range(1, 12))  # 2 full blocks + 3 rest
        assert alloc.reserve(3)
        pages = alloc.alloc(3)
        assert cache.register(prompt, pages) == 3
        m = cache.match(prompt)
        assert [e.page for e in m.entries] == pages[:2]
        assert m.fork is not None and m.fork_len == 2 and m.matched == 10
        m2 = cache.match(prompt[:4] + [99, 98, 97, 96, 95])
        assert [e.page for e in m2.entries] == pages[:1]
        assert m2.fork is None and m2.matched == 4
        assert alloc.reserve(3)
        pages2 = alloc.alloc(3)
        assert cache.register(prompt[:10], pages2) == 0
        cache.check_invariants()
        alloc.check_invariants()
        for p in reversed(pages):
            alloc.unref(p)
        for p in reversed(pages2):
            alloc.unref(p)
        alloc.check_invariants()
        assert alloc.retained_pages == 3
        results.append((m, m2, cache.stats(), cache.clear(),
                        alloc.free_pages))
        alloc.check_invariants()
    (m, m2, st, cleared, free), (rm, rm2, rst, rcleared, rfree) = results
    _same_match(m, rm)
    _same_match(m2, rm2)
    assert (st, cleared, free) == (rst, rcleared, rfree) == (st, 3, 11)


@pytest.mark.parametrize("seed", [7, 8])
def test_eviction_fuzz_no_deadlock_no_leak(seed):
    """The reference's eviction fuzz, each step applied to both caches:
    admit (match, pin, reserve the private remainder, alloc the prompt
    pages, register) and retire in random interleavings over a tiny
    pool; every match, pin, reservation and count equal, invariants
    held after every step, no deadlock, and the pool drains."""
    rng = np.random.RandomState(seed)
    (alloc, cache), (ralloc, rcache) = _twins(14)
    bases = [list(rng.randint(0, 50, (10,))) for _ in range(3)]
    prompts = [b + list(rng.randint(0, 50, (rng.randint(0, 5),)))
               for b in bases for _ in range(4)]
    live, pending = [], []

    def pages_for(n):
        return -(-n // PAGE)

    def try_admit(prompt):
        budget = pages_for(len(prompt) + 6)
        m = cache.pin(cache.match(prompt))
        rm = rcache.pin(rcache.match(prompt))
        _same_match(m, rm)
        ok = alloc.reserve(budget - len(m.entries))
        assert ok == ralloc.reserve(budget - len(rm.entries))
        if not ok:
            cache.unpin(m)
            rcache.unpin(rm)
            return False
        if m.fork is not None:
            cache.unpin_fork(m)
            rcache.unpin_fork(rm)
        n_priv = pages_for(len(prompt)) - len(m.entries)
        priv, rpriv = alloc.alloc(n_priv), ralloc.alloc(n_priv)
        assert priv == rpriv
        rows = m.shared_pages + priv
        assert cache.register(prompt, rows) == rcache.register(prompt, rows)
        live.append((rows, budget))
        return True

    def retire(i):
        rows, budget = live.pop(i)
        for a in (alloc, ralloc):
            for p in reversed(rows):
                a.unref(p)
            a.unreserve(budget - len(rows))

    def check():
        alloc.check_invariants()
        cache.check_invariants()
        for attr in ("free_pages", "reserved_pages", "retained_pages",
                     "inuse_pages"):
            assert getattr(alloc, attr) == getattr(ralloc, attr), attr
        assert cache.stats() == rcache.stats()
        assert cache.idle_pages() == rcache.idle_pages()

    for _ in range(600):
        op = rng.rand()
        if op < 0.5 and len(live) < 3:
            prompt = prompts[rng.randint(len(prompts))]
            if not try_admit(prompt):
                pending.append(prompt)
        elif op < 0.8 and live:
            retire(rng.randint(len(live)))
        elif pending:
            while pending and try_admit(pending[0]):
                pending.pop(0)
        check()
    while live:
        retire(0)
    while pending:
        assert try_admit(pending[0]), "FIFO head blocked with an empty " \
            "engine — deadlock"
        pending.pop(0)
        while live:
            retire(0)
        check()
    assert alloc.reserved_pages == 0 and alloc.inuse_pages == 0
    assert cache.clear() == rcache.clear()
    assert alloc.free_pages == ralloc.free_pages == 13
    check()
