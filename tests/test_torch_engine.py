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

"""The port's continuous-batching engine (the plain lane).

Port twins of tests/test_engine_continuous.py — the same prompts, seeds
and configs, on ``llama-test`` fp32 with the reference's params carried
across: every stream equals the same request run alone through the
port's ``generate`` at B=1 with the same key, under adversarial
admit/retire orderings, greedy and sampled. The B=1 reference runs at
the engine's shapes (the prompt left-padded to its bucket, the same
cache length): torch's products round rows differently at other shapes.
Then the cross-backend checks: the port engine's tokens equal the JAX
``DecodeEngine``'s on the same requests and keys; its ``stats()`` keys
and metric family names equal the reference engine's; the per-row
decode step's logits match the reference model's; the options of lanes
not ported raise.
"""

import threading
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
from kubeflow_tpu.inference.engine import engine as jax_engine_module
from kubeflow_tpu.inference.generate import init_cache as jax_init_cache
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import (
    DecodeEngine,
    EngineConfig,
    GenerateStream,
    PageAllocator,
    SlotScheduler,
    TokenEvent,
)
from kubeflow_tpu_torch.inference.engine import engine as engine_module
from kubeflow_tpu_torch.inference.generate import (
    generate,
    init_cache,
    prompt_bucket,
)
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import apply, llama_test
from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.serving.overload import (
    DeadlineExceededError,
    OverloadedError,
)

CACHE = 48
MAX_PROMPT = 16


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


def _engine(model, params, cfg, name):
    return DecodeEngine(model, params, cfg, name=name, device="cpu")


def _prompts(*lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (n,)).astype(np.int32) for n in lengths]


def _keys(n, base=100):
    return [prng.PRNGKey(base + i) for i in range(n)]


def _reference(model, params, prompt, key, max_new_tokens, **sampling):
    """The B=1 ground truth: the same prompt + per-request key through
    the port's generate(), left-padded to the engine's bucket."""
    width = prompt_bucket(len(prompt), MAX_PROMPT)
    ids = np.zeros((1, width), np.int32)
    ids[0, width - len(prompt):] = prompt
    tokens, _ = generate(
        model, params, torch.from_numpy(ids), max_new_tokens=max_new_tokens,
        rng=key[None], prompt_lengths=torch.tensor([len(prompt)]),
        **sampling)
    return tokens[0].numpy()


def _assert_pool_clean(engine):
    st = engine.stats()
    assert st["active_slots"] == 0, st
    assert st["queue_depth"] == 0, st
    assert st["free_pages"] == st["total_pages"], \
        f"leaked pages: {st}"
    assert st["reserved_pages"] == 0, st
    engine.kv.allocator.check_invariants()


# -- equality with B=1 under adversarial orderings -------------------------


def test_mid_decode_joins_mixed_lengths_bitwise_equal_greedy(
        model, params):
    """Rows join a live decode at staggered times with mixed prompt
    lengths AND mixed per-request token budgets; every row must equal
    its B=1 run. (2 slots, 5 requests: admissions necessarily
    interleave with retirements mid-decode.)"""
    cfg = EngineConfig(max_new_tokens=13, max_prompt_len=MAX_PROMPT,
                       temperature=0.0, num_slots=2, page_size=8,
                       slice_tokens=4)
    engine = _engine(model, params, cfg, "t-greedy")
    try:
        prompts = _prompts(5, 11, 3, 8, 6)
        keys = _keys(5)
        budgets = [13, 9, 5, 13, 9]
        streams = []
        for i in range(2):
            streams.append(engine.submit(prompts[i], rng=keys[i],
                                         max_new_tokens=budgets[i]))
        for s in streams:
            assert s.next_event(timeout=120.0) is not None
        for i in range(2, 5):
            streams.append(engine.submit(prompts[i], rng=keys[i],
                                         max_new_tokens=budgets[i]))
            time.sleep(0.01)  # stagger: distinct admit points
        results = [s.result(timeout=120.0) for s in streams]
        for i, (p, k, t) in enumerate(zip(prompts, keys, budgets)):
            want = _reference(model, params, p, k, t)
            np.testing.assert_array_equal(
                results[i], want,
                err_msg=f"row {i} (len={len(p)}, budget={t}) diverged "
                        f"from its B=1 reference")
        _assert_pool_clean(engine)
    finally:
        engine.stop()


def test_sampled_equality_under_churn(model, params):
    """Sampling (temperature + top_k + top_p) rides per-request key
    schedules, so mid-decode joins must not perturb any row's rng
    stream."""
    sampling = dict(temperature=0.8, top_k=50, top_p=0.95)
    cfg = EngineConfig(max_new_tokens=10, max_prompt_len=MAX_PROMPT,
                       num_slots=2, page_size=8, slice_tokens=3,
                       **sampling)
    engine = _engine(model, params, cfg, "t-sampled")
    try:
        prompts = _prompts(7, 4, 9, seed=3)
        keys = _keys(3, base=500)
        streams = [engine.submit(prompts[0], rng=keys[0])]
        assert streams[0].next_event(timeout=120.0) is not None
        streams += [engine.submit(p, rng=k)
                    for p, k in zip(prompts[1:], keys[1:])]
        results = [s.result(timeout=120.0) for s in streams]
        for i in range(3):
            want = _reference(model, params, prompts[i], keys[i], 10,
                              **sampling)
            np.testing.assert_array_equal(
                results[i], want, err_msg=f"sampled row {i} diverged")
        _assert_pool_clean(engine)
    finally:
        engine.stop()


def test_deadline_eviction_frees_slot_and_neighbors_unaffected(
        model, params):
    """A slot evicted mid-decode (deadline expiry at a slice boundary)
    fails its stream with DeadlineExceededError, frees its pages, and
    the freed slot admits a NEW request — with the surviving neighbor
    and the late joiner both still equal to B=1."""
    cfg = EngineConfig(max_new_tokens=17, max_prompt_len=MAX_PROMPT,
                       temperature=0.0, num_slots=2, page_size=8,
                       slice_tokens=4)
    engine = _engine(model, params, cfg, "t-evict")
    try:
        prompts = _prompts(6, 9, 5, seed=7)
        keys = _keys(3, base=900)
        survivor = engine.submit(prompts[0], rng=keys[0])
        victim = engine.submit(prompts[1], rng=keys[1],
                               deadline=time.monotonic() + 3600.0)
        # Wait until the victim is actually decoding, then age its
        # slot's deadline into the past — the engine must evict at the
        # next slice boundary.
        assert victim.next_event(timeout=120.0) is not None
        for slot in engine.scheduler.active_slots():
            if slot.request is not None and \
                    slot.request.stream is victim:
                slot.deadline = time.monotonic() - 0.001
                slot.request.deadline = slot.deadline
        with pytest.raises(DeadlineExceededError, match="mid-decode"):
            victim.result(timeout=120.0)
        joiner = engine.submit(prompts[2], rng=keys[2])
        np.testing.assert_array_equal(
            joiner.result(timeout=120.0),
            _reference(model, params, prompts[2], keys[2], 17),
            err_msg="joiner into the evicted slot diverged")
        np.testing.assert_array_equal(
            survivor.result(timeout=120.0),
            _reference(model, params, prompts[0], keys[0], 17),
            err_msg="survivor diverged after neighbor eviction")
        assert engine.scheduler.retired_by.get("deadline") == 1
        _assert_pool_clean(engine)
    finally:
        engine.stop()


def test_queued_request_expires_and_cancel_frees_slot(model, params):
    """Three single-slot scenarios on one engine: (a) a request whose
    deadline lapses while it waits for a slot fails from the QUEUE —
    never prefills, never binds; (b) a cancelled stream retires its slot
    at the next slice boundary and frees every page; (c) the
    queue-capacity bound sheds deadline-FREE submits with
    OverloadedError."""
    cfg = EngineConfig(max_new_tokens=13, max_prompt_len=MAX_PROMPT,
                       temperature=0.0, num_slots=1, page_size=8,
                       slice_tokens=2, queue_capacity=2)
    engine = _engine(model, params, cfg, "t-qexpire")
    try:
        prompts = _prompts(6, 5, seed=11)
        keys = _keys(2, base=1300)
        holder = engine.submit(prompts[0], rng=keys[0])
        assert holder.next_event(timeout=120.0) is not None
        queued = engine.submit(prompts[1], rng=keys[1],
                               deadline=time.monotonic() + 3600.0)
        admitted_before = engine.scheduler.admitted
        assert engine.scheduler.pending, "request should be queued"
        engine.scheduler.pending[0].deadline = time.monotonic() - 0.001
        with pytest.raises(DeadlineExceededError, match="queued"):
            queued.result(timeout=120.0)
        assert engine.scheduler.admitted == admitted_before, \
            "expired-in-queue request burned a prefill"
        np.testing.assert_array_equal(
            holder.result(timeout=120.0),
            _reference(model, params, prompts[0], keys[0], 13))

        # (b) cancel mid-decode.
        victim = engine.submit(prompts[1], rng=keys[1])
        assert victim.next_event(timeout=120.0) is not None
        victim.cancel()
        with pytest.raises(RuntimeError, match="cancelled"):
            victim.result(timeout=60.0)
        deadline = time.monotonic() + 30.0
        while engine.scheduler.occupancy() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.scheduler.retired_by.get("cancelled") == 1
        _assert_pool_clean(engine)

        # (c) deadline-free queue bound: slot holder + 2 queued fill
        # capacity; the next submit sheds synchronously.
        holder2 = engine.submit(prompts[0], rng=keys[0])
        assert holder2.next_event(timeout=120.0) is not None
        q = [engine.submit(prompts[1], rng=keys[1]) for _ in range(2)]
        with pytest.raises(OverloadedError, match="queue full"):
            engine.submit(prompts[1], rng=keys[1])
        for s in [holder2] + q:
            s.result(timeout=120.0)
        _assert_pool_clean(engine)
    finally:
        engine.stop()


def test_page_pool_contention_serializes_but_stays_correct(
        model, params):
    """A pool too small for two concurrent requests gates admission on
    reservations (FIFO holds the line); all requests still complete,
    correct, and the pool drains back to full."""
    cfg = EngineConfig(max_new_tokens=13, max_prompt_len=MAX_PROMPT,
                       temperature=0.0, num_slots=2, page_size=8,
                       slice_tokens=4, num_pages=4)
    engine = _engine(model, params, cfg, "t-pages")
    try:
        prompts = _prompts(4, 7, 6, seed=23)
        keys = _keys(3, base=1700)
        streams = [engine.submit(p, rng=k)
                   for p, k in zip(prompts, keys)]
        results = [s.result(timeout=180.0) for s in streams]
        for i in range(3):
            np.testing.assert_array_equal(
                results[i],
                _reference(model, params, prompts[i], keys[i], 13),
                err_msg=f"page-contended row {i} diverged")
        st = engine.stats()
        assert st["admitted"] == 3 and st["retired"] == {"budget": 3}
        _assert_pool_clean(engine)
    finally:
        engine.stop()


def test_early_eos_retires_early_and_pads_like_generate(model, params):
    """EOS mid-stream: the slot retires at the latch (stream stops
    emitting), the result is padded to the request budget with the EOS
    id — the exact latched shape generate() returns at B=1."""
    prompts = _prompts(6, seed=31)
    keys = _keys(1, base=2100)
    free_run = _reference(model, params, prompts[0], keys[0], 10)
    eos = int(free_run[2])
    if eos in (int(free_run[0]), int(free_run[1])):
        pytest.skip("degenerate repeated token; eos pick ambiguous")
    cfg = EngineConfig(max_new_tokens=10, max_prompt_len=MAX_PROMPT,
                       temperature=0.0, num_slots=2, page_size=8,
                       slice_tokens=4, eos_id=eos)
    engine = _engine(model, params, cfg, "t-eos")
    try:
        stream = engine.submit(prompts[0], rng=keys[0])
        events = [ev for ev in stream.events(timeout_per_event=120.0)]
        token_events = [ev for ev in events if not ev.final]
        assert len(token_events) == 3, \
            f"expected emission to stop at EOS (index 2), got " \
            f"{[ev.token for ev in token_events]}"
        want = _reference(model, params, prompts[0], keys[0], 10,
                          eos_id=eos)
        np.testing.assert_array_equal(stream.result(timeout=5.0), want)
        assert engine.scheduler.retired_by.get("eos") == 1
        _assert_pool_clean(engine)
    finally:
        engine.stop()


def test_short_join_finishes_well_before_long_neighbor(model, params):
    """A 3-token request admitted while a 21-token neighbor decodes must
    complete while the neighbor is still mid-decode."""
    cfg = EngineConfig(max_new_tokens=21, max_prompt_len=MAX_PROMPT,
                       temperature=0.0, num_slots=2, page_size=8,
                       slice_tokens=4)
    engine = _engine(model, params, cfg, "t-ttft")
    try:
        prompts = _prompts(8, 4, seed=43)
        keys = _keys(2, base=2500)
        # Warm both requests' paths first, so the measured join is
        # steady-state scheduling.
        engine.submit(prompts[0], rng=keys[0]).result(timeout=180.0)
        engine.submit(prompts[1], rng=keys[1],
                      max_new_tokens=3).result(timeout=180.0)
        long_s = engine.submit(prompts[0], rng=keys[0])
        assert long_s.next_event(timeout=60.0) is not None
        short_s = engine.submit(prompts[1], rng=keys[1],
                                max_new_tokens=3)
        # Snapshot the neighbor's progress ON THE ENGINE THREAD at the
        # moment the short stream finishes.
        snap = {}

        def on_emit():
            if short_s.done and "progress" not in snap:
                snap["progress"] = len(long_s.tokens_so_far)

        short_s.set_notify(on_emit)
        short_result = short_s.result(timeout=60.0)
        long_progress = snap.get("progress",
                                 len(long_s.tokens_so_far))
        assert long_progress < 21, (
            f"short request only completed after its long neighbor's "
            f"full decode ({long_progress}/21 tokens)")
        np.testing.assert_array_equal(
            short_result,
            _reference(model, params, prompts[1], keys[1], 3))
        np.testing.assert_array_equal(
            long_s.result(timeout=120.0),
            _reference(model, params, prompts[0], keys[0], 21))
        _assert_pool_clean(engine)
    finally:
        engine.stop()


def test_submit_rejects_request_that_can_never_fit_the_pool(
        model, params):
    """A worst-case reservation larger than the whole pool must fail
    at submit — otherwise it parks at the FIFO head forever."""
    cfg = EngineConfig(max_new_tokens=24, max_prompt_len=MAX_PROMPT,
                       temperature=0.0, num_slots=2, page_size=8,
                       slice_tokens=4, num_pages=3)  # 2 usable pages
    engine = _engine(model, params, cfg, "t-never")
    try:
        with pytest.raises(ValueError, match="worst-case"):
            engine.submit(np.zeros((8,), np.int32))
        with pytest.raises(ValueError, match="worst-case"):
            engine.submit(np.zeros((8,), np.int32),
                          max_new_tokens=24)
        stream = engine.submit(np.zeros((8,), np.int32),
                               max_new_tokens=5)  # 8+5=13 -> 2 pages
        assert stream.result(timeout=120.0).shape == (5,)
        _assert_pool_clean(engine)
    finally:
        engine.stop()


# -- host-side state machines (no model) -----------------------------------


class _FakeReq:
    def __init__(self, deadline=None, max_new_tokens=8):
        self.deadline = deadline
        self.max_new_tokens = max_new_tokens
        self.step_keys = np.arange(2 * max_new_tokens,
                                   dtype=np.uint32).reshape(-1, 2)


def test_page_allocator_reservation_invariants():
    alloc = PageAllocator(6)  # null + 5 usable
    assert alloc.free_pages == 5 and alloc.available() == 5
    assert alloc.reserve(3)
    assert alloc.available() == 2
    assert not alloc.reserve(3)  # would oversubscribe
    pages = alloc.alloc(2)
    assert len(pages) == 2 and 0 not in pages
    assert alloc.reserved_pages == 1 and alloc.free_pages == 3
    with pytest.raises(ValueError, match="without reservation"):
        alloc.alloc(2)  # only 1 page still reserved
    alloc.free(pages)
    alloc.unreserve(1)
    assert alloc.available() == 5
    with pytest.raises(ValueError, match="null page"):
        alloc.free([0])
    with pytest.raises(ValueError, match="exceeds"):
        alloc.unreserve(1)
    with pytest.raises(ValueError, match=">= 2 pages"):
        PageAllocator(1)


def test_slot_scheduler_fifo_holds_for_big_head():
    """A head request whose reservation doesn't fit must BLOCK later
    (smaller) arrivals — FIFO fairness, no starvation of big
    prompts."""
    alloc = PageAllocator(4)  # 3 usable
    sched = SlotScheduler(2, alloc)
    big, small = _FakeReq(), _FakeReq()
    sched.pending.extend([big, small])
    sizes = {id(big): 5, id(small): 1}
    assert sched.next_admittable(lambda r: sizes[id(r)]) is None
    assert list(sched.pending) == [big, small], \
        "FIFO must not skip the blocked head"
    sizes[id(big)] = 3
    assert sched.next_admittable(lambda r: sizes[id(r)]) is big


def test_slot_scheduler_bind_retire_roundtrip():
    alloc = PageAllocator(8)
    sched = SlotScheduler(2, alloc)
    req = _FakeReq()
    assert alloc.reserve(2)
    slot = sched.bind(req, prompt_width=8, pad_len=2, first_token=7,
                      done=False, budget_pages=2, deadline=None)
    assert slot.active and sched.occupancy() == 1
    assert slot.write_pos == 8 and slot.steps_done == 1
    assert slot.remaining == req.max_new_tokens - 1
    sched.retire(slot, "eos")
    assert not slot.active and sched.occupancy() == 0
    assert sched.retired_by == {"eos": 1}
    with pytest.raises(AssertionError):
        sched.retire(slot, "eos")  # double retire


def test_slot_scheduler_expired_pending_preserves_order():
    sched = SlotScheduler(1, PageAllocator(4))
    now = 1000.0
    live1 = _FakeReq(deadline=now + 5)
    dead = _FakeReq(deadline=now - 1)
    live2 = _FakeReq(deadline=None)
    sched.pending.extend([live1, dead, live2])
    assert sched.expired_pending(now=now) == [dead]
    assert list(sched.pending) == [live1, live2]


def test_slice_keys_clamp_past_schedule_end():
    req = _FakeReq(max_new_tokens=4)  # keys 0..3
    sched = SlotScheduler(1, PageAllocator(4))
    assert sched._allocator.reserve(1)
    slot = sched.bind(req, prompt_width=4, pad_len=0, first_token=1,
                      done=False, budget_pages=1, deadline=None)
    slot.steps_done = 3
    keys = SlotScheduler.slice_keys(slot, 4)
    np.testing.assert_array_equal(keys[0], req.step_keys[3])
    np.testing.assert_array_equal(keys[1], req.step_keys[3])
    np.testing.assert_array_equal(keys[3], req.step_keys[3])


def test_generate_stream_event_flow_and_notify():
    stream = GenerateStream(max_new_tokens=3)
    seen = []
    stream.set_notify(lambda: seen.append(len(stream.tokens_so_far)))
    stream._emit(TokenEvent(token=5, index=0))
    stream._emit(TokenEvent(token=9, index=1))
    assert stream.tokens_so_far == [5, 9]
    assert not stream.done
    ev = stream.next_event(timeout=1.0)
    assert (ev.token, ev.index, ev.final) == (5, 0, False)
    stream._finish(np.asarray([5, 9, 9], np.int32))
    assert stream.done
    rest = stream.drain()
    assert [e.token for e in rest] == [9, None]
    assert rest[-1].final
    np.testing.assert_array_equal(stream.result(timeout=1.0),
                                  [5, 9, 9])
    assert seen


def test_generate_stream_failure_propagates():
    stream = GenerateStream(max_new_tokens=4)
    stream._fail(DeadlineExceededError("expired mid-decode"))
    with pytest.raises(DeadlineExceededError):
        stream.result(timeout=1.0)
    ev = stream.next_event(timeout=0.1)
    assert ev is not None and ev.final and ev.error is not None
    assert stream.next_event(timeout=0.05) is None
    stream._emit(TokenEvent(token=1, index=9))
    assert stream.next_event(timeout=0.05) is None


def test_generate_stream_events_iterator_timeout():
    stream = GenerateStream(max_new_tokens=2)
    with pytest.raises(TimeoutError):
        for _ in stream.events(timeout_per_event=0.05):
            pass


def test_generate_stream_concurrent_consumer():
    """A consumer thread draining while the producer emits sees every
    token exactly once, in order."""
    stream = GenerateStream(max_new_tokens=64)
    got = []

    def consume():
        for ev in stream.events(timeout_per_event=5.0):
            if not ev.final:
                got.append(ev.token)

    t = threading.Thread(target=consume)
    t.start()
    for i in range(64):
        stream._emit(TokenEvent(token=i, index=i))
        if i % 7 == 0:
            time.sleep(0.001)
    stream._finish(np.arange(64, dtype=np.int32))
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == list(range(64))


# -- cross-backend ---------------------------------------------------------


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.0), dict(temperature=0.8, top_k=50, top_p=0.95)],
    ids=["greedy", "sampled"])
def test_tokens_equal_the_jax_engine(model, params, jax_model, jax_params,
                                     sampling):
    """The same requests, keys and config through the port's engine and
    the reference's DecodeEngine give the same tokens."""
    kw = dict(max_new_tokens=13, max_prompt_len=MAX_PROMPT, num_slots=2,
              page_size=8, slice_tokens=4, **sampling)
    prompts = _prompts(5, 11, 3, 8, 6)
    keys = _keys(5)
    budgets = [13, 9, 5, 13, 9]
    results = {}
    for name, make in (
            ("port", lambda: _engine(model, params, EngineConfig(**kw),
                                     "x-port")),
            ("jax", lambda: JaxDecodeEngine(
                jax_model, jax_params, JaxEngineConfig(**kw),
                name="x-jax"))):
        engine = make()
        try:
            streams = [engine.submit(p, rng=k, max_new_tokens=b)
                       for p, k, b in zip(prompts, keys, budgets)]
            results[name] = [s.result(timeout=180.0) for s in streams]
        finally:
            engine.stop()
    for i, (a, b) in enumerate(zip(results["port"], results["jax"])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


def test_next_key_folds_the_counter_as_the_reference(model, params,
                                                     jax_model, jax_params):
    cfg = dict(max_new_tokens=4, max_prompt_len=MAX_PROMPT, seed=7)
    port = _engine(model, params, EngineConfig(**cfg), "k-port")
    ref = JaxDecodeEngine(jax_model, jax_params, JaxEngineConfig(**cfg),
                          name="k-jax")
    try:
        for _ in range(3):
            np.testing.assert_array_equal(port._next_key(), ref._next_key())
    finally:
        port.stop()
        ref.stop()


def test_stats_keys_and_metric_families_equal_the_reference(
        model, params, jax_model, jax_params):
    kw = dict(max_new_tokens=4, max_prompt_len=MAX_PROMPT)
    port = _engine(model, params, EngineConfig(**kw), "s-port")
    ref = JaxDecodeEngine(jax_model, jax_params, JaxEngineConfig(**kw),
                          name="s-jax")
    try:
        assert set(port.stats()) == set(ref.stats())
        assert port.stats()["total_pages"] == ref.stats()["total_pages"]
    finally:
        port.stop()
        ref.stop()

    def families(module, metric_types):
        return {(type(v).__name__, v.name, v.labelnames,
                 getattr(v, "buckets", None))
                for v in vars(module).values()
                if isinstance(v, metric_types)}

    from kubeflow_tpu.obs import metrics as jax_metrics

    jax_types = (jax_metrics.Counter, jax_metrics.Gauge,
                 jax_metrics.Histogram)
    port_types = (obs_metrics.Counter, obs_metrics.Gauge,
                  obs_metrics.Histogram)
    assert families(engine_module, port_types) == \
        families(jax_engine_module, jax_types)


def test_per_row_decode_step_matches_the_reference(model, params,
                                                   jax_model, jax_params):
    """One decode step with per-row ``decode_positions`` over a cache
    holding rows at different positions: logits within the Llama parity
    tolerance, and the same cache rows written."""
    rng = np.random.default_rng(0)
    b = 3
    ks = rng.standard_normal((2, 2, b, CACHE, 2, 16)).astype(np.float32)
    tok = rng.integers(0, 512, (b, 1)).astype(np.int32)
    start = np.asarray([4, 11, 30], np.int32)
    pad = np.asarray([0, 2, 5], np.int32)
    positions = (start - pad)[:, None]
    jcache = jax_init_cache(jax_model, jax_params, b)
    for i in range(2):
        layer = jcache[f"layer_{i}"]["attention"]
        layer["k"], layer["v"] = jnp.asarray(ks[i, 0]), jnp.asarray(ks[i, 1])
    want, mutated = jax_model.apply(
        {"params": jax_params, "cache": jcache}, jnp.asarray(tok),
        jnp.asarray(positions), mutable=["cache"],
        pad_lengths=jnp.asarray(pad), decode_positions=jnp.asarray(start))
    cache = init_cache(model, params, b)
    for i in range(2):
        cache[i].k.copy_(torch.from_numpy(ks[i, 0]))
        cache[i].v.copy_(torch.from_numpy(ks[i, 1]))
    with torch.inference_mode():
        got = apply(model, params, torch.from_numpy(tok),
                    torch.from_numpy(positions),
                    pad_lengths=torch.from_numpy(pad),
                    decode_positions=torch.from_numpy(start), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for i in range(2):
        ref_k = np.asarray(mutated["cache"][f"layer_{i}"]["attention"]["k"])
        np.testing.assert_allclose(cache[i].k.numpy(), ref_k, atol=1e-5)
        assert cache[i].index == 0


@pytest.mark.parametrize("option", [
    "prefix_cache", "prefill_chunk", "host_cache_bytes", "draft"])
def test_unported_lane_options_raise(model, params, option):
    """The lane options' config errors raise ``ValueError`` as the
    reference's do: a chunk that is not a multiple of the page, a chunk
    without the prefix cache, a draft whose vocab is not the verifier's,
    a negative host-tier budget. A positive host-tier budget engages the
    tier on a prefix-cache engine and degrades to no tier without one,
    as the reference's does."""
    kw = dict(max_new_tokens=4, max_prompt_len=MAX_PROMPT)
    extra = {}
    error, match = ValueError, None
    if option == "prefix_cache":
        # The prefix lane serves; its chunks must be page-aligned.
        kw.update(prefix_cache=True, prefill_chunk=8, page_size=16)
        match = "multiple of engine_page_size"
    elif option == "prefill_chunk":
        kw["prefill_chunk"] = 8
        match = "requires engine_prefix_cache"
    elif option == "host_cache_bytes":
        for prefix, engaged in ((True, True), (False, False)):
            engine = DecodeEngine(model, params, EngineConfig(
                **kw, prefix_cache=prefix, host_cache_bytes=1 << 20),
                device="cpu")
            try:
                assert (engine.host_tier is not None) == engaged
                assert ("kv_tier" in engine.stats()) == engaged
                if engaged:
                    assert engine.prefix.host is engine.host_tier
                    assert engine.stats()["kv_tier"]["host"][
                        "budget_bytes"] == 1 << 20
            finally:
                engine.stop()
        kw.update(prefix_cache=True, host_cache_bytes=-1)
        match = "0 disables the host tier"
    else:
        kw["speculate_tokens"] = 2
        draft = llama_test(dtype="float32", cache_size=CACHE,
                           vocab_size=model.vocab_size + 1)
        extra = dict(draft_model=draft, draft_params={})
        match = "vocab_size"
    with pytest.raises(error, match=match):
        DecodeEngine(model, params, EngineConfig(**kw), device="cpu",
                     **extra)


@pytest.mark.parametrize("arg", ["handoff", "step_keys"])
def test_unported_submit_options_raise(model, params, arg):
    """``submit(handoff=)`` and ``submit(step_keys=)`` validate as the
    reference's do: the two are mutually exclusive, a handoff's budget
    must be its step-key schedule's, a resume's ``max_new_tokens`` its
    schedule's length and its key the schedule (not ``rng``)."""
    engine = _engine(model, params, EngineConfig(
        max_new_tokens=4, max_prompt_len=MAX_PROMPT), "u-submit")
    keys = np.zeros((4, 2), np.uint32)
    try:
        if arg == "handoff":
            handoff = engine.run_prefill(np.arange(1, 5, dtype=np.int32),
                                         rng=prng.PRNGKey(0))
            with pytest.raises(ValueError, match="mutually exclusive"):
                engine.submit(handoff=handoff, step_keys=keys)
            with pytest.raises(ValueError, match="step-key"):
                engine.submit(handoff=handoff, max_new_tokens=3)
        else:
            with pytest.raises(ValueError, match="mutually exclusive"):
                engine.submit(np.zeros(4, np.int32), step_keys=keys,
                              rng=prng.PRNGKey(0))
            with pytest.raises(ValueError, match="resume schedule"):
                engine.submit(np.zeros(4, np.int32), step_keys=keys,
                              max_new_tokens=3)
    finally:
        engine.stop()


def test_engine_runs_on_cuda_unless_asked(model, params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(max_new_tokens=4, max_prompt_len=MAX_PROMPT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(model, params, cfg)
    with pytest.raises(ValueError, match="cache_size"):
        DecodeEngine(model, params, EngineConfig(
            max_new_tokens=40, max_prompt_len=MAX_PROMPT), device="cpu")
