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

"""The host KV tier and fleet KV blocks in the port against the
reference.

Twins of tests/test_prefix_cache.py's tier tests (the eviction fuzz
across both tiers, spill and re-adopt greedy, a sampled join mid-decode
over re-adopted blocks, the fleet export/import round trip), of
tests/test_wire.py's kv-blocks codec (byte-exact in fp32 and bf16, the
geometry gate) and of tests/test_kv_store.py (all but the rendezvous
owner, which needs the proxy), on ``llama-test`` fp32 with the
reference's params carried across. Blocks cross backends on a 12-layer
``llama-test``: its ``layer_10`` sorts before ``layer_2`` in the
reference's tree-flatten order, so a block whose leaves went in layer
order would land layer 10's K/V in layer 2.
"""

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.inference.engine import DecodeEngine as JaxDecodeEngine
from kubeflow_tpu.inference.engine import EngineConfig as JaxEngineConfig
from kubeflow_tpu.inference.generate import init_cache as jax_init_cache
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.serving import wire as jax_wire
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import (
    DecodeEngine,
    EngineConfig,
    HostKVTier,
    PageAllocator,
    PrefixCache,
)
from kubeflow_tpu_torch.inference.engine.paged_kv import kv_leaf_order
from kubeflow_tpu_torch.inference.engine.prefix_cache import (
    _ROOT,
    _block_key,
)
from kubeflow_tpu_torch.inference.generate import generate
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import Llama, llama_test
from kubeflow_tpu_torch.serving import kv_store, wire

CACHE = 64
MAX_PROMPT = 24
PAGE = 4
HOST_BYTES = 64 * 1024 * 1024


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


def _carry(jax_params, model):
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(jax_params, sep="/").items()}
    return convert.params_from_flax(flat, model, device="cpu")


@pytest.fixture(scope="module")
def params(model, jax_params):
    return _carry(jax_params, model)


def _reference(model, params, prompt, key, max_new_tokens, **sampling):
    """B=1 ``generate`` of the unpadded prompt with the request's key."""
    tokens, _ = generate(
        model, params, torch.from_numpy(prompt)[None],
        max_new_tokens=max_new_tokens, rng=key[None],
        prompt_lengths=torch.tensor([len(prompt)]), **sampling)
    return tokens[0].numpy()


def _prefixed_prompts(prefix_len, suffix_lens, seed=0):
    """Prompts sharing a ``prefix_len``-token head with per-request
    random suffixes (the reference tests' generator)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 512, (prefix_len,)).astype(np.int32)
    out = []
    for i, n in enumerate(suffix_lens):
        r = np.random.RandomState(1000 + seed * 100 + i)
        suffix = r.randint(0, 512, (n,)).astype(np.int32)
        out.append(np.concatenate([prefix, suffix]) if n else prefix.copy())
    return out


def _keys(n, base=100):
    return [prng.PRNGKey(base + i) for i in range(n)]


def _assert_drained(engine):
    """Quiesced: no slots, queue or reservations; a clear of the index
    releases every page."""
    st = engine.stats()
    assert st["active_slots"] == 0 and st["queue_depth"] == 0, st
    assert st["reserved_pages"] == 0, st
    engine.kv.allocator.check_invariants()
    engine.prefix.check_invariants()
    engine.clear_prefix_cache()
    st = engine.stats()
    assert st["free_pages"] == st["total_pages"], f"leaked pages: {st}"


def _tier_engine(model, params, name, **kw):
    cfg = dict(max_new_tokens=7, max_prompt_len=MAX_PROMPT,
               temperature=0.0, num_slots=1, page_size=PAGE,
               slice_tokens=3, num_pages=10, prefix_cache=True,
               host_cache_bytes=HOST_BYTES)
    cfg.update(kw)
    return DecodeEngine(model, params, EngineConfig(**cfg), name=name,
                        device="cpu")


# -- the host tier ------------------------------------------------------------


def test_tiered_eviction_fuzz_no_leak_across_tiers():
    """Random admit/retire over a tiny pool with a host tier: reclaim
    spills full entries, matches walk into the host tier and re-adopt,
    a fleet 'fetch' imports chain blocks as a peer would. The
    allocator's and index's invariants and the host byte ledger hold
    after every step; a small host budget forces host-side evictions;
    at the end both tiers drain to zero."""
    rng = np.random.RandomState(23)
    P = 4
    alloc = PageAllocator(14)  # 13 usable
    cache = PrefixCache(P, alloc)
    host = HostKVTier(12 * 32)  # 32 bytes a fuzz block

    def fake_layers(block):
        # Content keyed by the block so a wrong splice would show.
        return [np.full((P, 2), block[0], np.float32)]

    cache.set_host_tier(host)
    cache.set_spill(lambda e: host.put(e.key, e.tokens,
                                       fake_layers(e.tokens)))
    bases = [list(rng.randint(0, 50, (10,))) for _ in range(3)]
    prompts = [b + list(rng.randint(0, 50, (rng.randint(0, 5),)))
               for b in bases for _ in range(4)]
    live, pending = [], []

    def pages_for(n):
        return -(-n // P)

    def try_admit(prompt):
        budget = pages_for(len(prompt) + 6)
        match = cache.pin(cache.match(prompt))
        if not alloc.reserve(budget - len(match.entries)):
            cache.unpin(match)
            return False
        if match.fork is not None:
            cache.unpin_fork(match)
        for hb in match.host_entries:
            assert hb.layers[0][0, 0].item() == hb.tokens[0]
        priv = alloc.alloc(pages_for(len(prompt)) - len(match.entries))
        rows = match.shared_pages + priv
        cache.register(prompt, rows)
        host.note_readopted(len(match.host_entries))
        live.append((rows, budget))
        return True

    def retire(i):
        rows, budget = live.pop(i)
        for p in reversed(rows):
            alloc.unref(p)
        alloc.unreserve(budget - len(rows))

    def fleet_import(prompt):
        parent = _ROOT
        for j in range(len(prompt) // P):
            block = tuple(prompt[j * P:(j + 1) * P])
            key = _block_key(parent, block)
            host.put(key, block, fake_layers(block), imported=True)
            parent = key

    for _ in range(600):
        op = rng.rand()
        if op < 0.45 and len(live) < 3:
            prompt = prompts[rng.randint(len(prompts))]
            if not try_admit(prompt):
                pending.append(prompt)
        elif op < 0.75 and live:
            retire(rng.randint(len(live)))
        elif op < 0.85:
            fleet_import(prompts[rng.randint(len(prompts))])
        elif pending:
            while pending and try_admit(pending[0]):
                pending.pop(0)
        alloc.check_invariants()
        cache.check_invariants()
        host.check_accounting()
    while live:
        retire(0)
    while pending:
        assert try_admit(pending[0]), "FIFO head blocked on an empty pool"
        pending.pop(0)
        while live:
            retire(0)
        alloc.check_invariants()
        cache.check_invariants()
        host.check_accounting()
    assert host.spilled_blocks > 0 and host.readopted_blocks > 0
    assert host.evicted_blocks > 0 and host.imported_blocks > 0
    assert alloc.reserved_pages == 0 and alloc.inuse_pages == 0
    cache.clear()
    assert alloc.free_pages == 13
    host.clear()
    assert host.resident_blocks() == 0 and host.resident_bytes() == 0
    host.check_accounting()


def test_host_tier_spill_readopt_bitwise_greedy(model, params):
    """A pool too small to keep every conversation spills full prefix
    blocks to host RAM; a revisit walks into the host tier, splices the
    blocks back and equals B=1 (a non-aligned prefix, so with the CoW
    fork too). ``stats()["kv_tier"]`` carries the tier."""
    engine = _tier_engine(model, params, "t-greedy")
    try:
        groups = [_prefixed_prompts(10, [2, 1], seed=s)
                  for s in (31, 32, 33)]
        keys = _keys(6, base=3100)
        k = 0
        for group in groups:
            for prompt in group:
                np.testing.assert_array_equal(
                    engine.submit(prompt, rng=keys[k]).result(180.0),
                    _reference(model, params, prompt, keys[k], 7),
                    err_msg=f"request {k} diverged with the host tier on")
                engine.kv.allocator.check_invariants()
                engine.prefix.check_invariants()
                engine.host_tier.check_accounting()
                k += 1
        tier = engine.stats()["kv_tier"]
        assert tier["host"]["spilled_blocks"] > 0, tier
        before = tier["host"]["readopted_blocks"]
        hits = engine.stats()["prefix_cache"]["hits"]
        revisit = _prefixed_prompts(10, [3], seed=31)[0]
        key = _keys(1, base=3200)[0]
        np.testing.assert_array_equal(
            engine.submit(revisit, rng=key).result(180.0),
            _reference(model, params, revisit, key, 7),
            err_msg="host re-adopt diverged from B=1")
        tier = engine.stats()["kv_tier"]
        assert tier["host"]["readopted_blocks"] > before, tier
        assert engine.stats()["prefix_cache"]["hits"] > hits
        assert set(tier) == {"host", "fetch_hits", "fetch_misses",
                             "fetch_errors", "fetched_blocks"}
        assert set(tier["host"]) == {
            "budget_bytes", "resident_bytes", "resident_blocks",
            "spilled_blocks", "imported_blocks", "evicted_blocks",
            "readopted_blocks"}
        _assert_drained(engine)
        engine.host_tier.check_accounting()
    finally:
        engine.stop()
    assert engine.host_tier.resident_bytes() == 0


def test_host_tier_sampled_mid_decode_join_bitwise(model, params):
    """Sampled decode over re-adopted host blocks with a live join: the
    donor re-adopts a spilled conversation and is still decoding when a
    sharer pins its re-registered pages. Both equal B=1."""
    sampling = dict(temperature=0.8, top_k=50, top_p=0.95)
    engine = _tier_engine(model, params, "t-sampled", num_slots=2,
                          num_pages=13, **sampling)
    try:
        conv = _prefixed_prompts(12, [2, 3, 2], seed=41)
        fills = [_prefixed_prompts(12, [2], seed=s)[0] for s in (42, 43, 44)]
        keys = _keys(6, base=4100)
        engine.submit(conv[0], rng=keys[0]).result(180.0)
        for i, fill in enumerate(fills):
            engine.submit(fill, rng=keys[1 + i]).result(180.0)
        host = engine.stats()["kv_tier"]["host"]
        assert host["spilled_blocks"] > 0, host
        before = host["readopted_blocks"]
        donor = engine.submit(conv[1], rng=keys[4])
        assert donor.next_event(timeout=120.0) is not None
        joiner = engine.submit(conv[2], rng=keys[5])
        for got, prompt, key in zip([donor.result(120.0),
                                     joiner.result(120.0)],
                                    conv[1:], keys[4:]):
            np.testing.assert_array_equal(
                got, _reference(model, params, prompt, key, 7, **sampling),
                err_msg="sampled tier re-adopt/join diverged")
        assert engine.stats()["kv_tier"]["host"]["readopted_blocks"] > \
            before
        _assert_drained(engine)
        engine.host_tier.check_accounting()
    finally:
        engine.stop()


def test_fleet_export_import_roundtrip_bitwise(model, params):
    """Replica A exports a warmed prompt's full blocks; replica B imports
    them into its host tier (chain keys from the tokens, never the
    peer's) and its first request on the conversation hits and equals
    B=1. Malformed imports land nothing and raise nothing."""
    owner = _tier_engine(model, params, "t-owner")
    asker = _tier_engine(model, params, "t-asker")
    try:
        prompts = _prefixed_prompts(12, [2, 3], seed=51)
        keys = _keys(2, base=5100)
        owner.submit(prompts[0], rng=keys[0]).result(180.0)
        blocks = owner.export_prefix_blocks(prompts[0])
        assert len(blocks) == 3, len(blocks)
        imported = asker.import_prefix_blocks(blocks)
        assert imported == 3
        asker.note_kv_fetch("hit", blocks=imported)
        hits = asker.stats()["prefix_cache"]["hits"]
        np.testing.assert_array_equal(
            asker.submit(prompts[1], rng=keys[1]).result(180.0),
            _reference(model, params, prompts[1], keys[1], 7),
            err_msg="fleet-fetched blocks diverged from cold prefill")
        st = asker.stats()
        assert st["prefix_cache"]["hits"] > hits
        assert st["kv_tier"]["fetch_hits"] == 1
        assert st["kv_tier"]["fetched_blocks"] == 3
        assert st["kv_tier"]["host"]["imported_blocks"] == 3
        assert asker.import_prefix_blocks([]) == 0
        assert asker.import_prefix_blocks(
            [(tuple(range(PAGE + 1)), blocks[0][1])]) == 0
        assert asker.import_prefix_blocks(
            [(blocks[0][0], blocks[0][1][:1])]) == 0
        asker.note_kv_fetch("miss")
        asker.note_kv_fetch("error")
        st = asker.stats()["kv_tier"]
        assert (st["fetch_misses"], st["fetch_errors"]) == (1, 1)
        _assert_drained(asker)
        _assert_drained(owner)
    finally:
        owner.stop()
        asker.stop()


def test_host_tier_metric_families_and_teardown(model, params):
    """The ``kft_engine_kv_host_*`` and fetch families render for a
    tiered engine, and ``stop()`` clears the tier and its callbacks."""
    from kubeflow_tpu_torch.obs import metrics as obs_metrics

    engine = _tier_engine(model, params, "t-metrics")
    try:
        for prompt in [p for s in (61, 62, 63)
                       for p in _prefixed_prompts(10, [2], seed=s)]:
            engine.submit(prompt, rng=prng.PRNGKey(1)).result(180.0)
        assert engine.host_tier.resident_blocks() > 0
        text = obs_metrics.render()
        for family in ("kft_engine_kv_host_spilled_blocks_total",
                       "kft_engine_kv_host_resident_bytes",
                       "kft_engine_kv_host_resident_blocks"):
            assert f'{family}{{model="t-metrics"}}' in text, family
    finally:
        engine.stop()
    assert engine.host_tier.resident_blocks() == 0
    # The callback is cleared: the child no longer reads the engine.
    assert 'kft_engine_kv_host_resident_bytes{model="t-metrics"} 0\n' in \
        obs_metrics.render()


# -- the kv-blocks codec ------------------------------------------------------


def _kv_blocks(n=2, page=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(tuple(int(t) for t in rng.randint(0, 100, (page,))),
             [rng.rand(page, 2, 3).astype(np.float32) for _ in range(2)])
            for _ in range(n)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kv_blocks_roundtrip_byte_exact(writer):
    """Blocks round-trip byte-exact, chains and order kept, whichever
    package wrote them."""
    blocks = _kv_blocks(n=3)
    enc = (wire if writer == "port" else jax_wire).encode_kv_blocks
    data = enc("llama_test", 7, 4, blocks)
    for dec in (wire.decode_kv_blocks, jax_wire.decode_kv_blocks):
        out = dec(data, model="llama_test", version=7, page_size=4)
        assert len(out) == 3
        for (tok_in, lay_in), (tok_out, lay_out) in zip(blocks, out):
            assert tok_out == tok_in and len(lay_out) == len(lay_in)
            for a, b in zip(lay_in, lay_out):
                assert b.dtype == a.dtype
                np.testing.assert_array_equal(b, a)


def test_kv_blocks_roundtrip_bf16_byte_exact():
    """bf16 K/V crosses the wire bit for bit in both directions: the
    port's CPU tensors to the reference's ml_dtypes arrays and back."""
    layer = np.asarray(jnp.linspace(-3.0, 3.0, 24, dtype=jnp.bfloat16)
                       ).reshape(4, 2, 3)
    words = torch.from_numpy(layer.view(np.int16).copy())
    port_layer = words.view(torch.bfloat16)
    data = wire.encode_kv_blocks("m", 1, 4, [((1, 2, 3, 4), [port_layer])])
    [(tokens, layers)] = jax_wire.decode_kv_blocks(data, model="m",
                                                   version=1, page_size=4)
    assert tokens == (1, 2, 3, 4) and layers[0].dtype == layer.dtype
    np.testing.assert_array_equal(layers[0], layer)
    data = jax_wire.encode_kv_blocks("m", 1, 4, [((1, 2, 3, 4), [layer])])
    [(tokens, layers)] = wire.decode_kv_blocks(data, model="m", version=1,
                                               page_size=4)
    assert layers[0].dtype == torch.bfloat16
    assert torch.equal(layers[0].view(torch.int16), words)


def test_kv_blocks_rejects_geometry_and_identity_mismatch():
    data = wire.encode_kv_blocks("llama_test", 7, 4, _kv_blocks())
    assert len(wire.decode_kv_blocks(data, model="llama_test")) == 2
    with pytest.raises(ValueError, match="model"):
        wire.decode_kv_blocks(data, model="other-model")
    with pytest.raises(ValueError, match="version"):
        wire.decode_kv_blocks(data, model="llama_test", version=8)
    with pytest.raises(ValueError, match="page"):
        wire.decode_kv_blocks(data, model="llama_test", page_size=8)
    with pytest.raises(ValueError, match="malformed"):
        wire.decode_kv_blocks(b"not msgpack at all", model="llama_test")
    bad = wire.encode_kv_blocks(
        "llama_test", 7, 4, [((1, 2, 3), [np.zeros((3, 2, 2), np.float32)])])
    with pytest.raises(ValueError, match="tokens"):
        wire.decode_kv_blocks(bad, model="llama_test")
    empty = wire.encode_kv_blocks("llama_test", 7, 4, [((1, 2, 3, 4), [])])
    with pytest.raises(ValueError, match="no KV layers"):
        wire.decode_kv_blocks(empty, model="llama_test")


# -- the fleet pull-through (serving/kv_store.py) ------------------------------


class _StubEngine:
    """The engine surface prefetch_into touches."""

    def __init__(self, *, host_tier=object(), probe=0, imports=None,
                 page_size=4):
        self.host_tier = host_tier
        self.config = type("C", (), {"page_size": page_size})()
        self._probe = probe
        self._imports = imports
        self.fetch_notes = []
        self.imported_payloads = []

    def probe_prefix(self, prompt):
        return self._probe

    def import_prefix_blocks(self, blocks):
        self.imported_payloads.append(blocks)
        if isinstance(self._imports, Exception):
            raise self._imports
        return len(blocks) if self._imports is None else self._imports

    def note_kv_fetch(self, outcome, *, blocks=0):
        self.fetch_notes.append((outcome, blocks))


def test_kv_fetch_path_and_prompt_of():
    assert kv_store.kv_fetch_path("m") == "/v1/models/m:kv/fetch"
    assert kv_store.kv_fetch_path("m", 3) == \
        "/v1/models/m/versions/3:kv/fetch"
    assert kv_store.prompt_of([[1, 2, 3], [9]]) == [1, 2, 3]
    assert kv_store.prompt_of(np.asarray([[4, 5]])) == [4, 5]
    for junk in ([[]], [], "garbage", [["x", "y"]], None):
        assert kv_store.prompt_of(junk) is None


def test_prefetch_skips_when_it_cannot_pay_off():
    """Every skip gate returns 0.0 without dialling the owner and
    without noting a fetch."""
    url = "http://owner.invalid:1"
    tokens = list(range(12))
    assert kv_store.prefetch_into(None, "m", 1, url, tokens) == 0.0
    assert kv_store.prefetch_into(_StubEngine(host_tier=None), "m", 1, url,
                                  tokens) == 0.0
    e = _StubEngine()
    assert kv_store.prefetch_into(e, "m", 1, url, ["x"]) == 0.0
    assert kv_store.prefetch_into(e, "m", 1, url, [1, 2, 3, 4]) == 0.0
    assert kv_store.prefetch_into(_StubEngine(probe=8), "m", 1, url,
                                  list(range(9))) == 0.0
    assert kv_store.prefetch_into(e, "m", 1, url, tokens,
                                  deadline_ms=0) == 0.0
    assert kv_store.prefetch_into(e, "m", 1, url, tokens,
                                  deadline=time.monotonic() - 1.0) == 0.0
    assert e.fetch_notes == [] and e.imported_payloads == []


def test_prefetch_dead_owner_is_an_error_note_never_a_raise():
    e = _StubEngine()
    spent = kv_store.prefetch_into(e, "m", 1, "http://127.0.0.1:1",
                                   list(range(12)), deadline_ms=200)
    assert spent >= 0.0
    assert e.fetch_notes == [("error", 0)] and e.imported_payloads == []


def test_prefetch_import_failure_is_an_error_note_never_a_raise(
        monkeypatch):
    e = _StubEngine(imports=RuntimeError("pool shape moved"))
    monkeypatch.setattr(kv_store, "fetch_blocks", lambda *a, **k: [
        ((1, 2, 3, 4), [np.zeros((4, 2, 2), np.float32)])])
    assert kv_store.prefetch_into(e, "m", 1, "http://x", range(12)) >= 0.0
    assert e.fetch_notes == [("error", 0)]


def test_prefetch_outcomes_hit_and_miss(monkeypatch):
    blocks = [((1, 2, 3, 4), [np.zeros((4, 2, 2), np.float32)])] * 2
    for answer, imports, note in ((blocks, None, ("hit", 2)),
                                  ([], None, ("miss", 0)),
                                  (blocks, 0, ("miss", 0))):
        e = _StubEngine(imports=imports)
        monkeypatch.setattr(kv_store, "fetch_blocks",
                            lambda *a, answer=answer, **k: list(answer))
        assert kv_store.prefetch_into(e, "m", 1, "http://x",
                                      range(12)) >= 0.0
        assert e.fetch_notes == [note]


def test_fetch_blocks_round_trip_against_live_owner():
    """fetch_blocks speaks HTTP to a stub owner on localhost: the body
    carries the token ids, the base64 msgpack decodes byte-exact, an
    empty answer is [], and a payload of another version raises."""
    payload = wire.encode_kv_blocks(
        "m", 2, 4, [((5, 6, 7, 8), [np.arange(16, dtype=np.float32)
                                     .reshape(4, 2, 2)])])
    seen = {}

    class _Owner(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            seen["path"], seen["tokens"] = self.path, body["tokens"]
            blob = (base64.b64encode(payload).decode()
                    if body["tokens"] else None)
            out = json.dumps({"blocks": blob}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Owner)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        got = kv_store.fetch_blocks(url, "m", 2, 4, [5, 6, 7, 8, 9],
                                    timeout_s=5.0)
        assert seen["path"] == "/v1/models/m/versions/2:kv/fetch"
        assert seen["tokens"] == [5, 6, 7, 8, 9]
        assert len(got) == 1 and got[0][0] == (5, 6, 7, 8)
        np.testing.assert_array_equal(
            got[0][1][0], np.arange(16, dtype=np.float32).reshape(4, 2, 2))
        assert kv_store.fetch_blocks(url, "m", 2, 4, [], timeout_s=5.0) == []
        with pytest.raises(ValueError):
            kv_store.fetch_blocks(url, "m", 3, 4, [5, 6, 7, 8, 9],
                                  timeout_s=5.0)
    finally:
        srv.shutdown()
        srv.server_close()


# -- fleet blocks across backends, 12 layers ----------------------------------

DEEP_LAYERS = 12
DEEP = dict(num_layers=DEEP_LAYERS, d_model=64, num_heads=4,
            num_kv_heads=2, mlp_dim=128, vocab_size=512, cache_size=CACHE)


@pytest.fixture(scope="module")
def deep():
    """A 12-layer ``llama-test`` (narrow widths) in both packages, the
    reference's params carried across."""
    jmodel = JaxLlama(dtype=jnp.float32, **DEEP)
    jparams = nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    pmodel = Llama(dtype="float32", **DEEP)
    return jmodel, jparams, pmodel, _carry(jparams, pmodel)


def test_kv_leaf_order_is_the_reference_tree_flatten_order(deep):
    jmodel, jparams, _, _ = deep
    paths = [jax.tree_util.keystr(p) for p, leaf in
             jax.tree_util.tree_flatten_with_path(
                 jax_init_cache(jmodel, jparams, 1))[0] if leaf.ndim == 4]
    want = [f"['layer_{i}']['attention']['{n}']"
            for i, n in kv_leaf_order(DEEP_LAYERS)]
    assert paths == want
    assert kv_leaf_order(DEEP_LAYERS)[2:4] == [(1, "k"), (1, "v")]
    assert kv_leaf_order(DEEP_LAYERS)[4] == (10, "k")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fleet_blocks_cross_backends_at_12_layers(deep, direction):
    """The owner (one package) serves a prompt and exports its blocks
    through its ``wire``; the asker (the other package) imports them
    into its host tier, and its request on the conversation hits and
    equals its own cold run. Each imported leaf is the asker's own K/V
    of the same block to fp32 rounding, layer for layer."""
    jmodel, jparams, pmodel, pparams = deep
    cfg = dict(max_new_tokens=7, max_prompt_len=MAX_PROMPT,
               temperature=0.0, num_slots=1, page_size=PAGE,
               slice_tokens=3, prefix_cache=True,
               host_cache_bytes=HOST_BYTES)
    port = DecodeEngine(pmodel, pparams, EngineConfig(**cfg),
                        name=f"deep-port-{direction}", device="cpu")
    ref = JaxDecodeEngine(jmodel, jparams, JaxEngineConfig(**cfg),
                          name=f"deep-jax-{direction}")
    owner, asker = (ref, port) if direction == "jax_to_port" else (port,
                                                                   ref)
    owner_wire, asker_wire = ((jax_wire, wire) if owner is ref
                              else (wire, jax_wire))
    try:
        prompts = _prefixed_prompts(12, [2, 3], seed=71)
        keys = _keys(2, base=7100)
        owner.submit(prompts[0], rng=keys[0]).result(180.0)
        blocks = owner.export_prefix_blocks(prompts[0])
        assert len(blocks) == 3
        data = owner_wire.encode_kv_blocks("m", 1, PAGE, blocks)
        carried = asker_wire.decode_kv_blocks(data, model="m", version=1,
                                              page_size=PAGE)
        # The asker's own K/V of the same blocks, leaf for leaf.
        asker.submit(prompts[0], rng=keys[0]).result(180.0)
        own = asker.export_prefix_blocks(prompts[0])
        for (_, got), (_, want) in zip(carried, own):
            assert len(got) == len(want) == 2 * DEEP_LAYERS
            for g, w in zip(got, want):
                g = g.numpy() if isinstance(g, torch.Tensor) else g
                w = w.numpy() if isinstance(w, torch.Tensor) else w
                np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                           atol=1e-5)
        asker.clear_prefix_cache()
        asker.host_tier.clear()
        cold = asker.submit(prompts[1], rng=keys[1]).result(180.0)
        asker.clear_prefix_cache()
        asker.host_tier.clear()
        assert asker.import_prefix_blocks(carried) == 3
        hits = asker.stats()["prefix_cache"]["hits"]
        hit = asker.submit(prompts[1], rng=keys[1]).result(180.0)
        assert asker.stats()["prefix_cache"]["hits"] == hits + 1
        assert asker.stats()["kv_tier"]["host"]["readopted_blocks"] == 3
        np.testing.assert_array_equal(hit, cold)
    finally:
        port.stop()
        ref.stop()
