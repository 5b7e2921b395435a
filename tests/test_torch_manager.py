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

"""The port's ``ServedModel`` / ``ModelManager`` against the reference.

Exports are the reference's (``export_model`` of ``llama-test`` fp32);
the port serves them with ``device="cpu"``. Twins of the reference's
manager tests (tests/test_serving.py's batching and version lifecycle,
the batcher's coalescing, the engine's unary, streamed, handoff and
resume paths) with the reference's tolerances: tokens equal, logits
within 1e-4. The resume cases pin the split form end to end: a stream
resumed once mints a token that carries ``prompt_len``, and a second
death resumes from it to the uninterrupted stream.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

from kubeflow_tpu.obs import metrics as ref_metrics
from kubeflow_tpu.serving import wire as jax_wire
from kubeflow_tpu.serving.model import load_version as jax_load_version
from kubeflow_tpu_torch.obs import metrics
from kubeflow_tpu_torch.serving import tenancy, wire
from kubeflow_tpu_torch.serving.manager import ModelManager, ServedModel
from tests._torch_serving import (
    ENGINE,
    GREEDY,
    NEW_TOKENS,
    PROMPT_LEN,
    SAMPLED,
    export_generate,
    export_predict,
)

TOL = dict(atol=1e-4, rtol=1e-4)
MODES = {"greedy": GREEDY, "sampled": SAMPLED}


@pytest.fixture(scope="module")
def pred_dir(tmp_path_factory):
    return export_predict(tmp_path_factory.mktemp("pred") / "p")


@pytest.fixture(scope="module")
def gen_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    return {mode: export_generate(root / mode, {**cfg, **ENGINE})
            for mode, cfg in MODES.items()}


@pytest.fixture(scope="module")
def static_dir(tmp_path_factory):
    return export_generate(tmp_path_factory.mktemp("static") / "s",
                           SAMPLED)


@pytest.fixture(scope="module")
def jax_refs(gen_dirs):
    """The reference's static run of every mode on the same prompts (a
    deterministic export's keys are per request row, so the engine's
    tokens equal these)."""
    rows = _rows(3, 5)
    out = {}
    for mode, base in gen_dirs.items():
        loaded = jax_load_version(str(base / "1"), max_batch=4)
        out[mode] = loaded.run({"input_ids": rows})["tokens"]
        loaded.close()
    return rows, out


@pytest.fixture(scope="module")
def engines(gen_dirs):
    served = {mode: ServedModel("m", str(base), max_batch=4,
                                continuous_batching=True, device="cpu")
              for mode, base in gen_dirs.items()}
    for s in served.values():
        assert s.poll_versions()
    yield served
    for s in served.values():
        s.stop()


def _rows(seed, n, length=PROMPT_LEN):
    return np.random.RandomState(seed).randint(
        0, 512, (n, length)).astype(np.int32)


def test_served_model_batching_matches_reference(pred_dir):
    """tests/test_serving.py's batching twin, against the reference's
    numbers: concurrent predict and classify submits coalesce into
    fewer executions than requests, and each request's rows equal the
    reference's run of the same rows."""
    served = ServedModel("p", str(pred_dir), max_batch=8, device="cpu")
    served.batch_window_s = 0.25
    try:
        assert served.poll_versions()
        assert not served.poll_versions()  # no new version
        ref = jax_load_version(str(pred_dir / "1"), max_batch=8, top_k=5)
        x = _rows(11, 6, 16)
        want_p = ref.run({"input_ids": x}, method="predict")
        want_c = ref.run({"input_ids": x}, method="classify")
        for method, want in (("predict", want_p), ("classify", want_c)):
            served.batch_stats(reset=True)
            futures = [served.submit({"input_ids": x[i:i + 1]}, None,
                                     method, None) for i in range(6)]
            got = [f.result(timeout=60) for f in futures]
            stats = served.batch_stats()
            assert stats["rows"] == 6
            assert stats["batches"] < 6, stats
            for i, out in enumerate(got):
                for k, v in want.items():
                    if v.dtype.kind == "f":
                        np.testing.assert_allclose(out[k][0], v[i], **TOL)
                    else:
                        np.testing.assert_array_equal(out[k][0], v[i])
    finally:
        served.stop()


def _copy_versions(base, src, versions):
    for v in versions:
        if not (base / str(v)).exists():
            shutil.copytree(str(src / "1"), str(base / str(v)))


@pytest.mark.parametrize("case", ["hot_reload", "specific", "all",
                                  "corrupt_dir", "rollback_on_demand"])
def test_version_lifecycle_as_the_reference(pred_dir, tmp_path, case):
    """tests/test_serving.py's version-policy twins on the port."""
    base = tmp_path / case
    _copy_versions(base, pred_dir, [1])
    policy = {"specific": "specific:1,3", "all": "all",
              "corrupt_dir": "all"}.get(case, "latest")
    if case == "specific":
        _copy_versions(base, pred_dir, [2, 3])
    if case == "corrupt_dir":
        (base / "2").mkdir()  # no metadata, no weights
        _copy_versions(base, pred_dir, [3])
    served = ServedModel(case, str(base), max_batch=2,
                         version_policy=policy, device="cpu")
    try:
        assert served.poll_versions()
        if case == "hot_reload":
            assert served.versions == [1]
            _copy_versions(base, pred_dir, [2])
            assert served.poll_versions()
            assert served.get().version == 2
            assert served.get(1).version == 1  # previous stays resident
        elif case == "specific":
            assert served.versions == [1, 3]
            assert served.get().version == 3
            with pytest.raises(KeyError, match="excluded by version_policy"):
                served.get(2)
        elif case == "all":
            _copy_versions(base, pred_dir, [2, 4])
            assert served.poll_versions()
            assert served.versions == [1, 2, 4]
            assert served.get().version == 4
        elif case == "corrupt_dir":
            assert served.versions == [1, 3]
            assert served.get().version == 3
            assert not served.poll_versions()
        else:
            _copy_versions(base, pred_dir, [2])
            assert served.poll_versions()
            _copy_versions(base, pred_dir, [3])
            assert served.poll_versions()
            assert served.versions == [2, 3]
            assert served.get(1).version == 1  # loaded back on demand
            out = served.get(1).run(
                {"input_ids": np.zeros((1, 16), np.int32)})
            assert out["logits"].shape == (1, 16, 512)
            with pytest.raises(KeyError, match="not found"):
                served.get(9)
    finally:
        served.stop()


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_unary_and_stream_equal_the_reference(engines, jax_refs,
                                                     mode):
    """A unary engine generate through ``submit`` (the future of
    ``{"tokens"}``) and ``submit_stream`` with a smaller per-request
    budget: the rows are the reference's, the streams their prefix."""
    rows, refs = jax_refs
    served = engines[mode]
    out = served.submit({"input_ids": rows}, None, "generate",
                        None).result(timeout=60)
    np.testing.assert_array_equal(out["tokens"], refs[mode])
    _, streams = served.submit_stream({"input_ids": rows}, None, None,
                                      max_new_tokens=3)
    for r, s in enumerate(streams):
        np.testing.assert_array_equal(s.result(timeout=60),
                                      refs[mode][r][:3])


def test_warm_engine_runs_every_warm_program(engines):
    """The load-time warmup reaches the prefill of every prompt bucket
    and a decode slice of every length 1..slice_tokens, so the first
    request runs no program for the first time at those buckets."""
    engine = engines["greedy"].get_resident().engine
    cfg = engine.config
    seen = set(engine._compile_seen)
    assert ("prefill", f"tokens[1,{cfg.max_prompt_len}]") in seen
    for k in range(1, cfg.slice_tokens + 1):
        assert ("decode_slice",
                f"steps={k} slots={cfg.num_slots}") in seen
    engines["greedy"].submit({"input_ids": _rows(4, 1)}, None, None,
                             None).result(timeout=60)
    assert set(engine._compile_seen) == seen
    # The warmup's zero prompts left nothing in the pool.
    assert engine.stats()["active_slots"] == 0


@pytest.mark.parametrize("mode", list(MODES))
def test_handoff_between_two_served_models(engines, gen_dirs, jax_refs,
                                           mode):
    """Role-split generate through the manager: ``prefill_handoff`` on
    one ``ServedModel``, the blobs through the port's wire (and
    readable by the reference's), ``submit_handoff`` on a second one
    over the same export: the tokens are the local run's."""
    rows, refs = jax_refs
    decode = ServedModel("m", str(gen_dirs[mode]), max_batch=4,
                         continuous_batching=True, device="cpu")
    try:
        assert decode.poll_versions()
        loaded, handoffs = engines[mode].prefill_handoff(
            {"input_ids": rows}, None, None)
        blobs = [wire.encode_kv_handoff("m", loaded.version, h)
                 for h in handoffs]
        for b in blobs:
            jax_wire.decode_kv_handoff(b, model="m", version=1)
        adopted = [wire.decode_kv_handoff(b, model="m", version=1)
                   for b in blobs]
        _, streams = decode.submit_handoff(adopted, None)
        got = np.stack([s.result(timeout=60) for s in streams])
        np.testing.assert_array_equal(got, refs[mode])
    finally:
        decode.stop()


def _resume(served, token_blob, emitted, record):
    token = wire.decode_resume_token(token_blob, model="m", version=1)
    engine = served.get_resident().engine
    submit = engine.submit

    def spy(*args, **kw):
        record.append(kw.get("prompt_len"))
        return submit(*args, **kw)

    engine.submit = spy
    try:
        _, (stream,) = served.submit_resume([(token, emitted)], None)
    finally:
        del engine.submit
    return stream


@pytest.mark.parametrize("kill", [1, 3, NEW_TOKENS - 1])
@pytest.mark.parametrize("mode", list(MODES))
def test_resume_and_a_second_death_equal_the_uninterrupted_stream(
        engines, jax_refs, mode, kill):
    """``submit_resume`` continues a stream killed after ``kill``
    tokens in the split form (``prompt_len`` = the prompt); the resumed
    stream's own token carries ``prompt_len``, and a second death one
    token later resumes from it, split at the original prompt, to the
    rest of the uninterrupted stream. The first-life token is byte-equal
    to the reference's encoding of the same context; the reference's
    decoder reads the resumed stream's token too."""
    rows, refs = jax_refs
    served = engines[mode]
    want = refs[mode][0]
    _, (first,) = served.submit_stream({"input_ids": rows[:1]}, None, None)
    np.testing.assert_array_equal(first.result(timeout=60), want)
    ctx = first.resume_ctx
    assert "prompt_len" not in ctx
    blob1 = wire.encode_resume_token("m", 1, ctx["prompt"],
                                     ctx["step_keys"],
                                     ctx["max_new_tokens"],
                                     prompt_len=ctx.get("prompt_len"))
    assert blob1 == jax_wire.encode_resume_token(
        "m", 1, ctx["prompt"], ctx["step_keys"], ctx["max_new_tokens"])
    calls = []
    second = _resume(served, blob1, want[:kill].tolist(), calls)
    np.testing.assert_array_equal(second.result(timeout=60), want[kill:])
    assert calls == [PROMPT_LEN]
    if kill >= NEW_TOKENS - 1:
        return  # one token left: nothing for a second death to split
    ctx2 = second.resume_ctx
    blob2 = wire.encode_resume_token("m", 1, ctx2["prompt"],
                                     ctx2["step_keys"],
                                     ctx2["max_new_tokens"],
                                     prompt_len=ctx2.get("prompt_len"))
    tok2 = wire.decode_resume_token(blob2, model="m", version=1)
    assert tok2["prompt_len"] == PROMPT_LEN
    assert len(tok2["prompt_tokens"]) == PROMPT_LEN + kill
    ref_tok2 = jax_wire.decode_resume_token(blob2, model="m", version=1)
    np.testing.assert_array_equal(ref_tok2["prompt_tokens"],
                                  tok2["prompt_tokens"])
    calls = []
    third = _resume(served, blob2, want[kill:kill + 1].tolist(), calls)
    np.testing.assert_array_equal(third.result(timeout=60),
                                  want[kill + 1:])
    assert calls == [PROMPT_LEN]


def test_static_generates_coalesce_equal_to_sequential(static_dir):
    """tests/test_serving_batch_generate.py's contract on the manager:
    concurrent mixed-length static generates (sampled, deterministic)
    coalesce into one execution a prompt-length bucket, and each equals
    its request alone and the reference's run of that request."""
    served = ServedModel("s", str(static_dir), max_batch=8, device="cpu")
    served.batch_window_s = 0.25
    ref = jax_load_version(str(static_dir / "1"), max_batch=8)
    try:
        assert served.poll_versions()
        rng = np.random.RandomState(7)
        prompts = [rng.randint(0, 512, (1, n)).astype(np.int32)
                   for n in (3, 8, 5, 8, 4)]
        alone = [served.submit({"input_ids": p}, None, None,
                               None).result(timeout=60)["tokens"]
                 for p in prompts]
        served.batch_stats(reset=True)
        results = [None] * len(prompts)
        barrier = threading.Barrier(len(prompts))

        def client(i):
            barrier.wait()
            results[i] = served.submit({"input_ids": prompts[i]}, None,
                                       None, None).result(timeout=60)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        stats = served.batch_stats()
        assert stats["rows"] == len(prompts)
        # One execution a prompt-length bucket (4 and 8): no row is
        # padded past its own bucket.
        loaded = served.get()
        buckets = {loaded._length_bucket(p.shape[1], PROMPT_LEN)
                   for p in prompts}
        assert stats["batches"] == len(buckets) < len(prompts), stats
        for i, p in enumerate(prompts):
            np.testing.assert_array_equal(results[i]["tokens"], alone[i])
            np.testing.assert_array_equal(
                alone[i], ref.run({"input_ids": p})["tokens"])
    finally:
        served.stop()


def test_batch_stats_tenancy_and_metric_families(engines, gen_dirs,
                                                 tmp_path):
    """``batch_stats`` carries the engine's ``stats()`` and, with a
    tenant registry, the tenants' queues and quotas; the engine's fair
    queue takes the registry's weights; the ``kft_serving_*`` families
    render in the port's registry and parse as the reference's
    exposition."""
    policy = tmp_path / "tenants.json"
    policy.write_text('{"tenants": {"gold": {"weight": 3}}}')
    registry = tenancy.TenantRegistry(
        tenancy.TenantPolicySource(str(policy)))
    served = ServedModel("mt", str(gen_dirs["greedy"]), max_batch=4,
                         continuous_batching=True, device="cpu",
                         tenancy_registry=registry)
    try:
        assert served.poll_versions()
        served.submit({"input_ids": _rows(8, 1)}, None, None, None,
                      tenant="gold").result(timeout=60)
        engine = served.get_resident().engine
        assert engine.scheduler.pending.weight_of("gold") == \
            registry.weight("gold")
        stats = served.batch_stats()
        assert set(stats["engine"]) >= {"slots", "admitted", "slices"}
        assert stats["engine"]["admitted"] >= 1
        assert set(stats["tenants"]) == {"queue_depths", "registry"}
        text = metrics.render()
        families = ref_metrics.parse_exposition(text)
        for fam in ("kft_serving_shed_total", "kft_serving_batches_total",
                    "kft_serving_queue_depth",
                    "kft_serving_est_batch_latency_seconds",
                    "kft_serving_queue_wait_seconds",
                    "kft_serving_dispatch_seconds"):
            assert fam in families, fam
    finally:
        served.stop()


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                         pred_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # The server CLI takes the CPU from JAX_PLATFORMS=cpu (the pod env's
    # simulated mode, utils/platform.py), as the test run sets it: this
    # case is a pod with no such env.
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelManager()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServedModel("p", str(pred_dir))
    from kubeflow_tpu_torch.serving import server

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main(["--model_name", "p", "--model_base_path",
                     str(pred_dir), "--port", "0", "--rest_port", "0"])
    manager = ModelManager(device="cpu")
    model = manager.add_model("p", str(pred_dir), max_batch=2)
    try:
        assert model.get().device.type == "cpu"
        assert manager.ready()
    finally:
        manager.stop()
