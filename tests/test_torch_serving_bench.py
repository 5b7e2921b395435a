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

"""The serving legs of kubeflow_tpu_torch.serving.benchmark against the
reference's: REST and gRPC, mixed load, overload, continuous batching
and the tenant sweep.

Each ported leg runs at a tiny config on the CPU next to the
reference's leg at the same config (once per file), and every field that
does not depend on the clock is held: the keys of every level of the
result, the completion counts, every bitwise verdict and invariant, and
the tenant leg's zero quota sheds of compliant tenants. Wall-clock
fields are only reported; no timing ratio is asserted. The REST
transport needs tornado: without it the leg raises ImportError and
never falls back to gRPC.
"""

import sys

import pytest

from _torch_bench import assert_same_keys
from kubeflow_tpu.serving import benchmark as jax_bench
from kubeflow_tpu_torch.serving import benchmark

SERVING = dict(model="resnet-test", image_hw=32, clients=2,
               requests_per_client=3, warmup_requests=1, max_batch=2,
               transport="both", sweep_clients=(1, 2))
MIXED = dict(prompt_len=8, new_tokens=4, classify_requests=3,
             generate_requests=2, max_batch=2)
OVERLOAD = dict(image_hw=32, phase_seconds=0.5, capacity_clients=2,
                capacity_requests=3, offered_x=(1.0, 2.0))
CONTINUOUS = dict(prompt_len=8, short_tokens=2, long_tokens=6,
                  num_requests=28, rates_x=(1.0,), equality_rows=2)
TENANT = dict(phase_seconds=1.0)

LEGS = {
    "serving": ("run_serving_benchmark", "ServingBenchConfig", SERVING),
    "mixed": ("run_mixed_load_benchmark", "MixedLoadConfig", MIXED),
    "overload": ("run_overload_benchmark", "OverloadBenchConfig", OVERLOAD),
    "continuous": ("run_continuous_benchmark", "ContinuousBenchConfig",
                   CONTINUOUS),
    "tenant": ("run_tenant_benchmark", "TenantBenchConfig", TENANT),
}


@pytest.fixture(scope="module")
def results():
    out = {}
    for leg, (run, config, kw) in LEGS.items():
        ours = getattr(benchmark, run)(getattr(benchmark, config)(**kw),
                                       device="cpu")
        theirs = getattr(jax_bench, run)(getattr(jax_bench, config)(**kw))
        out[leg] = ours, theirs
    return out


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_result_keys_equal_the_reference(results, leg):
    ours, theirs = results[leg]
    assert_same_keys(ours, theirs)


def test_serving_counts_and_sizes(results):
    ours, theirs = results["serving"]
    n = SERVING["clients"] * SERVING["requests_per_client"]
    for result in (ours, theirs):
        assert result["http_requests"] == result["grpc_requests"] == n
        assert [r["clients"] for r in result["sweep"]] == [1, 2]
        assert result["direct_model_ms"] > 0
    # The same image, the same wire bytes.
    assert ours["json_request_bytes"] == theirs["json_request_bytes"]
    assert ours["grpc_request_bytes"] == theirs["grpc_request_bytes"]


def test_mixed_load_counts(results):
    for result in results["mixed"]:
        assert result["generate_alone"]["requests"] == (
            MIXED["generate_requests"] * result["generate_clients"])
        for phase in ("classify_alone", "classify_under_generate"):
            assert result[phase]["requests"] == (
                MIXED["classify_requests"] * result["classify_clients"])
        assert result["generate_rps_under_mix"] > 0


def test_overload_accounts_for_every_request(results):
    for result in results["overload"]:
        assert result["never_dispatched_ok"] is True
        assert len(result["phases"]) == 2 * len(OVERLOAD["offered_x"])
        for row in result["phases"]:
            assert row["never_dispatched_ok"] is True
            assert row["sent"] == (row["ok"] + row["shed"] + row["expired"]
                                   + row["client_timeout"])


def test_continuous_counts_and_verdicts(results):
    for result in results["continuous"]:
        assert result["bitwise_greedy_ok"] is True
        assert result["bitwise_sampled_ok"] is True
        for row in result["rows"]:
            for stack in ("static", "continuous"):
                assert row[stack]["completed"] == CONTINUOUS["num_requests"]
        stats = result["engine_stats"]
        assert stats["active_slots"] == 0 and stats["queue_depth"] == 0


def test_tenant_compliant_tenants_see_no_quota_sheds(results):
    for result in results["tenant"]:
        on = result["phases"]["isolation_on"]["tenants"]
        for tenant, row in on.items():
            assert row["sent"] == (row["ok"] + row["quota"] + row["shed"]
                                   + row["expired"]
                                   + row["client_timeout"]), tenant
            if tenant != "noisy":
                assert row["quota"] == 0, tenant
        assert result["noisy_quota_sheds"] > 0
    ours, theirs = results["tenant"]
    for key in ("capacity_rps", "fair_share_rps", "offered_rates_rps"):
        assert ours[key] == theirs[key], key


def test_rest_without_tornado_raises_and_grpc_runs(monkeypatch):
    monkeypatch.setitem(sys.modules, "tornado", None)
    for transport in ("http", "both"):
        with pytest.raises(ImportError, match="tornado"):
            benchmark.run_serving_benchmark(benchmark.ServingBenchConfig(
                **dict(SERVING, transport=transport)), device="cpu")
    result = benchmark.run_serving_benchmark(benchmark.ServingBenchConfig(
        **dict(SERVING, transport="grpc", sweep_clients=())), device="cpu")
    assert result["requests"] == 6 and "http_requests" not in result


def test_generate_over_grpc_and_encoders_refused():
    result = benchmark.run_serving_benchmark(benchmark.ServingBenchConfig(
        model="llama-test", prompt_len=8, new_tokens=4, clients=2,
        requests_per_client=2, warmup_requests=1, max_batch=2,
        transport="grpc"), device="cpu")
    assert result["requests"] == 4
    with pytest.raises(ValueError, match="encoder-only"):
        benchmark.run_serving_benchmark(benchmark.ServingBenchConfig(
            model="bert-test", transport="grpc"), device="cpu")
    with pytest.raises(ValueError, match="unknown transport"):
        benchmark.run_serving_benchmark(benchmark.ServingBenchConfig(
            transport="carrier-pigeon"), device="cpu")


@pytest.mark.parametrize("argv", [["--transport", "grpc"], ["--mixed"]])
def test_cli_device_is_the_flag_not_the_env(monkeypatch, capsys, argv):
    # The reference's serving bench reads no platform from the env, and
    # neither does the port's: under JAX_PLATFORMS=cpu a leg is handed
    # no device (the card) unless --device names one.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    seen = []

    def leg(config, device=None):
        seen.append(device)
        return {}

    monkeypatch.setattr(benchmark, "run_serving_benchmark", leg)
    monkeypatch.setattr(benchmark, "run_mixed_load_benchmark", leg)
    assert benchmark.main(argv) == 0
    assert benchmark.main(argv + ["--device", "cpu"]) == 0
    assert seen == [None, "cpu"]
    capsys.readouterr()
