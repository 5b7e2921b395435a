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

"""The engine legs of kubeflow_tpu_torch.serving.benchmark against the
reference's: the prefix, tiered-prefix and speculative legs.

Each ported leg runs at a tiny config on ``llama-test`` fp32 next to the
reference's leg at the same config (once per file), and every field that
does not depend on the clock is held: the keys of every level of the
result (the port's configs carry one more, ``model``), the completion
counts, every bitwise verdict (true in both), the strong draft's
acceptance and verifier forwards per token, and the tiered leg's hit
counts and re-adopted blocks (one slot over a fixed cycle of requests).
Wall-clock fields are only reported; no timing ratio is asserted.
"""

import dataclasses

import pytest

from _torch_bench import assert_same_keys
from kubeflow_tpu.serving import benchmark as jax_bench
from kubeflow_tpu_torch.serving import benchmark

PREFIX = dict(system_prompt_len=40, suffix_len=4, max_prompt_len=48,
              new_tokens=4, num_requests=8, page_size=8, equality_rows=2)
TIERED = dict(cycles=1, equality_rows=2)
SPEC = dict(new_tokens=8, num_requests=3, equality_rows=2)

LEGS = {
    "prefix": ("run_prefix_benchmark", "PrefixBenchConfig", PREFIX),
    "tiered": ("run_tiered_prefix_benchmark", "TieredPrefixBenchConfig",
               TIERED),
    "spec": ("run_speculative_benchmark", "SpeculativeBenchConfig", SPEC),
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
    config = dict(ours["config"])
    assert config.pop("model") == "llama-test"
    assert config == theirs["config"]
    assert_same_keys(dict(ours, config=config), theirs)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_bitwise_verdicts_hold(results, leg):
    for result in results[leg]:
        verdicts = {k: v for k, v in result.items()
                    if k.startswith("bitwise_")}
        assert verdicts and all(v is True for v in verdicts.values()), \
            verdicts


def test_prefix_counts(results):
    ours, theirs = results["prefix"]
    for result in (ours, theirs):
        for phase in ("cold", "warm"):
            assert result[phase]["completed"] == PREFIX["num_requests"]
        assert result["prefill_role_hits"] > 0
    stats = ours["prefix_stats"]
    assert stats["hits"] + stats["misses"] == \
        theirs["prefix_stats"]["hits"] + theirs["prefix_stats"]["misses"]


def test_tiered_hit_rates_and_readopted_blocks(results):
    ours, theirs = results["tiered"]
    for key in ("working_set_pages", "hbm_pool_pages",
                "working_set_multiple", "sampled_readopted_blocks"):
        assert ours[key] == theirs[key], key
    for engine in ("baseline", "tiered"):
        for key in ("requests", "measured_hits", "measured_misses",
                    "effective_hit_rate"):
            assert ours[engine][key] == theirs[engine][key], (engine, key)
    for key in ("spilled_blocks", "readopted_blocks", "resident_blocks",
                "evicted_blocks", "imported_blocks"):
        assert ours["host_tier"][key] == theirs["host_tier"][key], key
    assert ours["host_tier"]["readopted_blocks"] > 0
    assert ours["tier_stats"]["prefix_cache"] == \
        theirs["tier_stats"]["prefix_cache"]


def test_strong_draft_acceptance_and_verifier_forwards(results):
    ours, theirs = results["spec"]
    for key in ("acceptance_rate", "verify_forwards_per_token",
                "sampled_acceptance_rate"):
        assert ours[key] == theirs[key], key
    for key in ("k", "acceptance_rate", "drafted_tokens", "accepted_tokens",
                "verify_forwards_per_token"):
        assert ours["rows"]["strong"][key] == theirs["rows"]["strong"][key]
    assert ours["speculative_wins"] and theirs["speculative_wins"]


def test_engine_legs_take_a_model():
    for config in ("PrefixBenchConfig", "TieredPrefixBenchConfig",
                   "SpeculativeBenchConfig"):
        ours = {f.name for f in dataclasses.fields(
            getattr(benchmark, config))}
        theirs = {f.name for f in dataclasses.fields(
            getattr(jax_bench, config))}
        assert ours - theirs == {"model"}, config
        assert getattr(benchmark, config)().model == "llama-test"
