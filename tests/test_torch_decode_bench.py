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

"""kubeflow_tpu_torch.inference.benchmark against the reference's.

At ``llama-test`` on the CPU: the same ``param_bytes`` (every weight in
bf16), the same keys in the result and each row, the prompt bit for bit
the reference's ``jax.random.randint`` draw, a sweep whose B = 1 row is
its own baseline, and positive timings. No speed is asserted.
"""

import json

import jax
import numpy as np
import pytest

from kubeflow_tpu.inference import benchmark as jax_bench
from kubeflow_tpu_torch.inference import benchmark
from kubeflow_tpu_torch.inference import generate as generate_module

CONFIG = dict(model="llama-test", prompt_len=8, max_new_tokens=4)
SIZES = (1, 2)


@pytest.fixture(scope="module")
def reference_sweep():
    return jax_bench.run_decode_batch_sweep(
        jax_bench.DecodeBenchConfig(**CONFIG), SIZES)


@pytest.fixture(scope="module")
def sweep():
    return benchmark.run_decode_batch_sweep(
        benchmark.DecodeBenchConfig(**CONFIG), SIZES, device="cpu")


def test_param_bytes_and_keys_equal_the_reference(sweep, reference_sweep):
    assert sweep["param_bytes"] == reference_sweep["param_bytes"]
    assert set(sweep) == set(reference_sweep)
    assert len(sweep["rows"]) == len(reference_sweep["rows"])
    for ours, theirs in zip(sweep["rows"], reference_sweep["rows"]):
        assert set(ours) == set(theirs)
        for key in ("model", "batch_size", "prompt_len", "max_new_tokens",
                    "param_bytes"):
            assert ours[key] == theirs[key], key
    assert set(sweep["speedup_vs_b1"]) == set(reference_sweep["speedup_vs_b1"])


def test_param_bytes_are_two_a_parameter():
    model, params, param_bytes = benchmark._init_bench_model(
        benchmark.DecodeBenchConfig(**CONFIG), "cpu")
    count = sum(p.numel() for _, p in model.named_parameters())
    assert param_bytes == 2 * count
    assert {str(t.dtype) for t in params.values()} == {"torch.bfloat16"}


def test_sweep_rows_are_timed_against_the_b1_row(sweep):
    assert sweep["speedup_vs_b1"]["1"] == 1.0
    for row in sweep["rows"]:
        for key in ("decode_tokens_per_sec", "per_token_ms", "prefill_ms",
                    "end_to_end_s", "weight_stream_gb_per_sec",
                    "compile_plus_warmup_s"):
            assert row[key] > 0, key


@pytest.mark.parametrize("batch_size", SIZES)
def test_the_prompt_is_the_references_draw(monkeypatch, batch_size):
    seen = []
    real = generate_module.generate

    def recording(model, params, prompt_ids, **kw):
        seen.append(prompt_ids.clone())
        return real(model, params, prompt_ids, **kw)

    monkeypatch.setattr(generate_module, "generate", recording)
    row = benchmark.run_decode_benchmark(benchmark.DecodeBenchConfig(
        batch_size=batch_size, **CONFIG), device="cpu")
    want = np.asarray(jax.random.randint(
        jax.random.PRNGKey(0), (batch_size, CONFIG["prompt_len"]), 0, 512))
    # Two warmups and two timed runs, all on the one prompt.
    assert len(seen) == 4
    for prompt in seen:
        np.testing.assert_array_equal(prompt.numpy(), want)
    assert row["batch_size"] == batch_size


def test_cli_sweep_on_the_cpu_only_when_asked(monkeypatch, capsys):
    # As the reference's decode bench, the CLI reads no platform from
    # the env: JAX_PLATFORMS=cpu leaves it on the card, which raises
    # where there is none; --device cpu is how the CPU is asked for.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    argv = ["--model", "llama-test", "--prompt_len", "8",
            "--max_new_tokens", "3", "--sweep_batch_sizes", "1,2"]
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmark.main(argv)
    assert benchmark.main(argv + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["batch_size"] for r in out["rows"]] == [1, 2]
    assert out["speedup_vs_b1"]["1"] == 1.0
