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

"""Autoregressive decode benchmark: tokens/s, per-token ms, weight GB/s.

The port of ``kubeflow_tpu/inference/benchmark.py``, on the port's
``generate`` (inference/generate.py), with the reference's keys and its
prefill-differenced method: ``t(prefill + 1 token)`` and ``t(prefill +
n tokens)`` are timed apart, and their difference is ``n - 1`` pure
decode steps. Decode streams every weight once a step, so the ceiling
is the weights' bytes over the card's memory rate; the result reports
the rate reached (``weight_stream_gb_per_sec``).

Params are drawn in bf16 on the device (every floating weight, the head
too, as the reference's ``cast_floating`` of its init), so
``param_bytes`` is twice the parameter count. The prompt is the
reference's own draw (``prng.randint``, bit for bit
``jax.random.randint``). Each timed run ends with a host read of a
token, the reference's ``int(tokens[0, -1])``: CUDA runs asynchronously,
and a clock stopped without that read would time the enqueue::

    python -m kubeflow_tpu_torch.inference.benchmark --model llama3-8b \\
        --sweep_batch_sizes 1,4,8

On the card unless ``--device cpu`` asks for the CPU. Like the
reference's decode bench it reads no platform from the env: a
``JAX_PLATFORMS=cpu`` env does not move it off the card.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Sequence

import torch

from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class DecodeBenchConfig:
    model: str = "llama2-7b"
    batch_size: int = 1
    prompt_len: int = 128
    max_new_tokens: int = 128
    temperature: float = 0.0
    seed: int = 0


def _init_bench_model(config: DecodeBenchConfig, device: DeviceLike = None):
    """``(model, params, param_bytes)``: one bf16 draw on the device,
    shared by the single run and the batch sweep (an 8B draw is the
    expensive part; the sweep must not repeat it per batch size)."""
    device = resolve_device(device)
    entry = get_model(config.model)
    cache = config.prompt_len + config.max_new_tokens
    model = entry.make(cache_size=cache)
    # Drawn in the template's dtypes and cast at once, one tensor at a
    # time: an 8B model never holds its fp32 head and bf16 copy of it
    # beside every other fp32 weight.
    params = init_params(model, seed=config.seed, device=device,
                         dtype=torch.bfloat16)
    param_bytes = sum(t.numel() * t.element_size() for t in params.values())
    return model, params, param_bytes


def _measure_decode(config: DecodeBenchConfig, model, params,
                    param_bytes: int, batch_size: int) -> Dict[str, Any]:
    """The timed section at one batch size (prefill-differenced)."""
    from kubeflow_tpu_torch.inference.generate import generate

    device = next(iter(params.values())).device
    entry = get_model(config.model)
    vocab = entry.num_classes_or_vocab
    rng = prng.PRNGKey(config.seed)
    prompt = torch.from_numpy(prng.randint(
        rng, (batch_size, config.prompt_len), 0, vocab)).to(device)

    def run(n: int):
        tokens, _ = generate(
            model, params, prompt, max_new_tokens=n,
            temperature=config.temperature, rng=rng)
        return int(tokens[0, -1])  # host read = fence

    n = config.max_new_tokens
    t0 = time.perf_counter()
    run(n)  # warmup (full)
    run(1)  # warmup (prefill-dominated probe)
    compile_s = time.perf_counter() - t0

    # Separate prefill from decode: t(prefill + 1 token) vs t(prefill
    # + n tokens); the difference is (n - 1) pure decode steps. Timing
    # the full call alone would fold the whole prompt forward pass into
    # "per-token decode latency".
    t0 = time.perf_counter()
    run(1)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(n)
    full_s = time.perf_counter() - t0

    decode_s = max(full_s - prefill_s, 1e-9)
    # Per STEP (one step advances every row); tokens/s is aggregate
    # across the batch, the serving-throughput number.
    per_token_ms = decode_s / (n - 1) * 1e3 if n > 1 else float("nan")
    return {
        "model": config.model,
        "batch_size": batch_size,
        "prompt_len": config.prompt_len,
        "max_new_tokens": n,
        "decode_tokens_per_sec":
            batch_size * (n - 1) / decode_s if n > 1 else 0.0,
        "per_token_ms": per_token_ms,
        "prefill_ms": prefill_s * 1e3,
        "end_to_end_s": full_s,
        "param_bytes": param_bytes,
        # Decode streams every weight once per STEP, shared by all the
        # batch's rows: the memory rate reached.
        "weight_stream_gb_per_sec":
            param_bytes / (per_token_ms / 1e3) / 1e9 if n > 1 else 0.0,
        # The reference's key: its first two runs compile; here they
        # warm the allocator, the kernels' first launches and the host.
        "compile_plus_warmup_s": compile_s,
    }


def run_decode_benchmark(config: DecodeBenchConfig,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """Decode tokens/s, per-token ms and weight-streaming GB/s at
    ``config.batch_size``. ``device``: ``None`` → cuda."""
    model, params, param_bytes = _init_bench_model(config, device)
    return _measure_decode(config, model, params, param_bytes,
                           config.batch_size)


def run_decode_batch_sweep(config: DecodeBenchConfig,
                           batch_sizes: Sequence[int] = (1, 4, 8),
                           device: DeviceLike = None) -> Dict[str, Any]:
    """Decode throughput against batch size, on one shared draw.

    A B = 1 decode step streams every weight to make one token, so rows
    added to the step come nearly free until the products turn
    compute-bound or the KV reads (which grow with B) catch up: expect
    aggregate tokens/s near B × the B = 1 row while the weights bound
    the step."""
    model, params, param_bytes = _init_bench_model(config, device)
    rows = [_measure_decode(config, model, params, param_bytes, b)
            for b in batch_sizes]
    base = next((r for r in rows if r["batch_size"] == 1), rows[0])
    base_tps = max(base["decode_tokens_per_sec"], 1e-9)
    return {
        "model": config.model,
        "prompt_len": config.prompt_len,
        "max_new_tokens": config.max_new_tokens,
        "param_bytes": param_bytes,
        "rows": rows,
        "speedup_vs_b1": {
            str(r["batch_size"]):
                round(r["decode_tokens_per_sec"] / base_tps, 3)
            for r in rows
        },
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="decode-bench")
    parser.add_argument("--model", default="llama2-7b")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--prompt_len", type=int, default=128)
    parser.add_argument("--max_new_tokens", type=int, default=128)
    parser.add_argument("--sweep_batch_sizes", default="",
                        help="comma-separated batch sizes (e.g. 1,4,8):"
                             " run the decode batch sweep instead of a "
                             "single measurement")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    config = DecodeBenchConfig(
        model=args.model, batch_size=args.batch_size,
        prompt_len=args.prompt_len,
        max_new_tokens=args.max_new_tokens)
    device = args.device
    if args.sweep_batch_sizes:
        sizes = tuple(int(s) for s in args.sweep_batch_sizes.split(",")
                      if s.strip())
        print(json.dumps(run_decode_batch_sweep(config, sizes, device)))
        return 0
    print(json.dumps(run_decode_benchmark(config, device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
