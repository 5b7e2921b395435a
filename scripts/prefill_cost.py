#!/usr/bin/env python3
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

"""What one llama3-8b prefill forward into the cache costs on a GPU.

Builds ``llama3-8b`` (random bf16 weights from seed 0) on the card and,
for each prompt length L, profiles one B = 1 prefill forward of L
tokens into a cache of L slots, as ``generate`` runs it: given
``logits_at`` (the last position alone) where the checkout's
``Llama.forward`` takes it, else the full-width head whose last row is
read. It prints one JSON line a length: the forward's device time (the
profiler's kernel records, summed) by kernel class, its launches, and
its parts timed alone at the forward's shapes, times their launches a
forward:

- ``attention``: the causal attention of the L queries over the cache,
  32 calls a forward: as the flash route (``prefill_attention`` in
  ``ops/flash_attention.py``, one launch at the block's offset) or as
  the per-query route (``prefill_attention`` in
  ``ops/decode_attention.py``, each query a row of the decode attention
  kernel), whichever the checkout has, and as the einsums of
  ``dense_attention``;
- ``head``: the fp32 ``lm_head``, as the decode GEMM's fp32 route on
  the one row read and as ``F.linear`` on all L rows.

Then the card's name and power limit. Run from a checkout's root; copied
into another checkout's root (a parent commit's, say) it measures that
checkout's forward by the same code::

    python3 scripts/prefill_cost.py [--lengths 512 2048 8192] [--out PATH]
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kubeflow_tpu_torch.inference.generate import init_cache  # noqa: E402
from kubeflow_tpu_torch.models.convert import init_params  # noqa: E402
from kubeflow_tpu_torch.models.llama import apply, llama3_8b  # noqa: E402
from kubeflow_tpu_torch.ops import decode_attention as da  # noqa: E402
from kubeflow_tpu_torch.ops import decode_gemm as dg  # noqa: E402
from kubeflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kubeflow_tpu_torch.ops.attention import dense_attention  # noqa: E402

#: Substrings of a kernel's name → its class, first match wins.
CLASSES = (
    ("prefill_gemm", ("prefill_gemm_kernel",)),
    ("decode_attention", ("decode_attention_kernel",)),
    ("flash_attention", ("flash_fwd_kernel",)),
    ("decode_gemm fp32 (head)", ("decode_gemm_fp32_kernel",)),
    ("rms_norm", ("rms_norm_kernel",)),
    ("cuBLAS gemm", ("gemm", "cutlass", "xmma", "nvjet", "matmul")),
    ("softmax/reduce", ("softmax", "reduce", "max_", "sum_")),
    ("copy/cast/index", ("copy", "cast", "cat", "fill", "index")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise/other"


def device_profile(fn, calls: int = 1):
    """Kernel time (ms) by class and launches, per call, over ``calls``
    calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_class = collections.Counter()
    launches = 0
    for row in prof.key_averages():
        if row.device_type != DeviceType.CUDA:
            continue
        by_class[kernel_class(row.key)] += row.self_device_time_total / 1e3
        launches += row.count
    return ({k: v / calls for k, v in by_class.items()},
            launches / calls)


def device_ms(fn, calls: int = 3) -> float:
    by_class, _ = device_profile(fn, calls)
    return sum(by_class.values())


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forward_row(params, length: int, seed: int) -> dict:
    model = llama3_8b(dtype="bfloat16", cache_size=length)
    takes_logits_at = "logits_at" in inspect.signature(
        type(model).forward).parameters
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, model.vocab_size, (1, length), device="cuda",
                        generator=gen)
    positions = torch.arange(length, device="cuda")[None]
    cache = init_cache(model, params, 1)
    kwargs = ({"logits_at": torch.full((1,), length - 1, device="cuda")}
              if takes_logits_at else {})

    def forward():
        for layer in cache:
            layer.index = 0
        with torch.inference_mode():
            return apply(model, params, ids, positions, cache=cache,
                         **kwargs)[:, -1]

    by_class, launches = device_profile(forward)
    row = {"length": length, "logits_at": takes_logits_at,
           "forward_device_ms": sum(by_class.values()),
           "launches": launches,
           "by_class_ms": dict(sorted(by_class.items(),
                                      key=lambda kv: -kv[1]))}
    del cache
    torch.cuda.empty_cache()

    # The parts alone, at one layer's shapes, times their launches.
    layers = model.num_layers
    q = torch.randn(1, length, 32, 128, device="cuda",
                    generator=gen).to(torch.bfloat16)
    k = torch.randn(1, length, 8, 128, device="cuda",
                    generator=gen).to(torch.bfloat16)
    v = torch.randn(1, length, 8, 128, device="cuda",
                    generator=gen).to(torch.bfloat16)
    valid = torch.ones((1, length), dtype=torch.bool, device="cuda")
    parts = {}
    with torch.inference_mode():
        if hasattr(fa, "prefill_attention"):
            parts["attention: flash route"] = layers * device_ms(
                lambda: fa.prefill_attention(q, k, v, 0, valid))
        if hasattr(da, "prefill_attention"):
            parts["attention: per-query kernel"] = layers * device_ms(
                lambda: da.prefill_attention(q, k, v, 0, valid))
        parts["attention: dense_attention einsums"] = layers * device_ms(
            lambda: dense_attention(q, k, v, causal=True, q_offset=0,
                                    kv_offset=0, kv_segment_valid=valid))
        del q, k, v
        torch.cuda.empty_cache()
        w = params["lm_head.weight"]
        x = torch.randn(length, w.shape[1], device="cuda", generator=gen)
        parts["head: fp32 route, 1 row"] = device_ms(
            lambda: dg.decode_linear(x[-1:], w))
        parts["head: F.linear, L rows"] = device_ms(lambda: F.linear(x, w))
    row["parts_ms"] = parts
    torch.cuda.empty_cache()
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--lengths", type=int, nargs="+",
                        default=[512, 2048, 8192])
    parser.add_argument("--out", default=None,
                        help="also write the lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("prefill_cost: CUDA is not available", file=sys.stderr)
        return 1
    params = init_params(llama3_8b(dtype="bfloat16"), seed=0, device="cuda")
    lines = []
    for length in args.lengths:
        try:
            row = forward_row(params, length, seed=length)
        except torch.cuda.OutOfMemoryError as e:
            row = {"length": length, "error": f"out of memory: {e}"[:300]}
            torch.cuda.empty_cache()
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    lines.append(json.dumps({"card": card()}))
    print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
