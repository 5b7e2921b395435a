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

"""Where the time goes in kubeflow_tpu_torch's Llama serving path, on a GPU.

Builds ``llama3-8b`` (random bf16 weights from seed 0) on the card and
profiles, with ``torch.profiler``, one predict forward ([2, 2048], the
flash kernel's path) and one greedy generate (two left-padded prompts
of 300 and 512 tokens, 16 new tokens; the cache path). For each it
prints one JSON line: wall time, device busy time and idle share, and
device time by kernel class and by the heaviest kernels. Run from the
repository root::

    python3 scripts/profile_torch_llama.py
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: Substrings of a kernel's name → its class, first match wins.
CLASSES = (
    ("flash_attention", ("flash_fwd_kernel",)),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "matmul", "cublas")),
    ("softmax/reduce", ("softmax", "reduce", "argmax", "max_", "sum_")),
    ("copy/cast", ("copy", "cast", "cat", "fill", "index")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise/other"


def profile(fn, label, card):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm: cuBLAS heuristics, the kernel's build and first launch
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # Device-side rows only: a CPU op's row also carries the time of
    # the kernels it launched, which would count them twice.
    by_kernel = collections.Counter()
    launches = collections.Counter()
    for row in prof.key_averages():
        if row.device_type != DeviceType.CUDA:
            continue
        by_kernel[row.key] += row.self_device_time_total / 1e3  # us → ms
        launches[row.key] += row.count
    busy = sum(by_kernel.values())
    by_class = collections.Counter()
    for name, t in by_kernel.items():
        by_class[kernel_class(name)] += t
    result = {
        "phase": label,
        "card": card,
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "kernel_launches": sum(launches.values()),
        "by_class_ms": dict(by_class.most_common()),
        "top_kernels": [
            {"name": name[:90], "ms": t, "launches": launches[name]}
            for name, t in by_kernel.most_common(8)],
    }
    print(json.dumps(result), flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_llama: needs a GPU", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.inference.generate import generate
    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.models.llama import apply
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.utils.device import resolve_device

    resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    entry = get_model("llama3-8b")
    model = entry.make()
    gen_model = entry.make(cache_size=512 + 16)
    params = init_params(model, seed=0)
    rng = np.random.default_rng(0)
    vocab = entry.num_classes_or_vocab
    ids = torch.from_numpy(rng.integers(0, vocab, (2, 2048)).astype(
        np.int32)).cuda()
    prompts = np.zeros((2, 512), np.int32)
    prompts[0, 512 - 300:] = rng.integers(0, vocab, 300)
    prompts[1] = rng.integers(0, vocab, 512)
    prompts = torch.from_numpy(prompts).cuda()
    lengths = torch.tensor([300, 512], dtype=torch.int32).cuda()

    def predict():
        with torch.inference_mode():
            apply(model, params, ids)

    def decode():
        generate(gen_model, params, prompts, max_new_tokens=16,
                 prompt_lengths=lengths)

    profile(predict, "predict [2, 2048]", card)
    profile(decode, "generate [2, 512] + 16 tokens", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
