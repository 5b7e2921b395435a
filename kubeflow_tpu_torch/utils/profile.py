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

"""Where the device time went, from a ``torch.profiler`` Chrome trace.

Reads the trace's device rows (kernels, memcpy, memset) and sums their
time by class. A kernel that runs inside a GPU annotation span —
``bn_backward_recompute`` (ops/bn_fused.py) or the optimizer's
``Optimizer.step`` — is charged to that span; any other is classed by
its name. Annotation spans and host rows are never summed, so no time is
counted twice. The idle share is 1 − device time / the caller's wall
time of the traced window.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Sequence, Tuple

#: GPU annotation name prefix → class.
ANNOTATIONS = (
    ("bn_backward_recompute", "bn_backward_recompute"),
    ("Optimizer.step", "optimizer"),
)
#: Substrings of a kernel's name → its class, first match wins.
CLASSES = (
    ("bn_forward_kernel", ("bn_train_forward",)),
    ("flash_attention", ("flash_fwd_kernel",)),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "matmul", "cublas")),
    ("reduce", ("reduce", "softmax", "norm", "argmax")),
    ("copy/cast", ("copy", "cast", "fill", "cat", "index", "memcpy",
                   "memset", "pad")),
)
#: The LM trainers' classes (training/benchmark.py): the kernels of the
#: port by name, the backward's plain recomputes and the optimizer by
#: span, cuBLAS's products split by type: an fp32 product's kernel
#: names its operands (``f32f32``, ``sgemm``), and outside the backward
#: recomputes the LM step's fp32 products are the ``lm_head``'s; any
#: other product is bf16.
LM_ANNOTATIONS = (
    ("flash_backward_recompute", "flash_backward_plain_recompute"),
    ("rms_norm_backward_recompute", "rms_norm_backward_plain_recompute"),
    ("Optimizer.step", "optimizer"),
)
LM_CLASSES = (
    ("flash_forward_kernel", ("flash_fwd_kernel",)),
    ("rms_norm_kernel", ("rms_norm_kernel",)),
    ("gemm_fp32", ("f32f32", "sgemm")),
    ("gemm_bf16", ("gemm", "cutlass", "xmma", "nvjet", "matmul", "cublas")),
    ("cross_entropy", ("nll_loss", "log_softmax", "logsoftmax")),
    ("reduce", ("reduce", "softmax", "norm", "argmax")),
    ("copy/cast", ("copy", "cast", "fill", "cat", "index", "memcpy",
                   "memset", "pad")),
)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_class(name: str, classes: Sequence[Tuple[str, Tuple[str, ...]]]
                 = CLASSES) -> str:
    low = name.lower()
    for cls, keys in classes:
        if any(k in low for k in keys):
            return cls
    return "elementwise/other"


def summarize_trace(path: str, wall_ms: float, top: int = 10,
                    classes=CLASSES, annotations=ANNOTATIONS) -> Dict:
    """Device time by class and the top kernels of a Chrome trace that
    ``torch.profiler.profile.export_chrome_trace`` wrote. ``classes``
    and ``annotations`` default to the vision trainer's; the LM
    trainers pass :data:`LM_CLASSES` and :data:`LM_ANNOTATIONS`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"], cls)
        for e in events if e.get("cat") == "gpu_user_annotation"
        for prefix, cls in annotations if e["name"].startswith(prefix))
    by_class = collections.Counter()
    by_kernel = collections.Counter()
    launches = collections.Counter()
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES or e.get("ph") != "X":
            continue
        ms = e["dur"] / 1e3
        cls = next((c for lo, hi, c in spans if lo <= e["ts"] < hi),
                   None) or kernel_class(e["name"], classes)
        by_class[cls] += ms
        by_kernel[e["name"]] += ms
        launches[e["name"]] += 1
    busy = sum(by_class.values())
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "kernel_launches": sum(launches.values()),
        "by_class_ms": dict(by_class.most_common()),
        "top_kernels": [
            {"name": name[:100], "ms": t, "launches": launches[name]}
            for name, t in by_kernel.most_common(top)],
    }
