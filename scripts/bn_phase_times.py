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

"""Where one launch of the BN training-forward kernel spends its time.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/bn_phase_times.py

Builds a copy of ``kubeflow_tpu_torch/csrc/bn_forward.cu`` in which
thread 0 of every block writes ``%globaltimer`` at each phase boundary
(start; partial sums done; first grid barrier; finalize done; second
barrier; parameters staged; streamed rows normalized; end), runs it at a
few ResNet-50 BN shapes, and prints for each boundary the [min, median,
max] over blocks in microseconds since the earliest block started. The
copy goes into the git-ignored build directory; the repository's source
is not touched. The stamps cost a few stores a block.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from kubeflow_tpu_torch.ops import _build, bn_fused  # noqa: E402

SHAPES = ((2112, 256, None), (12544, 512, None), (50176, 256, None),
          (200704, 128, None), (802816, 256, None), (802816, 256, 100352))
#: (boundary, code it follows) in the kernel's source, stamped in order.
STAMPS = (
    ("start", "  extern __shared__ __align__(128) unsigned char smem[];\n"),
    ("partials", "  float* partial = p.work;\n"),
    ("barrier1", "  cg::grid_group grid = cg::this_grid();\n  grid.sync();\n"),
    ("finalized", "p.scale[ch]);\n      }\n    }\n  }\n"),
    # The first barrier's line is stamped by now: this is the second.
    ("barrier2", "  grid.sync();\n\n"),
    ("params", "    b[i] = red[2 * width + tx * VEC + i];\n  }\n"),
    ("streamed", "                         nty, mu, k, b);\n"),
    ("end", "  normalize_rows<T, VEC>(x, y, b0, 1, b1 - b0, c, c0, ty, nty, "
            "mu, k, b);\n"),
)
SLOTS = 4096


def stamped_source() -> str:
    with open(os.path.join(_build.CSRC, "bn_forward.cu")) as f:
        src = f.read()
    stamp = ("#define STAMP(k) if (threadIdx.x == 0 && threadIdx.y == 0) { "
             "unsigned long long t_; asm volatile(\"mov.u64 %0, "
             "%%globaltimer;\" : \"=l\"(t_)); "
             f"g_stamps[blockIdx.x * {len(STAMPS)} + (k)] = t_; }}\n")
    src = src.replace(
        "struct Params {",
        f"__device__ unsigned long long g_stamps[{SLOTS * len(STAMPS)}];\n"
        + stamp + "struct Params {", 1)
    for k, (_, anchor) in enumerate(STAMPS):
        if src.count(anchor) < 1:
            raise RuntimeError(f"stamp anchor not found: {anchor!r}")
        src = src.replace(anchor, anchor + f"  STAMP({k});\n", 1)
    return src.replace(
        'extern "C" {',
        'extern "C" {\nint kft_bn_stamps(unsigned long long* out) {\n'
        '  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n'
        '}\n', 1)


def build() -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "bn_forward_stamped.cu")
    lib = os.path.join(_build.BUILD_DIR, "libbn_forward_stamped.so")
    with open(src, "w") as f:
        f.write(stamped_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    out = ctypes.CDLL(lib)
    out.kft_bn_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float,
                                                           ctypes.c_void_p]
    out.kft_bn_limits.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 3
    out.kft_bn_stamps.argtypes = [ctypes.c_void_p]
    return out


def phase_times(lib, m, c, stat_rows) -> dict:
    x = torch.randn(m, c, device="cuda").bfloat16()
    scale = torch.rand(c, device="cuda")
    bias = torch.randn(c, device="cuda")
    coresident, slab = bn_fused.device_limits(lib, x.device, 1, 8)
    plan = bn_fused.launch_plan(m, c, 8, 2, stat_rows, coresident=coresident,
                                slab_bytes=slab)
    geometry = bn_fused._Geometry(
        m, m if stat_rows is None else stat_rows, plan.stat_per,
        plan.rest_per, plan.smem_bytes, 1, 8, c, plan.tx, plan.ty,
        plan.c_tiles, plan.chunks, plan.keep)
    y = torch.empty_like(x)
    stats = torch.empty((2 * plan.chunks + 3) * c, device="cuda")
    for _ in range(4):  # the last launch's stamps are read
        err = lib.kft_bn_forward(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            stats.data_ptr(), ctypes.addressof(geometry), 1e-5,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (SLOTS * len(STAMPS)))()
    if lib.kft_bn_stamps(buf):
        raise RuntimeError("reading the stamps failed")
    n = len(STAMPS)
    t0 = min(buf[b * n] for b in range(plan.grid))
    row = {"shape": [m, c, stat_rows], "route": plan.route,
           "blocks": plan.grid}
    for k, (name, _) in enumerate(STAMPS):
        us = [(buf[b * n + k] - t0) / 1e3 for b in range(plan.grid)]
        row[name] = [round(min(us), 2), round(statistics.median(us), 2),
                     round(max(us), 2)]
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("bn_phase_times: needs a GPU", file=sys.stderr)
        return 1
    lib = build()
    for m, c, stat_rows in SHAPES:
        print(json.dumps(phase_times(lib, m, c, stat_rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
