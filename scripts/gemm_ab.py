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

"""The two GEMM kernels against an earlier design of each, on one GPU.

Builds copies of earlier ``csrc/prefill_gemm.cu`` and
``csrc/decode_gemm.cu`` sources (paths given; both take the same C entry
points as today's) with ``_build.NVCC_FLAGS``, loads them with ctypes
beside this checkout's kernels, and times the earlier kernel, today's
kernel and ``F.linear`` in turns (earlier, today, F.linear, F.linear,
today, earlier) on the same inputs: the four llama3-8b prefill products
at M = 512, and the five decode products at M = 1, 4 and 20 (the fp32
``lm_head`` also at 32, a whole pass of its rows: a speculative verify's
4 slots × 5 tokens take 20). Each turn is the device time per call from the
profiler's kernel records over 20 calls, the weights cycled through
copies larger than the 50 MB L2 as a forward reads them. Every kernel's
output is held against ``F.linear`` (one step of the output type) first.

Prints one JSON line per shape (both turns of each, in ms), then the sums
over a prefill forward's 224 products and a decode step's 225 at M = 4,
and the card's name and power limit. Fails, nonzero, where a copy is
missing or there is no GPU. Keep the copies in a git-ignored directory,
for example those of the parent commit::

    git show HEAD~1:kubeflow_tpu_torch/csrc/prefill_gemm.cu > .tmp/prefill_gemm_old.cu
    git show HEAD~1:kubeflow_tpu_torch/csrc/decode_gemm.cu > .tmp/decode_gemm_old.cu
    python3 scripts/gemm_ab.py --old_prefill .tmp/prefill_gemm_old.cu \\
        --old_decode .tmp/decode_gemm_old.cu [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import itertools
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kubeflow_tpu_torch.ops import _build  # noqa: E402
from kubeflow_tpu_torch.ops import decode_gemm as dg  # noqa: E402
from kubeflow_tpu_torch.ops import prefill_gemm as pg  # noqa: E402

#: (name, K, N, launches a prefill forward).
PREFILL = (("q_proj/o_proj [4096→4096]", 4096, 4096, 64),
           ("k_proj/v_proj [4096→1024]", 4096, 1024, 64),
           ("gate_proj/up_proj [4096→14336]", 4096, 14336, 64),
           ("down_proj [14336→4096]", 14336, 4096, 32))
PREFILL_M = 512
#: (name, K, N, dtype, launches a decode step).
DECODE = (("q_proj/o_proj [4096→4096] bf16", 4096, 4096, torch.bfloat16, 64),
          ("k_proj/v_proj [4096→1024] bf16", 4096, 1024, torch.bfloat16, 64),
          ("gate_proj/up_proj [4096→14336] bf16", 4096, 14336,
           torch.bfloat16, 64),
          ("down_proj [14336→4096] bf16", 14336, 4096, torch.bfloat16, 32),
          ("lm_head [4096→128256] fp32", 4096, 128256, torch.float32, 1))
DECODE_M = (1, 4, 20)
#: The fp32 lm_head's rows: DECODE_M and a whole pass over W.
FP32_HEAD_M = DECODE_M + (32,)
STEP = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
IMPLS = ("earlier", "today", "F.linear")
TURNS = ("earlier", "today", "F.linear", "F.linear", "today", "earlier")


def build_copy(path: str, name: str) -> ctypes.CDLL:
    """nvcc a copy of a kernel source into the build directory."""
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_build.BUILD_DIR, f"lib{name}-earlier-{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                              path], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{out.stdout}"
                               f"{out.stderr}")
    return ctypes.CDLL(lib)


def bind(lib: ctypes.CDLL, entry: str, ints: int) -> None:
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * ints
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def earlier_prefill(lib):
    def run(x, w):
        out = torch.empty((x.shape[0], w.shape[0]), dtype=x.dtype,
                          device=x.device)
        err = lib.kft_prefill_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                   x.shape[0], w.shape[0], w.shape[1],
                                   x.stride(0),
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "earlier prefill_gemm")
        return out
    return run


def earlier_decode(lib):
    def run(x, w):
        out = torch.empty((x.shape[0], w.shape[0]), dtype=x.dtype,
                          device=x.device)
        err = lib.kft_decode_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  1 if x.dtype == torch.bfloat16 else 0,
                                  x.shape[0], w.shape[0], w.shape[1],
                                  x.stride(0),
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "earlier decode_gemm")
        return out
    return run


def device_ms(fn, calls: int = 20) -> float:
    """Device time per call: the profiler's kernel records over calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / calls / 1e3


def cold_copies(w: torch.Tensor, at_least: int = 256 << 20):
    n = max(1, -(-at_least // (w.numel() * w.element_size())))
    return itertools.cycle([w] + [w.clone() for _ in range(n - 1)])


def compare(name, m, fns, x, w, dtype, launches):
    """Hold each kernel against F.linear, then time the three in turns."""
    want = F.linear(x, w)
    tol = STEP[dtype] * max(1.0, float(want.float().abs().max()))
    row = {"shape": f"{name} M={m}", "m": m, "launches": launches}
    for impl in IMPLS[:2]:
        err = float((fns[impl](x, w).float() - want.float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"{impl} {name} M={m}: max |Δ| {err} > "
                                 f"{tol}")
        row[f"{impl}_max_abs_err"] = err
    ws = cold_copies(w)
    times = {impl: [] for impl in IMPLS}
    for impl in TURNS:
        fn = fns[impl]
        times[impl].append(device_ms(lambda: fn(x, next(ws))))
    k, n = w.shape[1], w.shape[0]
    elem = w.element_size()
    t_bytes = (n * k + m * k + m * n) * elem / PEAK_BYTES * 1e3
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[dtype] * 1e3
    row.update({f"{impl}_device_ms": times[impl] for impl in IMPLS})
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
    row["today_bound_share"] = [row["bound_ms"] / t for t in times["today"]]
    print(json.dumps(row), flush=True)
    return row


def sums(rows, launches_key="launches"):
    """Σ launches · ms over rows, for each impl's two turns."""
    return {impl: [sum(r[launches_key] * r[f"{impl}_device_ms"][i]
                       for r in rows) for i in range(2)] for impl in IMPLS} | {
        "bound_ms": sum(r[launches_key] * r["bound_ms"] for r in rows)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old_prefill", required=True,
                        help="copy of an earlier csrc/prefill_gemm.cu")
    parser.add_argument("--old_decode", required=True,
                        help="copy of an earlier csrc/decode_gemm.cu")
    parser.add_argument("--out", default=None, help="also write JSON here")
    args = parser.parse_args()
    for path in (args.old_prefill, args.old_decode):
        if not os.path.isfile(path):
            print(f"gemm_ab: {path} is missing", file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("gemm_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    old_pf = build_copy(args.old_prefill, "prefill_gemm")
    old_dc = build_copy(args.old_decode, "decode_gemm")
    bind(old_pf, "kft_prefill_gemm", 3)
    bind(old_dc, "kft_decode_gemm", 4)
    _build.load("prefill_gemm")
    _build.load("decode_gemm")

    result = {"card": card, "prefill": [], "decode": []}
    fns = {"earlier": earlier_prefill(old_pf), "today": pg.prefill_linear,
           "F.linear": F.linear}
    for name, k, n, launches in PREFILL:
        gen = torch.Generator(device="cuda").manual_seed(11)
        w = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).to(
            torch.bfloat16)
        x = torch.randn(PREFILL_M, k, device="cuda", generator=gen).to(
            torch.bfloat16)
        result["prefill"].append(compare(name, PREFILL_M, fns, x, w,
                                         torch.bfloat16, launches))
        del w, x
        torch.cuda.empty_cache()
    fns = {"earlier": earlier_decode(old_dc), "today": dg.decode_linear,
           "F.linear": F.linear}
    for name, k, n, dtype, launches in DECODE:
        gen = torch.Generator(device="cuda").manual_seed(8)
        w = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).to(dtype)
        ms = FP32_HEAD_M if dtype == torch.float32 else DECODE_M
        x = torch.randn(max(ms), k, device="cuda", generator=gen).to(dtype)
        for m in ms:
            result["decode"].append(compare(name, m, fns, x[:m], w, dtype,
                                            launches))
        del w, x
        torch.cuda.empty_cache()
    result["prefill_forward"] = sums(result["prefill"])
    at4 = [r for r in result["decode"] if r["m"] == 4]
    result["decode_step_m4"] = sums(at4)
    result["decode_step_m4_bf16"] = sums(
        [r for r in at4 if "bf16" in r["shape"]])
    for key in ("prefill_forward", "decode_step_m4", "decode_step_m4_bf16"):
        print(json.dumps({key: result[key]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
