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

"""The RMSNorm kernel against an earlier design of it, on one GPU.

Builds a copy of an earlier ``csrc/rms_norm.cu`` (path given; its C entry
``kft_rms_norm(x, scale, y, dtype, rows, d, x_stride, eps, stream)``, the
one-block-a-row kernel) with ``_build.NVCC_FLAGS`` beside this checkout's
kernels, and times three implementations in turns (earlier, today,
library, then back) on the same inputs, at [M, 4096] bf16 for
M = 1, 4, 20, 512 and 8192 and at [4, 4096] fp32:

- the plain entry: the earlier kernel, ``rms_norm`` and ``F.rms_norm``;
- the fused entry (the residual add, then the norm): a torch add then the
  earlier kernel, ``add_rms_norm``, and ``x + d`` then ``F.rms_norm``.

Each turn gives the device ms per call (the profiler's kernel records
over 20 calls, every kernel of the call summed), ``ms`` (CUDA events
around 20 back-to-back calls, median of 7) and ``ms_one_call`` (one call
per event pair, median of 30, which adds the host's work), as
``chip_smoke.py`` times its kernels, and ``ms_one_call_interleaved``
(one call per event pair, the implementations in turn call by call, the
median of 200 rounds: the host's drift shared); then the bound (x, and d, read
once; y, and s, written once; the scale once) and the share of it the
device ms reach. At M = 8192 the inputs cycle through copies larger
than the 50 MB L2 (cold); below it they stay warm, as a forward's
stream, just written, is. Every output is held to the plain version
first: the kernels to one step of their type, ``F.rms_norm`` (which
rounds once where the reference rounds three times) to two.

With ``--old_checkout DIR`` (an unpacked earlier commit) it also counts
the kernels of one replayed captured decode slice (llama3-8b at full
width, bf16, 4 slots, 4 steps) there and here, each in a child process
(``--slice_kernels``) on the same card: all kernels, the RMSNorm kernels
and the bf16 elementwise adds, the kernels' device ms summed (the
profiler's), and a replay's wall ms (events, median of 30).

Prints one JSON line per shape and entry, then the slice counts and the
card's name and power limit (``nvidia-smi``); fails, nonzero, where the
copy is missing or there is no GPU. Keep the copies in a git-ignored
directory, for example those of the parent commit::

    git show HEAD~1:kubeflow_tpu_torch/csrc/rms_norm.cu > .tmp/rms_norm_old.cu
    mkdir -p .tmp/parent && git archive HEAD~1 | tar -x -C .tmp/parent
    python3 scripts/rms_norm_ab.py --old .tmp/rms_norm_old.cu \\
        --old_checkout .tmp/parent [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: llama3-8b's width; the main path's row counts: a decode step's 1 and
#: 4 (4 slots), a speculative verify's 20, a prefill's 512, an
#: 8192-token block.
D = 4096
SHAPES = tuple(("bfloat16", m) for m in (1, 4, 20, 512, 8192)) + (
    ("float32", 4),)
COLD_FROM = 8192
#: Rounds of the interleaved one-call timing.
INTERLEAVED = 200
IMPLS = ("earlier", "today", "library")
TURNS = IMPLS + IMPLS[::-1]
EPS = 1e-5
#: The captured slice: ``EngineConfig`` at the engine phases' 4 slots
#: and 4-step slices, short prompts.
SLICE_KEY = ("decode_slice", "steps=4 slots=4")
#: Replays of the slice timed one an event pair (the median kept).
REPLAYS = 30


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]


def slice_kernels() -> dict:
    """One replayed captured decode slice's kernels, in this process's
    package (the checkout on ``sys.path``)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from kubeflow_tpu_torch.inference import prng
    from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.models.registry import get_model

    model = get_model("llama3-8b").make(dtype="bfloat16", cache_size=128)
    params = init_params(model, seed=0, device="cuda")
    engine = DecodeEngine(model, params, EngineConfig(
        max_new_tokens=16, max_prompt_len=64, num_slots=4, page_size=16,
        slice_tokens=4), name="rms-norm-ab", device="cuda",
        capture_graphs=True)
    try:
        rng = np.random.default_rng(0)
        streams = [engine.submit(
            rng.integers(0, model.vocab_size, 64).astype(np.int32),
            rng=prng.PRNGKey(i), max_new_tokens=16) for i in range(4)]
        for stream in streams:
            stream.result(timeout=600)
        graph = engine._graphs.programs[SLICE_KEY].graph
        graph.replay()
        torch.cuda.synchronize()
        replays = []
        for _ in range(REPLAYS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            replays.append(start.elapsed_time(end))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
    finally:
        engine.stop()
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]

    def count(*parts):
        return sum(r.count for r in rows if all(p in r.key for p in parts))

    return {"kernels": sum(r.count for r in rows),
            "device_ms": sum(r.self_device_time_total for r in rows) / 1e3,
            "replay_ms": statistics.median(replays),
            "rms_norm_kernels": count("rms_norm_kernel"),
            "add_rms_norm_kernels": count("add_rms_norm_kernel"),
            "bf16_add_kernels": count("CUDAFunctor_add", "BFloat16"),
            "by_name": {r.key[:120]: r.count for r in sorted(
                rows, key=lambda r: -r.count)[:12]}}


def child_slice(root: str, env_root: str) -> dict:
    """``--slice_kernels`` in a child process whose package is the one
    under ``root``."""
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--slice_kernels",
         "--root", root], capture_output=True, text=True, cwd=env_root,
        env=env, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"slice kernels in {root} failed:\n"
                           f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def share_builds(old_root: str) -> None:
    """Copy this checkout's built kernels into the earlier checkout's
    build directory where the source is the same (the file name carries
    the source's hash), so its child builds only what differs."""
    from kubeflow_tpu_torch.ops import _build

    _build.build_all()
    old_csrc = os.path.join(old_root, "kubeflow_tpu_torch", "csrc")
    old_build = os.path.join(old_root, "kubeflow_tpu_torch", "_build")
    os.makedirs(old_build, exist_ok=True)
    for name in _build.sources():
        src, lib = _build._target(name)
        old_src = os.path.join(old_csrc, name + ".cu")
        if not os.path.exists(old_src):
            continue
        with open(src, "rb") as a, open(old_src, "rb") as b:
            if a.read() != b.read():
                continue
        dst = os.path.join(old_build, os.path.basename(lib))
        if not os.path.exists(dst):
            shutil.copy(lib, dst)


def earlier_kernel(path: str):
    """The earlier kernel's call: y = rms_norm(x) through its C entry."""
    import torch
    from gemm_ab import build_copy
    from kubeflow_tpu_torch.ops import _build

    lib = build_copy(path, "rms_norm")
    lib.kft_rms_norm.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_float,
                                    ctypes.c_void_p])
    lib.kft_rms_norm.restype = ctypes.c_int

    def run(x, scale, eps):
        rows = x.reshape(-1, x.shape[-1])
        y = torch.empty_like(x)
        err = lib.kft_rms_norm(rows.data_ptr(), scale.data_ptr(),
                               y.data_ptr(),
                               1 if x.dtype == torch.bfloat16 else 0,
                               rows.shape[0], rows.shape[1], rows.stride(0),
                               eps, torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "earlier rms_norm")
        return y
    return run


def compare(entry, dtype_name, m, fns, inputs, card):
    """Hold each implementation to the plain version, then time them in
    turns."""
    import torch
    from chip_smoke import (DECODE_TOL, KERNEL_TIMING, bound, cold_cycle,
                            profiled_ms, time_ms)
    from kubeflow_tpu_torch.ops import rms_norm as rn

    dtype = getattr(torch, dtype_name)
    x, delta, scale = inputs
    want = (rn.rms_norm_reference(x, scale, EPS) if entry == "plain"
            else rn.add_rms_norm_reference(x, delta, scale, EPS)[1])
    tol = DECODE_TOL[dtype] * max(1.0, float(want.float().abs().max()))
    # F.rms_norm rounds once, after fp32 products; the reference rounds
    # rsqrt, the product and the scale in turn: up to two steps apart.
    limits = {"earlier": tol, "today": tol, "library": 2 * tol}
    row = {"entry": entry, "shape": f"[{m}, {D}] {dtype_name}", "m": m,
           "cold": m >= COLD_FROM, "card": card}
    for impl in IMPLS:
        got = fns[impl](x, delta)
        got = got[1] if isinstance(got, tuple) else got
        err = float((got.float() - want.float()).abs().max())
        if not err <= limits[impl]:
            raise AssertionError(f"{impl} {entry} [{m}, {D}] {dtype_name}: "
                                 f"max |Δ| {err} > {limits[impl]}")
        row[f"{impl}_max_abs_err"] = err
    copies = (cold_cycle((x, delta)) if m >= COLD_FROM
              else cold_cycle((x, delta), at_least=0))
    times = {impl: {"device_ms": [], "ms": [], "ms_one_call": []}
             for impl in IMPLS}
    for impl in TURNS:
        fn = fns[impl]

        def call():
            a, b = next(copies)
            return fn(a, b)

        times[impl]["device_ms"].append(profiled_ms(call))
        times[impl]["ms"].append(time_ms(call, **KERNEL_TIMING))
        times[impl]["ms_one_call"].append(time_ms(call))
    # The host's work a call, the implementations interleaved call by
    # call so that they share the host's drift: one call an event pair.
    calls = {impl: [] for impl in IMPLS}
    for _ in range(INTERLEAVED):
        for impl in IMPLS:
            fn = fns[impl]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            a, b = next(copies)
            start.record()
            fn(a, b)
            end.record()
            end.synchronize()
            calls[impl].append(start.elapsed_time(end))
    elem = x.element_size()
    streams = 2 if entry == "plain" else 4
    b_ms, b_by = bound((streams * m * D + D) * elem,
                       (4.0 + (entry != "plain")) * m * D, dtype)
    row.update({f"{impl}_{k}": v for impl in IMPLS
                for k, v in times[impl].items()})
    row.update({f"{impl}_ms_one_call_interleaved":
                statistics.median(calls[impl]) for impl in IMPLS})
    row.update(bound_ms=b_ms, bound_by=b_by)
    row.update({f"{impl}_bound_share": [b_ms / t for t in
                                        times[impl]["device_ms"]]
                for impl in IMPLS})
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", help="copy of an earlier csrc/rms_norm.cu")
    parser.add_argument("--old_checkout", default=None,
                        help="an earlier commit unpacked: count its "
                        "captured slice's kernels beside this checkout's")
    parser.add_argument("--out", default=None, help="also write JSON here")
    parser.add_argument("--slice_kernels", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("rms_norm_ab: CUDA is not available", file=sys.stderr)
        return 1
    if args.slice_kernels:
        print(json.dumps(slice_kernels()), flush=True)
        return 0
    if not args.old or not os.path.isfile(args.old):
        print(f"rms_norm_ab: {args.old} is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    from kubeflow_tpu_torch.ops import rms_norm as rn

    card = card_name()
    print(card, flush=True)
    earlier = earlier_kernel(args.old)
    result = {"card": card, "rows": []}
    for dtype_name, m in SHAPES:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(m)
        x = (torch.randn(m, D, device="cuda", generator=gen) * 2).to(dtype)
        delta = torch.randn(m, D, device="cuda", generator=gen).to(dtype)
        scale = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).to(
            dtype)
        plain = {
            "earlier": lambda a, b: earlier(a, scale, EPS),
            "today": lambda a, b: rn.rms_norm(a, scale, EPS),
            "library": lambda a, b: F.rms_norm(a, (D,), scale, EPS)}
        fused = {
            "earlier": lambda a, b: earlier(a + b, scale, EPS),
            "today": lambda a, b: rn.add_rms_norm(a, b, scale, EPS),
            "library": lambda a, b: F.rms_norm(a + b, (D,), scale, EPS)}
        for entry, fns in (("plain", plain), ("fused", fused)):
            result["rows"].append(compare(entry, dtype_name, m, fns,
                                          (x, delta, scale), card))
        del x, delta, scale
        torch.cuda.empty_cache()
    if args.old_checkout:
        old_root = os.path.abspath(args.old_checkout)
        share_builds(old_root)
        slices = {"earlier": child_slice(old_root, old_root),
                  "today": child_slice(args.root, args.root)}
        slices["kernels_fewer"] = (slices["earlier"]["kernels"]
                                   - slices["today"]["kernels"])
        result["captured_slice"] = slices
        print(json.dumps({"captured_slice": slices}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
