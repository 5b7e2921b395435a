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

"""tpu-cnn on one GPU — the vision training benchmark.

Port of the vision half of ``kubeflow_tpu/training/benchmark.py`` (the
``tf_cnn_benchmarks`` replacement): synthetic data, SGD with Nesterov
momentum, images/sec as the headline metric. The LM and LoRA halves
come with the LM-training slice. Run::

    python -m kubeflow_tpu_torch.training.benchmark --model resnet50 \\
        --batch_size 256 --bn_stat_rows 32

``flops_per_step`` is ``torch.utils.flop_counter``'s count of one step
(forward and backward); ``mfu_pct`` is taken against the card's
published bf16 peak and only on a card whose peak is known. Timing
fences on the host (``float(loss)``) after the timed loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from kubeflow_tpu_torch.models.convert import init_resnet
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.training.train import (
    create_train_state,
    make_train_step,
    sgd,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.profile import summarize_trace

#: Device name substring → published dense bf16 FLOP/s (MFU denominator).
PEAK_BF16_FLOPS = {"H100": 989e12, "H200": 989e12}


@dataclasses.dataclass
class BenchConfig:
    model: str = "resnet50"
    batch_size: int = 128
    steps: int = 20
    warmup_steps: int = 3
    learning_rate: Optional[float] = None  # None → per-model default
    momentum: float = 0.9
    image_size: Optional[int] = None  # override model default (smoke runs)
    seed: int = 0
    model_kwargs: Optional[Dict] = None  # e.g. {"bn_stat_rows": 32}
    profile_dir: Optional[str] = None  # torch.profiler trace of timed steps


def synthetic_batch(config: BenchConfig, num_classes: int, input_shape,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """bf16 N(0, 1) NHWC images and integer labels, drawn on the device
    from a generator seeded with ``config.seed`` (synthetic mode, the
    reference's default)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed)
    images = torch.randn((config.batch_size, *input_shape), generator=gen,
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, num_classes, (config.batch_size,),
                           generator=gen, device=device)
    return {"inputs": images, "labels": labels}


def peak_flops(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((p for k, p in PEAK_BF16_FLOPS.items() if k in name), None)


def _timed_steps(step_fn, state, batch, config: BenchConfig):
    """One counted step and the rest of the warmup, then the timed loop.
    Returns (elapsed_s, compile_plus_warmup_s, losses, flops)."""
    start = time.perf_counter()
    counter = FlopCounterMode(display=False)
    with counter:
        state, metrics = step_fn(state, batch)
    for _ in range(max(config.warmup_steps, 1) - 1):
        state, metrics = step_fn(state, batch)
    float(metrics["loss"])
    warmup_s = time.perf_counter() - start

    prof = contextlib.nullcontext()
    if config.profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if batch["inputs"].is_cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    losses = []
    with prof:
        start = time.perf_counter()
        for _ in range(config.steps):
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"])
        float(metrics["loss"])  # the fence, inside the trace
        elapsed = time.perf_counter() - start
    if config.profile_dir:
        os.makedirs(config.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(config.profile_dir,
                                              "trace.json"))
    return (elapsed, warmup_s, torch.stack(losses).tolist(),
            float(counter.get_total_flops()))


def run_benchmark(config: BenchConfig,
                  device: DeviceLike = None) -> Dict[str, float]:
    """Returns {images_per_sec, images_per_sec_per_chip, step_time_ms,
    ...}; the device is ``cuda`` unless the caller asks for the CPU."""
    device = resolve_device(device)
    entry = get_model(config.model)
    if entry.family != "vision":
        raise ValueError(f"{config.model!r} is {entry.family}; the port's "
                         "benchmark trains vision models")
    model = entry.make(**(config.model_kwargs or {}))
    input_shape = entry.input_spec[0]
    if config.image_size is not None:
        input_shape = (config.image_size, config.image_size, input_shape[-1])
    lr = (config.learning_rate if config.learning_rate is not None
          else (entry.bench_lr if entry.bench_lr is not None else 0.1))
    params, batch_stats = init_resnet(model, seed=config.seed, device=device)
    state = create_train_state(model, sgd(lr, config.momentum), params,
                               batch_stats)
    batch = synthetic_batch(config, entry.num_classes_or_vocab, input_shape,
                            device)

    elapsed, warmup_s, losses, flops = _timed_steps(
        make_train_step(), state, batch, config)
    step_time_s = elapsed / config.steps
    images_per_sec = config.batch_size * config.steps / elapsed
    result = {
        "model": config.model,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "global_batch_size": config.batch_size,
        "n_chips": 1,
        "steps": config.steps,
        "images_per_sec": images_per_sec,
        "images_per_sec_per_chip": images_per_sec,
        "step_time_ms": step_time_s * 1e3,
        "compile_plus_warmup_s": warmup_s,
        "final_loss": losses[-1],
        "losses": losses,
        "flops_per_step": flops,
    }
    peak = peak_flops(device)
    if peak is not None:
        result["mfu_pct"] = flops / step_time_s / peak * 100
    if config.profile_dir and device.type == "cuda":
        result["profile"] = summarize_trace(
            os.path.join(config.profile_dir, "trace.json"), elapsed * 1e3)
    return result


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="tpu-cnn")
    parser.add_argument("--model", default="resnet50")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup_steps", type=int, default=3)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "timed steps under this dir, and a device-time "
                             "breakdown into the result")
    parser.add_argument("--bn_stat_rows", type=int, default=0,
                        help="ghost-BN statistics row cap for vision "
                             "models (0 = exact BN)")
    parser.add_argument("--learning_rate", type=float, default=None,
                        help="vision sgd lr (default: 0.1, or the model's "
                             "registered bench_lr)")
    args = parser.parse_args(argv)
    try:
        entry = get_model(args.model)
    except KeyError as e:
        parser.error(str(e.args[0]))
    if args.bn_stat_rows and entry.family != "vision":
        # Silently ignoring the flag would report an exact-BN number
        # as a ghost-BN one.
        parser.error(
            f"--bn_stat_rows applies to vision models; {args.model!r} "
            f"is {entry.family}")
    if args.bn_stat_rows < 0:
        # GhostBatchNorm's `0 < stat_rows` guard would silently fall
        # back to exact BN.
        parser.error(f"--bn_stat_rows must be >= 0; got "
                     f"{args.bn_stat_rows}")
    if entry.family != "vision":
        parser.error(f"{args.model!r} is {entry.family}: the LM and LoRA "
                     "benchmarks are not ported yet")
    result = run_benchmark(
        BenchConfig(model=args.model, batch_size=args.batch_size,
                    steps=args.steps, warmup_steps=args.warmup_steps,
                    image_size=args.image_size,
                    profile_dir=args.profile_dir,
                    learning_rate=args.learning_rate,
                    model_kwargs=({"bn_stat_rows": args.bn_stat_rows}
                                  if args.bn_stat_rows else None)))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
