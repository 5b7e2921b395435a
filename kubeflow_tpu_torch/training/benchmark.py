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

"""tpu-cnn on one GPU: the training benchmarks.

Port of ``kubeflow_tpu/training/benchmark.py`` (the
``tf_cnn_benchmarks`` replacement), its three halves:

- vision (:func:`run_benchmark`): synthetic images, SGD with Nesterov
  momentum, images/sec as the headline metric;
- LM pretraining (:func:`run_lm_benchmark`): a step over every param,
  ``adamw`` (optax's), tokens/sec;
- LoRA fine-tuning (:func:`run_lora_benchmark`): a bf16 frozen base,
  rank-r adapters on q/k/v/o, rematerialised blocks, ``adamw(1e-4)``,
  b1 × L1024: the reference's "7B on one chip" row.

Run::

    python -m kubeflow_tpu_torch.training.benchmark --model resnet50 \\
        --batch_size 256 --bn_stat_rows 32
    python -m kubeflow_tpu_torch.training.benchmark --model llama3-8b \\
        --lora_rank 16 --seq_len 1024

Vision (every vision entry of the registry: ResNet, Inception and ViT
at lr 0.1, VGG and AlexNet at their ``bench_lr``): ``flops_per_step`` is
``torch.utils.flop_counter``'s count of one step. The counter sees
ViT's attention only through its plain version: on the CPU its forward
and backward; on the card, where the kernel forward (launched through
ctypes) is hidden from it, the backward's plain recompute of the
forward and that recompute's backward. Both are 3 ×
:func:`~kubeflow_tpu_torch.ops.flash_attention.attention_flops` a layer
(a forward, and a backward of twice its work), what a formula counts,
so a step counts the same on either device (tests hold the card's count
to the CPU's; a backward kernel would break that, and attention would
then be counted by formula). LM and LoRA: ``flops_per_step`` is
:func:`lm_train_flops`, a formula over the model's shapes (Llama dense
and MoE, and BERT), the same whatever implements attention (a FLOP
counter sees the plain backward's ops but not a kernel launched
through ctypes, so its count would move with the implementation). It
counts the work the step does, as the reference's XLA count does: the
remat recompute and attention's full square, so ``mfu_pct`` over it is
a hardware-FLOPs utilisation. ``model_flops_per_step`` and
``model_flops_util_pct`` count the model's own work beside it: no
recompute, the causal half of attention. Both are taken against the
card's published dense bf16 peak (the fp32 head included), and only on
a card whose peak is known. Timing fences on the host
(``float(loss)``) after the timed loop. With ``profile_dir`` the result
adds a device-time breakdown of the timed steps (``utils/profile.py``)
and the device's idle share.
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

from kubeflow_tpu_torch.models.bert import Bert
from kubeflow_tpu_torch.models.convert import init_params, init_vision
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh
from kubeflow_tpu_torch.training.data import (
    host_shard_range,
    process_index_and_count,
)
from kubeflow_tpu_torch.training.train import (
    create_train_state,
    make_train_step,
    place_state,
    sgd,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.profile import (
    LM_ANNOTATIONS,
    LM_CLASSES,
    summarize_trace,
)

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
    # The gang's mesh (batch axes); None → all ranks on the data axis in
    # a gang, no mesh alone.
    mesh: Optional[MeshSpec] = None


def bench_mesh(spec: Optional[MeshSpec], device) -> Optional[Mesh]:
    """The benchmark's mesh, as the reference's ``build_mesh(config.
    mesh)``: over the gang's ranks (the megascale env filling dcn_data),
    or None for one process given no spec."""
    if spec is None and process_index_and_count()[1] == 1:
        return None
    return build_mesh(spec, device)


def _rank_rows(batch: Dict[str, torch.Tensor], mesh: Optional[Mesh]):
    """This rank's rows of a global batch (all of it without a mesh)."""
    if mesh is None:
        return batch
    rows = host_shard_range(next(iter(batch.values())).shape[0], mesh=mesh)
    return {k: v[rows.start:rows.stop] for k, v in batch.items()}


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
    kwargs = dict(config.model_kwargs or {})
    model = entry.make(**kwargs)
    input_shape = entry.input_spec[0]
    if config.image_size is not None:
        input_shape = (config.image_size, config.image_size, input_shape[-1])
        if getattr(model, "SIZED_BY_IMAGE", False):
            # ViT's position table and the classic CNNs' fc1 take their
            # size from the image.
            model = entry.make(image_size=config.image_size, **kwargs)
    lr = (config.learning_rate if config.learning_rate is not None
          else (entry.bench_lr if entry.bench_lr is not None else 0.1))
    mesh = bench_mesh(config.mesh, device)
    params, batch_stats = init_vision(model, seed=config.seed, device=device)
    state = create_train_state(model, sgd(lr, config.momentum), params,
                               batch_stats)
    if mesh is not None:
        state = place_state(mesh, state)
    batch = _rank_rows(synthetic_batch(config, entry.num_classes_or_vocab,
                                       input_shape, device), mesh)

    elapsed, warmup_s, losses, flops = _timed_steps(
        make_train_step(mesh), state, batch, config)
    n_chips = mesh.size if mesh is not None else 1
    step_time_s = elapsed / config.steps
    images_per_sec = config.batch_size * config.steps / elapsed
    result = {
        "model": config.model,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "global_batch_size": config.batch_size,
        "n_chips": n_chips,
        "steps": config.steps,
        "images_per_sec": images_per_sec,
        "images_per_sec_per_chip": images_per_sec / n_chips,
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


# -- LM pretraining and LoRA fine-tuning ------------------------------------


def _ffn_flops(model, batch_size: int, seq_len: int) -> int:
    """One forward's FFN FLOPs over every layer. Dense: ``2·T·d·f`` a
    weight (gate/up/down for Llama, in/out for BERT). MoE: what the layer
    runs, over its capacity slots (``n_groups·E·C``) rather than the
    tokens, ``2·slots·d·f`` for each of ``w_in`` and ``w_out``, the
    dispatch and combine products ``2·n·G·E·C·d`` each, and the router
    ``2·T·d·E``."""
    from kubeflow_tpu_torch.ops.moe import _fit_group_size, compute_capacity

    d, f, tokens = model.d_model, model.mlp_dim, batch_size * seq_len
    experts = getattr(model, "num_experts", 0)
    if not experts:
        return 2 * tokens * d * f * (2 if isinstance(model, Bert) else 3) * (
            model.num_layers)
    moe = model.layers[0].moe
    group = _fit_group_size(tokens, moe.group_size)
    cap = compute_capacity(group, experts, moe.num_selected,
                           moe.capacity_factor)
    slots = (tokens // group) * experts * cap
    per_layer = (2 * slots * d * f * 2 + 2 * 2 * tokens * experts * cap * d
                 + 2 * tokens * d * experts)
    return per_layer * model.num_layers


def lm_train_flops(model, batch_size: int, seq_len: int, *,
                   lora_rank: int = 0, remat: bool = False,
                   causal: bool = False) -> float:
    """FLOPs of one LM train step (Llama dense or MoE, BERT), by formula
    (each product 2·m·n·k):

    - forward: the attention projections ``2·T·P`` (T = batch·seq_len
      tokens, P the q/k/v/o weights of every layer), the FFNs
      (:func:`_ffn_flops`), the head ``2·T·d·V`` (BERT's tied head and
      its ``mlm_transform``, ``2·T·d·(V + d)``), attention ``4·B·H·L²·D``
      a layer (QKᵀ and PV over the full square, as the usual count has
      it), and LoRA's adapters ``2·T·r·(in + out)`` for each of q/k/v/o;
    - backward: twice the forward, except that a frozen LoRA base and
      head take only their input gradient (once the forward's); attention
      twice its forward (dQ, dK, dV, dP);
    - with ``remat``, each block's forward once more (projections,
      attention and adapters; not the head);
    - with ``causal``, attention over the L·(L + 1)/2 pairs a causal
      mask keeps, in place of the full square.

    The count does not depend on how attention is implemented: the
    flash backward's recompute of its own forward is not counted."""
    d, layers = model.d_model, model.num_layers
    heads, hd = model.num_heads, model.head_dim
    kv = model.num_kv_heads * hd
    tokens = batch_size * seq_len
    proj = layers * (2 * d * heads * hd + 2 * d * kv)
    f_proj = 2 * tokens * proj + _ffn_flops(model, batch_size, seq_len)
    head = model.vocab_size + (d if hasattr(model, "mlm_transform") else 0)
    f_head = 2 * tokens * d * head
    pairs = seq_len * (seq_len + 1) // 2 if causal else seq_len ** 2
    f_attn = 4 * batch_size * heads * pairs * hd * layers
    f_lora = 0
    if lora_rank:
        f_lora = 2 * tokens * lora_rank * layers * (
            (d + heads * hd) * 2 + (d + kv) * 2)
        backward = f_proj + f_head + 2 * f_attn + 2 * f_lora
    else:
        backward = 2 * (f_proj + f_head + f_attn)
    forward = f_proj + f_head + f_attn + f_lora
    recompute = f_proj + f_attn + f_lora if remat else 0
    return float(forward + backward + recompute)


def _timed_lm_steps(step_fn, state, batch, warmup_steps: int, steps: int,
                    *, batch_iter=None, profile_dir: Optional[str] = None):
    """Warmup steps (at least one), then the timed loop, fenced on the
    host inside the trace. Returns (state, elapsed_s, warmup_s,
    warmup losses, losses)."""
    start = time.perf_counter()
    warmup_losses = []
    for _ in range(max(warmup_steps, 1)):
        state, metrics = step_fn(state, batch)
        warmup_losses.append(metrics["loss"])
    float(metrics["loss"])
    warmup_s = time.perf_counter() - start
    prof = contextlib.nullcontext()
    if profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    losses = []
    with prof:
        start = time.perf_counter()
        for _ in range(steps):
            if batch_iter is not None:
                batch = next(batch_iter)
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"])
        float(metrics["loss"])  # the fence, inside the trace
        elapsed = time.perf_counter() - start
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return (state, elapsed, warmup_s, torch.stack(warmup_losses).tolist(),
            torch.stack(losses).tolist())


def summarize_lm_trace(profile_dir: str, wall_ms: float) -> Dict:
    """The LM step's device time by class (flash forward kernel, the
    flash and RMSNorm backwards' plain recomputes, the RMSNorm kernel,
    bf16 and fp32 products, cross entropy, optimizer) and the idle
    share, from the trace :func:`_timed_lm_steps` wrote; and
    ``host_span_ms``, the host's wall time inside each annotated span
    (a span's host time includes launching its kernels)."""
    path = os.path.join(profile_dir, "trace.json")
    summary = summarize_trace(path, wall_ms, classes=LM_CLASSES,
                              annotations=LM_ANNOTATIONS)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = dict.fromkeys((cls for _, cls in LM_ANNOTATIONS), 0.0)
    for e in events:
        if e.get("cat") != "user_annotation" or e.get("ph") != "X":
            continue
        for prefix, cls in LM_ANNOTATIONS:
            if e["name"].startswith(prefix):
                host[cls] += e["dur"] / 1e3
    summary["host_span_ms"] = host
    return summary


def _lm_result(config, model, device, elapsed, warmup_s, warmup_losses,
               losses, *, lora_rank=0, remat=False, mesh=None) -> Dict:
    b, l = config.batch_size, config.seq_len
    step_time_s = elapsed / config.steps
    flops = lm_train_flops(model, b, l, lora_rank=lora_rank, remat=remat)
    model_flops = lm_train_flops(model, b, l, lora_rank=lora_rank,
                                 causal=not isinstance(model, Bert))
    result = {
        "model": config.model,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "global_batch_size": b,
        "seq_len": l,
        "n_chips": mesh.size if mesh is not None else 1,
        "steps": config.steps,
        "step_time_ms": step_time_s * 1e3,
        "tokens_per_sec": b * l / step_time_s,
        "compile_plus_warmup_s": warmup_s,
        "final_loss": losses[-1],
        "warmup_losses": warmup_losses,
        "losses": losses,
        "flops_per_step": flops,
        "model_flops_per_step": model_flops,
    }
    peak = peak_flops(device)
    if peak is not None:
        result["mfu_pct"] = flops / step_time_s / peak * 100
        result["model_flops_util_pct"] = (model_flops / step_time_s / peak
                                          * 100)
    if config.profile_dir and device.type == "cuda":
        result["profile"] = summarize_lm_trace(config.profile_dir,
                                               elapsed * 1e3)
    return result


def _synthetic_lm_batch(b: int, l: int, vocab: int, objective: str,
                        seed: int, device: torch.device) -> Dict:
    """Random token ids (and, for mlm, random labels and a 15% weight
    mask), drawn on the device from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    batch = {"input_ids": torch.randint(0, vocab, (b, l), generator=gen,
                                        device=device, dtype=torch.int32)}
    if objective == "mlm":
        batch["mlm_labels"] = torch.randint(
            0, vocab, (b, l), generator=gen, device=device,
            dtype=torch.int32)
        batch["mlm_weights"] = (torch.rand(
            (b, l), generator=gen, device=device) < 0.15).float()
    return batch


@dataclasses.dataclass
class LMBenchConfig:
    model: str = "bert-base"
    batch_size: int = 32
    seq_len: int = 512
    steps: int = 10
    warmup_steps: int = 2
    learning_rate: float = 1e-4
    objective: str = "mlm"
    seed: int = 0
    profile_dir: Optional[str] = None  # torch.profiler trace of timed steps
    model_kwargs: Optional[Dict] = None  # e.g. {"num_layers": 4}
    mesh: Optional[MeshSpec] = None  # as BenchConfig's


def run_lm_benchmark(config: LMBenchConfig,
                     device: DeviceLike = None) -> Dict[str, float]:
    """The pretraining step's benchmark: fp32 master params,
    ``adamw(learning_rate)``, step time, tokens/sec and MFU by
    :func:`lm_train_flops`. As the reference, the batch is random ids
    and, for the default mlm objective, random labels and weights (the
    causal objective shifts the ids)."""
    from kubeflow_tpu_torch.training.lm import (
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.training.optim import adamw

    device = resolve_device(device)
    entry = get_model(config.model)
    kwargs = dict(config.model_kwargs or {})
    if entry.decoder:
        kwargs.setdefault("param_dtype", "float32")  # BERT keeps fp32
    model = entry.make(**kwargs)
    mesh = bench_mesh(config.mesh, device)
    state, _ = create_lm_state(model, adamw(config.learning_rate),
                               init_params(model, config.seed, device), mesh)
    batch = _rank_rows(_synthetic_lm_batch(
        config.batch_size, config.seq_len, entry.num_classes_or_vocab,
        config.objective, config.seed, device), mesh)
    _, elapsed, warmup_s, warmup_losses, losses = _timed_lm_steps(
        make_lm_train_step(mesh, objective=config.objective), state, batch,
        config.warmup_steps, config.steps, profile_dir=config.profile_dir)
    return _lm_result(config, model, device, elapsed, warmup_s,
                      warmup_losses, losses,
                      remat=bool(kwargs.get("remat")), mesh=mesh)


@dataclasses.dataclass
class LoRABenchConfig:
    model: str = "llama2-7b"
    lora_rank: int = 16
    batch_size: int = 1
    seq_len: int = 1024
    steps: int = 5
    warmup_steps: int = 1
    learning_rate: float = 1e-4
    seed: int = 0
    data_paths: Optional[tuple] = None  # token shards; None → synthetic
    profile_dir: Optional[str] = None  # torch.profiler trace of timed steps
    mesh: Optional[MeshSpec] = None  # as BenchConfig's


def run_lora_benchmark(config: LoRABenchConfig, device: DeviceLike = None,
                       params: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, float]:
    """The LoRA fine-tune step's benchmark: the base frozen in bf16 (no
    gradient or moment buffers), blocks rematerialised, adapters the
    only train state, ``adamw(learning_rate)``. ``params`` is the base
    to fine-tune (cast to bf16; default: drawn from ``seed``). Reports
    step time, tokens/sec, MFU and the trainable fraction."""
    return fine_tune_lora(config, device, params)[0]


def fine_tune_lora(config: LoRABenchConfig, device: DeviceLike = None,
                   params: Optional[Dict[str, torch.Tensor]] = None):
    """:func:`run_lora_benchmark`'s run: (its result, the trained
    ``LoRAState``), for a caller that goes on to check or merge the
    adapters."""
    from kubeflow_tpu_torch.training.data import (
        DevicePrefetcher,
        synthetic_causal_lm,
        token_shard_batches,
    )
    from kubeflow_tpu_torch.training.finetune import (
        create_lora_state,
        make_lora_train_step,
    )
    from kubeflow_tpu_torch.training.optim import adamw

    device = resolve_device(device)
    entry = get_model(config.model)
    model = entry.make(lora_rank=config.lora_rank, remat=True)
    vocab = entry.num_classes_or_vocab
    b, l = config.batch_size, config.seq_len
    if params is None:
        params = init_params(entry.make(param_dtype="float32"), config.seed,
                             device, dtype=torch.bfloat16)
    mesh = bench_mesh(config.mesh, device)
    state, _ = create_lora_state(model, adamw(config.learning_rate), params,
                                 seed=config.seed, mesh=mesh,
                                 base_dtype=torch.bfloat16)
    batch_iter = None
    try:
        # The sources yield this rank's rows (host_shard_range).
        if config.data_paths:
            batch_iter = DevicePrefetcher(
                token_shard_batches(list(config.data_paths), b, l,
                                    seed=config.seed, mesh=mesh),
                mesh, prefetch=2, device=device)
            batch = next(batch_iter)
        else:
            batch = next(synthetic_causal_lm(b, l, vocab, seed=config.seed,
                                             mesh=mesh))
        state, elapsed, warmup_s, warmup_losses, losses = _timed_lm_steps(
            make_lora_train_step(mesh), state, batch, config.warmup_steps,
            config.steps, batch_iter=batch_iter,
            profile_dir=config.profile_dir)
    finally:
        # An error mid-loop must not leak the prefetch thread.
        if batch_iter is not None:
            batch_iter.close()
    n_base = sum(t.numel() for t in state.base_params.values())
    n_lora = sum(t.numel() for t in state.lora.values())
    result = _lm_result(config, model, device, elapsed, warmup_s,
                        warmup_losses, losses, lora_rank=config.lora_rank,
                        remat=True, mesh=mesh)
    result.update(lora_rank=config.lora_rank, base_params=n_base,
                  trainable_params=n_lora,
                  trainable_pct=round(n_lora / max(n_base, 1) * 100, 4))
    return result, state


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="tpu-cnn")
    parser.add_argument("--model", default="resnet50")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="default: 128 (vision) / 32 (language) / 1 "
                             "(LoRA)")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup_steps", type=int, default=3,
                        help="vision warmup steps")
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--seq_len", type=int, default=512)
    parser.add_argument("--lora_rank", type=int, default=0,
                        help=">0: the LoRA fine-tune benchmark (language "
                             "models only)")
    parser.add_argument("--data", default=None,
                        help="token shards (.npy / raw .bin) for the "
                             "fine-tune path: comma-separated files, dirs, "
                             "or globs; gs://-style fsspec paths download "
                             "into a local cache. Default: synthetic")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: cpu where the env has "
                             "JAX_PLATFORMS=cpu, else cuda)")
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
    from kubeflow_tpu_torch.training.launcher import initialize_distributed
    from kubeflow_tpu_torch.utils.platform import default_device

    args.device = default_device(args.device)

    # A tpu-cnn pod command joins its gang itself (a no-op for one
    # process, and where the launcher's fallthrough joined already).
    initialize_distributed(device=args.device)
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
    if args.learning_rate is not None and entry.family != "vision":
        # Only the vision config reads it: an LM run would report the
        # flag's value beside its fixed adamw rate.
        parser.error(
            f"--learning_rate applies to vision models; {args.model!r} "
            f"is {entry.family}")
    if args.lora_rank > 0 and entry.family != "language":
        parser.error(
            f"--lora_rank requires a language model; {args.model!r} is "
            f"{entry.family}")
    data_paths = None
    if args.data:
        if args.lora_rank <= 0:
            # Only the fine-tune path reads shards: timing synthetic
            # batches as real data is the failure to avoid.
            parser.error("--data requires --lora_rank > 0")
        from kubeflow_tpu_torch.training.data import resolve_shards

        try:
            data_paths = tuple(resolve_shards(args.data))
        except ValueError as e:
            parser.error(str(e))
    if entry.family == "language" and args.lora_rank > 0:
        result = run_lora_benchmark(
            LoRABenchConfig(model=args.model, lora_rank=args.lora_rank,
                            batch_size=args.batch_size or 1,
                            steps=args.steps, seq_len=args.seq_len,
                            data_paths=data_paths,
                            profile_dir=args.profile_dir),
            device=args.device)
    elif entry.family == "language":
        result = run_lm_benchmark(
            LMBenchConfig(model=args.model,
                          batch_size=args.batch_size or 32,
                          steps=args.steps, seq_len=args.seq_len,
                          profile_dir=args.profile_dir),
            device=args.device)
    else:
        result = run_benchmark(
            BenchConfig(model=args.model,
                        batch_size=args.batch_size or 128,
                        steps=args.steps, warmup_steps=args.warmup_steps,
                        image_size=args.image_size,
                        profile_dir=args.profile_dir,
                        learning_rate=args.learning_rate,
                        model_kwargs=({"bn_stat_rows": args.bn_stat_rows}
                                      if args.bn_stat_rows else None)),
            device=args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
