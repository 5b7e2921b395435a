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

"""Drive kubeflow_tpu_torch on one NVIDIA GPU, end to end.

Run from the repository root with no arguments::

    python3 chip_smoke.py

1. Environment: the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions.
2. Build: every ``kubeflow_tpu_torch/csrc/*.cu`` at once, one ``nvcc``
   each, timed.
3. Kernels vs their plain versions on the card, at the main path's
   shapes and three variants; each kernel's time (median of CUDA-event
   timed calls), its plain version's, the one-call PyTorch yardstick
   (``library_ms``, never used by the port) and the card's bound.
4. The slice: ``llama3-8b`` at full width with random weights from seed
   0, served through ``LoadedModel.run``: predict [2, 2048], classify
   [1, 2048], and greedy generate of two left-padded prompts (300 and
   512 tokens, 32 new tokens). Launch counts are zeroed just before and
   read just after; every kernel must have run on that path. The
   predict logits are held against the same forward on the plain
   attention, and a small fp32 model against the CPU.
5. One JSON line of kernel numbers, then the result line.

Any failure ends the run with a nonzero exit and no result line. Needs
one GPU; fails without one.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.inference.generate import generate
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.models.llama import apply, llama_test
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import dense_attention
from kubeflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from kubeflow_tpu_torch.serving.model import LoadedModel
from kubeflow_tpu_torch.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)
from kubeflow_tpu_torch.utils.device import resolve_device

#: Published peaks of one H100 SXM (dense): bf16 tensor cores, fp32
#: outside the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

#: Kernel vs plain version, both on the card. bf16 outputs are rounded
#: to 8 bits of mantissa (a relative step of 2**-8 near 1.0; outputs are
#: averages of N(0, 1) values, below 1), and P is rounded to bf16 in
#: both after fp32 exps that differ in summation order. fp32: the CPU
#: parity tolerance, as both keep fp32 throughout.
KERNEL_TOL = {"bfloat16": 1e-2, "float32": 2e-5}

#: llama3-8b predict logits through the kernel vs through the plain
#: attention: ||Δ|| / ||plain||. Random bf16 weights amplify rounding
#: through 32 layers; two plain attentions (blockwise vs dense) differ
#: by 0.051 on this forward, so twice that floor. A wrong mask or head
#: mapping gives differences of order 1.
LOGITS_REL_RMS_TOL = 0.1

LLAMA = "llama3-8b"
PREDICT_SHAPE = (2, 2048)
CLASSIFY_SHAPE = (1, 2048)
PROMPTS = (300, 512)
NEW_TOKENS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of ``reps`` calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_rms(a, b) -> float:
    return float((a - b).norm() / b.norm())


def attention_bound(q, k, v, mask, causal):
    """Least time (ms) the card could take for one attention call, and
    what bounds it: the multiply-adds this call's mask admits (causal
    and key validity counted from the data), and each input read once
    and the output written once."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    pairs = torch.ones((b, lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        pairs &= torch.ones((lq, lk), dtype=torch.bool,
                            device=q.device).tril()
    if mask is not None:
        pairs &= (mask != 0)[:, None, :]
    flops = 4.0 * d * h * float(pairs.sum())  # QK^T and PV
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
    nbytes += q.numel() * q.element_size()  # the output
    if mask is not None:
        nbytes += mask.numel() * mask.element_size()
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_flash(name, b, l, h, hkv, d, dtype, causal, masked):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, l, h, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, l, hkv, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, l, hkv, d, device="cuda", generator=gen).to(dtype)
    mask = None
    if masked:
        lengths = torch.tensor([[l * 3 // 4], [l]], device="cuda")[:b]
        mask = (torch.arange(l, device="cuda")[None, :] < lengths).to(
            torch.int32)
    run = functools.partial(flash_attention, q, k, v, causal=causal,
                            kv_segment_valid=mask)
    plain = functools.partial(flash_attention_reference, q, k, v,
                              causal=causal, kv_segment_valid=mask)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = float((out.float() - ref.float()).abs().max())
    dt = str(dtype).replace("torch.", "")
    tol = KERNEL_TOL[dt]
    if not torch.isfinite(out).all() or err > tol:
        raise AssertionError(f"flash {name}: max |Δ| {err} > {tol}")
    # The yardstick: one PyTorch call for the same function, on
    # [B, H, L, D] views with the KV heads repeated beforehand.
    rep = h // hkv
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    attn_mask = None if mask is None else (mask != 0)[:, None, None, :]
    library = functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                attn_mask=attn_mask, is_causal=causal)
    bound, bound_by = attention_bound(q, k, v, mask, causal)
    row = {"shape": name, "dtype": dt, "max_abs_err": err, "tol": tol,
           "ms": time_ms(run), "plain_ms": time_ms(plain, reps=20),
           "library_ms": time_ms(library), "bound_ms": bound,
           "bound_by": bound_by}
    log(f"flash {name}: {json.dumps(row)}")
    return row


def llama_metadata(method, seq, kwargs, generate_config=None):
    out = ({"tokens": TensorSpec("int32", (-1, NEW_TOKENS))}
           if method == "generate" else {})
    return ModelMetadata(
        model_name=LLAMA, registry_name=LLAMA, model_kwargs=kwargs,
        signatures={"serving_default": Signature(
            method=method, inputs={"input_ids": TensorSpec("int32",
                                                           (-1, seq))},
            outputs=out)},
        generate_config=generate_config or {})


def small_model_agreement():
    """``llama-test`` in fp32: logits and greedy tokens on the card
    (the fp32 kernel) agree with the CPU (the plain version) — the CPU
    tests' tolerance, 1e-4."""
    model = llama_test(dtype="float32")
    gen_model = llama_test(dtype="float32", cache_size=48)
    cpu = init_params(model, seed=0, device="cpu")
    gpu = {k: v.to("cuda") for k, v in cpu.items()}
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 32)).astype(np.int32))
    a = apply(model, gpu, ids.cuda()).cpu()
    b = apply(model, cpu, ids)
    err = float((a - b).abs().max())
    tok_g, log_g = generate(gen_model, gpu, ids.cuda(), max_new_tokens=8,
                            prompt_lengths=torch.tensor([20, 32]).cuda())
    tok_c, log_c = generate(gen_model, cpu, ids, max_new_tokens=8,
                            prompt_lengths=torch.tensor([20, 32]))
    gen_err = float((log_g.cpu() - log_c).abs().max())
    if err > 1e-4 or gen_err > 1e-4 or not torch.equal(tok_g.cpu(), tok_c):
        raise AssertionError(f"llama-test cuda vs cpu: logits |Δ| {err}, "
                             f"generate |Δ| {gen_err}")
    log(f"llama-test fp32 cuda vs cpu: logits max |Δ| {err}, generate "
        f"logits max |Δ| {gen_err}, tokens equal (tol 1e-4)")


def serve_llama(card):
    entry = get_model(LLAMA)
    t0 = time.monotonic()
    params = init_params(entry.make(dtype="bfloat16"), seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    log(f"{LLAMA}: {n_params} params made on the card in "
        f"{time.monotonic() - t0:.2f} s")
    predict_model = LoadedModel(
        llama_metadata("predict", PREDICT_SHAPE[1], {"dtype": "bfloat16"}),
        1, params, max_batch=2)
    cache_size = max(PROMPTS) + NEW_TOKENS
    gen_model = LoadedModel(
        llama_metadata("generate", max(PROMPTS),
                       {"dtype": "bfloat16", "cache_size": cache_size},
                       {"max_new_tokens": NEW_TOKENS, "temperature": 0.0}),
        1, params, max_batch=2)
    rng = np.random.default_rng(0)
    vocab = entry.num_classes_or_vocab
    x_pred = rng.integers(0, vocab, PREDICT_SHAPE).astype(np.int32)
    x_cls = rng.integers(0, vocab, CLASSIFY_SHAPE).astype(np.int32)
    x_gen = np.zeros((len(PROMPTS), max(PROMPTS)), np.int32)
    for i, n in enumerate(PROMPTS):  # left-padded rows
        x_gen[i, max(PROMPTS) - n:] = rng.integers(0, vocab, n)
    lengths = np.asarray(PROMPTS, np.int32)

    # One untimed pass first: cuBLAS picks its algorithms on first use.
    predict_model.run({"input_ids": x_cls}, method="predict")

    # The main path, with every launch count zeroed just before it.
    flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pred = predict_model.run({"input_ids": x_pred}, method="predict")
    predict_s = time.monotonic() - t0
    after_predict = flash_attention.launches
    cls = predict_model.run({"input_ids": x_cls}, method="classify")
    t0 = time.monotonic()
    gen = gen_model.run({"input_ids": x_gen}, prompt_lengths=lengths)
    generate_s = time.monotonic() - t0
    launches = {"flash_attention": flash_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path launches: {json.dumps(launches)}")

    layers = entry.make().num_layers
    if after_predict < layers:
        raise AssertionError(f"predict launched flash {after_predict} "
                             f"times, fewer than its {layers} layers")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
    logits = pred["logits"]
    if logits.shape != (*PREDICT_SHAPE, vocab) or logits.dtype != np.float32:
        raise AssertionError(f"predict logits {logits.shape} {logits.dtype}")
    if cls["classes"].shape != (*CLASSIFY_SHAPE, 5):
        raise AssertionError(f"classify classes {cls['classes'].shape}")
    if not (np.isfinite(cls["scores"]).all()
            and ((cls["classes"] >= 0) & (cls["classes"] < vocab)).all()):
        raise AssertionError("classify gave non-finite scores or classes "
                             "outside the vocabulary")
    tokens = gen["tokens"]
    if tokens.shape != (len(PROMPTS), NEW_TOKENS) or not (
            (tokens >= 0) & (tokens < vocab)).all():
        raise AssertionError(f"generate tokens {tokens.shape} out of range")

    # Predict logits through the kernel vs the same forward on the
    # plain attention, on the card; beside it, the bf16 noise floor: the
    # same forward on the two plain attentions (blockwise vs dense).
    kernel_logits = torch.from_numpy(logits).cuda()
    if not torch.isfinite(kernel_logits).all():
        raise AssertionError("predict logits are not finite")
    ids = torch.from_numpy(x_pred).cuda()

    def forward_with(attention):
        model = entry.make(dtype="bfloat16", attention_fn=functools.partial(
            attention, causal=True))
        with torch.inference_mode():
            return apply(model, params, ids)

    plain_logits = forward_with(flash_attention_reference)
    err = rel_rms(kernel_logits, plain_logits)
    floor = rel_rms(forward_with(dense_attention), plain_logits)
    log(f"predict logits, kernel vs plain attention: relative RMS {err} "
        f"(tol {LOGITS_REL_RMS_TOL}), max |Δ| "
        f"{float((kernel_logits - plain_logits).abs().max())}; plain vs "
        f"dense attention (the bf16 floor): relative RMS {floor}")
    if err > LOGITS_REL_RMS_TOL:
        raise AssertionError(f"predict logits differ: relative RMS {err} > "
                             f"{LOGITS_REL_RMS_TOL}")
    del kernel_logits, plain_logits, pred

    # Timings after the counted run: forward on the card, prefill and
    # decode split.
    with torch.inference_mode():
        forward_ms = time_ms(
            lambda: apply(predict_model._module, params, ids), reps=5,
            warmup=1)
    gen_ids = torch.from_numpy(x_gen).cuda()
    gen_lengths = torch.from_numpy(lengths).cuda()

    def prefill():
        generate(gen_model._module, params, gen_ids, max_new_tokens=1,
                 prompt_lengths=gen_lengths)

    prefill_ms = time_ms(prefill, reps=5, warmup=1)
    t0 = time.monotonic()
    generate(gen_model._module, params, gen_ids, max_new_tokens=NEW_TOKENS,
             prompt_lengths=gen_lengths)
    torch.cuda.synchronize()
    generate_ms = (time.monotonic() - t0) * 1e3
    decode_ms = (generate_ms - prefill_ms) / (NEW_TOKENS - 1)
    tokens_predict = PREDICT_SHAPE[0] * PREDICT_SHAPE[1]
    metrics = {
        "card": card,
        "predict_request_s": predict_s,
        "predict_request_tokens_per_s": tokens_predict / predict_s,
        "predict_forward_ms": forward_ms,
        "predict_forward_tokens_per_s": tokens_predict / forward_ms * 1e3,
        "generate_request_s": generate_s,
        "prefill_ms": prefill_ms,
        "decode_ms_per_token": decode_ms,
        "peak_memory_gb": peak_gb,
        "logits_vs_plain_rel_rms": err,
        "plain_vs_dense_rel_rms": floor,
    }
    log(f"{LLAMA} serving: {json.dumps(metrics)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on a GPU", file=sys.stderr)
        return 1

    resolve_device()  # TF32 off for the fp32 head and the fp32 checks
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.monotonic()
    reports = _build.build_all()
    log(f"built {sorted(reports)} in {time.monotonic() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    bf16, fp32 = torch.bfloat16, torch.float32
    shapes = [
        # (a) the slice's shape: classify's [1, 2048], llama3-8b heads.
        ("a: B1 L2048 H32/8 D128 causal", 1, 2048, 32, 8, 128, bf16, True,
         False),
        # predict's batch on the main path.
        ("a2: B2 L2048 H32/8 D128 causal", 2, 2048, 32, 8, 128, bf16,
         True, False),
        ("b: B2 L1000 H32/8 D128 causal", 2, 1000, 32, 8, 128, bf16, True,
         False),
        ("c: B2 L512 H12 D64 key mask", 2, 512, 12, 12, 64, bf16, False,
         True),
        ("d: B2 L256 H8/2 D64 causal fp32", 2, 256, 8, 2, 64, fp32, True,
         False),
    ]
    rows = [check_flash(*s) for s in shapes]
    small_model_agreement()
    launches = serve_llama(card)

    main_row = rows[0]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:83",
        "launches": launches["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
