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

``--bn_only`` builds the kernels and runs phase 5 alone, with no result
line; copied into another checkout's root and run there, it times that
checkout's BN kernel by the same code (a parent commit's, say).

1. Environment: the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions.
2. Build: every ``kubeflow_tpu_torch/csrc/*.cu`` at once, one ``nvcc``
   each, timed, with the compiler's registers and spills per kernel;
   ``launch_plan``'s shared memory held to the library's own figure for
   every flash instantiation.
3. Flash attention vs its plain version on the card, at the Llama
   path's shapes, a long sequence, three variants and ViT-B/16's and
   BERT-base's training shapes (rows f and g), and the same bits
   on a second call; each kernel's time (CUDA events around 20
   back-to-back calls, median of 7 such runs; ``ms_one_call``: one call
   per event pair, median of 30, which adds the wrapper's host work; and
   the profiler's kernel time, ``device_ms``), its plain
   version's, the one-call PyTorch yardstick (``library_ms``, never
   used by the port, timed as the kernel), the card's bound, the share
   of it reached and the instantiation's registers and spills. Then
   the flash gradient: dq, dk and dv through the kernel's
   ``autograd.Function`` against the plain version's, bf16 and fp32,
   causal and key-masked.
3b. The decode step's kernels (decode GEMM at each llama3-8b decode
   product, RMSNorm's two entries at [M, 4096], decode attention over a
   544-slot cache) against their plain twins at M = 1 and 4: one step of
   the output type, the same bits on a second call, and every row at M
   in (2, 3, 4, 8, 16, 20, 32) equal to the row computed alone (20: a
   speculative verify's 4 slots × 5 tokens); RMSNorm also at M = 20,
   512 and 8192 (L2-cold) and [4, 4096] fp32, its rows equal in 20-row
   blocks, the fused entry's sum equal to torch's add and its norm to
   the plain entry's, bit for bit; times as the flash
   kernel's (weights and caches cycled through copies larger than L2,
   as a decode step reads them), the profiler's device time, the bound,
   and the PyTorch call computing the same function (``F.linear``,
   ``F.rms_norm``, ``scaled_dot_product_attention`` with the mask and
   ``enable_gqa``); decode attention also at llama3-8b's full context,
   B1 S8192. Then a prefill's attention over the cache
   (``prefill_attention``: one flash launch for the block, causal at its
   offset) on generate's left-padded [2, 512] block over 544 slots, an
   engine chunk of 64 at offset 448, a [1, 2048] and a [1, 8192] prompt:
   within 1e-2 of ``dense_attention(causal=True, q_offset=...)``, the
   same bits on a second call, one launch a call, a chunk's rows (the
   chunk at 448; the last 64 rows of each other block at their offset)
   equal to the one-shot block's; timed beside the earlier route (each
   query a row of the decode attention kernel, written out here; not at
   8,192, where it takes about 115 ms a call), the plain version, SDPA
   with the same mask and the bound.
   Then the decode GEMM's fp32 route at the lm_head's shape,
   M = 1, 4, 16, 20, 32 and 40: within 1e-5·max(1, |y|) of its plain
   version, the same bits twice, every row equal to itself alone, one
   pass over W up to 32 rows; its device ms in turns with its earlier
   design (built from ``scripts/earlier/decode_gemm_fp32_row_tiles.cu``
   as ``scripts/gemm_ab.py`` builds earlier designs) and ``F.linear``,
   beside the bound.
3c. The prefill GEMM at each llama3-8b prefill product, M = 512,
   against its plain version (``F.linear``) to one bf16 step, the same
   bits on a second call, and the rows of blocks of M = 1, 2, 20, 128,
   140, 256 and 512 rows equal to the same rows of the 512-row block;
   the 1024-row block of generate's [2, 512] prefill the same way (one
   bf16 step, the same bits twice, each 512-row half equal to the half
   alone); timed
   as the decode kernels, summed over one prefill forward's 224
   launches.
4. The Llama slice: ``llama3-8b`` at full width with random weights
   from seed 0, served through ``LoadedModel.run``: predict [2, 2048],
   classify [1, 2048], and greedy generate of two left-padded prompts
   (300 and 512 tokens, 32 new tokens). The predict logits are held
   against the same forward on the plain attention, and a small fp32
   model against the CPU; ``llama-test`` goes through the port's
   ``export_model`` and back through ``load_version`` to bit-equal
   predict logits. On the same ``llama3-8b`` params, ``:generate``
   through the continuous-batching engine (4 slots, pages of 16,
   4-token slices): six requests at once (prompts 300, 512, 77, 410,
   200, 512; budgets 32, 8, 32, 16, 32, 24), greedy and sampled
   (temperature 0.7, top-k 40, top-p 0.9, keys ``PRNGKey(100 + i)``).
   Every stream equals B=1 ``generate``'s, token for token, and the
   pool ends clean; requests 1 and 3 through a 1-slot engine too;
   every admission's prefill launches the prefill GEMM 224 times,
   flash 32 (its attention over the cache, one launch a layer) and the
   decode GEMM once (its fp32 head at the position read). Then
   a sampled ``LoadedModel.run`` of two left-padded rows with their own
   keys, each row equal to B=1. Time to first token, inter-token ms,
   tokens/s, slices and peak memory are printed. Each generate decode
   step and each engine decode step must launch the decode GEMM 225
   times and decode attention 32 times (RMSNorm 65, 64 of them the
   fused entry, which takes the residual add before the norm: every
   forward 1 plain and 2·layers fused, asserted), generate's prefill
   the prefill GEMM 224 times and flash 32 times (one a layer for its
   [2, 512] block), and no CUDA tensor may reach a plain
   twin. Then the prefix lane (``engine_prefix_cache``, 4 slots, the
   same cache): 8 requests sharing a 360-token prefix, one cold, then 7
   at once, greedy and sampled: 7 hits and 1 miss, a clean pool, TTFTs,
   each hit stream equal to its own cold run and every stream equal to
   B=1 ``generate`` (asserted). Then speculative decoding on the engine
   mix (k = 4), greedy and sampled, with the strong draft (llama3-8b
   itself, its own dense cache) and a weak one (one layer at llama3-8b's
   widths from seed 9): every stream equal to the vanilla engine's and
   B=1's, the strong draft's acceptance above 0.5, rounds run, a clean
   pool (asserted); acceptance, verifier forwards per token, inter-token
   ms and tokens/s beside the vanilla engine's. Then chunked prefill
   (chunk 64) with speculation on the prefix mix plus a 512-token prompt
   admitted while the others decode, greedy and sampled: every stream
   equal to the same engine's without chunking and to B=1 (asserted);
   the decoding neighbours' largest inter-token gap while the long
   prompt is admitted, chunked against one-shot. Then the four mixes on
   a captured engine (every plain slice, speculative draft and verify
   and classic admission prefill a CUDA graph), greedy and sampled
   (captured, captured again, and in the engine mix uncaptured): every
   captured stream equal to the B=1 streams the mixes' phases held
   their uncaptured engines to, one graph per ``engine_compile`` key of a captured
   program, no decode attention launched by a wrapper in the replayed
   pass and, in the engine mix, no wrapper launch at all, and no plain
   twin called (asserted); inter-token ms of both, the graphs against
   the distinct keys, the device idle share and each kernel's launches
   of the replayed pass and of one 4-step slice replayed alone, and a
   classic admission's device ms beside its TTFT on both engines
   (reported; the slice's 260 norm kernels, 256 of them fused, and no
   bf16 add kernel, asserted). Every engine phase that counts launches runs the engine
   a server builds (captured) and counts what the card ran
   (``served_launches``): the wrappers' launches, less each graph's
   capture (which records its warm-up's launches, asserted equal), plus
   each replay's graph. Then one verify forward
   (4 slots × 5 tokens) beside one decode step: 225 decode-GEMM
   launches at M = 20, 65 RMSNorm, 160 decode attention, no prefill GEMM
   and no plain twin (asserted), and the device ms of each. Then one
   decode step's kernel launches through the decode kernels and through
   the plain ops. Then the engine's last lanes, greedy and sampled: KV
   handoff (the engine mix through ``run_prefill``, the blob through
   ``serving/wire.py`` both ways, ``submit(handoff=)`` on a second
   engine; and the prefix mix on a prefill-role engine, chunks of 64,
   adopted by a decode-role engine): every adopted stream equal to the
   local one and B=1, the decode engine's index holding the carried
   prefix, the prefill-role engine's hits, each prefill forward's 224 +
   32 + 1 launches and none in an adoption (asserted; blob bytes, encode,
   decode and adopt ms printed). Mid-stream resume in both lanes: three
   engine-mix requests killed after 1 token, the middle and budget - 1,
   continued on a peer engine from a resume
   token that carries the original prompt, with the emitted tokens
   apart (``submit(prompt_len=)``): resumed == uninterrupted in 9 of 9
   cases a lane and mode, and each resume's one prompt prefill forward
   and one replay forward on the decode kernels (asserted); TTFTs
   printed. The host tier
   (one slot, 34 usable pages, 256 MB of host RAM; fillers between
   prefix-mix requests evict the prefix): spilled and re-adopted blocks,
   each hit equal to its cold run and B=1, both tiers drained (asserted;
   ms a spilled and a re-adopted block printed). Fleet blocks: engine
   A's export of the 22 shared blocks through the wire into engine B's
   host tier, B's hit equal to its cold run and B=1, B's pages of them
   byte-equal to A's (asserted). Then the serving plane on the same
   params (``serve_manager``): ``ServedModel`` / ``ModelManager`` as a
   server runs them, greedy and sampled, two continuous-batching models
   sharing the params, loaded through the version poll with the bucket
   and engine warmups (captured engines): the engine mix's six prompts
   through ``submit`` at once, each equal to B=1 ``generate`` with the
   request's key, and no graph captured after the load; ``submit_stream``
   with the mix's budgets, each the unary row's prefix; ``prefill_handoff``
   → the wire → ``submit_handoff`` on the peer, equal to the local rows;
   ``submit_resume`` after kills at 1, the middle and budget - 1, then a
   second death one token into each resumed stream (its token carrying
   ``prompt_len``) resumed on the first model, every case equal to the
   uninterrupted stream; the engine phases' launch formulas and no plain
   twin (asserted); then the micro-batcher: four [1, 512] predict and
   classify requests at once in fewer executions, each row within 3e-2
   relative RMS of the request alone, 32 flash launches an execution,
   and four mixed-length static generates at once, one execution a
   prompt bucket, each equal to the request alone (asserted); the REST
   and SSE server on a
   loopback port where tornado imports (said so where it does not); the
   load path itself on a ``llama-test`` export (add_model → the poll →
   ``load_version`` → the warmups; which queue served). Load seconds,
   TTFT and inter-token ms, a manager pass's idle share, ``batch_stats()``
   and the ``kft_serving_*`` exposition are printed. Then LM training
   (``train_lm``), once the serving phases' engines and caches are gone,
   each part through an entry point, its counts zeroed just before it
   and read just after. (1) LoRA fine-tuning of ``llama3-8b`` at full
   width and depth through ``run_lora_benchmark``'s run
   (``fine_tune_lora``: rank 16, α 16, rematerialised blocks, b1 ×
   L1024, ``adamw(1e-4)``, adapters from seed 0, one warmup and 10 timed
   steps on its fixed batch) on the served params, which it casts to
   bf16 (``cast_floating``, the head too): 13,631,488 trainable params;
   step 0's loss equal to the base model's bit for bit (B is zero); each
   step 64 flash launches (forward and the remat recompute), 129
   RMSNorm, 32 flash and 64 RMSNorm gradients recomputed through their
   plain versions and no plain twin in a forward; every base tensor
   bit-identical to a host copy, with no ``.grad``, after the run; the
   loss lower at step 10 than at step 0; peak memory under 80 GB
   (asserted); step ms, tokens/s, hardware- and model-FLOPs utilisation
   by ``lm_train_flops`` and a profiled step's device split and idle
   share (reported). The adapters merged into the served params
   (``merge_lora``) and served: every merged weight W + (A·B·α/r)ᵀ
   rounded to bf16 once and ``LoadedModel.run`` predict at [1, 1024]
   equal to the merged weights applied on the same route, bit for bit;
   within 0.1 relative RMS of the adapter forward (the bound of two bf16
   routes of one function) and closer to it than the unmerged base; 32
   flash launches and a 16-token greedy generate (asserted; the floor
   between the adapter forward on flash and on dense attention beside
   it). (2) The LoRA benchmark's CLI (``training.benchmark --model
   llama3-8b --lora_rank 16 --seq_len 1024 --data``) on a token shard:
   its own base drawn and cast to bf16, the batches put on the card by
   the prefetch thread; 13,631,488 trainable params, finite losses, the
   launches of its 3 steps by the formula (asserted). (3) The
   pretraining step through the tpu-lm CLI (``training.pretrain --model
   llama3-8b --num_layers 4``, ``fit`` and its optimizer:
   ``clip_by_global_norm(1.0)``, ``adamw(warmup_cosine(0, 1e-4, 2, 10),
   weight_decay=0.01)``), fp32 masters, b1 × L2048 on a token shard of
   one repeated sequence (depth cut: at 32 layers its fp32 state takes
   ~129 GB): the first update changes nothing (its rate is 0: step 2's
   loss equals step 1's bit for bit), 4 flash and 9 RMSNorm launches a
   step, the loss falls over 10 steps, peak under 80 GB (asserted);
   step ms, tokens/s, utilisation (reported). The params are freed
   before the next phases.
5. The BN forward kernel: its launch plan at every ResNet-50 b256 BN
   shape from the card's own limits (the smallest layers must take the
   on-chip route), then the kernel vs its plain version at each of the
   12 distinct shapes (read off the model), exact and with
   ``bn_stat_rows=32``, and one ragged fp32 case; timed as the flash
   kernel in 3 (the yardstick is ``F.batch_norm``), against the
   one-read bound (x read once, y written once) with the two-read
   figure beside it, and summed over the 53 layers of a step.
6. ``resnet-test`` fp32: one train step on the card (the kernel)
   against the CPU (the plain version).
7. The ResNet slice: ``run_benchmark`` trains ``resnet50`` at 224², b256,
   bf16, SGD-Nesterov, twice: the ``bench.py`` headline
   (``bn_stat_rows=32``, 3 warmup + 20 timed steps) and the CLI default
   (exact BN, 1 + 5). The first step's logits through the kernel are
   held against the plain BN, beside the bf16 floor.
7b. The rest of the registry, each path's launches counted. BERT
   (``train_bert``): the training loop's drain agreement on an nccl
   group of one; the tpu-lm CLI at its defaults (bert-base, mlm) as the
   pod command under ``launcher.launch`` with a one-process operator
   env, 10 steps on a token shard (the loss falls); bert-base at full
   width and depth, b32 × L128 with padded rows: the first step's
   logits through the flash kernel within twice the bf16 floor of the
   plain attention, 12 flash launches a forward, 10 mlm steps on the
   fixed batch through the tpu-lm step (12 flash launches and 12 plain
   gradient recomputes a step, the loss falls, peak < 80 GB), a profiled
   step's split; one bert-large forward (24 launches) against the plain
   attention. Vision (``train_vision``): ``run_benchmark`` (tpu-cnn) for
   vit-b16 b64, inception-v3 b128, vgg16 b64 and alexnet b128 on a fixed
   batch (12 flash launches a ViT forward, 94 BN an Inception forward,
   the loss lower at the last step, peak < 80 GB; images/s and a
   profiled run's split); the BN kernel at Inception-v3's 18 BN shapes
   (ε = 1e-3) and one fp32 shape as in 5; the first step's logits of
   ViT and Inception through the kernels against the plain twins within
   twice their floors. Served vision (``serve_vision``): port exports of
   vit-b16 and inception-v3 (with ``batch_stats``) through
   ``load_version``, ``predict`` and ``classify`` bitwise equal to the
   module applied. MoE (``train_moe``): tpu-lm steps of llama-moe-bench
   and its dense twin at b8 × L1024 (4 flash a step, the loss falls,
   the aux loss in the MoE's metrics), their tokens/s side by side;
   llama-moe-bench served: a predict, a B = 1 greedy generate, and the
   engine's four-slot streams against B = 1 (reported).
8. The measuring entry points (``measure_phases``; alone:
   ``python3 scripts/measure_phase.py``). The decode sweep
   (``inference.benchmark.run_decode_batch_sweep``) on llama3-8b, every
   weight bf16, prompt 128, 128 new tokens, B = 1, 4, 8: each row's
   tokens/s, ms a token beside the weights' bound, prefill ms and weight
   GB/s printed; its launches by the formulas (4 prefill forwards and
   254 decode steps a batch size), ``param_bytes`` = 2 × 8,030,261,248
   and every rate under the card's 3,350 GB/s (asserted). The engine
   legs of ``serving/benchmark.py`` at llama3-8b bf16 and their default
   shapes (prefix, tiered prefix, speculative): every bitwise verdict
   and every kernel launched (asserted), hit rates, the TTFT ratio,
   acceptance and verifier forwards a token printed. The export-backed
   legs at the reference's models: continuous batching (llama-test),
   gRPC serving (inception-v3, 299²), mixed load and overload
   (resnet-test; 2 s an offered-load phase): verdicts and completion
   counts asserted, latencies
   printed; the REST leg only where tornado imports. ``kft-export`` of
   a llama-test checkpoint written there, loaded on the card: params
   bit-equal and greedy tokens equal to the module's (asserted). Each
   leg's peak memory and the phase's wall time are printed.
9. The gang (``gang_lm`` after the LM training, ``gang_vision`` after the
   ResNet runs; alone: ``python3 scripts/gang_phase.py``), in a one-rank
   nccl group: llama3-8b LoRA for two steps through
   ``DevicePrefetcher(mesh)`` and ``make_lora_train_step(mesh)`` on
   ``data=-1`` and on ``fsdp=-1``, loss, grad norm, adapters and moments
   bitwise the unmeshed steps', with nccl all-reduces issued; the first
   mesh's adapter state saved by two checkpointers (host ids 0 and 1)
   and restored into one host bitwise; ``kft-export --shards tensor=2``
   of llama3-8b at full width cut to two blocks beside the monolithic
   export, its plan checked and its greedy tokens served equal; one
   ResNet-50 b256 exact-BN step meshed (53 stats and 53 apply launches,
   no fused one; loss and running statistics bitwise, grad norm and
   params within 2**-7) against the unmeshed step; the BN sync route
   (stats, the all-reduce, apply) against its twins and bit for bit
   against the fused launch at [802816, 256] bf16 and at each ResNet-50
   BN shape, with its times beside the fused launch's, the library's
   and the bounds (asserted: all of it but the times). After the Llama
   slice, the seq and pipeline axes (``gang_axes``; alone: ``python3
   scripts/axes_gang.py``): flash at a Ulysses rank's and a pipeline
   stage's shapes, then two gloo ranks sharing the card run ring and
   Ulysses attention at llama3-8b's and BERT-base's shapes (with
   gradients), a 4-block llama3-8b forward with the ring, and GPipe and
   interleaved steps of the depth-4 pretraining cell, each held against
   the one-process run made first (asserted; times reported). Then the
   expert axis and BERT's tensor axis (``gang_expert``; alone:
   ``python3 scripts/expert_gang.py``): flash at an MoE block's and a
   BERT tensor rank's shapes, then two gloo ranks sharing the card take
   two tpu-lm steps of llama-moe-bench at its full config on
   ``expert=2`` and on ``data=2`` and of bert-base mlm on ``tensor=2``,
   each held against the one-process steps made first (metrics, every
   updated leaf and its update, each rank's own experts or heads, the
   launches; asserted), with the MoE layer's device ms beside the dense
   twin's MLP (reported).
10. One JSON line of kernel numbers, then the result line.

Each path's launch counts are zeroed just before it and read just
after; every kernel must have run on its path. The kernels line lists
the decode kernels' figures summed over one llama3-8b decode step at
4 slots, and the prefill GEMM's over one prefill forward at M = 512.
Any failure ends the run
with a nonzero exit and no result line. Needs one GPU; fails without
one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import json
import logging
import math
import os
import pickle
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from kubeflow_tpu_torch.inference.engine import engine as engine_module
from kubeflow_tpu_torch.inference.generate import _sample_logits, generate
from kubeflow_tpu_torch.models.inception import InceptionV3
from kubeflow_tpu_torch.models.vit import ViT
from kubeflow_tpu_torch.models.convert import (
    flax_key,
    init_params,
    init_vision,
    params_to_flax,
    unflatten_tree,
)
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.models.layers import apply as apply_vision
from kubeflow_tpu_torch.models.llama import LayerCache, apply, llama_test
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.ops import _build, bn_fused
from kubeflow_tpu_torch.ops import decode_attention as da
from kubeflow_tpu_torch.ops import decode_gemm as dg
from kubeflow_tpu_torch.ops import prefill_gemm as pg
from kubeflow_tpu_torch.ops import rms_norm as rn
from kubeflow_tpu_torch.ops.attention import dense_attention
from kubeflow_tpu_torch.ops.batch_norm import GhostBatchNorm
from kubeflow_tpu_torch.ops.bn_fused import (
    bn_apply,
    bn_stats,
    fused_bn_train_forward,
    reference_bn_apply,
    reference_bn_stats,
    reference_bn_train_forward,
)
from kubeflow_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    flash_attention,
    flash_attention_reference,
    kernel_smem_bytes,
    launch_plan,
    prefill_attention,
)
from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.obs.tracing import TRACER
from kubeflow_tpu_torch.serving.export import (
    export_model,
    read_metadata,
)
from kubeflow_tpu_torch.serving import benchmark as serving_bench
from kubeflow_tpu_torch.serving import export_cli
from kubeflow_tpu_torch.inference.benchmark import (
    DecodeBenchConfig,
    run_decode_batch_sweep,
)
from kubeflow_tpu_torch.training.checkpoint import (
    CheckpointConfig,
    Checkpointer,
    ContinuousCheckpointConfig,
    ShardedCheckpointer,
)
from kubeflow_tpu_torch.serving import sharding, wire
from kubeflow_tpu_torch.serving.manager import ModelManager, ServedModel
from kubeflow_tpu_torch.serving.model import LoadedModel, load_version
from kubeflow_tpu_torch.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)
from kubeflow_tpu_torch.ops.lora import merge_lora
from kubeflow_tpu_torch.training.benchmark import (
    BenchConfig,
    LoRABenchConfig,
    fine_tune_lora,
    lm_train_flops,
    run_benchmark,
    summarize_lm_trace,
    synthetic_batch,
)
from kubeflow_tpu_torch.training.benchmark import main as benchmark_main
from kubeflow_tpu_torch.training import launcher
from kubeflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from kubeflow_tpu_torch.training.data import (
    DevicePrefetcher,
    host_shard_range,
    place_batch,
    synthetic_causal_lm,
)
from kubeflow_tpu_torch.training.finetune import (
    create_lora_state,
    make_lora_train_step,
)
from kubeflow_tpu_torch.training.lm import (
    causal_lm_loss,
    create_lm_state,
    lm_forward_with_aux,
    make_lm_train_step,
)
from kubeflow_tpu_torch.training.loop import agree_on_drain
from kubeflow_tpu_torch.training import optim
from kubeflow_tpu_torch.training.optim import adamw
from kubeflow_tpu_torch.training.pretrain import main as pretrain_main
from kubeflow_tpu_torch.training.train import (
    create_train_state,
    make_train_step,
    place_state,
    sgd,
)
from kubeflow_tpu_torch.utils.device import resolve_device
from kubeflow_tpu_torch.utils.trees import cast_floating

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

#: BN kernel vs plain version, both on the card. Statistics: fp32 sums
#: of up to 3.2 M values of variance ~4 in another order (hierarchical
#: partials vs PyTorch's reduction), so a few 1e-6; 1e-4 absolute. y: the
#: two agree on mean and mul to an fp32 ulp or so and then round op by
#: op alike, so an output can differ by one step of its type: 2**-7 of
#: max(1, |y|) in bf16, 1e-5 of it in fp32.
BN_STAT_TOL = 1e-4
BN_Y_REL_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}

#: resnet-test fp32, one train step on the card vs the CPU: the CPU
#: tests' tolerance for the trainer.
TRAIN_TOL = 1e-4

#: ResNet-50's BN layers: one per conv (the stem, three per bottleneck
#: block, one per projection shortcut).
RESNET50_BN_LAYERS = 53
RESNET_BATCH = 256
#: (name, batch, warmup, timed steps, bn_stat_rows): the bench.py
#: headline and the benchmark CLI's default.
RESNET_RUNS = (("b256 bn_stat_rows=32", RESNET_BATCH, 3, 20, 32),
               ("b256 exact BN", RESNET_BATCH, 1, 5, 0))

ROOT = os.path.dirname(os.path.abspath(__file__))

LLAMA = "llama3-8b"
PREDICT_SHAPE = (2, 2048)
CLASSIFY_SHAPE = (1, 2048)
PROMPTS = (300, 512)
NEW_TOKENS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 3, calls: int = 1) -> float:
    """Median over ``reps`` runs of ``calls`` back-to-back calls, each
    run timed with CUDA events and divided by ``calls``. With many calls
    the host's launch work overlaps the device's, so a kernel's time is
    its device time; one call also counts the host's work before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


#: Kernel and yardstick timings: 7 runs of 20 calls, so the wrapper's
#: host work (about 0.03 ms a call for flash) overlaps the device's.
KERNEL_TIMING = {"reps": 7, "calls": 20}


#: The profiled figures that CUDA events had to stand in for: one entry
#: a call whose three traces held no device time.
PROFILER_FALLBACKS = []


def profiled_ms(fn, calls: int = 20) -> float:
    """Device time per call from the profiler's kernel records (CUPTI):
    the kernels that ``calls`` calls of fn launch, summed, over calls.
    Unlike the event-timed runs it holds no host work and no gap between
    kernels, so it stays the device's where a call's host work outlasts
    its kernels."""
    fn()
    torch.cuda.synchronize()
    # A trace of calls that launch kernels but holds no device time lost
    # its records (CUPTI): it is taken again, three times at most. On
    # some machines CUPTI stops recording a process's kernels for good
    # (the traces of a call that had one minutes before come back empty);
    # then ``calls`` back-to-back calls between CUDA events stand in, the
    # host's launch work overlapping the device's, and the call is listed
    # in PROFILER_FALLBACKS and logged.
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = sum(e.self_device_time_total for e in events)
        if total > 0:
            return total / calls / 1e3
    ms = time_ms(fn, reps=KERNEL_TIMING["reps"], calls=calls)
    name = getattr(fn, "func", fn)
    name = getattr(name, "__qualname__", repr(name))
    PROFILER_FALLBACKS.append(name)
    log(f"profiler: three traces of {name} held no device time ({len(events)} "
        f"event kinds in the last); CUDA events instead: {ms} ms a call")
    return ms


def compiler_report(report: str) -> dict:
    """``{kernel entry: {"registers", "spill_stores", "spill_loads"}}``
    from ``nvcc -Xptxas -v``'s report (registers at launch: a kernel
    that raises its own with ``setmaxnreg`` runs with more)."""
    kernels, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
        elif name and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[name].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels[name]["registers"] = int(m.group(1))
    return kernels


def flash_instantiation(kernels: dict, dtype, d: int) -> dict:
    """The report's entry for the kernel that takes (dtype, head_dim)."""
    key = (f"flash_fwd_kernel_wgmmaILi{d}E" if dtype == torch.bfloat16
           else "flash_fwd_kernel_fma")
    found = [v for k, v in kernels.items() if key in k]
    if len(found) != 1:
        raise AssertionError(f"compiler report: {len(found)} entries for "
                             f"{key}")
    return found[0]


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


def check_flash(kernels, name, b, l, h, hkv, d, dtype, causal, masked):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, l, h, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, l, hkv, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, l, hkv, d, device="cuda", generator=gen).to(dtype)
    mask = None
    if masked:
        # Every other row padded to three quarters of its length.
        lengths = torch.tensor([[l * 3 // 4 if i % 2 == 0 else l]
                                for i in range(b)], device="cuda")
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
    if not torch.equal(run(), out):
        raise AssertionError(f"flash {name}: a second call gave other bits")
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
    ms = time_ms(run, **KERNEL_TIMING)
    row = {"shape": name, "dtype": dt, "max_abs_err": err, "tol": tol,
           "ms": ms, "ms_one_call": time_ms(run),
           # The profiler's kernel time: where a call's host work (the
           # wrapper's checks, a mask's cast) outlasts its kernel, the
           # 20-call time is the host's.
           "device_ms": profiled_ms(run),
           "plain_ms": time_ms(plain, reps=20),
           "library_ms": time_ms(library, **KERNEL_TIMING),
           "library_device_ms": profiled_ms(library),
           "bound_ms": bound, "bound_by": bound_by,
           "bound_share": bound / ms,
           **flash_instantiation(kernels, dtype, d)}
    log(f"flash {name}: {json.dumps(row)}")
    return row


def flash_gradient_rows():
    """dq, dk and dv through the kernel's autograd.Function against the
    plain version's autograd, bf16 and fp32, causal and key-masked. Both
    backwards recompute through the plain version, so they agree to
    flash's gradient tolerance (5e-4) or better."""
    rows = []
    for name, b, l, h, hkv, d, dtype, causal in (
            ("B1 L512 H32/8 D128 causal bf16", 1, 512, 32, 8, 128,
             torch.bfloat16, True),
            ("B2 L256 H12 D64 key mask bf16", 2, 256, 12, 12, 64,
             torch.bfloat16, False),
            ("B2 L256 H8/2 D64 causal fp32", 2, 256, 8, 2, 64,
             torch.float32, True),
            ("B2 L256 H8 D64 key mask fp32", 2, 256, 8, 8, 64,
             torch.float32, False)):
        gen = torch.Generator(device="cuda").manual_seed(7)
        qkv = [torch.randn(b, l, n, d, device="cuda", generator=gen).to(dtype)
               for n in (h, hkv, hkv)]
        mask = None if causal else (torch.arange(l, device="cuda")[None, :]
                                    < torch.tensor([[l * 3 // 4], [l]],
                                                   device="cuda")[:b]).int()
        gout = torch.randn(b, l, h, d, device="cuda", generator=gen)
        grads = []
        for fn in (flash_attention, flash_attention_reference):
            leaves = [t.clone().requires_grad_(True) for t in qkv]
            out = fn(*leaves, causal=causal, kv_segment_valid=mask)
            (out.float() * gout).sum().backward()
            grads.append([t.grad.float() for t in leaves])
        errs = [float((g - r).abs().max()) for g, r in zip(*grads)]
        row = {"shape": name, "max_abs_err_dq_dk_dv": errs, "tol": 5e-4}
        log(f"flash gradient {name}: {json.dumps(row)}")
        if max(errs) > 5e-4:
            raise AssertionError(f"flash gradient {name}: {errs}")
        rows.append(row)
    return rows


#: The decode step's kernels hold against their plain twins to one step
#: of the output type: 2**-7 of max(1, |y|) in bf16 (fp32 sums in
#: another order, then one rounding), 1e-5 of it in fp32; attention to
#: flash's tolerances (1e-2 bf16, 2e-5 fp32).
DECODE_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
#: Row counts whose every row must equal that row computed alone.
INVARIANCE_ROWS = (2, 3, 4, 8, 16, 20, 32)
#: Rows the row-count checks' inputs hold: the largest of INVARIANCE_ROWS.
CHECK_ROWS = max(INVARIANCE_ROWS)
#: llama3-8b's decode-step products: (name, K, N, dtype, launches a
#: step). 7 a layer over 32 layers, and the fp32 head.
DECODE_GEMMS = (
    ("q_proj/o_proj [4096→4096] bf16", 4096, 4096, torch.bfloat16, 64),
    ("k_proj/v_proj [4096→1024] bf16", 4096, 1024, torch.bfloat16, 64),
    ("gate_proj/up_proj [4096→14336] bf16", 4096, 14336, torch.bfloat16, 64),
    ("down_proj [14336→4096] bf16", 14336, 4096, torch.bfloat16, 32),
    ("lm_head [4096→128256] fp32", 4096, 128256, torch.float32, 1),
)
#: The decode rows' cache positions in the engine mix's shapes.
DECODE_POSITIONS = (300, 511, 77, 410)


def cold_cycle(tensors, at_least=256 << 20):
    """Copies of ``tensors`` (a tuple) enough to exceed the 50 MB L2
    several times over, handed out in turn: a decode step reads each
    layer's weights (and each layer's cache) once, from device memory."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, -(-at_least // size)) if size < at_least else 1
    copies = [tensors] + [tuple(t.clone() for t in tensors)
                          for _ in range(n - 1)]
    return itertools.cycle(copies)


def bound(nbytes, flops, dtype):
    """Least time (ms) for the work and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                 else "bytes")


def hold_rows(name, fn, plain, inputs, dtype, tol=None):
    """``fn`` vs ``plain`` on a CHECK_ROWS batch's leading rows: max |Δ|
    within one step of the type (or ``tol``) at M = 1 and 4, the same
    bits on a second call, and every row at M in INVARIANCE_ROWS equal
    to itself computed alone. ``inputs(m)`` gives the call's args."""
    errs = {}
    for m in (1, 4):
        got = fn(*inputs(m))
        torch.cuda.synchronize()
        want = plain(*inputs(m))
        err = float((got.float() - want.float()).abs().max())
        limit = (tol if tol is not None else DECODE_TOL[dtype]
                 * max(1.0, float(want.float().abs().max())))
        if not torch.isfinite(got).all() or err > limit:
            raise AssertionError(f"{name} M={m}: max |Δ| {err} > {limit}")
        if not torch.equal(fn(*inputs(m)), got):
            raise AssertionError(f"{name} M={m}: a second call gave other "
                                 "bits")
        errs[m] = (err, limit)
    for m in INVARIANCE_ROWS:
        whole = fn(*inputs(m))
        for i in range(m):
            alone = fn(*[t[i:i + 1] if t.shape[0] == m else t
                         for t in inputs(m)])
            if not torch.equal(alone, whole[i:i + 1]):
                raise AssertionError(
                    f"{name}: row {i} of M={m} differs from the row alone")
    return errs


def decode_gemm_rows(shapes=DECODE_GEMMS):
    """The decode GEMM at each llama3-8b decode shape (``shapes``: a
    tensor rank's with TENSOR_DECODE_GEMMS), M = 1 and 4."""
    rows = []
    for name, k, n, dtype, per_step in shapes:
        gen = torch.Generator(device="cuda").manual_seed(8)
        w = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).to(dtype)
        x = torch.randn(CHECK_ROWS, 1, k, device="cuda", generator=gen).to(
            dtype)
        errs = hold_rows(f"decode_gemm {name}", dg.decode_linear,
                         dg.decode_linear_reference,
                         lambda m: (x[:m], w), dtype)
        for m in (1, 4):
            xs = x[:m]
            ws = cold_cycle((w,))

            def run():
                return dg.decode_linear(xs, next(ws)[0])

            def plain():
                return dg.decode_linear_reference(xs, next(ws)[0])

            def library():
                return F.linear(xs, next(ws)[0])

            elem = w.element_size()
            b_ms, b_by = bound((n * k + m * k + m * n) * elem,
                               2.0 * m * n * k, dtype)
            ms = time_ms(run, **KERNEL_TIMING)
            row = {"shape": f"{name} M={m}", "m": m,
                   "launches_per_step": per_step,
                   "max_abs_err": errs[m][0], "tol": errs[m][1],
                   "ms": ms, "device_ms": profiled_ms(run),
                   "plain_ms": time_ms(plain, reps=5),
                   "library_ms": time_ms(library, **KERNEL_TIMING),
                   "library_device_ms": profiled_ms(library),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms}
            log(f"decode_gemm {json.dumps(row)}")
            rows.append(row)
        del w, x, ws
        torch.cuda.empty_cache()
    return rows


#: RMSNorm's shapes: llama3-8b's width at the main path's row counts
#: (a decode step's 1 and 4, a speculative verify's 20, a prefill's 512
#: and an 8192-token block, read L2-cold), bf16, and [4, 4096] fp32.
NORM_SHAPES = tuple((torch.bfloat16, m) for m in (1, 4, 20, 512, 8192)) + (
    (torch.float32, 4),)
#: From this row count the inputs cycle through copies larger than L2.
NORM_COLD_ROWS = 8192


def rms_norm_rows():
    """Both RMSNorm entries at NORM_SHAPES: within one step of the type
    of the plain version, the same bits on a second call, every row
    equal to the row in blocks of 20 rows (at M = 1 and 4, the decode
    checks of hold_rows), the fused entry's s equal to torch's x + d
    and its y to the plain entry's norm of it, bit for bit; timed
    beside the plain version, the library (F.rms_norm; for the fused
    entry the pair x + d, F.rms_norm) and the bound."""
    rows = []
    d = 4096
    # A decode step's launches of each entry: layer 0's attention norm
    # plain, the other 64 fused with the residual add before them.
    step_launches = {"plain": STEP_LAUNCHES["rms_norm"]
                     - STEP_LAUNCHES["add_rms_norm"],
                     "fused": STEP_LAUNCHES["add_rms_norm"]}
    for dtype, m in NORM_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(9)
        n = max(m, CHECK_ROWS)
        x = (torch.randn(n, d, device="cuda", generator=gen) * 2).to(dtype)
        delta = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
        scale = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(
            dtype)
        name = f"[{m}, {d}] {str(dtype).replace('torch.', '')}"
        entries = {
            "plain": (lambda a, b: rn.rms_norm(a, scale, 1e-5),
                      lambda a, b: rn.rms_norm_reference(a, scale, 1e-5),
                      lambda a, b: F.rms_norm(a, (d,), scale, 1e-5)),
            "fused": (lambda a, b: rn.add_rms_norm(a, b, scale, 1e-5)[1],
                      lambda a, b: rn.add_rms_norm_reference(
                          a, b, scale, 1e-5)[1],
                      lambda a, b: F.rms_norm(a + b, (d,), scale, 1e-5))}
        errs = {}
        if m in (1, 4) and dtype == torch.bfloat16:
            for entry, (run, plain, _) in entries.items():
                errs[entry] = hold_rows(
                    f"rms_norm {entry} [M, {d}] bf16", run, plain,
                    lambda k: (x[:k], delta[:k]), dtype)
        xs, ds = x[:m], delta[:m]
        s, y = rn.add_rms_norm(xs, ds, scale, 1e-5)
        if not (torch.equal(s, xs + ds)
                and torch.equal(y, rn.rms_norm(xs + ds, scale, 1e-5))):
            raise AssertionError(f"add_rms_norm {name}: not the add, then "
                                 "the plain entry's norm, bit for bit")
        copies = cold_cycle((xs, ds), 0 if m < NORM_COLD_ROWS else 256 << 20)
        for entry, (run, plain, library) in entries.items():
            got, want = run(xs, ds), plain(xs, ds)
            err = float((got.float() - want.float()).abs().max())
            tol = DECODE_TOL[dtype] * max(1.0, float(want.float().abs().max()))
            if not torch.isfinite(got).all() or err > tol:
                raise AssertionError(f"rms_norm {entry} {name}: max |Δ| "
                                     f"{err} > {tol}")
            blocks = torch.cat([run(xs[i:i + 20], ds[i:i + 20])
                                for i in range(0, m, 20)])
            if not (torch.equal(run(xs, ds), got)
                    and torch.equal(blocks, got)):
                raise AssertionError(f"rms_norm {entry} {name}: other bits "
                                     "on a second call or in 20-row blocks")
            err, tol = errs.get(entry, {}).get(m, (err, tol))

            def turn(fn):
                def call():
                    a, b = next(copies)
                    return fn(a, b)
                return call

            elem = x.element_size()
            streams = 2 if entry == "plain" else 4
            b_ms, b_by = bound((streams * m * d + d) * elem,
                               (4.0 + (entry == "fused")) * m * d, dtype)
            ms = time_ms(turn(run), **KERNEL_TIMING)
            device = profiled_ms(turn(run))
            row = {"entry": entry, "shape": name, "m": m,
                   "cold": m >= NORM_COLD_ROWS,
                   "launches_per_step": (step_launches[entry]
                                         if dtype == torch.bfloat16
                                         and m in (1, 4) else 0),
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "ms_one_call": time_ms(turn(run)),
                   "device_ms": device,
                   "plain_ms": time_ms(turn(plain), reps=5),
                   "library_ms": time_ms(turn(library), **KERNEL_TIMING),
                   "library_ms_one_call": time_ms(turn(library)),
                   "library_device_ms": profiled_ms(turn(library)),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms,
                   "device_bound_share": b_ms / device}
            log(f"rms_norm {json.dumps(row)}")
            rows.append(row)
        del x, delta, xs, ds, copies
        torch.cuda.empty_cache()
    return rows


def decode_attention_rows(heads=32, kv_heads=8, full_context=True):
    """Decode attention at llama3-8b's heads (``heads`` over
    ``kv_heads``: a tensor rank's 16 over 4 at tensor=2) over the
    engine's 544-slot cache, bf16, rows at the engine mix's positions
    (M = 1, 4); with ``full_context`` also one row at 8,192 keys."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf = torch.bfloat16
    h, hkv = heads, kv_heads
    q = torch.randn(CHECK_ROWS, 1, h, 128, device="cuda",
                    generator=gen).to(bf)
    k = torch.randn(CHECK_ROWS, ENGINE_CACHE, hkv, 128, device="cuda",
                    generator=gen).to(bf)
    v = torch.randn(CHECK_ROWS, ENGINE_CACHE, hkv, 128, device="cuda",
                    generator=gen).to(bf)
    pos = torch.tensor(DECODE_POSITIONS * (CHECK_ROWS // 4), device="cuda")
    valid = (torch.arange(ENGINE_CACHE, device="cuda")[None, :]
             <= pos[:, None])
    errs = hold_rows("decode_attention", da.decode_attention,
                     lambda *a: dense_attention(*a[:3],
                                                kv_segment_valid=a[3]),
                     lambda m: (q[:m], k[:m], v[:m], valid[:m]), bf,
                     tol=KERNEL_TOL["bfloat16"])
    for m in (1, 4):
        qs, ms_ = q[:m], valid[:m]
        caches = cold_cycle((k[:m].contiguous(), v[:m].contiguous()))

        def run():
            kk, vv = next(caches)
            return da.decode_attention(qs, kk, vv, ms_)

        def plain():
            kk, vv = next(caches)
            return dense_attention(qs, kk, vv, kv_segment_valid=ms_)

        def library():
            kk, vv = next(caches)
            return F.scaled_dot_product_attention(
                qs.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                attn_mask=ms_[:, None, None, :], enable_gqa=True)

        n_valid = int(ms_.sum())
        nbytes = (2 * n_valid * hkv * 128 + 2 * m * h * 128) * 2 \
            + ms_.numel()
        b_ms, b_by = bound(nbytes, 4.0 * 128 * h * n_valid, bf)
        t = time_ms(run, **KERNEL_TIMING)
        row = {"shape": f"B{m} S{ENGINE_CACHE} H{h}/{hkv} D128 bf16",
               "m": m, "launches_per_step": 32,
               "max_abs_err": errs[m][0], "tol": errs[m][1], "ms": t,
               "device_ms": profiled_ms(run),
               "plain_ms": time_ms(plain, **KERNEL_TIMING),
               "library_ms": time_ms(library, **KERNEL_TIMING),
               "library_device_ms": profiled_ms(library),
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / t}
        log(f"decode_attention {json.dumps(row)}")
        rows.append(row)
    if not full_context:
        return rows
    # llama3-8b's full context, one row: the kernel at its S ceiling's
    # side of the main path (a CTA holds 1,024 keys of 8,192).
    s_long = 8192
    del q, k, v, caches
    torch.cuda.empty_cache()
    q = torch.randn(1, 1, 32, 128, device="cuda", generator=gen).to(bf)
    k = torch.randn(1, s_long, 8, 128, device="cuda", generator=gen).to(bf)
    v = torch.randn(1, s_long, 8, 128, device="cuda", generator=gen).to(bf)
    valid = torch.arange(s_long, device="cuda")[None, :] < s_long - 100
    got = da.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    want = dense_attention(q, k, v, kv_segment_valid=valid)
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got).all() or err > KERNEL_TOL["bfloat16"]:
        raise AssertionError(f"decode_attention S={s_long}: max |Δ| {err}")
    if not torch.equal(da.decode_attention(q, k, v, valid), got):
        raise AssertionError(f"decode_attention S={s_long}: a second call "
                             "gave other bits")
    run = functools.partial(da.decode_attention, q, k, v, valid)
    library = functools.partial(
        F.scaled_dot_product_attention, q.transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), attn_mask=valid[:, None, None, :],
        enable_gqa=True)
    n_valid = int(valid.sum())
    b_ms, b_by = bound((2 * n_valid * 8 * 128 + 2 * 32 * 128) * 2
                       + valid.numel(), 4.0 * 128 * 32 * n_valid, bf)
    t = time_ms(run, **KERNEL_TIMING)
    row = {"shape": f"B1 S{s_long} H32/8 D128 bf16", "m": 1, "s": s_long,
           "launches_per_step": 0, "splits": da.splits(s_long),
           "max_abs_err": err, "tol": KERNEL_TOL["bfloat16"], "ms": t,
           "device_ms": profiled_ms(run),
           "plain_ms": time_ms(functools.partial(
               dense_attention, q, k, v, kv_segment_valid=valid), reps=5),
           "library_ms": time_ms(library, **KERNEL_TIMING),
           "library_device_ms": profiled_ms(library),
           "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / t}
    log(f"decode_attention {json.dumps(row)}")
    rows.append(row)
    return rows


#: Prefill blocks whose attention over the cache runs on the flash
#: kernel, one launch a block: (name, rows' pad lengths, block width,
#: offset, cache slots). generate's left-padded [2, 512] prompt block
#: over its 544-slot cache (the engine's cache has that length too); an
#: engine chunk of 64 at offset 448 of the 512-token row; prompts of
#: 2,048 and 8,192 tokens (llama3-8b's context) over caches of their
#: length.
PREFILL_ATTENTION = (
    ("generate [2, 512] pads (212, 0) S544",
     (max(PROMPTS) - PROMPTS[0], 0), max(PROMPTS), 0,
     max(PROMPTS) + NEW_TOKENS),
    ("chunk [1, 64] at 448 S544", (0,), 64, 448, max(PROMPTS) + NEW_TOKENS),
    ("prompt [1, 2048] S2048", (0,), 2048, 0, 2048),
    ("prompt [1, 8192] S8192", (0,), 8192, 0, 8192),
)
#: The earlier route is timed up to this block width; past it a call
#: takes about 115 ms (8,192 rows of 32 CTA clusters each).
EARLIER_ROUTE_MAX_L = 2048
#: A chunk's width where the rows of a block are held against a chunk of
#: them: the chunk phase's.
ROWS_CHUNK = 64


def per_query_attention(q, k, v, q_offset, valid):
    """The earlier route of a prefill's attention, kept here to time
    beside the flash launch: each query a row of the decode attention
    kernel with its causal frontier as its validity and its batch row's
    K/V broadcast (batch stride 0), one launch for each of the B rows."""
    b, l = q.shape[:2]
    pos = torch.arange(k.shape[1], device=q.device)
    causal = pos[None, :] <= q_offset + torch.arange(
        l, device=q.device)[:, None]
    return torch.stack([da.decode_attention(
        q[i][:, None], k[i][None].expand(l, *k.shape[1:]),
        v[i][None].expand(l, *v.shape[1:]), causal & valid[i][None, :])[:, 0]
        for i in range(b)])


def prefill_attention_rows():
    """``prefill_attention`` at llama3-8b's heads (32/8, D = 128, bf16)
    on the blocks of PREFILL_ATTENTION, with the validity generate and
    the engine build (keys below the block's end and at or past the
    row's pad): against ``dense_attention(causal=True, q_offset=...)``
    within flash's tolerance, the same bits on a second call, one flash
    launch a call, and a chunk's rows equal to the same rows of the
    one-shot block (the chunk row against its 512-token block; every
    other block's last ROWS_CHUNK rows, run as a chunk at their offset,
    against the block); its time beside the earlier route (to
    EARLIER_ROUTE_MAX_L), the plain version, SDPA with the same mask,
    and the bound."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16
    blocks = {}
    for name, pads, l, offset, s in PREFILL_ATTENTION:
        b = len(pads)
        if offset:  # the chunk: the one-shot block's unpadded row
            ref_q, ref_k, ref_v = blocks[PREFILL_ATTENTION[0][0]]
            q = ref_q[-1:, offset:offset + l].clone()
            k, v = ref_k[-1:].clone(), ref_v[-1:].clone()
        else:
            q = torch.randn(b, l, 32, 128, device="cuda",
                            generator=gen).to(bf)
            k = torch.randn(b, s, 8, 128, device="cuda", generator=gen).to(bf)
            v = torch.randn(b, s, 8, 128, device="cuda", generator=gen).to(bf)
        if name == PREFILL_ATTENTION[0][0]:
            blocks[name] = (q, k, v)
        slots = torch.arange(s, device="cuda")
        pad = torch.tensor(pads, device="cuda")

        def validity(end):
            return (slots[None, :] < end) & (slots[None, :] >= pad[:, None])

        valid = validity(offset + l)
        run = functools.partial(prefill_attention, q, k, v, offset, valid)
        plain = functools.partial(dense_attention, q, k, v, causal=True,
                                  q_offset=offset, kv_offset=0,
                                  kv_segment_valid=valid)
        before = flash_attention.launches
        got = run()
        torch.cuda.synchronize()
        if flash_attention.launches != before + 1:
            raise AssertionError(f"prefill_attention {name}: "
                                 f"{flash_attention.launches - before} "
                                 "flash launches, not 1")
        want = plain()
        err = float((got.float() - want.float()).abs().max())
        del want
        if not torch.isfinite(got).all() or err > KERNEL_TOL["bfloat16"]:
            raise AssertionError(f"prefill_attention {name}: max |Δ| {err}")
        if not torch.equal(run(), got):
            raise AssertionError(f"prefill_attention {name}: a second call "
                                 "gave other bits")
        if offset:
            whole = prefill_attention(ref_q[-1:], k, v, 0, valid)
            if not torch.equal(got, whole[:, offset:offset + l]):
                raise AssertionError(
                    f"prefill_attention {name}: the chunk's rows differ "
                    "from the same rows of the one-shot block")
        else:
            lo = l - ROWS_CHUNK
            part = prefill_attention(q[:, lo:].contiguous(), k, v, lo,
                                     validity(l))
            if not torch.equal(part, got[:, lo:]):
                raise AssertionError(
                    f"prefill_attention {name}: its last {ROWS_CHUNK} rows "
                    "as a chunk differ from the same rows of the block")
        causal = slots[None, :] <= offset + torch.arange(
            l, device="cuda")[:, None]
        mask = causal[None] & valid[:, None, :]  # [B, L, S]
        library = functools.partial(
            F.scaled_dot_product_attention, q.transpose(1, 2),
            k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask[:, None],
            enable_gqa=True)
        pairs = float(mask.sum())
        n_valid = int(valid.sum())
        b_ms, b_by = bound((2 * n_valid * 8 * 128 + 2 * b * l * 32 * 128) * 2
                           + valid.numel(), 4.0 * 128 * 32 * pairs, bf)
        t = time_ms(run, **KERNEL_TIMING)
        row = {"shape": f"{name} H32/8 D128 bf16", "b": b, "l": l,
               "offset": offset, "s": s, "launches": 1,
               "max_abs_err": err, "tol": KERNEL_TOL["bfloat16"], "ms": t,
               "device_ms": profiled_ms(run)}
        if l <= EARLIER_ROUTE_MAX_L:
            earlier = functools.partial(per_query_attention, q, k, v, offset,
                                        valid)
            row.update(earlier_ms=time_ms(earlier, reps=5),
                       earlier_device_ms=profiled_ms(earlier, calls=5),
                       earlier_launches=b)
        else:
            row["earlier_ms"] = (f"not timed: about 115 ms a call past "
                                 f"{EARLIER_ROUTE_MAX_L} rows")
        row.update(plain_ms=time_ms(plain, reps=5),
                   plain_device_ms=profiled_ms(plain, calls=5),
                   library_ms=time_ms(library, **KERNEL_TIMING),
                   library_device_ms=profiled_ms(library),
                   bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / t)
        log(f"prefill_attention {json.dumps(row)}")
        rows.append(row)
        del q, k, v, got, mask, causal, library, run, plain
        torch.cuda.empty_cache()
    del blocks
    torch.cuda.empty_cache()
    return rows


#: llama3-8b's prefill products at M = 512 (a [1, 512] prompt block):
#: (name, K, N, launches a prefill forward). 7 a layer over 32 layers;
#: the fp32 head stays cuBLAS.
PREFILL_GEMMS = (
    ("q_proj/o_proj [4096→4096]", 4096, 4096, 64),
    ("k_proj/v_proj [4096→1024]", 4096, 1024, 64),
    ("gate_proj/up_proj [4096→14336]", 4096, 14336, 64),
    ("down_proj [14336→4096]", 14336, 4096, 32),
)
PREFILL_M = 512
#: The rows generate's left-padded [2, 512] prefill block gives each
#: product.
MAIN_PATH_M = len(PROMPTS) * max(PROMPTS)
#: Block widths whose rows must equal the same rows of the 512-wide
#: block: a decode-sized block, a hit's one-token tail prefilled 2 wide,
#: the prefix mix's tail buckets and exact tails, and the cold width.
PREFILL_WIDTHS = (1, 2, 20, 128, 140, 256, 512)


def prefill_gemm_rows(shapes=PREFILL_GEMMS):
    """The prefill GEMM at each llama3-8b prefill shape, M = 512, bf16:
    within one bf16 step of ``F.linear`` (its plain version), the same
    bits on a second call, and the last and first M rows of the block
    computed alone in a block of M rows, for every M in PREFILL_WIDTHS,
    equal to the same rows of the 512-wide block, bit for bit. The
    MAIN_PATH_M-row block generate's prefill gives it (more output tiles
    than the card holds clusters at k/v, so a cluster walks a second
    one) is held the same way: within one bf16 step, the same bits on a
    second call, and each 512-row half equal to that half alone. Times as
    the decode kernels' (weights cycled through copies larger than L2),
    the bound the larger of the FLOPs at the bf16 peak and the bytes."""
    rows = []
    bf = torch.bfloat16
    for name, k, n, per_forward in shapes:
        gen = torch.Generator(device="cuda").manual_seed(11)
        w = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).to(bf)
        x_main = torch.randn(MAIN_PATH_M, k, device="cuda",
                             generator=gen).to(bf)
        x = x_main[:PREFILL_M]
        errs = {}
        for block in (x, x_main):
            got = pg.prefill_linear(block, w)
            torch.cuda.synchronize()
            want = pg.prefill_linear_reference(block, w)
            err = float((got.float() - want.float()).abs().max())
            tol = DECODE_TOL[bf] * max(1.0, float(want.float().abs().max()))
            if not torch.isfinite(got).all() or err > tol:
                raise AssertionError(f"prefill_gemm {name} M={len(block)}: "
                                     f"max |Δ| {err} > {tol}")
            if not torch.equal(pg.prefill_linear(block, w), got):
                raise AssertionError(f"prefill_gemm {name} M={len(block)}: "
                                     "a second call gave other bits")
            errs[len(block)] = (err, tol, got)
        err, tol, got = errs[PREFILL_M]
        main_err, main_tol, main_got = errs[MAIN_PATH_M]
        for r0 in range(0, MAIN_PATH_M, PREFILL_M):
            half = x_main[r0:r0 + PREFILL_M]
            if not torch.equal(pg.prefill_linear(half, w),
                               main_got[r0:r0 + PREFILL_M]):
                raise AssertionError(
                    f"prefill_gemm {name}: rows {r0}.. of the "
                    f"{MAIN_PATH_M}-row block differ from the same "
                    f"{PREFILL_M} rows alone")
        for m in PREFILL_WIDTHS:
            tail = pg.prefill_linear(x[PREFILL_M - m:].contiguous(), w)
            head = pg.prefill_linear(x[:m], w)
            if not (torch.equal(tail, got[PREFILL_M - m:])
                    and torch.equal(head, got[:m])):
                raise AssertionError(f"prefill_gemm {name}: rows of an "
                                     f"{m}-row block differ from the same "
                                     f"rows of the {PREFILL_M}-row block")
        ws = cold_cycle((w,))

        def run():
            return pg.prefill_linear(x, next(ws)[0])

        def library():
            return F.linear(x, next(ws)[0])

        b_ms, b_by = bound((n * k + PREFILL_M * k + PREFILL_M * n) * 2,
                           2.0 * PREFILL_M * n * k, bf)
        ms = time_ms(run, **KERNEL_TIMING)
        lib_ms = time_ms(library, **KERNEL_TIMING)
        row = {"shape": f"{name} M={PREFILL_M} bf16",
               "launches_per_forward": per_forward,
               "max_abs_err": err, "tol": tol,
               "widths_bitwise_equal": list(PREFILL_WIDTHS),
               f"max_abs_err_m{MAIN_PATH_M}": main_err,
               f"tol_m{MAIN_PATH_M}": main_tol,
               "ms": ms, "device_ms": profiled_ms(run),
               # The plain version is the library call, F.linear.
               "plain_ms": lib_ms, "library_ms": lib_ms,
               "library_device_ms": profiled_ms(library),
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
        log(f"prefill_gemm {json.dumps(row)}")
        rows.append(row)
        del w, x, x_main, ws, got, want, main_got, errs
        torch.cuda.empty_cache()
    sums = {key: sum(r["launches_per_forward"] * r[key] for r in rows)
            for key in ("ms", "device_ms", "library_ms",
                        "library_device_ms", "bound_ms")}
    log(f"prefill_gemm per llama3-8b prefill forward [1, {PREFILL_M}]: "
        f"Σ layers·ms {json.dumps(sums)} over "
        f"{sum(r['launches_per_forward'] for r in rows)} launches")
    return rows


def per_step(rows, key):
    """Σ over the decode step's launches of ``key``, from the M = 4
    rows (a row's launches a step times its figure)."""
    return sum(r["launches_per_step"] * r[key] for r in rows if r["m"] == 4)


#: Every kernel's launch counter, by the name the kernels line gives it.
COUNTERS = {"flash_attention": flash_attention,
            "decode_gemm": dg.decode_linear,
            "rms_norm": rn.rms_norm,
            "add_rms_norm": rn.add_rms_norm,
            "decode_attention": da.decode_attention,
            "prefill_gemm": pg.prefill_linear}
#: llama3-8b's launches a decode step: 7 products a layer and the head;
#: two norms a layer and the final one (rms_norm counts either entry),
#: all but layer 0's attention norm fused with the residual add before
#: it (add_rms_norm); attention once a layer.
STEP_LAUNCHES = {"decode_gemm": 7 * 32 + 1, "rms_norm": 2 * 32 + 1,
                 "add_rms_norm": 2 * 32, "decode_attention": 32}
#: llama3-8b's prefill-GEMM launches a prefill forward: its 7 bf16
#: projections a layer (the fp32 head stays cuBLAS).
PREFILL_LAUNCHES = 7 * 32
#: Flash launches a prefill forward takes, whatever its B: its attention
#: over the cache, one launch a layer for the whole block.
PREFILL_ATTENTION_LAUNCHES = 32
#: Decode-GEMM launches a prefill forward takes: its fp32 head at the
#: one position a row its caller reads.
PREFILL_HEAD_LAUNCHES = 1


def fused_norms_ok(counts, layers: int = 32) -> bool:
    """Every Llama forward of the run launched one plain norm (layer 0's
    attention norm) and 2·layers fused ones (every other norm, the
    residual add before it in the same launch), and some forward ran."""
    plain = counts["rms_norm"] - counts["add_rms_norm"]
    return plain > 0 and counts["add_rms_norm"] == 2 * layers * plain


def prefills_on_flash(counts) -> bool:
    """Every prefill forward's layer (the verifier's and the draft's,
    chunk or whole block) launched 7 prefill GEMMs and one flash: its
    attention over the cache went to flash and nowhere else."""
    return (counts["flash_attention"] > 0
            and counts["prefill_gemm"] == 7 * counts["flash_attention"])


def zero_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


#: Each kernel's function names in the profiler's CUDA activity (the
#: ``__global__`` functions of ``csrc/*.cu``), by the name the kernels
#: line gives it.
KERNEL_NAMES = {"flash_attention": ("flash_fwd_kernel_wgmma",
                                    "flash_fwd_kernel_fma"),
                "decode_gemm": ("decode_gemm_bf16_kernel",
                                "decode_gemm_fp32_kernel"),
                # Either entry's kernel: rms_norm_kernel<T, D> and
                # add_rms_norm_kernel<T, D>.
                "rms_norm": ("rms_norm_kernel",),
                "add_rms_norm": ("add_rms_norm_kernel",),
                "decode_attention": ("decode_attention_kernel",),
                "prefill_gemm": ("prefill_gemm_kernel",)}


def kernel_counts(prof) -> dict:
    """Each kernel's launches in a profile's CUDA activity: a replayed
    graph's kernel nodes count one each, as eager launches do."""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for row in prof.key_averages():
        for name, functions in KERNEL_NAMES.items():
            if any(f in row.key for f in functions):
                counts[name] += row.count
    return counts


class ProgramTally:
    """A captured engine's program calls, in order, as ``(key, first
    use?)``, and each key's body: the wrappers' launches while its
    capture recorded it into the graph."""

    def __init__(self):
        self.bodies = {}
        self.calls = []

    def run(self, graphs, run, key, body, inputs):
        """``GraphCache.run`` (``run``) with the call noted. A key's
        first use runs its body twice, the warm-up and the capture: each
        run's launches are read from the wrappers, and they must be
        equal (a capture records what the warm-up ran)."""
        if key in graphs.programs:
            self.calls.append((key, False))
            return run(key, body, inputs)
        runs = []

        def recorded(**kw):
            before = read_counts()
            out = body(**kw)
            after = read_counts()
            runs.append({k: after[k] - before[k] for k in after})
            return out

        out = run(key, recorded, inputs)
        warm_up, captured = runs
        if warm_up != captured:
            raise AssertionError(f"program {key}: the capture recorded "
                                 f"{captured}, its warm-up ran {warm_up}")
        self.bodies[key] = captured
        self.calls.append((key, True))
        return out


def tally_programs(engine):
    """Route a captured engine's program calls through a
    ``ProgramTally``: from its build on, for an engine whose first
    captures come before the block that counts (a server's load warms
    its engine up), else for one ``served_launches`` block."""
    graphs = engine._graphs
    if not hasattr(graphs, "smoke_tally"):
        graphs.smoke_tally = ProgramTally()
    graphs.run = functools.partial(graphs.smoke_tally.run, graphs,
                                   graphs.run)


@contextlib.contextmanager
def served_launches(*engines):
    """Each kernel's launches on the card for the block's work on
    ``engines``, captured as a server builds them: the yielded dict is
    filled when the block ends. A wrapper counts each launch it makes:
    every eager call's, and a captured program's twice on the key's
    first use (the warm-up runs the body, the capture records it). A
    replay calls no wrapper and runs the kernels its graph holds. So the
    card ran each kernel the wrappers' count, less each first use's
    capture, plus each replay's body. serve_captured reads one replayed
    slice's kernels from the card itself."""
    patched = []
    for engine in engines:
        graphs = engine._graphs
        if graphs is None:
            raise AssertionError(f"engine {engine.name} runs uncaptured")
        # An engine tallied from its build on (tally_programs) keeps its
        # tally; any other is tallied for the block.
        lasting = "run" in vars(graphs)
        if not lasting:
            tally_programs(engine)
        patched.append((graphs, len(graphs.smoke_tally.calls), lasting))
    counts = {}
    zero_counts()
    try:
        yield counts
    finally:
        for graphs, _, lasting in patched:
            if not lasting:
                del graphs.run  # the class's method again; no cycle kept
    counts.update(read_counts())
    for graphs, mark, _ in patched:
        tally = graphs.smoke_tally
        for key, first in tally.calls[mark:]:
            for name, n in tally.bodies[key].items():
                counts[name] += -n if first else n


@contextlib.contextmanager
def twin_calls():
    """Count calls of the decode GEMM's, the prefill GEMM's and
    RMSNorm's plain twins: on the card's routes a CUDA tensor must never
    reach them."""
    calls = {"decode_linear_reference": 0, "prefill_linear_reference": 0,
             "rms_norm_reference": 0}
    saved = (dg.decode_linear_reference, pg.prefill_linear_reference,
             rn.rms_norm_reference)

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    dg.decode_linear_reference = counted("decode_linear_reference", saved[0])
    pg.prefill_linear_reference = counted("prefill_linear_reference",
                                          saved[1])
    rn.rms_norm_reference = counted("rms_norm_reference", saved[2])
    try:
        yield calls
    finally:
        (dg.decode_linear_reference, pg.prefill_linear_reference,
         rn.rms_norm_reference) = saved


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
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with twin_calls() as twins:
        zero_counts()
        t0 = time.monotonic()
        pred = predict_model.run({"input_ids": x_pred}, method="predict")
        predict_s = time.monotonic() - t0
        after_predict = read_counts()
        cls = predict_model.run({"input_ids": x_cls}, method="classify")
        before_generate = read_counts()
        t0 = time.monotonic()
        gen = gen_model.run({"input_ids": x_gen}, prompt_lengths=lengths)
        generate_s = time.monotonic() - t0
        launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path launches: {json.dumps(launches)}; plain twins called "
        f"{json.dumps(twins)}")

    layers = entry.make().num_layers
    if after_predict["flash_attention"] < layers:
        raise AssertionError(f"predict launched flash "
                             f"{after_predict['flash_attention']} times, "
                             f"fewer than its {layers} layers")
    # generate: one prefill (its norms, its 7 bf16 projections a layer
    # through the prefill GEMM, its attention one flash launch a layer
    # for the [2, 512] block), then NEW_TOKENS - 1 decode steps, each
    # through the three decode kernels.
    steps = NEW_TOKENS - 1
    in_generate = {k: launches[k] - before_generate[k] for k in launches}
    want = {k: steps * n for k, n in STEP_LAUNCHES.items()}
    want["rms_norm"] += STEP_LAUNCHES["rms_norm"]
    want["add_rms_norm"] += STEP_LAUNCHES["add_rms_norm"]
    want["prefill_gemm"] = PREFILL_LAUNCHES
    want["flash_attention"] = PREFILL_ATTENTION_LAUNCHES
    want["decode_gemm"] += PREFILL_HEAD_LAUNCHES
    if before_generate["prefill_gemm"]:
        raise AssertionError(f"the cache-free forward launched the prefill "
                             f"GEMM {before_generate['prefill_gemm']} times")
    if any(in_generate[k] != n for k, n in want.items()) or any(
            twins.values()):
        raise AssertionError(f"generate launched {in_generate}, expected "
                             f"{want}; plain twins called {twins}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
    launches["flash_attention_prefill"] = in_generate["flash_attention"]
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
    del predict_model, gen_model
    # The engine slice and the prefix lane on the same params, made once.
    kw = {"dtype": "bfloat16"}
    _, vanilla = timed(serve_engine, card, LLAMA, params, kw,
                       decode_ms_b2=decode_ms)
    _, prefix_refs = timed(serve_prefix, card, LLAMA, params, kw)
    timed(serve_spec, card, LLAMA, params, kw, vanilla)
    _, chunk_refs = timed(serve_chunked, card, LLAMA, params, kw)
    # The B=1 streams serve_engine, serve_prefix and serve_chunked held
    # their uncaptured engines to: the captured engines' yardstick.
    b1_refs = {"engine": {m: vanilla[m][1] for m in vanilla},
               "prefix": prefix_refs, "chunk": chunk_refs}
    captured = timed(serve_captured, card, LLAMA, params, kw, b1_refs)
    timed(serve_handoff, card, LLAMA, params, kw, vanilla, prefix_refs)
    timed(serve_resume, card, LLAMA, params, kw)
    timed(serve_host_tier, card, LLAMA, params, kw, prefix_refs)
    timed(serve_fleet, card, LLAMA, params, kw, prefix_refs)
    timed(verify_forward_launches, card, LLAMA, params)
    timed(decode_step_launches, card, LLAMA, params)
    timed(serve_manager, card, LLAMA, params, kw, captured)
    del captured
    train = timed(train_lm, card, params)
    launches["flash_attention_train"] = train["flash_attention"]
    launches["rms_norm_train"] = train["rms_norm"]
    launches["add_rms_norm_train"] = train["add_rms_norm"]
    gang = timed(gang_lm, card, params)
    launches["flash_attention_gang"] = gang["flash_attention"]
    launches["rms_norm_gang"] = gang["rms_norm"]
    launches["add_rms_norm_gang"] = gang["add_rms_norm"]
    tensor = timed(gang_tensor, card)
    launches["tensor_ranks"] = tensor["launches"]
    return launches


def timed(phase, *args, **kw):
    """Run one phase and print its wall seconds (the smoke's time
    limit is shared by every phase)."""
    t0 = time.monotonic()
    out = phase(*args, **kw)
    log(f"phase {phase.__name__}: {time.monotonic() - t0:.1f} s")
    return out


#: The engine slice (phases 4b-4d): ``EngineConfig(max_new_tokens=32,
#: max_prompt_len=512, num_slots=4, page_size=16, slice_tokens=4)``;
#: six requests submitted at once, with budgets that retire slots at
#: different slices, so the two queued requests join mid-decode.
ENGINE_GENERATE_CONFIG = {"max_new_tokens": 32, "engine_slots": 4,
                          "engine_page_size": 16, "engine_slice_tokens": 4}
ENGINE_PROMPTS = (300, 512, 77, 410, 200, 512)
ENGINE_BUDGETS = (32, 8, 32, 16, 32, 24)
#: Requests 1 and 3 (0-based 0 and 2) through a 1-slot engine.
STRICT_REQUESTS = (0, 2)
SAMPLING = {"temperature": 0.7, "top_k": 40, "top_p": 0.9}
#: The engine's cache: the longest prompt bucket plus the budget, a
#: whole number of 16-token pages, so the engine's logical cache and
#: the B=1 reference's cache have one length.
ENGINE_CACHE = 512 + 32


def engine_model(registry, params, kwargs, max_prompt, generate_config,
                 device):
    """A generate-method ``LoadedModel`` for the engine phases."""
    meta = ModelMetadata(
        model_name=registry, registry_name=registry, model_kwargs=kwargs,
        signatures={"serving_default": Signature(
            method="generate",
            inputs={"input_ids": TensorSpec("int32", (-1, max_prompt))},
            outputs={"tokens": TensorSpec(
                "int32", (-1, generate_config["max_new_tokens"]))})},
        generate_config=generate_config)
    return LoadedModel(meta, 1, params, max_batch=2, device=device)


def b1_reference(loaded, prompt, key, budget, sampling):
    """The B=1 ground truth for one engine request: ``generate`` at the
    engine's shapes (the prompt left-padded to the engine's bucket, the
    same cache length) with the request's key."""
    engine = loaded.engine
    width = engine._prompt_width(len(prompt))
    ids = np.zeros((1, width), np.int32)
    ids[0, width - len(prompt):] = prompt
    device = loaded.device
    tokens, _ = generate(
        loaded._module, loaded.params, torch.from_numpy(ids).to(device),
        max_new_tokens=budget, rng=key[None],
        prompt_lengths=torch.tensor([len(prompt)], device=device),
        **sampling)
    return tokens[0].cpu().numpy()


def run_engine(engine, requests):
    """Submit every request at once; wait for all (see run_streams)."""
    return run_streams(engine, [
        functools.partial(engine.submit, prompt, rng=key,
                          max_new_tokens=budget)
        for prompt, budget, key in requests])


def slice_inter_ms(slices):
    """Each engine_slice span's inter-token ms: a plain slice's wall
    over its steps; a speculative round's over the tokens it emitted a
    slot."""
    return [e["dur"] / 1e3 / (e["args"]["tokens"] / e["args"]["slots"]
                              if e["args"].get("spec")
                              else e["args"]["steps"]) for e in slices]


def run_streams(engine, submits):
    """Call every submit (each returns a stream) at once; wait for all.
    Returns the token arrays and the timings: each request's time to
    first token (from its submit to the engine emitting token 0), the
    engine_slice spans' inter-token ms, the aggregate tokens/s and the
    slices run."""
    TRACER.clear()
    firsts = {}
    streams = []
    t0 = time.monotonic()
    for i, submit in enumerate(submits):
        submitted = time.monotonic()
        stream = submit()

        def on_emit(i=i, stream=stream, submitted=submitted):
            if i not in firsts and stream.tokens_so_far:
                firsts[i] = (time.monotonic() - submitted) * 1e3

        stream.set_notify(on_emit)
        on_emit()  # in case token 0 was emitted before the hook
        streams.append(stream)
    results = [s.result(timeout=600) for s in streams]
    wall = time.monotonic() - t0
    slices = [e for e in TRACER.snapshot() if e["name"] == "engine_slice"]
    inter = slice_inter_ms(slices)
    timing = {
        "ttft_ms": [firsts[i] for i in range(len(submits))],
        "inter_token_ms": (statistics.median(inter) if inter else None),
        "inter_token_ms_range": ([min(inter), max(inter)] if inter
                                 else None),
        "tokens_per_s": sum(len(r) for r in results) / wall,
        "wall_s": wall,
        "slices": engine.stats()["slices"],
        "decode_steps": sum(e["args"]["steps"] for e in slices),
    }
    return results, timing


def check_engine_pool(engine, admitted):
    stats = engine.stats()
    engine.kv.allocator.check_invariants()
    if (stats["admitted"] != admitted
            or stats["retired"] != {"budget": admitted}
            or stats["free_pages"] != stats["total_pages"]
            or stats["reserved_pages"] or stats["active_slots"]
            or stats["queue_depth"]):
        raise AssertionError(f"engine pool not clean: {stats}")
    return stats


def first_divergence(a, b):
    diff = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return int(diff[0]) if diff.size else None


def engine_requests(vocab, prompts=ENGINE_PROMPTS, budgets=ENGINE_BUDGETS):
    """The engine mix's requests: (prompt, budget, key)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, n).astype(np.int32), budget,
             prng.PRNGKey(100 + i))
            for i, (n, budget) in enumerate(zip(prompts, budgets))]


def serve_engine(card, registry, params, kwargs, *, prompts=ENGINE_PROMPTS,
                 budgets=ENGINE_BUDGETS, generate_config=None,
                 cache_size=ENGINE_CACHE, device=None,
                 decode_ms_b2=None):
    """Phases 4b-4d on ``params``: ``:generate`` through the
    continuous-batching engine, greedy and sampled, 4 slots then 1;
    then sampled ``LoadedModel.run`` with per-row keys. Returns the
    report and, by mode, each request's stream, its B=1 reference and
    the run's timing."""
    config = dict(ENGINE_GENERATE_CONFIG if generate_config is None
                  else generate_config)
    vocab = get_model(registry).num_classes_or_vocab
    max_prompt = max(prompts)
    requests = engine_requests(vocab, prompts, budgets)
    kwargs = dict(kwargs, cache_size=cache_size)
    report = {"card": card}
    runs = {}
    for mode, sampling in (("greedy", {"temperature": 0.0}),
                           ("sampled", SAMPLING)):
        loaded = engine_model(registry, params, kwargs, max_prompt,
                              dict(config, **sampling), device)
        engine = loaded.ensure_engine(name=f"smoke-{mode}")
        if engine.kv.logical_len != cache_size:
            raise AssertionError(f"engine logical cache "
                                 f"{engine.kv.logical_len} != {cache_size}")
        if device is None:
            torch.cuda.reset_peak_memory_stats()
        with twin_calls() as twins, served_launches(engine) as counts:
            results, timing = run_engine(engine, requests)
        if device is None:
            timing["peak_memory_gb"] = \
                torch.cuda.max_memory_allocated() / 1e9
        # Every decode step of every slice went through the kernels.
        steps = timing.pop("decode_steps")
        timing["launches"] = counts
        timing["decode_steps"] = steps
        want = {k: steps * n for k, n in STEP_LAUNCHES.items()
                if k not in ("rms_norm", "add_rms_norm")}
        # One B=1 prefill an admission, its attention on flash.
        want["prefill_gemm"] = PREFILL_LAUNCHES * len(requests)
        want["flash_attention"] = PREFILL_ATTENTION_LAUNCHES * len(requests)
        want["decode_gemm"] += PREFILL_HEAD_LAUNCHES * len(requests)
        if (any(counts[k] != n for k, n in want.items())
                or counts["rms_norm"] < steps * STEP_LAUNCHES["rms_norm"]
                or not fused_norms_ok(counts) or any(twins.values())):
            raise AssertionError(f"engine {mode}: launches {counts} over "
                                 f"{steps} decode steps, expected {want}; "
                                 f"plain twins called {twins}")
        check_engine_pool(engine, len(requests))
        refs = [b1_reference(loaded, p, k, b, sampling)
                for p, b, k in requests]
        for i, ((prompt, budget, _), got, want) in enumerate(
                zip(requests, results, refs)):
            if got.shape != (budget,) or not ((got >= 0)
                                              & (got < vocab)).all():
                raise AssertionError(f"engine {mode} request {i}: tokens "
                                     f"{got.shape}, budget {budget}")
            if got[0] != want[0]:
                raise AssertionError(
                    f"engine {mode} request {i}: first token {got[0]} != "
                    f"B=1 generate's {want[0]}")
        runs[mode] = (results, refs, timing)
        timing["streams_equal_b1"] = sum(
            np.array_equal(g, w) for g, w in zip(results, refs))
        timing["first_divergence"] = [first_divergence(g, w)
                                      for g, w in zip(results, refs)]
        if timing["streams_equal_b1"] != len(requests):
            raise AssertionError(
                f"engine {mode}: {timing['streams_equal_b1']} of "
                f"{len(requests)} streams equal B=1 generate; first "
                f"divergent steps {timing['first_divergence']}")
        loaded.close()

        # The strict check: a 1-slot engine runs the B=1 shapes.
        one = engine_model(registry, params, kwargs, max_prompt,
                           dict(config, engine_slots=1, **sampling), device)
        engine = one.ensure_engine(name=f"smoke-{mode}-1slot")
        strict = [requests[i] for i in STRICT_REQUESTS]
        got, _ = run_engine(engine, strict)
        check_engine_pool(engine, len(strict))
        for i, g in zip(STRICT_REQUESTS, got):
            if not np.array_equal(g, refs[i]):
                raise AssertionError(
                    f"1-slot engine {mode} request {i} differs from B=1 "
                    f"generate at step {first_divergence(g, refs[i])}: "
                    f"{g.tolist()} vs {refs[i].tolist()}")
        one.close()
        timing["one_slot_streams_equal_b1"] = len(strict)
        report[mode] = timing
        log(f"engine {mode}, {len(requests)} requests, "
            f"{config['engine_slots']} slots: {json.dumps(timing)}")
        log(f"engine {mode}: inter-token {timing['inter_token_ms']} ms, "
            f"{timing['tokens_per_s']} tokens/s (this mix before the decode "
            f"kernels, NVIDIA H100 80GB HBM3, 700 W: 65.6-78.5 ms)")
    report["generate_decode_ms_per_token_b2"] = decode_ms_b2
    log(f"{registry} engine: {json.dumps(report)}")

    # Sampled LoadedModel.run: two left-padded rows with their own keys.
    loaded = engine_model(registry, params, kwargs, max_prompt,
                          dict(config, **SAMPLING), device)
    x = np.zeros((2, max_prompt), np.int32)
    lengths = np.asarray(prompts[:2], np.int32)
    for i, (prompt, _, _) in enumerate(requests[:2]):
        x[i, max_prompt - len(prompt):] = prompt
    keys = np.stack([prng.PRNGKey(200), prng.PRNGKey(201)])
    out = loaded.run({"input_ids": x}, prompt_lengths=lengths,
                     row_rngs=keys)["tokens"]
    budget = config["max_new_tokens"]
    for i in range(2):
        ids = torch.from_numpy(x[i:i + 1]).to(loaded.device)
        want, _ = generate(loaded._module, loaded.params, ids,
                           max_new_tokens=budget, rng=keys[i:i + 1],
                           prompt_lengths=torch.tensor(
                               [int(lengths[i])], device=loaded.device),
                           **SAMPLING)
        want = want[0].cpu().numpy()
        if out.shape != (2, budget) or not ((out >= 0)
                                            & (out < vocab)).all():
            raise AssertionError(f"sampled run tokens {out.shape}")
        if not np.array_equal(out[i], want):
            raise AssertionError(
                f"sampled run row {i} differs from B=1 at step "
                f"{first_divergence(out[i], want)}")
    log("sampled LoadedModel.run, 2 rows with row_rngs: each row equals "
        "B=1 generate")
    return report, runs


#: The prefix-lane phase: 8 requests sharing a 360-token prefix (22
#: full pages of 16 and 8 tokens of a 23rd), tails of 20-140 tokens,
#: budgets 16-32. Every prompt runs past the 23rd page, so a hit shares
#: the 22 full pages; the copy-on-write fork of a partly matched page
#: runs only against a prompt that ends inside one (the CPU twins and
#: tests/test_torch_gpu.py run it).
PREFIX_SHARED = 360
PREFIX_REQUESTS = 8
PREFIX_GENERATE_CONFIG = dict(ENGINE_GENERATE_CONFIG,
                              engine_prefix_cache=True)


def prefix_requests(vocab):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, PREFIX_SHARED).astype(np.int32)
    tails = rng.integers(20, 141, PREFIX_REQUESTS)
    budgets = rng.integers(16, 33, PREFIX_REQUESTS)
    return [(np.concatenate([shared, rng.integers(0, vocab, int(n)).astype(
                np.int32)]), int(b), prng.PRNGKey(300 + i))
            for i, (n, b) in enumerate(zip(tails, budgets))]


def b1_unpadded(loaded, prompt, key, budget, sampling):
    """B=1 ``generate`` of the prompt as the pad-0 layout holds it."""
    device = loaded.device
    tokens, _ = generate(
        loaded._module, loaded.params,
        torch.from_numpy(prompt[None]).to(device), max_new_tokens=budget,
        rng=key[None], prompt_lengths=torch.tensor([len(prompt)],
                                                   device=device),
        **sampling)
    return tokens[0].cpu().numpy()


def serve_prefix(card, registry, params, kwargs, *,
                 cache_size=ENGINE_CACHE, device=None):
    """The prefix-cache lane through ``LoadedModel.ensure_engine``:
    request 0 alone (cold), then the other 7 at once (hits on the shared
    pages), greedy and sampled. Asserts 7 hits and 1 miss, saved prefill
    tokens, a clean pool and both invariant checks, one prefill forward
    through the prefill GEMM (224 launches) per request; prints the
    TTFTs; asserts each hit stream equal to its own cold run, each cold
    run and every stream equal to B=1 ``generate``. A tail prefill runs
    the prompt's last rows in a narrower block than the cold prefill;
    the prefill GEMM gives a row the same bits at both widths
    (scripts/decode_invariance.py, ``tail``), so the streams agree."""
    vocab = get_model(registry).num_classes_or_vocab
    requests = prefix_requests(vocab)
    kwargs = dict(kwargs, cache_size=cache_size)
    max_prompt = 512
    report = {"card": card}
    prefix_refs = {}
    for mode, sampling in (("greedy", {"temperature": 0.0}),
                           ("sampled", SAMPLING)):
        loaded = engine_model(registry, params, kwargs, max_prompt,
                              dict(PREFIX_GENERATE_CONFIG, **sampling),
                              device)
        engine = loaded.ensure_engine(name=f"smoke-prefix-{mode}")
        if engine.prefix is None:
            raise AssertionError("engine_prefix_cache did not reach the "
                                 "engine")
        with twin_calls() as twins, served_launches(engine) as counts:
            cold, cold_timing = run_engine(engine, requests[:1])
            hits, timing = run_engine(engine, requests[1:])
        # Tokens each hit took from the cache (not a multiple of the
        # page size where it forked a boundary page).
        matched = [e["args"]["prefix_matched"] for e in TRACER.snapshot()
                   if e["name"] == "engine_prefill"]
        stats = engine.stats()
        px = stats["prefix_cache"]
        engine.kv.allocator.check_invariants()
        engine.prefix.check_invariants()
        if (px["hits"] != PREFIX_REQUESTS - 1 or px["misses"] != 1
                or px["saved_prefill_tokens"] <= 0
                or stats["active_slots"] or stats["queue_depth"]
                or stats["reserved_pages"]
                or stats["free_pages"] + stats["retained_pages"]
                != stats["total_pages"] or any(twins.values())
                or counts["decode_gemm"] != STEP_LAUNCHES["decode_gemm"] * (
                    cold_timing["decode_steps"] + timing["decode_steps"])
                + PREFILL_HEAD_LAUNCHES * PREFIX_REQUESTS
                or counts["decode_attention"]
                != STEP_LAUNCHES["decode_attention"] * (
                    cold_timing["decode_steps"] + timing["decode_steps"])
                or counts["prefill_gemm"]
                != PREFILL_LAUNCHES * PREFIX_REQUESTS
                or counts["flash_attention"]
                != PREFILL_ATTENTION_LAUNCHES * PREFIX_REQUESTS
                or not fused_norms_ok(counts)):
            raise AssertionError(f"prefix {mode}: stats {stats}, launches "
                                 f"{counts}, plain twins called {twins}")
        results = cold + hits
        for (prompt, budget, _), got in zip(requests, results):
            if got.shape != (budget,) or not ((got >= 0)
                                              & (got < vocab)).all():
                raise AssertionError(f"prefix {mode}: tokens {got.shape}, "
                                     f"budget {budget}")
        # Each hit request again, alone and cold.
        recold = []
        for prompt, budget, key in requests[1:]:
            engine.clear_prefix_cache()
            recold.append(engine.submit(prompt, rng=key,
                                        max_new_tokens=budget).result(600))
        engine.clear_prefix_cache()
        if engine.stats()["free_pages"] != engine.stats()["total_pages"]:
            raise AssertionError(f"prefix {mode}: pages leaked after clear: "
                                 f"{engine.stats()}")
        refs = [b1_unpadded(loaded, p, k, b, sampling)
                for p, b, k in requests]
        prefix_refs[mode] = refs
        row = {
            "ttft_ms_cold": cold_timing["ttft_ms"][0],
            "ttft_ms_hits": timing["ttft_ms"],
            "inter_token_ms": timing["inter_token_ms"],
            "tokens_per_s_hits": timing["tokens_per_s"],
            "prefix_cache": px,
            "prefix_matched": matched,
            "launches": counts,
            "hit_equals_own_cold_run": sum(
                np.array_equal(h, c) for h, c in zip(hits, recold)),
            "hit_vs_cold_first_divergence": [
                first_divergence(h, c) for h, c in zip(hits, recold)],
            "streams_equal_b1": sum(
                np.array_equal(g, w) for g, w in zip(results, refs)),
            "b1_first_divergence": [first_divergence(g, w)
                                    for g, w in zip(results, refs)],
            "cold_runs_equal_b1": sum(
                np.array_equal(c, w) for c, w in zip(recold, refs[1:])),
        }
        report[mode] = row
        log(f"prefix lane {mode}, 1 cold + {PREFIX_REQUESTS - 1} hits, "
            f"4 slots: {json.dumps(row)}")
        loaded.close()
        hits_n = PREFIX_REQUESTS - 1
        if (row["hit_equals_own_cold_run"] != hits_n
                or row["cold_runs_equal_b1"] != hits_n
                or row["streams_equal_b1"] != PREFIX_REQUESTS):
            raise AssertionError(
                f"prefix {mode}: {row['hit_equals_own_cold_run']} of "
                f"{hits_n} hits equal their own cold run (first divergent "
                f"steps {row['hit_vs_cold_first_divergence']}), "
                f"{row['cold_runs_equal_b1']} cold runs and "
                f"{row['streams_equal_b1']} of {PREFIX_REQUESTS} streams "
                f"equal B=1 (first divergent steps "
                f"{row['b1_first_divergence']})")
    return report, prefix_refs


def decode_step_launches(card, registry, params):
    """Kernel launches of one engine-shaped decode step (llama3-8b, 4
    rows over a 544-slot cache, greedy), from the profiler: through the
    port's decode kernels, and through the plain ops the port ran
    before them (cuBLAS linears, the RMSNorm formula, dense_attention)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    model = get_model(registry).make(dtype="bfloat16",
                                     cache_size=ENGINE_CACHE)
    n = len(DECODE_POSITIONS)
    shape = (n, ENGINE_CACHE, model.num_kv_heads, model.head_dim)
    cache = [LayerCache(torch.zeros(shape, dtype=torch.bfloat16,
                                    device="cuda"),
                        torch.zeros(shape, dtype=torch.bfloat16,
                                    device="cuda"))
             for _ in range(model.num_layers)]
    pos = torch.tensor(DECODE_POSITIONS, device="cuda")
    tok = torch.zeros((n, 1), dtype=torch.long, device="cuda")
    pads = torch.zeros(n, dtype=torch.int32, device="cuda")

    def step():
        with torch.inference_mode():
            logits = apply(model, params, tok, pos[:, None],
                           pad_lengths=pads, decode_positions=pos,
                           cache=cache)[:, 0]
            return _sample_logits(logits, None, 0.0, None, None)

    def count():
        step()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            step()
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) * 1e3
        rows = [r for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA]
        return {"launches": sum(r.count for r in rows),
                "device_ms": sum(r.self_device_time_total
                                 for r in rows) / 1e3,
                "wall_ms_profiled": wall}

    out = {"card": card, "port": count()}
    saved = (llama.decode_linear, llama.rms_norm, llama.add_rms_norm,
             llama.decode_attention)
    llama.decode_linear = F.linear
    llama.rms_norm = rn.rms_norm_reference
    llama.add_rms_norm = rn.add_rms_norm_reference
    llama.decode_attention = lambda q, k, v, valid: dense_attention(
        q, k, v, kv_segment_valid=valid)
    try:
        out["plain_ops"] = count()
    finally:
        (llama.decode_linear, llama.rms_norm, llama.add_rms_norm,
         llama.decode_attention) = saved
    log(f"decode step launches (4 rows, cache {ENGINE_CACHE}): "
        f"{json.dumps(out)} (generate's decode profiled before the decode "
        f"kernels: ~3,400 a step)")
    return out


#: The fp32 head's rows on the decode GEMM's fp32 route, at the lm_head's
#: shape: a decode step's M = 1 and 4, 16, a speculative verify's
#: 4 slots × 5 tokens = 20, a whole pass's 32, and 40 (a second pass).
FP32_HEAD_ROWS = (1, 4, 16, 20, 32, 40)
#: The fp32 route's earlier design, kept as a copy to time beside today's.
EARLIER_FP32 = os.path.join(ROOT, "scripts", "earlier",
                            "decode_gemm_fp32_row_tiles.cu")


def earlier_fp32_route():
    """The earlier fp32 design, ``(x, W) -> y``, built from its copy as
    ``scripts/gemm_ab.py`` builds earlier designs."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import gemm_ab

    lib = gemm_ab.build_copy(EARLIER_FP32, "decode_gemm_fp32")
    gemm_ab.bind(lib, "kft_decode_gemm", 4)
    return gemm_ab.earlier_decode(lib)


def fp32_head_rows(earlier):
    """The decode GEMM's fp32 route at the lm_head's [4096→128256], M in
    FP32_HEAD_ROWS: within 1e-5·max(1, |y|) of its plain version, the
    same bits on a second call, every row equal to itself computed
    alone, and one pass over W up to M = 32. Device ms (the profiler's,
    W read from device memory) in turns with the earlier design and
    F.linear (earlier, today, F.linear, F.linear, today, earlier),
    beside the bound."""
    fp32 = torch.float32
    k, n = 4096, 128256
    gen = torch.Generator(device="cuda").manual_seed(8)
    w = torch.randn(n, k, device="cuda", generator=gen) * 0.02
    x = torch.randn(max(FP32_HEAD_ROWS), k, device="cuda", generator=gen)
    fns = {"earlier": earlier, "today": dg.decode_linear,
           "F.linear": F.linear}
    rows = []
    for m in FP32_HEAD_ROWS:
        xs = x[:m]
        got = dg.decode_linear(xs, w)
        torch.cuda.synchronize()
        want = dg.decode_linear_reference(xs, w)
        err = float((got - want).abs().max())
        tol = DECODE_TOL[fp32] * max(1.0, float(want.abs().max()))
        earlier_err = float((earlier(xs, w) - want).abs().max())
        if not torch.isfinite(got).all() or err > tol or earlier_err > tol:
            raise AssertionError(f"fp32 head M={m}: max |Δ| {err} "
                                 f"(earlier design {earlier_err}) > {tol}")
        if not torch.equal(dg.decode_linear(xs, w), got):
            raise AssertionError(f"fp32 head M={m}: a second call gave "
                                 "other bits")
        for i in range(m):
            if not torch.equal(dg.decode_linear(xs[i:i + 1], w),
                               got[i:i + 1]):
                raise AssertionError(f"fp32 head: row {i} of M={m} differs "
                                     "from the row alone")
        passes = dg.launch_plan(fp32, m, n, k).grid_y
        if passes != -(-m // dg.ROWS_PER_PASS):
            raise AssertionError(f"fp32 head M={m}: {passes} passes over W")
        times = {impl: [] for impl in fns}
        for impl in ("earlier", "today", "F.linear", "F.linear", "today",
                     "earlier"):
            fn = fns[impl]
            times[impl].append(profiled_ms(lambda: fn(xs, w)))
        b_ms, b_by = bound((n * k + m * k + m * n) * 4, 2.0 * m * n * k,
                           fp32)
        row = {"shape": f"lm_head [4096→128256] fp32 M={m}", "m": m,
               "passes_over_w": passes, "max_abs_err": err, "tol": tol,
               "device_ms": times["today"],
               "earlier_device_ms": times["earlier"],
               "library_device_ms": times["F.linear"],
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / min(times["today"])}
        log(f"fp32 head {json.dumps(row)}")
        rows.append(row)
    del w, x
    torch.cuda.empty_cache()
    return rows


#: Speculative decoding on the engine mix: draft tokens a round.
SPEC_K = 4
#: The weak draft: one layer at llama3-8b's widths, from another seed.
WEAK_DRAFT_SEED = 9


def weak_draft(registry, cache_size, device=None):
    """A 1-layer Llama at the model's widths, random from another seed:
    its proposals are noise (acceptance near 0), and its steps run the
    decode kernels at the shapes a full model's step gives them."""
    full = get_model(registry).make()
    model = llama.Llama(
        vocab_size=full.vocab_size, num_layers=1, d_model=full.d_model,
        num_heads=full.num_heads, num_kv_heads=full.num_kv_heads,
        mlp_dim=full.mlp_dim, rope_theta=full.rope_theta,
        dtype="bfloat16", cache_size=cache_size)
    return model, init_params(model, seed=WEAK_DRAFT_SEED, device=device)


def spec_engine(loaded, name, draft, **engine_kw):
    """The engine ``LoadedModel.ensure_engine`` builds from ``loaded``'s
    export config, with ``draft`` ((module, params)) as its speculative
    draft, as an export naming a draft gets (``engine_kw``: the
    ``DecodeEngine`` switch for an uncaptured comparison engine)."""
    (_, spec), = loaded.signature().inputs.items()
    config = EngineConfig.from_generate_config(
        loaded.metadata.generate_config, spec.shape[1])
    return DecodeEngine(loaded._module, loaded.params, config, name=name,
                        device=loaded.device, draft_model=draft[0],
                        draft_params=draft[1], **engine_kw)


def serve_spec(card, registry, params, kwargs, vanilla, *,
               cache_size=ENGINE_CACHE, device=None):
    """Speculative decoding on the engine mix (4 slots, k = SPEC_K),
    greedy and sampled, with the strong draft (the model itself: the
    same params, its own dense cache) and the weak one. Asserts every
    stream equal to the vanilla engine's (``vanilla``: serve_engine's
    runs) and B=1's, the strong draft's acceptance above 0.5, rounds
    run, a clean pool, every decode kernel and the prefill GEMM
    launched and every prefill's attention on flash (no CUDA tensor at a
    plain twin). Reports the acceptance,
    verifier forwards per emitted token, inter-token ms and tokens/s
    beside the vanilla engine's."""
    vocab = get_model(registry).num_classes_or_vocab
    requests = engine_requests(vocab)
    kwargs = dict(kwargs, cache_size=cache_size)
    config = dict(ENGINE_GENERATE_CONFIG, engine_draft_tokens=SPEC_K)
    drafts = {"strong": None,
              "weak": weak_draft(registry, cache_size, device)}
    report = {"card": card, "k": SPEC_K}
    for draft_name, draft in drafts.items():
        for mode, sampling in (("greedy", {"temperature": 0.0}),
                               ("sampled", SAMPLING)):
            loaded = engine_model(registry, params, kwargs,
                                  max(ENGINE_PROMPTS),
                                  dict(config, **sampling), device)
            engine = spec_engine(
                loaded, f"smoke-spec-{draft_name}-{mode}",
                (loaded._module, loaded.params) if draft is None else draft)
            try:
                with twin_calls() as twins, served_launches(engine) as counts:
                    results, timing = run_engine(engine, requests)
                stats = check_engine_pool(engine, len(requests))
            finally:
                engine.stop()
            spec = stats["spec"]
            want, refs, plain = vanilla[mode]
            tokens = sum(len(r) for r in results)
            row = {
                "acceptance_rate": spec["acceptance_rate"],
                "rounds": spec["rounds"],
                "verify_forwards_per_token": spec["rounds"] / tokens,
                "slot_verify_forwards_per_token":
                    spec["drafted_tokens"] / SPEC_K / tokens,
                "inter_token_ms": timing["inter_token_ms"],
                "inter_token_ms_range": timing["inter_token_ms_range"],
                "tokens_per_s": timing["tokens_per_s"],
                "vanilla_inter_token_ms": plain["inter_token_ms"],
                "vanilla_tokens_per_s": plain["tokens_per_s"],
                "ttft_ms": timing["ttft_ms"],
                "launches": counts,
                "streams_equal_vanilla": sum(
                    np.array_equal(g, w) for g, w in zip(results, want)),
                "streams_equal_b1": sum(
                    np.array_equal(g, w) for g, w in zip(results, refs)),
                "first_divergence": [first_divergence(g, w)
                                     for g, w in zip(results, refs)],
            }
            report[f"{draft_name} {mode}"] = row
            log(f"spec {draft_name} draft {mode}, k={SPEC_K}: "
                f"{json.dumps(row)}")
            if (row["streams_equal_vanilla"] != len(requests)
                    or row["streams_equal_b1"] != len(requests)
                    or spec["rounds"] <= 0
                    or (draft is None and spec["acceptance_rate"] <= 0.5)
                    or not prefills_on_flash(counts) or any(twins.values())
                    or not all(counts[k] for k in (
                        "decode_gemm", "rms_norm", "add_rms_norm",
                        "decode_attention", "prefill_gemm"))):
                raise AssertionError(
                    f"spec {draft_name} {mode}: {row}, stats {stats}, "
                    f"plain twins called {twins}")
            loaded.close()
    log(f"{registry} speculative decoding: {json.dumps(report)}")
    return report


#: The chunked-prefill phase: the prefix lane's chunk, and one long
#: prompt admitted while the prefix mix decodes.
PREFILL_CHUNK = 64
LONG_PROMPT, LONG_BUDGET = 512, 16


def run_with_long(engine, requests, long_request):
    """Submit ``requests`` at once; once every one of them is admitted
    (each has streamed a token, none is queued), submit
    ``long_request``, so its admission is the only one while the others
    decode. Returns every stream's tokens (``requests`` then the long
    one) and the largest gap between two token events of another stream
    while the long prompt was being admitted (its submit to its first
    token), in ms."""
    events = {}
    streams = []

    def submit(prompt, budget, key):
        stream = engine.submit(prompt, rng=key, max_new_tokens=budget)
        times = events.setdefault(len(streams), [])
        stream.set_notify(lambda times=times: times.append(
            time.monotonic()))
        streams.append(stream)
        return stream

    for prompt, budget, key in requests:
        submit(prompt, budget, key)
    deadline = time.monotonic() + 600
    while not all(s.tokens_so_far for s in streams):
        if time.monotonic() > deadline:
            raise AssertionError("a request was never admitted")
        time.sleep(0.002)
    t_submit = time.monotonic()
    long_stream = submit(*long_request)
    results = [s.result(timeout=600) for s in streams]
    t_first = events[len(streams) - 1][0]
    gap = 0.0
    for i, times in events.items():
        if i == len(streams) - 1:
            continue
        for a, b in zip(times, times[1:]):
            if b > t_submit and a < t_first:
                gap = max(gap, b - a)
    del long_stream
    return results, gap * 1e3


def serve_chunked(card, registry, params, kwargs, *,
                  cache_size=ENGINE_CACHE, device=None):
    """Chunked prefill composed with speculative decoding (the strong
    draft, k = SPEC_K): the prefix lane with ``engine_prefill_chunk`` =
    PREFILL_CHUNK, on the prefix mix (request 0 cold, then 7 at once)
    plus a LONG_PROMPT-token prompt admitted while they decode, greedy
    and sampled; and the same engine without chunking. Asserts every
    chunked stream equal to the unchunked engine's and to B=1, a clean
    pool, every kernel of the path launched and every chunk's attention
    on flash; reports the decoding
    neighbours' largest inter-token gap while the long prompt is
    admitted, chunked against one-shot."""
    vocab = get_model(registry).num_classes_or_vocab
    requests = prefix_requests(vocab)
    rng = np.random.default_rng(1)
    long_request = (rng.integers(0, vocab, LONG_PROMPT).astype(np.int32),
                    LONG_BUDGET, prng.PRNGKey(400))
    kwargs = dict(kwargs, cache_size=cache_size)
    report = {"card": card, "chunk": PREFILL_CHUNK, "k": SPEC_K}
    b1 = {}
    for mode, sampling in (("greedy", {"temperature": 0.0}),
                           ("sampled", SAMPLING)):
        runs = {}
        for lane, extra in (("chunked",
                             {"engine_prefill_chunk": PREFILL_CHUNK}),
                            ("one_shot", {})):
            loaded = engine_model(
                registry, params, kwargs, LONG_PROMPT,
                dict(PREFIX_GENERATE_CONFIG, engine_draft_tokens=SPEC_K,
                     **extra, **sampling), device)
            engine = spec_engine(loaded, f"smoke-{lane}-{mode}",
                                 (loaded._module, loaded.params))
            try:
                with twin_calls() as twins, served_launches(engine) as counts:
                    prompt, budget, key = requests[0]
                    cold = engine.submit(prompt, rng=key,
                                         max_new_tokens=budget).result(600)
                    results, gap = run_with_long(engine, requests[1:],
                                                 long_request)
                stats = engine.stats()
                engine.kv.allocator.check_invariants()
                engine.prefix.check_invariants()
            finally:
                engine.stop()
            if (stats["active_slots"] or stats["queue_depth"]
                    or stats["reserved_pages"]
                    or stats["free_pages"] + stats["retained_pages"]
                    != stats["total_pages"] or any(twins.values())
                    or not prefills_on_flash(counts)
                    or not all(counts[k] for k in (
                        "decode_gemm", "rms_norm", "add_rms_norm",
                        "decode_attention", "prefill_gemm"))
                    or stats.get("prefill_chunk") != extra.get(
                        "engine_prefill_chunk")):
                raise AssertionError(f"{lane} {mode}: stats {stats}, "
                                     f"launches {counts}, plain twins "
                                     f"called {twins}")
            runs[lane] = {"streams": [cold] + results, "gap_ms": gap,
                          "launches": counts,
                          "acceptance_rate": stats["spec"][
                              "acceptance_rate"]}
            loaded.close()
        refs = [b1_unpadded(loaded, p, k, b, sampling)
                for p, b, k in requests + [long_request]]
        b1[mode] = refs
        chunked, one_shot = runs["chunked"], runs["one_shot"]
        row = {
            "neighbour_max_gap_ms_chunked": chunked["gap_ms"],
            "neighbour_max_gap_ms_one_shot": one_shot["gap_ms"],
            "acceptance_rate": chunked["acceptance_rate"],
            "launches_chunked": chunked["launches"],
            "streams_equal_one_shot": sum(
                np.array_equal(a, b) for a, b in zip(chunked["streams"],
                                                     one_shot["streams"])),
            "streams_equal_b1": sum(
                np.array_equal(a, b) for a, b in zip(chunked["streams"],
                                                     refs)),
            "one_shot_streams_equal_b1": sum(
                np.array_equal(a, b) for a, b in zip(one_shot["streams"],
                                                     refs)),
            "b1_first_divergence": [first_divergence(a, b) for a, b in
                                    zip(chunked["streams"], refs)],
        }
        report[mode] = row
        log(f"chunked prefill {mode} (chunk {PREFILL_CHUNK}, spec k="
            f"{SPEC_K}), prefix mix + a {LONG_PROMPT}-token prompt: "
            f"{json.dumps(row)}")
        n = len(refs)
        if (row["streams_equal_one_shot"] != n or row["streams_equal_b1"]
                != n or row["one_shot_streams_equal_b1"] != n):
            raise AssertionError(f"chunked {mode}: {row}")
    return report, b1


#: The programs a captured engine runs as CUDA graphs, by engine_compile
#: program name (kubeflow_tpu_torch/inference/engine/graphs.py).
CAPTURED = ("decode_slice", "spec_draft", "spec_verify", "prefill")


#: The modes whose passes run under the profiler for the device's idle
#: share (``serve_captured``'s replayed pass and its uncaptured pass,
#: ``serve_manager``'s pass):
#: greedy alone. A sampled pass runs the same kernels and the sampler's
#: few; profiling it too cost ~70 s of the smoke's time limit.
PROFILED_MODES = ("greedy",)


def device_window(fn):
    """``fn()`` under the profiler's CUDA activity, then a synchronise:
    its result, and the window's wall ms (host clock), the device's busy
    ms (every kernel, copy and set it ran, summed), the idle share
    1 - busy / wall, the device launches, each kernel's launches and
    the bf16 elementwise adds (PyTorch's add kernel on bf16: a residual
    add outside the fused norm would be one)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]
    busy = sum(r.self_device_time_total for r in rows) / 1e3
    return out, {"wall_ms": wall, "device_ms": busy,
                 "idle_share": max(0.0, 1.0 - busy / wall),
                 "launches": sum(r.count for r in rows),
                 "kernels": kernel_counts(prof),
                 "bf16_adds": sum(r.count for r in rows
                                  if "CUDAFunctor_add" in r.key
                                  and "BFloat16" in r.key)}


def captured_mixes(vocab):
    """The four mixes as their phases run them: (name, generate config,
    strong draft?, max prompt, requests)."""
    return [
        ("engine", ENGINE_GENERATE_CONFIG, False, max(ENGINE_PROMPTS),
         engine_requests(vocab)),
        ("prefix", PREFIX_GENERATE_CONFIG, False, 512,
         prefix_requests(vocab)),
        ("spec", dict(ENGINE_GENERATE_CONFIG, engine_draft_tokens=SPEC_K),
         True, max(ENGINE_PROMPTS), engine_requests(vocab)),
        ("chunk", dict(PREFIX_GENERATE_CONFIG, engine_draft_tokens=SPEC_K,
                       engine_prefill_chunk=PREFILL_CHUNK),
         True, LONG_PROMPT, prefix_requests(vocab)),
    ]


def run_mix(engine, mix, requests, long_request):
    """One pass of a mix as its phase runs it (the engine and spec mixes
    at once; the prefix mix's request 0 cold, then the 7 at once; the
    chunk mix's request 0, then the 7 with the long prompt admitted once
    they decode). Returns the streams and the pass's median inter-token
    ms. The prefix index is cleared after a pass, so each pass takes the
    same path."""
    if mix in ("engine", "spec"):
        streams, timing = run_engine(engine, requests)
        return streams, timing["inter_token_ms"]
    cold, _ = run_engine(engine, requests[:1])
    TRACER.clear()
    if mix == "prefix":
        rest, _ = run_engine(engine, requests[1:])
    else:
        rest, _ = run_with_long(engine, requests[1:], long_request)
    inter = slice_inter_ms([e for e in TRACER.snapshot()
                            if e["name"] == "engine_slice"])
    engine.clear_prefix_cache()
    return cold + rest, statistics.median(inter)


def serve_captured(card, registry, params, kwargs, refs, *,
                   cache_size=ENGINE_CACHE, device=None):
    """The engine, prefix, spec and chunk mixes on a captured engine
    (every plain slice, speculative draft and verify and classic
    admission prefill a CUDA graph, graphs.py), greedy and sampled:
    captured (its graphs captured on first use), captured again
    (replays) and, in the engine mix, uncaptured. ``refs`` holds, by
    mix and mode, the B=1 ``generate`` streams the earlier phases drew
    and held their uncaptured engines to (``serve_engine``'s for the
    engine and spec mixes, ``serve_prefix``'s for the prefix mix,
    ``serve_chunked``'s, the long prompt's included, for the chunk
    mix): every pass's streams must equal them, so each captured stream
    equals the uncaptured engine's. Also asserted: one graph per
    engine_compile key of a captured program, and in the replayed pass
    no decode attention launch from a wrapper (every decode step
    replayed) and, in the engine mix, no wrapper launch at all; no plain
    twin called in any pass. Reports inter-token ms of both engines, the
    graphs against the distinct engine_compile keys and, in the engine
    mix: the device idle share and each kernel's launches of both
    greedy second passes (``PROFILED_MODES``) and of one captured 4-step
    slice replayed alone, and a classic admission (the 512-token request
    alone, budget 1) on both engines, its device ms beside its
    host-clock TTFT."""
    vocab = get_model(registry).num_classes_or_vocab
    kwargs = dict(kwargs, cache_size=cache_size)
    rng = np.random.default_rng(1)
    long_request = (rng.integers(0, vocab, LONG_PROMPT).astype(np.int32),
                    LONG_BUDGET, prng.PRNGKey(400))
    report = {"card": card}
    for mix, config, strong, max_prompt, requests in captured_mixes(vocab):
        for mode, sampling in MODES:
            loaded = engine_model(registry, params, kwargs, max_prompt,
                                  dict(config, **sampling), device)
            draft = (loaded._module, loaded.params) if strong else None
            # The engine mix alone runs an uncaptured pass here (its
            # profiled window); the other mixes' uncaptured streams are
            # their phases'.
            engines = {
                captured: (spec_engine(loaded, f"smoke-graphs-{mix}-{mode}",
                                       draft, capture_graphs=captured)
                           if strong else DecodeEngine(
                               loaded._module, loaded.params,
                               EngineConfig.from_generate_config(
                                   loaded.metadata.generate_config,
                                   max_prompt),
                               name=f"smoke-graphs-{mix}-{mode}",
                               device=loaded.device,
                               capture_graphs=captured))
                for captured in ((False, True) if mix == "engine"
                                 else (True,))}
            eager, graphs = engines.get(False), engines[True]
            try:
                passes, inter, windows = {}, {}, {}
                with twin_calls() as twins:
                    for name, engine in (("captured 1", graphs),
                                         ("captured 2", graphs),
                                         ("eager", eager)):
                        if engine is None:
                            continue
                        zero_counts()
                        if (mix == "engine" and name != "captured 1"
                                and mode in PROFILED_MODES):
                            (streams, ms), window = device_window(
                                functools.partial(run_mix, engine, mix,
                                                  requests, long_request))
                            windows[name] = window
                        else:
                            streams, ms = run_mix(engine, mix, requests,
                                                  long_request)
                        passes[name] = (streams, read_counts())
                        inter[name] = ms
                want = refs[{"spec": "engine"}.get(mix, mix)][mode]
                equal = {name: sum(np.array_equal(g, w)
                                   for g, w in zip(streams, want))
                         for name, (streams, _) in passes.items()}
                keys = set(graphs._graphs.programs)
                compiled = set(graphs._compile_seen)
                replayed = passes["captured 2"][1]
                row = {
                    "streams_equal_b1": equal,
                    "inter_token_ms": inter,
                    "graphs": len(keys),
                    "engine_compile_keys": len(compiled),
                    "graph_keys": sorted(" ".join(k) for k in keys),
                    "replays": graphs._graphs.replays(),
                    "launches_replayed_pass": replayed,
                    "plain_twin_calls": twins,
                }
                if mix == "engine":
                    row["pass_windows"] = windows
                    row.update(captured_engine_extras(
                        eager, graphs, requests))
                report[f"{mix} {mode}"] = row
                log(f"captured {mix} {mode}: {json.dumps(row)}")
                bad = [
                    any(n != len(want) or len(streams) != len(want)
                        for n, (streams, _) in zip(equal.values(),
                                                   passes.values())),
                    keys != {k for k in compiled if k[0] in CAPTURED},
                    graphs.captured_keys() != keys,
                    replayed["decode_attention"] != 0,
                    mix == "engine" and any(replayed.values()),
                    any(twins.values()),
                ]
                if any(bad):
                    raise AssertionError(
                        f"captured {mix} {mode}: {row}; failed checks "
                        f"{[i for i, b in enumerate(bad) if b]}")
            finally:
                for engine in engines.values():
                    engine.stop()
                loaded.close()
    log(f"{registry} captured decode programs: {json.dumps(report)}")
    return report


def captured_engine_extras(eager, graphs, requests):
    """The engine mix's device windows: one captured 4-step slice
    replayed alone (each kernel's launches beside a 4-step slice's
    STEP_LAUNCHES; its norm kernels and no bf16 add asserted), and a
    classic admission (the 512-token request, budget 1, alone on an idle
    engine) on each engine, its device ms beside its host-clock TTFT."""
    out = {}
    program = graphs._graphs.programs[("decode_slice", "steps=4 slots=4")]
    _, out["slice_replay_window"] = device_window(program.graph.replay)
    # What the card ran, by kernel, beside a 4-step slice's launches.
    window = out["slice_replay_window"]
    window["kernels_expected"] = dict(
        dict.fromkeys(KERNEL_NAMES, 0),
        **{k: 4 * n for k, n in STEP_LAUNCHES.items()})
    # 65 norm kernels a step, 64 of them fused with the residual add
    # before them, and no residual add of its own beside them.
    if (any(window["kernels"][k] != window["kernels_expected"][k]
            for k in ("rms_norm", "add_rms_norm")) or window["bf16_adds"]):
        raise AssertionError(f"a replayed 4-step slice ran {window}")
    prompt, _, key = requests[1]
    for name, engine in (("uncaptured", eager), ("captured", graphs)):
        (_, timing), window = device_window(functools.partial(
            run_engine, engine, [(prompt, 1, key)]))
        out[f"admission_{name}"] = dict(window, ttft_ms=timing["ttft_ms"][0])
    return out


#: Slice 11's lanes. Resume kills three engine-mix requests (the
#: 300-token prompt; the 512-token one, whose context passes
#: max_prompt_len; the 77-token one) after the first token, the middle
#: and budget - 1.
RESUME_REQUESTS = (0, 1, 2)
#: The host-tier phase: one slot and 34 usable pages, one request's
#: worth at the longest prefix-mix request, so a filler of another
#: 512-token prompt between rounds evicts the 360-token prefix; 256 MB
#: of host RAM holds it (about 2 MB a page at llama3-8b).
HOST_TIER_PAGES = 35
HOST_TIER_BYTES = 256 << 20
HOST_TIER_REQUESTS = (0, 1, 2)
MODES = (("greedy", {"temperature": 0.0}), ("sampled", SAMPLING))


def kill_points(budget):
    return (1, budget // 2, budget - 1)


def prefill_launches_ok(counts, forwards, decode_steps):
    """``forwards`` prefill forwards (224 prefill GEMM, 32 flash, one
    decode GEMM for the head's row each) and ``decode_steps`` decode
    steps, and nothing else."""
    return (counts["prefill_gemm"] == PREFILL_LAUNCHES * forwards
            and counts["flash_attention"]
            == PREFILL_ATTENTION_LAUNCHES * forwards
            and counts["decode_gemm"]
            == STEP_LAUNCHES["decode_gemm"] * decode_steps
            + PREFILL_HEAD_LAUNCHES * forwards
            and counts["decode_attention"]
            == STEP_LAUNCHES["decode_attention"] * decode_steps)


def traced_decode_steps():
    """Decode steps of the engine_slice spans since TRACER.clear()."""
    return sum(e["args"]["steps"] for e in TRACER.snapshot()
               if e["name"] == "engine_slice")


def handoff_blob(handoff, timing):
    """A handoff through the wire and back, timed."""
    t0 = time.monotonic()
    blob = wire.encode_kv_handoff(LLAMA, 1, handoff)
    t1 = time.monotonic()
    carried = wire.decode_kv_handoff(blob, model=LLAMA, version=1)
    timing["blob_bytes"].append(len(blob))
    timing["encode_ms"].append((t1 - t0) * 1e3)
    timing["decode_ms"].append((time.monotonic() - t1) * 1e3)
    return carried


def serve_handoff(card, registry, params, kwargs, vanilla, prefix_refs, *,
                  cache_size=ENGINE_CACHE, device=None):
    """KV handoff, greedy and sampled. Classic lane: engine A's
    ``run_prefill`` of each engine-mix request, the blob through
    ``wire`` both ways, ``submit(handoff=)`` on engine B, all six at
    once. Prefix lane: a prefill-role engine (chunks of PREFILL_CHUNK)
    on the prefix mix, its right-layout blobs adopted by a decode-role
    engine. Asserts every adopted stream equal to the local engine's
    and B=1 (classic; ``vanilla``) or B=1 (prefix; ``prefix_refs``),
    the prefill-role engine's hits, the decode engine's index holding
    the carried prefix, clean pools, each prefill forward's launches
    and none in the adopting engine's prefills. Prints the blob's bytes,
    encode and decode ms and the admissions' adopt ms."""
    vocab = get_model(registry).num_classes_or_vocab
    kwargs = dict(kwargs, cache_size=cache_size)
    report = {"card": card}
    for lane, requests in (("classic", engine_requests(vocab)),
                           ("prefix", prefix_requests(vocab))):
        for mode, sampling in MODES:
            if lane == "classic":
                config = dict(ENGINE_GENERATE_CONFIG, **sampling)
                want = list(zip(*vanilla[mode][:2]))
            else:
                config = dict(PREFIX_GENERATE_CONFIG,
                              engine_prefill_chunk=PREFILL_CHUNK, **sampling)
                want = [(r, r) for r in prefix_refs[mode]]
            loaded = engine_model(registry, params, kwargs,
                                  max(ENGINE_PROMPTS), config, device)
            prefill = loaded.ensure_engine(name=f"smoke-handoff-{lane}-"
                                           f"prefill-{mode}")
            decode = DecodeEngine(
                loaded._module, loaded.params,
                dataclasses.replace(prefill.config, prefill_chunk=0),
                name=f"smoke-handoff-{lane}-decode-{mode}",
                device=loaded.device)
            blobs = {"blob_bytes": [], "encode_ms": [], "decode_ms": []}
            try:
                with twin_calls() as twins:
                    with served_launches(prefill) as at_prefill:
                        handoffs = [prefill.run_prefill(p, rng=k,
                                                        max_new_tokens=b)
                                    for p, b, k in requests]
                    carried = [handoff_blob(h, blobs) for h in handoffs]
                    with served_launches(decode) as counts:
                        results, timing = run_streams(decode, [
                            functools.partial(decode.submit, handoff=h)
                            for h in carried])
                adopt = [e["dur"] / 1e3 for e in TRACER.snapshot()
                         if e["name"] == "engine_prefill"
                         and e["args"].get("adopted")]
                pstats, dstats = prefill.stats(), decode.stats()
                row = {
                    "blob_bytes": blobs["blob_bytes"][0],
                    "encode_ms": blobs["encode_ms"],
                    "decode_ms": blobs["decode_ms"],
                    "adopt_ms": adopt,
                    "ttft_ms": timing["ttft_ms"],
                    "inter_token_ms": timing["inter_token_ms"],
                    "launches_prefill": at_prefill,
                    "launches_adopting": counts,
                    "streams_equal_local": sum(
                        np.array_equal(g, w[0])
                        for g, w in zip(results, want)),
                    "streams_equal_b1": sum(
                        np.array_equal(g, w[1])
                        for g, w in zip(results, want)),
                    "first_divergence": [first_divergence(g, w[1])
                                         for g, w in zip(results, want)],
                }
                if lane == "prefix":
                    row["prefill_role_prefix_cache"] = pstats["prefix_cache"]
                    row["decode_role_matched"] = decode.probe_prefix(
                        requests[0][0])
                report[f"{lane} {mode}"] = row
                log(f"handoff {lane} {mode}, {len(requests)} requests: "
                    f"{json.dumps(row)}")
                layouts = {h.layout for h in handoffs}
                # One prefill forward a request, at least one a request
                # in the prefix lane's chunks: 224 prefill GEMM, 32
                # flash and one head on the decode GEMM each.
                forwards = len(requests) if lane == "classic" else max(
                    len(requests),
                    at_prefill["flash_attention"] // PREFILL_ATTENTION_LAUNCHES)
                bad = [
                    row["streams_equal_b1"] != len(requests),
                    row["streams_equal_local"] != len(requests),
                    layouts != {"left" if lane == "classic" else "right"},
                    not prefill_launches_ok(at_prefill, forwards, 0),
                    not prefill_launches_ok(counts, 0,
                                            timing["decode_steps"]),
                    any(twins.values()),
                    dstats["active_slots"] or dstats["reserved_pages"],
                    dstats["admitted"] != len(requests),
                ]
                if lane == "classic":
                    bad += [dstats["free_pages"] != dstats["total_pages"],
                            pstats["admitted"] != 0]
                else:
                    bad += [pstats["prefix_cache"]["hits"] <= 0,
                            pstats["retired"] != {
                                "prefill_handoff": len(requests)},
                            row["decode_role_matched"]
                            < PREFIX_SHARED - PREFIX_SHARED % 16]
                    decode.kv.allocator.check_invariants()
                    decode.prefix.check_invariants()
                    decode.clear_prefix_cache()
                    if decode.stats()["free_pages"] != \
                            decode.stats()["total_pages"]:
                        bad.append("pages leaked")
                if any(bad):
                    raise AssertionError(
                        f"handoff {lane} {mode}: {row}; prefill-role "
                        f"stats {pstats}; decode-role stats {dstats}; "
                        f"failed checks {[i for i, b in enumerate(bad) if b]};"
                        f" plain twins called {twins}")
            finally:
                decode.stop()
                loaded.close()
    log(f"{registry} KV handoff: {json.dumps(report)}")
    return report


#: A split resume's replay forward of n emitted tokens (n <= 32): 7
#: projections a layer and the head's row on the decode GEMM, two norms a
#: layer and the final one, one decode attention launch a layer for each
#: token, and no prefill GEMM; its prompt's prefill forward is a
#: prefill's (PREFILL_LAUNCHES, PREFILL_ATTENTION_LAUNCHES, the head's
#: row), with its norms (2 a layer and the final one at the row read).
REPLAY_LAUNCHES = {"decode_gemm": 7 * 32 + 1, "rms_norm": 2 * 32 + 1}


def resume_launches_ok(counts, resumes, emitted, decode_steps):
    """``resumes`` split resumes of ``emitted`` emitted tokens in all,
    each one prompt prefill forward and one replay forward, then
    ``decode_steps`` decode steps, and nothing else."""
    return (counts["prefill_gemm"] == PREFILL_LAUNCHES * resumes
            and counts["flash_attention"]
            == PREFILL_ATTENTION_LAUNCHES * resumes
            and counts["decode_gemm"]
            == STEP_LAUNCHES["decode_gemm"] * decode_steps
            + (REPLAY_LAUNCHES["decode_gemm"] + PREFILL_HEAD_LAUNCHES)
            * resumes
            and counts["rms_norm"]
            == STEP_LAUNCHES["rms_norm"] * decode_steps
            + (REPLAY_LAUNCHES["rms_norm"] + STEP_LAUNCHES["rms_norm"])
            * resumes
            and counts["decode_attention"]
            == STEP_LAUNCHES["decode_attention"] * (decode_steps + emitted)
            and fused_norms_ok(counts))


def serve_resume(card, registry, params, kwargs, *,
                 cache_size=ENGINE_CACHE, device=None):
    """Mid-stream resume in both lanes, greedy and sampled: three
    engine-mix requests run on one engine; each is killed
    after 1 token, the middle and budget - 1. As the reference's manager
    does it, the resume token carries the original prompt, the whole
    schedule and the whole budget (``wire`` both ways), and the emitted
    tokens travel apart; a peer engine continues all nine at once
    with ``submit(prompt + emitted, step_keys=keys[kill:],
    prompt_len=len(prompt))``: the prompt prefilled as at its admission,
    the emitted tokens replayed on the decode route. Asserts every
    resumed stream equal to the uninterrupted one (ROADMAP C9), each
    resume's launches on the card (one prompt prefill forward, one
    replay forward:
    225 decode GEMM, 65 RMSNorm, 32 decode attention a token, no prefill
    GEMM), the tokens' shape and range and a clean pool. Prints each
    resume's TTFT beside the original's. (A second death of a resumed
    stream runs through the manager, serve_manager.)"""
    vocab = get_model(registry).num_classes_or_vocab
    kwargs = dict(kwargs, cache_size=cache_size)
    picks = [engine_requests(vocab)[i] for i in RESUME_REQUESTS]
    report = {"card": card}
    for lane, lane_config in (("classic", ENGINE_GENERATE_CONFIG),
                              ("prefix", PREFIX_GENERATE_CONFIG)):
        for mode, sampling in MODES:
            loaded = engine_model(registry, params, kwargs,
                                  max(ENGINE_PROMPTS),
                                  dict(lane_config, **sampling), device)
            engine = loaded.ensure_engine(name=f"smoke-resume-{lane}-{mode}")
            peer = DecodeEngine(loaded._module, loaded.params,
                                engine.config,
                                name=f"smoke-resume-peer-{lane}-{mode}",
                                device=loaded.device)
            try:
                full, original = run_engine(engine, picks)
                submits, wants, cases, emitted = [], [], [], 0
                for i, ((prompt, budget, key), got) in enumerate(
                        zip(picks, full)):
                    doc = wire.decode_resume_token(
                        wire.encode_resume_token(
                            LLAMA, 1, prompt,
                            prng.split(np.asarray(key, np.uint32), budget),
                            budget),
                        model=LLAMA, version=1)
                    for kill in kill_points(budget):
                        submits.append(functools.partial(
                            peer.submit, np.concatenate(
                                [doc["prompt_tokens"], got[:kill]]),
                            step_keys=doc["step_keys"][kill:],
                            prompt_len=len(doc["prompt_tokens"])))
                        wants.append(got[kill:])
                        cases.append((RESUME_REQUESTS[i], kill))
                        emitted += kill
                with twin_calls() as twins, served_launches(peer) as counts:
                    resumed, timing = run_streams(peer, submits)
                stats = peer.stats()
                equal = [np.array_equal(g, w) for g, w in zip(resumed,
                                                              wants)]
                row = {
                    "resumed_equal_uninterrupted":
                        f"{sum(equal)} of {len(equal)}",
                    "cases": [
                        {"request": r, "kill": k, "equal": e,
                         "first_divergence": first_divergence(g, w),
                         "ttft_ms": t}
                        for (r, k), e, g, w, t in zip(
                            cases, equal, resumed, wants,
                            timing["ttft_ms"])],
                    "original_ttft_ms": original["ttft_ms"],
                    "inter_token_ms": timing["inter_token_ms"],
                    "launches": counts,
                }
                report[f"{lane} {mode}"] = row
                log(f"resume {lane} {mode}: {json.dumps(row)}")
                bad = [
                    not all(equal),
                    not resume_launches_ok(counts, len(submits), emitted,
                                           timing["decode_steps"]),
                    any(twins.values()),
                    any(g.shape != w.shape or not ((g >= 0)
                                                   & (g < vocab)).all()
                        for g, w in zip(resumed, wants)),
                    stats["active_slots"] or stats["reserved_pages"],
                    stats["admitted"] != len(submits),
                ]
                if any(bad):
                    raise AssertionError(
                        f"resume {lane} {mode}: {row}; stats {stats}; "
                        f"failed checks {[i for i, b in enumerate(bad) if b]};"
                        f" plain twins called {twins}")
            finally:
                peer.stop()
                loaded.close()
    log(f"{registry} mid-stream resume: {json.dumps(report)}")
    return report


def serve_host_tier(card, registry, params, kwargs, prefix_refs, *,
                    cache_size=ENGINE_CACHE, device=None):
    """The host KV tier, greedy and sampled: one slot, a pool of
    HOST_TIER_PAGES and HOST_TIER_BYTES of host RAM; prefix-mix requests
    0, 1, 2 with a filler of another 512-token prompt after each but the
    last, so the 360-token prefix spills to host RAM between rounds and
    comes back on the next request. Asserts spilled and re-adopted
    blocks, each re-adopted hit equal to its cold run and B=1
    (``prefix_refs``), one prefill forward an admission, and both tiers
    drained to zero with a clean byte ledger. Prints ms per spilled and
    per re-adopted block (host clock around each spill, and around each
    splice with the card synchronised)."""
    vocab = get_model(registry).num_classes_or_vocab
    kwargs = dict(kwargs, cache_size=cache_size)
    requests = prefix_requests(vocab)
    picks = [requests[i] for i in HOST_TIER_REQUESTS]
    rng = np.random.default_rng(5)
    fillers = [(rng.integers(0, vocab, 512).astype(np.int32), 32,
                prng.PRNGKey(700 + i)) for i in range(len(picks) - 1)]
    report = {"card": card}
    splice = engine_module.splice_host_blocks
    for mode, sampling in MODES:
        loaded = engine_model(
            registry, params, kwargs, 512,
            dict(PREFIX_GENERATE_CONFIG, engine_slots=1,
                 engine_num_pages=HOST_TIER_PAGES,
                 engine_host_cache_bytes=HOST_TIER_BYTES, **sampling),
            device)
        engine = loaded.ensure_engine(name=f"smoke-host-tier-{mode}")
        spill_ms, splice_ms = [], []
        spill = engine.prefix._spill

        def timed_spill(entry, spill=spill, out=spill_ms):
            t0 = time.monotonic()
            spill(entry)
            out.append((time.monotonic() - t0) * 1e3)

        def timed_splice(cache, layers, first, page, out=splice_ms):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            cache = splice(cache, layers, first, page)
            torch.cuda.synchronize()
            out.append(((time.monotonic() - t0) * 1e3, len(layers)))
            return cache

        engine.prefix.set_spill(timed_spill)
        engine_module.splice_host_blocks = timed_splice
        try:
            TRACER.clear()
            with twin_calls() as twins, served_launches(engine) as counts:
                hits = []
                for i, (prompt, budget, key) in enumerate(picks):
                    hits.append(engine.submit(prompt, rng=key,
                                              max_new_tokens=budget)
                                .result(600))
                    if i < len(fillers):
                        p, b, k = fillers[i]
                        engine.submit(p, rng=k, max_new_tokens=b).result(600)
            steps = traced_decode_steps()
            stats = engine.stats()
            tier = stats["kv_tier"]["host"]
            engine.kv.allocator.check_invariants()
            engine.prefix.check_invariants()
            engine.host_tier.check_accounting()
            cold = []
            for prompt, budget, key in picks[1:]:
                engine.clear_prefix_cache()
                engine.host_tier.clear()
                cold.append(engine.submit(prompt, rng=key,
                                          max_new_tokens=budget).result(600))
            engine.clear_prefix_cache()
            engine.host_tier.clear()
            engine.host_tier.check_accounting()
            drained = engine.stats()
        finally:
            engine_module.splice_host_blocks = splice
            loaded.close()
        refs = [prefix_refs[mode][i] for i in HOST_TIER_REQUESTS]
        blocks = sum(n for _, n in splice_ms)
        row = {
            "kv_tier": tier,
            "prefix_cache": stats["prefix_cache"],
            "spill_ms_per_block": (statistics.mean(spill_ms) if spill_ms
                                   else None),
            "readopt_ms_per_block": (sum(ms for ms, _ in splice_ms) / blocks
                                     if blocks else None),
            "readopted_blocks_per_hit": [n for _, n in splice_ms],
            "launches": counts,
            "hits_equal_cold": sum(np.array_equal(h, c)
                                   for h, c in zip(hits[1:], cold)),
            "streams_equal_b1": sum(np.array_equal(h, r)
                                    for h, r in zip(hits, refs)),
            "first_divergence": [first_divergence(h, r)
                                 for h, r in zip(hits, refs)],
        }
        report[mode] = row
        log(f"host tier {mode}: {json.dumps(row)}")
        admissions = len(picks) + len(fillers)
        bad = [
            tier["spilled_blocks"] <= 0, tier["readopted_blocks"] <= 0,
            stats["prefix_cache"]["hits"] != len(picks) - 1,
            row["hits_equal_cold"] != len(picks) - 1,
            row["streams_equal_b1"] != len(picks),
            not prefill_launches_ok(counts, admissions, steps),
            any(twins.values()),
            drained["free_pages"] != drained["total_pages"],
            drained["reserved_pages"] or drained["active_slots"],
            drained["kv_tier"]["host"]["resident_bytes"] != 0,
            drained["kv_tier"]["host"]["resident_blocks"] != 0,
        ]
        if any(bad):
            raise AssertionError(
                f"host tier {mode}: {row}; after the drain {drained}; "
                f"failed checks {[i for i, b in enumerate(bad) if b]}; "
                f"plain twins called {twins}")
    log(f"{registry} host KV tier: {json.dumps(report)}")
    return report


def serve_fleet(card, registry, params, kwargs, prefix_refs, *,
                cache_size=ENGINE_CACHE, device=None):
    """Fleet KV blocks, greedy and sampled: engine A serves prefix-mix
    request 0; its ``export_prefix_blocks`` of request 1's prompt goes
    through ``wire.encode_kv_blocks`` / ``decode_kv_blocks`` into engine
    B's ``import_prefix_blocks``. Asserts every block sent imported and
    re-adopted, B's request a hit equal to its cold run and B=1, and
    B's pages of those blocks, read back, byte-equal to A's. Prints the
    export, codec and import ms and the payload's bytes."""
    vocab = get_model(registry).num_classes_or_vocab
    kwargs = dict(kwargs, cache_size=cache_size)
    picks = prefix_requests(vocab)[:2]
    report = {"card": card}
    for mode, sampling in MODES:
        loaded = engine_model(
            registry, params, kwargs, 512,
            dict(PREFIX_GENERATE_CONFIG,
                 engine_host_cache_bytes=HOST_TIER_BYTES, **sampling),
            device)
        owner = loaded.ensure_engine(name=f"smoke-fleet-owner-{mode}")
        asker = DecodeEngine(loaded._module, loaded.params, owner.config,
                             name=f"smoke-fleet-asker-{mode}",
                             device=loaded.device)
        (p0, b0, k0), (p1, b1, k1) = picks
        try:
            owner.submit(p0, rng=k0, max_new_tokens=b0).result(600)
            t0 = time.monotonic()
            blocks = owner.export_prefix_blocks(p1)
            t1 = time.monotonic()
            data = wire.encode_kv_blocks(LLAMA, 1, 16, blocks)
            t2 = time.monotonic()
            carried = wire.decode_kv_blocks(data, model=LLAMA, version=1,
                                            page_size=16)
            t3 = time.monotonic()
            imported = asker.import_prefix_blocks(carried)
            t4 = time.monotonic()
            asker.note_kv_fetch("hit", blocks=imported)
            with twin_calls() as twins:
                hit = asker.submit(p1, rng=k1, max_new_tokens=b1).result(600)
            stats = asker.stats()
            readback = asker.export_prefix_blocks(p1)[:len(blocks)]
            same_bytes = len(readback) == len(blocks) and all(
                torch.equal(g.view(torch.int16), w.view(torch.int16))
                for (_, got), (_, want) in zip(readback, blocks)
                for g, w in zip(got, want))
            asker.clear_prefix_cache()
            asker.host_tier.clear()
            cold = asker.submit(p1, rng=k1, max_new_tokens=b1).result(600)
        finally:
            asker.stop()
            loaded.close()
        row = {
            "blocks_sent": len(blocks), "imported": imported,
            "payload_bytes": len(data),
            "export_ms": (t1 - t0) * 1e3, "encode_ms": (t2 - t1) * 1e3,
            "decode_ms": (t3 - t2) * 1e3, "import_ms": (t4 - t3) * 1e3,
            "kv_tier": stats["kv_tier"], "prefix_cache": stats["prefix_cache"],
            "readback_byte_equal": same_bytes,
            "hit_equals_cold": bool(np.array_equal(hit, cold)),
            "hit_equals_b1": bool(np.array_equal(hit, prefix_refs[mode][1])),
        }
        report[mode] = row
        log(f"fleet blocks {mode}: {json.dumps(row)}")
        if (len(blocks) != PREFIX_SHARED // 16 or imported != len(blocks)
                or stats["kv_tier"]["fetch_hits"] != 1
                or stats["kv_tier"]["host"]["readopted_blocks"] != imported
                or stats["prefix_cache"]["hits"] != 1
                or not same_bytes or not row["hit_equals_cold"]
                or not row["hit_equals_b1"] or any(twins.values())):
            raise AssertionError(f"fleet blocks {mode}: {row}; plain twins "
                                 f"called {twins}")
    log(f"{registry} fleet KV blocks: {json.dumps(report)}")
    return report


#: The manager phase: the engine mix's generate config with prompt
#: buckets at the mix's widths (77 → 128, 200 → 256, the rest → 512),
#: so the load's engine warmup reaches every bucket the mix takes, and
#: a deterministic per-request key (seed 0), so a request's key is
#: known to the B=1 reference. The engine models load at max_batch 2
#: (their bucket warmup runs the B=1 generate loop a bucket), the
#: batcher's at 4.
MANAGER_BUCKETS = (128, 256, 512)
MANAGER_MAX_BATCH = 4
#: The batcher's predict and classify requests: [1, 512] each, four at
#: once; and its static generates (power-of-two prompt buckets), four
#: prompts at once whose lengths mix the buckets (300, 410 and 512 take
#: 512; 77 takes 128), so the group runs as two executions.
MANAGER_PREDICT_SEQ = 512
MANAGER_STATIC_PROMPTS = (0, 1, 2, 3)
#: A coalesced predict or classify row against the same request alone:
#: the bf16 Llama tolerance (relative RMS; the cache-free forward's
#: projections run on F.linear, whose sums depend on the row count).
MANAGER_TOL = 3e-2


class SmokeServedModel(ServedModel):
    """A ``ServedModel`` whose one version is an in-memory
    ``LoadedModel`` on the smoke's llama3-8b params (an export would be
    ~16 GB on disk). ``_load`` builds it and then does what
    ``ServedModel._load`` does after its ``load_version``: the bucket
    warmup, the admission prior and, for a continuous-batching generate
    model, the engine warmup (``_warm_engine``). A peer that only
    adopts and resumes skips the bucket warmup (``bucket_warmup``): it
    runs no static request, and the warmup's B=1 generates cost ~8 s a
    model at llama3-8b."""

    def __init__(self, name, metadata, params, bucket_warmup=True, **kw):
        super().__init__(name, "", **kw)
        self._metadata, self._params = metadata, params
        self._bucket_warmup = bucket_warmup
        self.load_s = {}

    def _available_versions(self):
        return [1]

    def _load(self, version):
        t0 = time.monotonic()
        loaded = LoadedModel(self._metadata, version, self._params,
                             max_batch=self.max_batch, device=self.device)
        if self._bucket_warmup:
            loaded.warmup()
            self._latency.seed(loaded.warmup_batch_seconds)
        t1 = time.monotonic()
        if (self.continuous_batching
                and loaded.signature().method == "generate"):
            engine = loaded.ensure_engine(
                self.name, queue_capacity=self.queue_capacity)
            if engine._graphs is not None:
                # Its warmup captures: the tally must see those bodies.
                tally_programs(engine)
            self._warm_engine(engine)
        self.load_s = {"bucket_warmup_s": t1 - t0,
                       "engine_warmup_s": time.monotonic() - t1}
        return loaded


def manager_model(name, registry, method, seq, kwargs, params, config,
                  device, max_batch=MANAGER_MAX_BATCH, bucket_warmup=True,
                  **kw):
    meta = ModelMetadata(
        model_name=name, registry_name=registry, model_kwargs=kwargs,
        signatures={"serving_default": Signature(
            method=method,
            inputs={"input_ids": TensorSpec("int32", (-1, seq))},
            outputs={})},
        generate_config=config)
    served = SmokeServedModel(name, meta, params, max_batch=max_batch,
                              device=device, bucket_warmup=bucket_warmup,
                              **kw)
    t0 = time.monotonic()
    if not served.poll_versions():
        raise AssertionError(f"{name}: no version loaded")
    served.load_s["load_s"] = time.monotonic() - t0
    return served


def resume_token(stream):
    """The token a server mints for a live stream (server.py's resume
    event), through the wire and back as the next replica reads it."""
    ctx = stream.resume_ctx
    blob = wire.encode_resume_token(
        LLAMA, 1, ctx["prompt"], ctx["step_keys"], ctx["max_new_tokens"],
        prompt_len=ctx.get("prompt_len"))
    return wire.decode_resume_token(blob, model=LLAMA, version=1)


def manager_resumes(served, cases, vocab, bad):
    """``submit_resume`` of ``cases`` ``(token, emitted, want)`` on
    ``served``, counted; returns the streams, the report row, and
    appends failed checks to ``bad``."""
    engine = served.get().engine
    TRACER.clear()
    with twin_calls() as twins, served_launches(engine) as counts:
        _, streams = served.submit_resume(
            [(token, emitted) for token, emitted, _ in cases], None)
        got = [s.result(timeout=600) for s in streams]
    equal = [np.array_equal(g, w) for g, (_, _, w) in zip(got, cases)]
    # Replayed on the decode route: the context past the original
    # prompt (a second death's token holds its first life's tokens).
    emitted = sum(len(t["prompt_tokens"]) + len(e)
                  - t.get("prompt_len", len(t["prompt_tokens"]))
                  for t, e, _ in cases)
    row = {"equal": f"{sum(equal)} of {len(equal)}",
           "first_divergence": [first_divergence(g, w)
                                for g, (_, _, w) in zip(got, cases)],
           "launches": counts}
    bad += [not all(equal),
            not resume_launches_ok(counts, len(cases), emitted,
                                   traced_decode_steps()),
            any(twins.values()),
            any(not ((g >= 0) & (g < vocab)).all() for g in got)]
    return streams, row


def manager_batcher(card, registry, params, kwargs, device):
    """The micro-batcher: four [1, 512] predict and four classify
    requests submitted at once coalesce into fewer executions, each row
    within the bf16 tolerance of the request alone (max |Δ| reported),
    32 flash launches an execution; then four mixed-length static
    generates at once (``_run_generate_group``), greedy and sampled:
    one execution a prompt-length bucket (two), each row equal to the
    same request alone."""
    vocab = get_model(registry).num_classes_or_vocab
    report = {}
    # The batcher's models skip the bucket warmup: serve_manager's
    # models ran the load path's warmups on the same params.
    served = manager_model("smoke-manager-predict", registry, "predict",
                           MANAGER_PREDICT_SEQ,
                           {k: v for k, v in kwargs.items()
                            if k != "cache_size"},  # the cache-free forward
                           params, {}, device, bucket_warmup=False)
    try:
        served.batch_window_s = 0.25
        loaded = served.get()
        report["predict_load_s"] = served.load_s
        x = np.random.default_rng(5).integers(
            0, vocab, (4, MANAGER_PREDICT_SEQ)).astype(np.int32)
        for method, key in (("predict", "logits"), ("classify", "scores")):
            alone = [loaded.run({"input_ids": x[i:i + 1]}, method=method)
                     for i in range(len(x))]
            served.batch_stats(reset=True)
            with twin_calls() as twins:
                zero_counts()
                futures = [served.submit({"input_ids": x[i:i + 1]}, None,
                                         method, None)
                           for i in range(len(x))]
                got = [f.result(timeout=600) for f in futures]
                counts = read_counts()
            stats = served.batch_stats()
            errs = [rel_rms(torch.from_numpy(g[key][0]),
                            torch.from_numpy(a[key][0]))
                    for g, a in zip(got, alone)]
            row = {"requests": len(x), "executions": stats["batches"],
                   "rel_rms": errs,
                   "max_abs": max(float(np.abs(g[key] - a[key]).max())
                                  for g, a in zip(got, alone)),
                   "launches": counts}
            if method == "classify":
                row["classes_equal"] = float(np.mean(
                    [np.mean(g["classes"] == a["classes"])
                     for g, a in zip(got, alone)]))
            report[method] = row
            log(f"manager batcher {method}: {json.dumps(row)}")
            if (stats["rows"] != len(x) or stats["batches"] >= len(x)
                    or max(errs) > MANAGER_TOL
                    or counts["flash_attention"] != 32 * stats["batches"]
                    or counts["prefill_gemm"] or counts["decode_gemm"]
                    or any(twins.values())):
                raise AssertionError(f"manager batcher {method}: {row}; "
                                     f"stats {stats}; twins {twins}")
    finally:
        served.stop()
    picks = [engine_requests(vocab)[i] for i in MANAGER_STATIC_PROMPTS]
    for mode, sampling in MODES:
        config = dict(max_new_tokens=NEW_TOKENS, deterministic=True,
                      **sampling)
        served = manager_model(f"smoke-manager-static-{mode}", registry,
                               "generate", max(ENGINE_PROMPTS), kwargs,
                               params, config, device, bucket_warmup=False)
        try:
            served.batch_window_s = 0.25
            loaded = served.get()
            alone = [served.submit({"input_ids": p[None]}, None, None, None)
                     .result(timeout=600)["tokens"][0]
                     for p, _, _ in picks]
            served.batch_stats(reset=True)
            futures = [served.submit({"input_ids": p[None]}, None, None,
                                     None) for p, _, _ in picks]
            got = [f.result(timeout=600)["tokens"][0] for f in futures]
            stats = served.batch_stats()
            buckets = {loaded._length_bucket(len(p), max(ENGINE_PROMPTS))
                       for p, _, _ in picks}
            equal = [np.array_equal(g, a) for g, a in zip(got, alone)]
            row = {"prompts": [len(p) for p, _, _ in picks],
                   "executions": stats["batches"],
                   "equal_alone": f"{sum(equal)} of {len(equal)}",
                   "first_divergence": [first_divergence(g, a)
                                        for g, a in zip(got, alone)],
                   "load_s": served.load_s}
            report[f"static {mode}"] = row
            log(f"manager static generate {mode}: {json.dumps(row)}")
            if (stats["batches"] != len(buckets)
                    or not all(equal)
                    or any(not ((g >= 0) & (g < vocab)).all()
                           for g in got)):
                raise AssertionError(f"manager static generate {mode}: "
                                     f"{row}; stats {stats}")
        finally:
            served.stop()
    return report


def manager_load_path(device=None):
    """The load path itself on the card: a ``llama-test`` generate
    export through ``ModelManager.add_model`` → the version poll →
    ``load_version`` → the bucket and engine warmups, then one request
    equal to B=1 ``generate``. Reports which queue served (the native
    one of ``native/libkft_runtime.so`` or the Python one)."""
    from kubeflow_tpu_torch.serving import _native

    kwargs = {"dtype": "bfloat16", "cache_size": 64}
    params = init_params(llama_test(**kwargs), seed=0, device="cpu")
    meta = ModelMetadata(
        model_name="tiny", registry_name="llama-test", model_kwargs=kwargs,
        signatures={"serving_default": Signature(
            method="generate",
            inputs={"input_ids": TensorSpec("int32", (-1, 16))},
            outputs={"tokens": TensorSpec("int32", (-1, 8))})},
        generate_config={"max_new_tokens": 8, "engine_slots": 2,
                         "engine_page_size": 8, "engine_slice_tokens": 4,
                         "deterministic": True})
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        export_model(tmp, 1, meta,
                     {"params": unflatten_tree(params_to_flax(params))})
        manager = ModelManager(poll_interval_s=3600, device=device)
        try:
            t0 = time.monotonic()
            served = manager.add_model("tiny", tmp, max_batch=2,
                                       continuous_batching=True)
            load_s = time.monotonic() - t0
            loaded = served.get()
            prompt = np.arange(3, 14, dtype=np.int32)
            got = served.submit({"input_ids": prompt[None]}, None, None,
                                None).result(timeout=300)["tokens"][0]
            want = b1_reference(loaded, prompt, loaded.request_rngs(1)[0],
                                8, {})
            row = {"load_s": load_s, "ready": manager.ready(),
                   "queue": type(served._queue).__name__,
                   "native_library": _native._LIB is not None,
                   "captured_keys": len(loaded.engine.captured_keys()),
                   "equal_b1": bool(np.array_equal(got, want))}
        finally:
            manager.stop()
    log(f"manager load path (llama-test export): {json.dumps(row)}")
    if not (row["ready"] and row["equal_b1"]):
        raise AssertionError(f"manager load path: {row}")
    return row


def manager_http(served, requests, unary):
    """``make_app`` on a loopback port in front of ``served``: one unary
    ``:generate`` and one SSE stream over HTTP give the manager's tokens.
    Returns None (and says so) where tornado does not import."""
    try:
        import tornado.ioloop  # noqa: F401
    except ImportError as e:
        log(f"manager http: {e.name} does not import on this machine; "
            f"the REST/SSE server was not driven")
        return None
    import asyncio
    import http.client
    import threading

    from kubeflow_tpu_torch.serving.server import make_app

    manager = ModelManager(device=served.device)
    manager._models[served.name] = served
    holder, started = {}, threading.Event()

    def run():
        asyncio.set_event_loop(asyncio.new_event_loop())
        server = make_app(manager).listen(0, address="127.0.0.1")
        holder["port"] = next(iter(
            server._sockets.values())).getsockname()[1]
        holder["loop"] = tornado.ioloop.IOLoop.current()
        started.set()
        holder["loop"].start()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    if not started.wait(60):
        raise AssertionError("manager http: the server did not start")
    try:
        out = {}
        for name, i, body in (
                ("unary", 0, {"instances": [requests[0][0].tolist()]}),
                ("sse", 1, {"instances": [requests[1][0].tolist()],
                            "stream": True})):
            conn = http.client.HTTPConnection("127.0.0.1", holder["port"],
                                              timeout=600)
            conn.request("POST", f"/v1/models/{served.name}:generate",
                         body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                raise AssertionError(f"manager http {name}: "
                                     f"{resp.status} {resp.read()}")
            if name == "unary":
                tokens = json.loads(resp.read())["predictions"][0]["tokens"]
            else:
                events = list(wire.iter_sse_events(resp))
                tokens = [d["token"] for e, d in events if e == "token"]
                if events[-1][0] != "done" or \
                        events[-1][1]["tokens"][0] != tokens:
                    raise AssertionError(f"manager http sse: {events[-1]}")
            conn.close()
            out[name] = tokens == unary[i].tolist()
    finally:
        holder["loop"].add_callback(holder["loop"].stop)
        thread.join(10)
    log(f"manager http (make_app on loopback): tokens equal the "
        f"manager's {out}")
    if not all(out.values()):
        raise AssertionError(f"manager http: {out}")
    return out


def serve_manager(card, registry, params, kwargs, captured=None, *,
                  cache_size=ENGINE_CACHE, device=None):
    """The serving plane on ``params``: ``ServedModel`` / ``ModelManager``
    as a server runs them, greedy and sampled. Two continuous-batching
    models (``a`` and its peer ``b``, sharing the params) load through
    the version poll with the bucket and engine warmups, their engines
    captured. Asserted: the engine mix's six prompts through
    ``ServedModel.submit`` at once, each equal to B=1 ``generate`` with
    the request's key, no graph captured after the load's warmup, and
    the engine phases' launch formulas; ``submit_stream`` with the mix's
    budgets, each stream the unary row's prefix; ``prefill_handoff`` on
    ``a``, the blobs through the wire, ``submit_handoff`` on ``b``,
    equal to the unary rows, 224 + 32 + 1 launches a prefill and none an
    adoption; ``submit_resume`` on ``b`` of three requests killed at 1,
    the middle and budget - 1 (tokens minted as the server mints them),
    and a second death one token into each resumed stream, its token
    carrying ``prompt_len``, resumed on ``a``: every case equal to the
    uninterrupted stream, with each resume's launches; no plain twin
    anywhere. Reported: load and warmup seconds, TTFT and inter-token ms
    beside ``serve_captured``'s, a greedy manager pass's idle share,
    ``batch_stats()`` and the ``kft_serving_*`` exposition. Then the
    batcher (``manager_batcher``), the REST/SSE server where tornado
    imports (``manager_http``) and the llama-test load path
    (``manager_load_path``)."""
    vocab = get_model(registry).num_classes_or_vocab
    kwargs = dict(kwargs, cache_size=cache_size)
    requests = engine_requests(vocab)
    report = {"card": card}
    for mode, sampling in MODES:
        config = dict(ENGINE_GENERATE_CONFIG, deterministic=True,
                      prompt_buckets=list(MANAGER_BUCKETS), **sampling)
        a, b = (manager_model(f"smoke-manager-{mode}-{side}", registry,
                              "generate", max(ENGINE_PROMPTS), kwargs,
                              params, config, device, max_batch=2,
                              bucket_warmup=side == "a",
                              continuous_batching=True)
                for side in "ab")
        try:
            loaded = a.get()
            engine, peer = loaded.engine, b.get().engine
            warm, peer_warm = engine.captured_keys(), peer.captured_keys()
            key = loaded.request_rngs(1)[0]  # deterministic: every row's
            budget = config["max_new_tokens"]
            refs = [b1_reference(loaded, p, key, budget, sampling)
                    for p, _, _ in requests]
            bad = []
            # 1. Unary generates through submit, all six at once.
            TRACER.clear()
            with twin_calls() as twins, served_launches(engine) as counts:
                futures = [a.submit({"input_ids": p[None]}, None, None,
                                    None) for p, _, _ in requests]
                unary = [f.result(timeout=600)["tokens"][0]
                         for f in futures]
            steps = traced_decode_steps()
            want = {k: steps * n for k, n in STEP_LAUNCHES.items()
                    if k not in ("rms_norm", "add_rms_norm")}
            want["prefill_gemm"] = PREFILL_LAUNCHES * len(requests)
            want["flash_attention"] = \
                PREFILL_ATTENTION_LAUNCHES * len(requests)
            want["decode_gemm"] += PREFILL_HEAD_LAUNCHES * len(requests)
            equal = [np.array_equal(g, w) for g, w in zip(unary, refs)]
            row = {"load_s": a.load_s, "peer_load_s": b.load_s,
                   "unary_equal_b1": f"{sum(equal)} of {len(equal)}",
                   "first_divergence": [first_divergence(g, w)
                                        for g, w in zip(unary, refs)],
                   "graphs_after_load": len(warm),
                   "unary_launches": counts}
            bad += [not all(equal),
                    engine.captured_keys() != warm,
                    any(counts[k] != n for k, n in want.items()),
                    counts["rms_norm"] < steps * STEP_LAUNCHES["rms_norm"],
                    not fused_norms_ok(counts),
                    any(twins.values())]
            # 2. Streams with the mix's budgets: each the unary prefix.
            live = []

            def submit_stream(prompt, n):
                _, (stream,) = a.submit_stream({"input_ids": prompt[None]},
                                               None, None, max_new_tokens=n)
                live.append(stream)
                return stream

            streamed, timing = run_streams(engine, [
                functools.partial(submit_stream, p, n)
                for p, n, _ in requests])
            prefix = [np.array_equal(s, u[:len(s)]) and len(s) == n
                      for s, u, (_, n, _) in zip(streamed, unary, requests)]
            row["streams_prefix_of_unary"] = f"{sum(prefix)} of {len(prefix)}"
            row["ttft_ms"] = timing["ttft_ms"]
            row["inter_token_ms"] = timing["inter_token_ms"]
            row["inter_token_ms_range"] = timing["inter_token_ms_range"]
            if captured is not None:
                row["serve_captured_inter_token_ms"] = captured.get(
                    f"engine {mode}", {}).get("inter_token_ms")
            bad.append(not all(prefix))
            # 3. Role split: prefill on a, the blobs through the wire,
            # adopted on b.
            TRACER.clear()
            with twin_calls() as twins, \
                    served_launches(engine, peer) as counts:
                carried = []
                for p, _, _ in requests:
                    _, (h,) = a.prefill_handoff({"input_ids": p[None]},
                                                None, None)
                    carried.append(wire.decode_kv_handoff(
                        wire.encode_kv_handoff(LLAMA, 1, h), model=LLAMA,
                        version=1))
                _, streams = b.submit_handoff(carried, None)
                adopted = [s.result(timeout=600) for s in streams]
            equal = [np.array_equal(g, w) for g, w in zip(adopted, unary)]
            row["handoff_equal_local"] = f"{sum(equal)} of {len(equal)}"
            row["handoff_launches"] = counts
            bad += [not all(equal),
                    not prefill_launches_ok(counts, len(requests),
                                            traced_decode_steps()),
                    any(twins.values())]
            # 4. Resume on b after kills at 1, the middle and budget - 1,
            # then a second death one token later, resumed on a.
            first, cases = [], []
            for i in RESUME_REQUESTS:
                token = resume_token(live[i])
                bad.append("prompt_len" in token)  # a first life's token
                full = streamed[i]
                for kill in kill_points(len(full)):
                    cases.append((token, full[:kill].tolist(), full[kill:]))
                    first.append((i, kill))
            resumed, row["resume"] = manager_resumes(b, cases, vocab, bad)
            second = []
            for (i, kill), stream in zip(first, resumed):
                full = streamed[i]
                if kill >= len(full) - 1:
                    continue  # one token left: nothing to die after
                token = resume_token(stream)
                bad.append(token.get("prompt_len") != len(requests[i][0]))
                second.append((token, full[kill:kill + 1].tolist(),
                               full[kill + 1:]))
            _, row["second_death"] = manager_resumes(a, second, vocab, bad)
            row["second_death"]["cases"] = len(second)
            # Reported: one greedy manager pass under the profiler, the
            # batcher's and engine's stats, the serving families.
            if mode in PROFILED_MODES:
                _, window = device_window(lambda: [
                    f.result(timeout=600) for f in [
                        a.submit({"input_ids": p[None]}, None, None, None)
                        for p, _, _ in requests]])
                row["manager_pass_window"] = {
                    k: window[k] for k in ("wall_ms", "device_ms",
                                           "idle_share")}
            row["batch_stats"] = a.batch_stats()
            # No capture after the loads' warmups, on either model,
            # through every path above.
            row["graphs_after_phase"] = [len(engine.captured_keys()),
                                         len(peer.captured_keys())]
            bad += [engine.captured_keys() != warm,
                    peer.captured_keys() != peer_warm]
            if mode == "greedy":
                row["http"] = manager_http(a, requests, unary)
            report[mode] = row
            log(f"manager {mode}: {json.dumps(row, default=str)}")
            if any(bad):
                raise AssertionError(
                    f"manager {mode}: failed checks "
                    f"{[i for i, x in enumerate(bad) if x]}; {row}")
        finally:
            a.stop()
            b.stop()
    exposition = [line for line in obs_metrics.render().splitlines()
                  if line.startswith("kft_serving_")]
    log("manager kft_serving_* exposition:\n" + "\n".join(exposition))
    report["batcher"] = manager_batcher(card, registry, params, kwargs,
                                        device)
    report["load_path"] = manager_load_path(device)
    return report



# -- The LM training slice (phase 4z) -----------------------------------------

#: run_lora_benchmark's settings, at llama3-8b's full width and depth.
LORA_RANK = 16
LORA_ALPHA = 16.0
LORA_SEQ = 1024
LORA_LR = 1e-4
LORA_STEPS = 10
#: The CLI run (``training.benchmark --lora_rank``) on a token shard:
#: its warmup step and this many timed ones.
LORA_CLI_STEPS = 2
#: rank 16 on q/k/v/o of 32 layers: 32·16·((4096 + 4096)·2 + (4096 +
#: 1024)·2) adapter params, 0.170% of llama3-8b's 8,030,261,248.
LORA_TRAINABLE = 13_631_488
#: The merge is checked where it is exact: every merged weight equals
#: W + (A·B·α/r)ᵀ in fp32 rounded to bf16 once, bit for bit, and the
#: merged model served equals the same weights applied on the same
#: route, bit for bit. Against the adapter forward (a different
#: function: W and the delta apart, each in bf16) the merged model is
#: held to LOGITS_REL_RMS_TOL, the bound of two bf16 routes of one
#: llama3-8b function, and must sit closer to it than the unmerged base;
#: the floor between the adapter forward on flash and on the plain dense
#: attention is measured beside it.
MERGE_GENERATE_PROMPT = 128
MERGE_GENERATE_TOKENS = 16
#: The pretraining step, through the tpu-lm CLI: llama3-8b's full
#: width, depth cut 32 → 4 (at 32 layers the fp32 params, grads and two
#: moments take ~129 GB).
PRETRAIN_LAYERS = 4
PRETRAIN_SEQ = 2048
PRETRAIN_STEPS = 10
#: The pretrain CLI's default peak rate and a 2-step warmup.
PRETRAIN_LR = 1e-4
PRETRAIN_WARMUP = 2


def train_launch_formula(layers: int, remat: bool, frozen_embed: bool):
    """Launches and plain recomputes one train step makes. Forward:
    flash once a layer, RMSNorm twice a layer and once at the end, all
    but layer 0's attention norm fused with the residual add before it;
    a remat backward runs each block's forward again (flash and both
    block norms once more, layer 0's attention norm a plain one).
    Backward: the flash gradient recomputes through its plain version
    once a layer; a norm's gradient through its plain formula wherever
    its input or scale wants one (all of them, except the first block's
    attention norm when the embedding is frozen, as in LoRA)."""
    again = 1 if remat else 0
    return {
        "flash_attention": layers * (1 + again),
        "rms_norm": 2 * layers + 1 + 2 * layers * again,
        "add_rms_norm": 2 * layers + (2 * layers - 1) * again,
        "flash_backward": layers,
        "rms_norm_backward": 2 * layers + 1 - (1 if frozen_embed else 0),
        "forward_plain": 0,
    }


@contextlib.contextmanager
def train_twins():
    """Count each call of a plain twin (flash's, RMSNorm's, both
    GEMMs'), telling a backward's recompute (the design: the gradient
    recomputes through the plain version, as the reference's custom VJP
    does) from a forward's, which on the card must never happen."""
    calls = {"flash_backward": 0, "rms_norm_backward": 0,
             "forward_plain": 0}
    depth = [0]
    fa_mod = sys.modules[flash_attention.__module__]
    saved = {(fa_mod, "flash_attention_reference"):
             fa_mod.flash_attention_reference,
             (rn, "rms_norm_reference"): rn.rms_norm_reference,
             (dg, "decode_linear_reference"): dg.decode_linear_reference,
             (pg, "prefill_linear_reference"): pg.prefill_linear_reference}
    backwards = {fa_mod._FlashAttention: fa_mod._FlashAttention.backward,
                 rn._RMSNorm: rn._RMSNorm.backward,
                 rn._AddRMSNorm: rn._AddRMSNorm.backward}

    def counted(key, fn, backward_name):
        def wrapped(*a, **kw):
            if depth[0] and backward_name:
                calls[backward_name] += 1
            else:
                calls["forward_plain"] += 1
            return fn(*a, **kw)
        return wrapped

    def in_backward(fn):
        def wrapped(ctx, *grads):
            depth[0] += 1
            try:
                return fn(ctx, *grads)
            finally:
                depth[0] -= 1
        return staticmethod(wrapped)

    names = {"flash_attention_reference": "flash_backward",
             "rms_norm_reference": "rms_norm_backward"}
    for (mod, name), fn in saved.items():
        setattr(mod, name, counted(name, fn, names.get(name)))
    for cls, fn in backwards.items():
        cls.backward = in_backward(fn)
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        for cls, fn in backwards.items():
            cls.backward = staticmethod(fn)


TRAIN_KERNELS = ("flash_attention", "rms_norm", "add_rms_norm")


@contextlib.contextmanager
def counted_run(name: str, steps: int, want: dict):
    """Zero every count just before a training run and read the counts
    just after it: its flash and RMSNorm launches and its plain-twin
    calls must be ``steps`` times the formula's. Yields a dict that
    holds the run's launches once it has ended."""
    out = {}
    with train_twins() as twins:
        zero_counts()
        yield out
        torch.cuda.synchronize()
        counts = read_counts()
    out.update({k: counts[k] for k in TRAIN_KERNELS})
    got = {**out, **twins}
    expected = {k: steps * v for k, v in want.items()}
    if got != expected:
        raise AssertionError(f"{name}: {steps} steps launched / recomputed "
                             f"{got}, expected {expected}")


def profiled_step(step, state, batch):
    """One step under ``torch.profiler``: its wall ms and the LM
    breakdown (``training/benchmark.py`` ``summarize_lm_trace``)."""
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            float(metrics["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
        summary = summarize_lm_trace(tmp, wall_ms)
    return state, summary


def write_token_shard(directory: str, seq_len: int, vocab: int,
                      seed: int, repeats: int = 8) -> str:
    """A ``.npy`` token shard: one random sequence of ``seq_len`` ids
    repeated, so every chunk the stream cuts is that sequence and a run
    on it trains on a fixed batch through the real data path (the shard
    read, the vocabulary check on the host, the prefetch to the
    card)."""
    ids = np.random.RandomState(seed).randint(0, vocab, seq_len)
    path = os.path.join(directory, "tokens.npy")
    np.save(path, np.tile(ids.astype(np.int32), repeats))
    return path


def run_cli(main_fn, argv) -> dict:
    """An entry point's ``main(argv)`` in this process: exit code 0 and
    its last stdout line, a JSON object."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"{argv}: exit code {rc}, output "
                             f"{out.getvalue()[-2000:]!r}")
    return json.loads(lines[-1])


def train_lora(card, params, device=None):
    """LoRA fine-tuning of llama3-8b at full width and depth through
    ``run_lora_benchmark``'s run (``fine_tune_lora``: r 16, α 16, remat,
    b1 × L1024, ``adamw(1e-4)``, seed 0, one fixed synthetic batch) on
    the served params, which it casts to bf16 (the reference's
    ``cast_floating``, the head too); then the adapters merged into the
    served params and served. Returns (report, flash and RMSNorm
    launches)."""
    entry = get_model(LLAMA)
    vocab = entry.num_classes_or_vocab
    device = resolve_device(device)
    config = LoRABenchConfig(model=LLAMA, lora_rank=LORA_RANK,
                             seq_len=LORA_SEQ, steps=LORA_STEPS,
                             warmup_steps=1, learning_rate=LORA_LR, seed=0)
    # run_lora_benchmark's batch; the base model's loss on it, and the
    # base on the host to check it after the run.
    host_batch = next(synthetic_causal_lm(1, LORA_SEQ, vocab, seed=0))
    batch = place_batch(host_batch, device)
    base = cast_floating(params, torch.bfloat16)
    with torch.no_grad():
        _, (base_loss, _, _) = lm_forward_with_aux(
            entry.make(), base, batch, causal_lm_loss, 0.01)
    frozen = {k: v.cpu() for k, v in base.items()}
    del base
    torch.cuda.reset_peak_memory_stats()
    want = train_launch_formula(entry.make().num_layers, remat=True,
                                frozen_embed=True)
    with counted_run("lora", 1 + LORA_STEPS, want) as launches:
        result, state = fine_tune_lora(config, device, params)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if result["trainable_params"] != LORA_TRAINABLE or any(
            t.requires_grad for t in state.base_params.values()):
        raise AssertionError(
            f"lora: {result['trainable_params']} trainable params "
            f"(expected {LORA_TRAINABLE}); a base tensor wants a gradient: "
            f"{any(t.requires_grad for t in state.base_params.values())}")
    losses = result["warmup_losses"] + result["losses"]
    if losses[0] != float(base_loss):
        raise AssertionError(f"lora step 0 loss {losses[0]!r} != the base "
                             f"model's {float(base_loss)!r}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"lora: the loss did not fall on the fixed "
                             f"batch over {LORA_STEPS} steps: {losses}")
    for k, v in state.base_params.items():
        if v.grad is not None or not torch.equal(v.cpu(), frozen[k]):
            raise AssertionError(f"lora: base tensor {k} changed or holds "
                                 "a gradient")
    del frozen
    if peak_gb >= 80:
        raise AssertionError(f"lora: peak {peak_gb} GB")
    state, profile = profiled_step(make_lora_train_step(), state, batch)
    step_ms = result["step_time_ms"]
    report = {
        "card": card, "model": LLAMA, "lora_rank": LORA_RANK,
        "seq_len": LORA_SEQ, "base_params": result["base_params"],
        "trainable_params": result["trainable_params"],
        "trainable_pct": result["trainable_pct"],
        "step0_loss": losses[0], "base_loss": float(base_loss),
        "losses": losses, "step_ms": step_ms,
        "tokens_per_s": result["tokens_per_sec"],
        "flops_per_step": result["flops_per_step"],
        "hfu_pct": result.get("mfu_pct"),
        "model_flops_per_step": result["model_flops_per_step"],
        "model_flops_util_pct": result.get("model_flops_util_pct"),
        "peak_memory_gb": peak_gb,
        "per_step": {k: v for k, v in want.items()},
        "profiled_step": profile,
        "busy_share_of_timed_step": profile["device_busy_ms"] / step_ms,
    }
    log(f"lora fine-tune: {json.dumps(report)}")
    report["merged"] = serve_merged(state, params, host_batch, device)
    return report, dict(launches)


def train_lora_cli(card):
    """The LoRA benchmark's CLI as a user runs it on the card
    (``training.benchmark --model llama3-8b --lora_rank 16 --seq_len
    1024``) on a token shard (``--data``): its own base drawn in fp32 and
    cast to bf16 tensor by tensor, the batches put on the card by the
    prefetch thread. Asserted: exit 0, 13,631,488 trainable params,
    finite losses, the launches of its steps by the formula."""
    entry = get_model(LLAMA)
    want = train_launch_formula(entry.make().num_layers, remat=True,
                                frozen_embed=True)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        shard = write_token_shard(tmp, LORA_SEQ,
                                  entry.num_classes_or_vocab, seed=1)
        with counted_run("lora cli", 1 + LORA_CLI_STEPS, want) as launches:
            result = run_cli(benchmark_main, [
                "--model", LLAMA, "--lora_rank", str(LORA_RANK),
                "--seq_len", str(LORA_SEQ), "--steps", str(LORA_CLI_STEPS),
                "--data", shard])
    losses = result["warmup_losses"] + result["losses"]
    if result["trainable_params"] != LORA_TRAINABLE or not all(
            np.isfinite(losses)):
        raise AssertionError(f"lora cli: {result}")
    report = {k: result.get(k) for k in (
        "device", "step_time_ms", "tokens_per_sec", "mfu_pct",
        "model_flops_util_pct", "trainable_params", "trainable_pct",
        "compile_plus_warmup_s")}
    report.update(card=card, losses=losses)
    log(f"lora benchmark CLI: {json.dumps(report)}")
    return report, dict(launches)


def serve_merged(state, params, host_batch, device):
    """The trained adapters merged into the served params
    (``merge_lora``), then served. Asserted: every merged weight is
    W + (A·B·α/r)ᵀ rounded to bf16 once and every other tensor the
    served one, bit for bit; ``LoadedModel.run`` predict at [1, 1024]
    equals the merged weights applied on the same route bit for bit,
    with one flash launch a layer; it is within LOGITS_REL_RMS_TOL of
    the adapter forward and closer to it than the unmerged base; a
    greedy generate of 16 tokens."""
    entry = get_model(LLAMA)
    vocab = entry.num_classes_or_vocab
    ids = torch.from_numpy(host_batch["input_ids"]).to(device)
    dense = entry.make(lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA,
                       attention_fn=functools.partial(dense_attention,
                                                      causal=True))
    with torch.no_grad():
        adapter = apply(state.model, state.variables(), ids)
        floor = rel_rms(apply(dense, state.variables(), ids), adapter)
        unmerged = rel_rms(apply(entry.make(), params, ids), adapter)
    merged = merge_lora(params, state.lora, alpha=LORA_ALPHA)
    adapted = {k[:-len(".lora_a")] for k in state.lora
               if k.endswith(".lora_a")}
    moved = total = 0
    for name, w in merged.items():
        layer = name[:-len(".weight")]
        if layer not in adapted:
            if w is not params[name]:
                raise AssertionError(f"merge: {name} is not the served "
                                     "tensor")
            continue
        a = state.lora[f"{layer}.lora_a"].float()
        b = state.lora[f"{layer}.lora_b"].float()
        want = (params[name].float()
                + (a @ b * (LORA_ALPHA / LORA_RANK)).T).to(w.dtype)
        if w.dtype != params[name].dtype or not torch.equal(w, want):
            raise AssertionError(f"merge: {name} is not W + (A·B·α/r)ᵀ "
                                 "rounded once")
        moved += int((w != params[name]).sum())
        total += w.numel()
    loaded = LoadedModel(
        llama_metadata("predict", LORA_SEQ, {"dtype": "bfloat16"}), 1,
        merged, max_batch=1, device=device)
    zero_counts()
    out = loaded.run({"input_ids": host_batch["input_ids"]},
                     method="predict")
    flash_n = read_counts()["flash_attention"]
    logits = torch.from_numpy(out["logits"]).to(device)
    with torch.no_grad():
        same_route = torch.equal(
            logits, apply(entry.make(dtype="bfloat16"), merged, ids))
    err = rel_rms(logits, adapter)
    layers = entry.make().num_layers
    del logits, adapter, loaded
    if not same_route or flash_n != layers or not (
            err < LOGITS_REL_RMS_TOL and err < unmerged):
        raise AssertionError(
            f"merged model: served == the same weights applied: "
            f"{same_route}; {flash_n} flash launches (expected {layers}); "
            f"relative RMS {err} vs the adapter forward (tol "
            f"{LOGITS_REL_RMS_TOL}; the unmerged base {unmerged}, the floor "
            f"{floor})")
    prompt = host_batch["input_ids"][:, :MERGE_GENERATE_PROMPT]
    gen_model = LoadedModel(ModelMetadata(
        model_name=LLAMA, registry_name=LLAMA,
        model_kwargs={"dtype": "bfloat16",
                      "cache_size": MERGE_GENERATE_PROMPT
                      + MERGE_GENERATE_TOKENS},
        signatures={"serving_default": Signature(
            method="generate",
            inputs={"input_ids": TensorSpec(
                "int32", (-1, MERGE_GENERATE_PROMPT))},
            outputs={"tokens": TensorSpec(
                "int32", (-1, MERGE_GENERATE_TOKENS))})},
        generate_config={"max_new_tokens": MERGE_GENERATE_TOKENS,
                         "temperature": 0.0}), 1, merged, max_batch=1,
        device=device)
    tokens = gen_model.run({"input_ids": prompt})["tokens"]
    del gen_model, merged
    if tokens.shape != (1, MERGE_GENERATE_TOKENS) or not (
            (tokens >= 0) & (tokens < vocab)).all():
        raise AssertionError(f"merged generate tokens {tokens.shape} out of "
                             "range")
    report = {"weights_exact": True, "served_equals_applied": same_route,
              "adapted_weights_changed_share": moved / total,
              "logits_vs_adapter_rel_rms": err,
              "unmerged_base_vs_adapter_rel_rms": unmerged,
              "adapter_dense_vs_flash_rel_rms": floor,
              "flash_launches": flash_n,
              "tokens": tokens[0].tolist()}
    log(f"lora merged and served: {json.dumps(report)}")
    return report


def train_pretrain(card):
    """The pretraining step through the tpu-lm CLI
    (``training.pretrain.main``: ``fit``, the prefetch thread, the
    vocabulary check on the host) with its optimizer
    (``clip_by_global_norm(1.0)``, then ``adamw(warmup_cosine(0, 1e-4,
    2, 10), weight_decay=0.01)``) on ``llama3-8b --num_layers 4``, fp32
    masters, b1 × L2048, on a token shard of one repeated sequence (a
    fixed batch), every step logged. The first update's rate is
    schedule(0) = 0, so it changes no param: step 2's loss equals step
    1's bit for bit. The loss falls over 10 steps; the launches by the
    formula; peak memory < 80 GB."""
    entry = get_model(LLAMA)
    model = entry.make(num_layers=PRETRAIN_LAYERS)
    want = train_launch_formula(PRETRAIN_LAYERS, remat=False,
                                frozen_embed=False)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        shard = write_token_shard(tmp, PRETRAIN_SEQ,
                                  entry.num_classes_or_vocab, seed=2)
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        with counted_run("pretrain", PRETRAIN_STEPS, want) as launches:
            final = run_cli(pretrain_main, [
                "--model", LLAMA, "--num_layers", str(PRETRAIN_LAYERS),
                "--global_batch", "1", "--seq_len", str(PRETRAIN_SEQ),
                "--steps", str(PRETRAIN_STEPS),
                "--warmup_steps", str(PRETRAIN_WARMUP),
                "--learning_rate", str(PRETRAIN_LR), "--log_every", "1",
                "--data", shard, "--metrics_path", metrics_path])
        with open(metrics_path) as f:
            records = [json.loads(line) for line in f]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in records]
    if final["final_step"] != PRETRAIN_STEPS or [
            r["step"] for r in records] != list(
                range(1, PRETRAIN_STEPS + 1)):
        raise AssertionError(f"pretrain: {final}, logged steps "
                             f"{[r['step'] for r in records]}")
    if losses[1] != losses[0]:
        raise AssertionError(f"pretrain: the first update (lr = "
                             f"schedule(0) = 0) moved the loss on the fixed "
                             f"batch: {losses[0]!r} → {losses[1]!r}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"pretrain: the loss did not fall over "
                             f"{PRETRAIN_STEPS} steps: {losses}")
    if peak_gb >= 80:
        raise AssertionError(f"pretrain: peak {peak_gb} GB")
    # Each logged window is one step; the first two hold the warmup.
    step_ms = statistics.median(1e3 / r["steps_per_sec"]
                                for r in records[2:])
    flops = lm_train_flops(model, 1, PRETRAIN_SEQ)
    model_flops = lm_train_flops(model, 1, PRETRAIN_SEQ, causal=True)
    report = {
        "card": card, "model": f"{LLAMA} --num_layers {PRETRAIN_LAYERS}",
        "seq_len": PRETRAIN_SEQ,
        "params": sum(p.numel() for p in model.parameters()),
        "losses": losses, "step_ms": step_ms,
        "step_ms_each": [1e3 / r["steps_per_sec"] for r in records],
        "tokens_per_s": PRETRAIN_SEQ / step_ms * 1e3,
        "flops_per_step": flops,
        "hfu_pct": flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"] * 100,
        "model_flops_per_step": model_flops,
        "model_flops_util_pct": (model_flops / (step_ms / 1e3)
                                 / PEAK_FLOPS["bfloat16"] * 100),
        "peak_memory_gb": peak_gb, "per_step": want,
    }
    log(f"pretrain step: {json.dumps(report)}")
    return report, dict(launches)


def train_lm(card, params):
    """Phase 4z: LoRA on the served params, merged and served; the LoRA
    benchmark's CLI on a token shard; then the pretraining step through
    the tpu-lm CLI. The serving phases' engines and caches are gone by
    now. Returns the train path's flash and RMSNorm launches."""
    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    for phase, args in ((train_lora, (card, params)),
                        (train_lora_cli, (card,)),
                        (train_pretrain, (card,))):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{phase.__name__}: {torch.cuda.memory_allocated() / 1e9:.2f} "
            "GB allocated at the start (the served params)")
        _, got = timed(phase, *args)
        for k in launches:
            launches[k] += got[k]
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def verify_forward_launches(card, registry, params):
    """One speculative verify forward (4 slots × SPEC_K + 1 tokens over a
    544-slot cache) beside one decode step at the same rows: each
    forward's kernel launches (zeroed just before it), the rows each
    decode-GEMM launch took, and its device ms from the profiler. The
    verify must launch the decode GEMM 225 times at M = 20, RMSNorm 65
    and decode attention 32·(k + 1) times, and no prefill GEMM; no CUDA
    tensor may reach a plain twin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    model = get_model(registry).make(dtype="bfloat16",
                                     cache_size=ENGINE_CACHE)
    n, width = len(DECODE_POSITIONS), SPEC_K + 1
    shape = (n, ENGINE_CACHE, model.num_kv_heads, model.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(12)
    cache = [LayerCache(torch.randn(shape, device="cuda", generator=gen).to(
        torch.bfloat16), torch.randn(shape, device="cuda", generator=gen).to(
        torch.bfloat16)) for _ in range(model.num_layers)]
    pos = torch.tensor(DECODE_POSITIONS, device="cuda")
    block = torch.randint(0, model.vocab_size, (n, width), device="cuda",
                          generator=gen)
    pads = torch.zeros(n, dtype=torch.int32, device="cuda")
    forwards = {
        "decode step": lambda: apply(
            model, params, block[:, :1], pos[:, None], pad_lengths=pads,
            decode_positions=pos, cache=cache),
        "verify": lambda: apply(
            model, params, block, pos[:, None] + torch.arange(
                width, device="cuda")[None], pad_lengths=pads,
            decode_positions=pos, cache=cache)}
    rows_seen = []
    saved = llama.decode_linear

    def counted(x, w):
        rows_seen.append(x.reshape(-1, x.shape[-1]).shape[0])
        return saved(x, w)

    out = {"card": card}
    for name, fn in forwards.items():
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            llama.decode_linear = counted
            rows_seen.clear()
            try:
                with twin_calls() as twins:
                    zero_counts()
                    fn()
                    torch.cuda.synchronize()
                    counts = read_counts()
            finally:
                llama.decode_linear = saved
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        cuda_rows = [r for r in prof.key_averages()
                     if r.device_type == DeviceType.CUDA]
        out[name] = {"launches": counts, "decode_gemm_rows": sorted(
            set(rows_seen)), "plain_twins": twins,
            "device_ms": sum(r.self_device_time_total
                             for r in cuda_rows) / 1e3,
            "kernel_launches": sum(r.count for r in cuda_rows)}
    log(f"verify forward vs decode step (4 slots, k={SPEC_K}, cache "
        f"{ENGINE_CACHE}): {json.dumps(out)}")
    want = {"decode_gemm": STEP_LAUNCHES["decode_gemm"],
            "rms_norm": STEP_LAUNCHES["rms_norm"],
            "add_rms_norm": STEP_LAUNCHES["add_rms_norm"],
            "decode_attention": STEP_LAUNCHES["decode_attention"] * width,
            "prefill_gemm": 0, "flash_attention": 0}
    verify = out["verify"]
    if (verify["launches"] != want or verify["decode_gemm_rows"] != [
            n * width] or any(verify["plain_twins"].values())):
        raise AssertionError(f"verify forward: launches "
                             f"{verify['launches']}, expected {want}; "
                             f"decode GEMM rows {verify['decode_gemm_rows']}"
                             f"; plain twins {verify['plain_twins']}")
    return out


def export_round_trip(device=None):
    """Phase 4e: ``llama-test`` (fp32 and bf16) through the port's
    ``export_model`` and back through ``load_version``, on the disk of
    the machine, inside the checkout: predict logits equal the in-memory
    model's bit for bit."""
    x = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".export-") as base:
        for version, dtype in ((1, "float32"), (2, "bfloat16")):
            meta = ModelMetadata(
                model_name="llama-test", registry_name="llama-test",
                model_kwargs={"dtype": dtype},
                signatures={"serving_default": Signature(
                    method="predict",
                    inputs={"input_ids": TensorSpec("int32", (-1, 16))},
                    outputs={})})
            params = init_params(llama_test(dtype=dtype), seed=0,
                                 device=device)
            memory = LoadedModel(meta, version, params, max_batch=2,
                                 device=device)
            path = export_model(base, version, meta, {"params": (
                unflatten_tree(params_to_flax(params)))})
            loaded = load_version(str(path), max_batch=2, device=device)
            a = memory.run({"input_ids": x})["logits"]
            b = loaded.run({"input_ids": x})["logits"]
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"llama-test {dtype} export round trip: logits max "
                    f"|Δ| {np.abs(a - b).max()}")
            log(f"export round trip llama-test {dtype}: "
                f"{os.path.getsize(os.path.join(path, 'params.msgpack'))} "
                f"bytes, predict logits bit-equal")


def bn_bound(m, m_stat, c, dtype):
    """Least time (ms) the card could take for one BN forward, what
    bounds it, and the two-read figure beside it. The bound: x read
    once and y written once (scale and bias read, mean and var written),
    against a few fp32 operations per element (square and two adds for
    the stats, subtract, multiply and add to normalize). ``two_read_ms``
    also reads the stat rows a second time: the traffic of a design
    that streams x twice."""
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * m * c * elem + 4 * c * 4
    flops = 3.0 * m_stat * c + 3.0 * m * c
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    two_read = (nbytes + m_stat * c * elem) / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "two_read_ms": max(t_ops, two_read)}


def resnet50_bn_shapes(batch: int = RESNET_BATCH) -> list:
    """``[(M, C, layers)]``: each distinct [M, C] that ResNet-50's BN
    layers hand the kernel in a training forward at ``batch``, 224²,
    with the number of layers at it, in order of first use. From a
    forward on the meta device whose BN layers record their rows view
    (meta convolutions return NCHW strides, so each BN input is made
    channels-last first, as on the card)."""
    seen = {}

    def record(x, scale, bias, eps=1e-5, stat_rows=None):
        seen[tuple(x.shape)] = seen.get(tuple(x.shape), 0) + 1
        c = x.shape[1]
        return (torch.empty_like(x), x.new_empty(c, dtype=torch.float32),
                x.new_empty(c, dtype=torch.float32))

    entry = get_model("resnet50")
    model = entry.make(norm_fn=record)
    for mod in model.modules():
        if isinstance(mod, GhostBatchNorm):
            mod.register_forward_pre_hook(lambda _, args: (
                args[0].contiguous(memory_format=torch.channels_last),
                *args[1:]))
    x = torch.empty(batch, *entry.input_spec[0], device="meta")
    with torch.no_grad():
        model(x, train=True)
    return [(m, c, n) for (m, c), n in seen.items()]


def check_bn(name, nhw, c, dtype, stat_rows=None, layers=0, eps=1e-5):
    """The BN kernel vs its plain version on one [N·H·W, C] shape, with
    ``stat_rows`` leading rows feeding the statistics (all when None):
    y, the stats and the same bits on a second call; then the kernel's
    time (20 back-to-back calls per event pair, median of 7), its kernel
    time from the profiler (``device_ms``: at the small shapes a call's
    host work outlasts its kernel), one call per pair, the plain
    version's, and ``F.batch_norm``'s timed both ways, only where it
    computes the same function (all rows)."""
    n, h, w = nhw
    m = n * h * w
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(m, c, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    scale = torch.rand(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)
    run = functools.partial(fused_bn_train_forward, x, scale, bias,
                            eps=eps, stat_rows=stat_rows)
    plain = functools.partial(reference_bn_train_forward, x, scale, bias,
                              eps=eps, stat_rows=stat_rows)
    y, mean, var = run()
    torch.cuda.synchronize()
    y_ref, mean_ref, var_ref = plain()
    dt = str(dtype).replace("torch.", "")
    err = float((y.float() - y_ref.float()).abs().max())
    y_tol = BN_Y_REL_TOL[dt] * max(1.0, float(y_ref.float().abs().max()))
    stat_err = max(float((mean - mean_ref).abs().max()),
                   float((var - var_ref).abs().max()))
    # Bits: the partials are summed in a fixed order, no atomics.
    y2, mean2, var2 = run()
    deterministic = (torch.equal(y, y2) and torch.equal(mean, mean2)
                     and torch.equal(var, var2))
    del y_ref, y2
    if (not torch.isfinite(y).all() or err > y_tol
            or stat_err > BN_STAT_TOL or not deterministic):
        raise AssertionError(
            f"bn {name}: y max |Δ| {err} (tol {y_tol}), stats max |Δ| "
            f"{stat_err} (tol {BN_STAT_TOL}), deterministic {deterministic}")
    # Event timings first: the profiler runs after them.
    ms, ms_one_call = time_ms(run, **KERNEL_TIMING), time_ms(run)
    library_ms = library_device_ms = None
    if stat_rows is None:
        nchw = x.view(n, h, w, c).permute(0, 3, 1, 2)  # channels-last
        library = functools.partial(
            F.batch_norm, nchw, None, None, weight=scale, bias=bias,
            training=True, momentum=0.0, eps=eps)
        library_ms = time_ms(library, **KERNEL_TIMING)
        library_device_ms = profiled_ms(library)
    bound = bn_bound(m, m if stat_rows is None else stat_rows, c, dtype)
    row = {"shape": name, "dtype": dt, "layers": layers,
           "max_abs_err": err, "tol": y_tol,
           "stats_max_abs_err": stat_err, "stats_tol": BN_STAT_TOL,
           "ms": ms, "device_ms": profiled_ms(run),
           "ms_one_call": ms_one_call,
           # The plain version makes fp32 copies of x: few reps where
           # x is hundreds of MB.
           "plain_ms": time_ms(plain, reps=3 if m * c > 5e7 else 10,
                               warmup=1),
           "library_ms": library_ms, "library_device_ms": library_device_ms,
           **bound,
           "bound_share": bound["bound_ms"] / ms,
           "two_read_share": bound["two_read_ms"] / ms}
    log(f"bn {name}: {json.dumps(row)}")
    return row


def bn_kernel_table():
    """The BN kernel at every distinct BN shape of ResNet-50 at b256,
    exact and with ``bn_stat_rows=32`` (the leading 32 of 256 images),
    plus a ragged fp32 case off the vector width (the scalar path); the
    per-step sums Σ layers·ms and Σ layers·bound of both runs."""
    shapes = resnet50_bn_shapes()
    if (sum(n for *_, n in shapes) != RESNET50_BN_LAYERS
            or len(shapes) != len(set((m, c) for m, c, _ in shapes))):
        raise AssertionError(f"resnet50 BN shapes {shapes}")
    rows = []
    for stat_images in (None, 32):
        for m, c, n in shapes:
            stat_rows = None if stat_images is None else (
                m * stat_images // RESNET_BATCH)
            name = f"[{m},{c}] bf16" + (
                "" if stat_rows is None else f" stat_rows={stat_rows}")
            side = math.isqrt(m // RESNET_BATCH)
            rows.append(check_bn(name, (RESNET_BATCH, side, side), c,
                                 torch.bfloat16, stat_rows, n))
    # Ragged: M and C multiples of no tile (the scalar path).
    rows.append(check_bn("[100003,99] fp32", (100003, 1, 1), 99,
                         torch.float32))
    for label, ghost in (("exact BN", False), ("bn_stat_rows=32", True)):
        step = [r for r in rows if r["layers"] and
                ("stat_rows" in r["shape"]) == ghost]
        sums = {k: sum(r["layers"] * r[k] for r in step)
                for k in ("ms", "device_ms", "ms_one_call", "bound_ms",
                          "two_read_ms")}
        log(f"bn per ResNet-50 step, {label}: Σ layers·ms "
            f"{json.dumps(sums)} over {sum(r['layers'] for r in step)} "
            f"layers")
    return rows


def bn_layers(model) -> int:
    return sum(isinstance(m, GhostBatchNorm) for m in model.modules())


def _max_abs(a: dict, b: dict) -> float:
    return max(float((a[k].detach().cpu() - b[k].detach().cpu()).abs().max())
               for k in a)


def resnet_test_agreement():
    """``resnet-test`` fp32, one train step: on the card (the BN kernel
    in fp32) and on the CPU (its plain version) from the same variables
    and batch — loss, grad_norm, params and batch_stats within
    TRAIN_TOL. 64² images keep the last stage's BN off the 1×1,
    near-zero-variance inputs that amplify any summation order."""
    rng = np.random.default_rng(0)
    batch = {"inputs": torch.from_numpy(rng.standard_normal(
                 (16, 64, 64, 3), dtype=np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, 16))}
    out = {}
    for device in ("cpu", "cuda"):
        model = get_model("resnet-test").make(dtype="float32")
        params, stats = init_vision(model, seed=0, device="cpu")
        state = create_train_state(
            model, sgd(0.1, 0.9), {k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in stats.items()})
        fused_bn_train_forward.launches = 0
        state, metrics = make_train_step()(
            state, {k: v.to(device) for k, v in batch.items()})
        out[device] = (state, {k: float(v) for k, v in metrics.items()},
                       fused_bn_train_forward.launches)
    (cpu, m_cpu, n_cpu), (gpu, m_gpu, n_gpu) = out["cpu"], out["cuda"]
    errs = {"loss": abs(m_cpu["loss"] - m_gpu["loss"]),
            "grad_norm": abs(m_cpu["grad_norm"] - m_gpu["grad_norm"]),
            "params": _max_abs(gpu.params, cpu.params),
            "batch_stats": _max_abs(gpu.batch_stats, cpu.batch_stats)}
    if (n_cpu != 0 or n_gpu != bn_layers(gpu.model)
            or max(errs.values()) > TRAIN_TOL):
        raise AssertionError(f"resnet-test train step cuda vs cpu: {errs}; "
                             f"BN launches cpu {n_cpu}, cuda {n_gpu}")
    log(f"resnet-test fp32 train step cuda vs cpu: max |Δ| "
        f"{json.dumps(errs)} (tol {TRAIN_TOL}); {n_gpu} BN kernel launches")


def bn_fp64_stats(x, scale, bias, *, eps=1e-5, stat_rows=None):
    """Another plain BN: the statistics summed in fp64, then the same
    fp32 formula. Against the plain version it gives the bf16 noise
    floor of the ResNet forward."""
    xs = (x if stat_rows is None else x[:stat_rows]).double()
    mean = xs.mean(0)
    var = torch.clamp(xs.square().mean(0) - mean.square(), min=0.0)
    mean, var = mean.float(), var.float()
    y = (x.float() - mean) * (torch.rsqrt(var + eps) * scale) + bias
    return y.to(x.dtype), mean, var


def resnet50_first_step_agreement(config, entry, params, stats):
    """The first step's forward (train mode) through the BN kernel vs
    through the plain BN, from the benchmark's params and batch:
    relative RMS of the logits, within twice the bf16 floor measured
    beside it (plain BN vs plain BN with fp64 statistics)."""
    batch = synthetic_batch(config, entry.num_classes_or_vocab,
                            entry.input_spec[0], torch.device("cuda"))
    logits, losses = {}, {}
    for label, norm_fn in (("kernel", None),
                           ("plain", reference_bn_train_forward),
                           ("fp64_stats", bn_fp64_stats)):
        model = entry.make(norm_fn=norm_fn, **config.model_kwargs)
        with torch.no_grad():
            out = apply_vision(model, params,
                               {k: v.clone() for k, v in stats.items()},
                               batch["inputs"], train=True)
        logits[label] = out
        losses[label] = float(F.cross_entropy(out, batch["labels"]))
    err = rel_rms(logits["kernel"], logits["plain"])
    floor = rel_rms(logits["fp64_stats"], logits["plain"])
    tol = 2 * floor
    row = {"logits_rel_rms": err, "floor_rel_rms": floor, "tol": tol,
           "loss_kernel": losses["kernel"], "loss_plain": losses["plain"],
           "loss_fp64_stats": losses["fp64_stats"]}
    log(f"resnet50 first step, kernel vs plain BN: {json.dumps(row)}")
    if not all(torch.isfinite(v).all() for v in logits.values()):
        raise AssertionError("resnet50 logits are not finite")
    if err > tol:
        raise AssertionError(f"resnet50 logits differ: relative RMS {err} > "
                             f"{tol} (twice the floor {floor})")
    return row


def train_resnet50(card):
    """The ResNet slice at full width: run_benchmark in both
    configurations, launch counts zeroed just before each and read just
    after. Returns the BN kernel's launches over both."""
    entry = get_model("resnet50")
    if bn_layers(entry.make()) != RESNET50_BN_LAYERS:
        raise AssertionError("resnet50 does not have 53 BN layers")
    total = 0
    for name, batch, warmup, steps, stat_rows in RESNET_RUNS:
        config = BenchConfig(model="resnet50", batch_size=batch, steps=steps,
                             warmup_steps=warmup, learning_rate=0.1,
                             momentum=0.9, seed=0,
                             model_kwargs={"bn_stat_rows": stat_rows})
        torch.cuda.reset_peak_memory_stats()
        fused_bn_train_forward.launches = 0
        result = run_benchmark(config)
        launches = fused_bn_train_forward.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        total += launches
        losses = result.pop("losses")
        result.update(card=card, peak_memory_gb=peak_gb,
                      bn_launches=launches, losses=losses)
        log(f"resnet50 {name}: {json.dumps(result)}")
        expected = RESNET50_BN_LAYERS * (warmup + steps)
        if launches != expected:
            raise AssertionError(f"resnet50 {name}: {launches} BN kernel "
                                 f"launches, expected {expected}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"resnet50 {name}: loss did not fall on "
                                 f"the fixed batch: {losses}")
        if peak_gb >= 80:
            raise AssertionError(f"resnet50 {name}: peak {peak_gb} GB")
        if stat_rows:
            params, stats = init_vision(entry.make(), seed=0)
            resnet50_first_step_agreement(config, entry, params, stats)
            del params, stats
    return total


def bn_routes(shapes) -> None:
    """The BN launch plan at each shape, from the card's own limits:
    the route, the rows a block keeps in shared memory and the grid.
    The layers whose stat slab fits in shared memory must take the
    on-chip route, which reads x from device memory once."""
    lib = bn_fused._library()
    coresident, slab = bn_fused.device_limits(
        lib, torch.device("cuda", torch.cuda.current_device()), 1, 8)
    log(f"bn limits: {coresident} co-resident blocks, {slab} bytes of x a "
        f"block may keep")
    for m, c, n in shapes:
        for stat_rows in (None, m // 8):
            plan = bn_fused.launch_plan(m, c, 8, 2, stat_rows,
                                        coresident=coresident,
                                        slab_bytes=slab)
            log(f"bn plan [{m},{c}] stat_rows={stat_rows}: "
                f"{json.dumps(dataclasses.asdict(plan))}")
            fits = plan.stat_per * min(plan.tx * 8, c) * 2 <= slab
            if (plan.route == "onchip") != fits or plan.grid > coresident:
                raise AssertionError(f"bn plan [{m},{c}]: {plan}")
    onchip = [(m, c) for m, c, _ in shapes if bn_fused.launch_plan(
        m, c, 8, 2, coresident=coresident, slab_bytes=slab).route == "onchip"]
    log(f"bn on-chip route (exact BN): {onchip}")
    if not {(12544, 512), (50176, 256)} <= set(onchip):
        raise AssertionError("the smallest ResNet-50 BN layers do not take "
                             "the on-chip route")



# -- the gang: the batch axes (dcn_data, data, fsdp) on one card ---------------

#: llama3-8b LoRA steps on each mesh, and unmeshed beside them.
GANG_LORA_STEPS = 2
GANG_MESHES = (("data=-1", MeshSpec(data=-1)), ("fsdp=-1", MeshSpec(fsdp=-1)))
#: The BN route's headline row (the row every PR has reported).
BN_MAIN = (802816, 256)


@contextlib.contextmanager
def nccl_gang():
    """An nccl group of one process on the card (a TCP rendezvous on
    localhost), as a one-card gang forms: every collective of the mesh
    trainers is a real nccl launch on it."""
    dist = torch.distributed
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"gang backend {dist.get_backend()}")
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def counted_collectives():
    """Counts the all-reduces, all-gathers and reduce-scatters issued on
    the group while the block runs."""
    dist = torch.distributed
    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
    counts = dict.fromkeys(names, 0)
    real = {n: getattr(dist, n) for n in names}

    def counting(name):
        def call(*args, **kw):
            counts[name] += 1
            return real[name](*args, **kw)
        return call

    for n in names:
        setattr(dist, n, counting(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(dist, n, real[n])


def gang_lora(card, params):
    """llama3-8b LoRA (r 16, remat, b1 × L1024, ``adamw(1e-4)``) for two
    steps unmeshed, then through ``DevicePrefetcher(mesh)`` and
    ``make_lora_train_step(mesh)`` on ``MeshSpec(data=-1)`` and
    ``MeshSpec(fsdp=-1)`` of the one-rank nccl group, from the same
    served params and seed. Asserted, on each mesh: loss, accuracy and
    grad norm of both steps, the adapters and the moments equal the
    unmeshed run's bit for bit; the run launches the flash and RMSNorm
    kernels as often as the unmeshed one and issues nccl collectives.
    Returns (the data mesh's final state, the meshed runs' launches)."""
    entry = get_model(LLAMA)
    batches = list(itertools.islice(synthetic_causal_lm(
        1, LORA_SEQ, entry.num_classes_or_vocab, seed=2), GANG_LORA_STEPS))
    model = entry.make(lora_rank=LORA_RANK, remat=True)

    def run(mesh):
        state, _ = create_lora_state(model, adamw(LORA_LR), params, seed=0,
                                     mesh=mesh, base_dtype=torch.bfloat16)
        step = make_lora_train_step(mesh)
        source = DevicePrefetcher(iter(batches), mesh, prefetch=1)
        metrics = []
        zero_counts()
        try:
            for batch in source:
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            source.close()
        torch.cuda.synchronize()
        return state, metrics, {k: read_counts()[k] for k in TRAIN_KERNELS}

    ref_state, ref_metrics, ref_launches = run(None)
    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    kept = None
    for name, spec in GANG_MESHES:
        mesh = build_mesh(spec)
        with counted_collectives() as collectives:
            state, metrics, got = run(mesh)
        if metrics != ref_metrics:
            raise AssertionError(f"gang lora {name}: metrics {metrics} != "
                                 f"unmeshed {ref_metrics}")
        for k, v in ref_state.lora.items():
            mu, nu = (state.opt_state[0].mu[k], state.opt_state[0].nu[k])
            if not (torch.equal(state.lora[k], v)
                    and torch.equal(mu, ref_state.opt_state[0].mu[k])
                    and torch.equal(nu, ref_state.opt_state[0].nu[k])):
                raise AssertionError(f"gang lora {name}: adapter {k} or its "
                                     "moments differ from the unmeshed run")
        if got != ref_launches or not all(got.values()) or not (
                collectives["all_reduce"]):
            raise AssertionError(f"gang lora {name}: launches {got} (unmeshed "
                                 f"{ref_launches}), collectives {collectives}")
        for k in launches:
            launches[k] += got[k]
        log(f"gang lora {name} {dict(mesh.shape)}: {GANG_LORA_STEPS} steps "
            f"bitwise the unmeshed run's (losses "
            f"{[m['loss'] for m in metrics]}), launches {got}, nccl "
            f"collectives {collectives} [{card}]")
        if kept is None:
            kept = state
        del state
    return kept, launches


def gang_checkpoint(card, state):
    """The data mesh's LoRA training state (step, adapters, moments; the
    frozen base is the served params) saved by two checkpointers, host ids
    0 and 1 of a two-host gang, over one directory, then restored into a
    one-host state: every leaf bit-equal, two shard files and the
    manifest's host count and plan as the reference writes them."""
    saved = {"step": state.step, "lora": state.lora,
             "opt_state": state.opt_state}
    fresh = {"step": 0,
             "lora": {k: torch.zeros_like(v) for k, v in state.lora.items()},
             "opt_state": adamw(LORA_LR).init(
                 {k: torch.zeros_like(v) for k, v in state.lora.items()})}
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".ckpt-") as base:
        hosts = [ShardedCheckpointer(ContinuousCheckpointConfig(
            directory=base, num_hosts=2, host_id=h, save_interval_steps=1))
            for h in range(2)]
        for ckpt in hosts:
            ckpt.save(state.step, saved, force=True)
        for ckpt in hosts:
            if not ckpt.wait(120.0):
                raise AssertionError("gang checkpoint: a host's write hung")
            ckpt.close()
        step_dir = os.path.join(base, f"step-{state.step:08d}")
        manifest = json.load(open(os.path.join(step_dir, "manifest.json")))
        files = sorted(f for f in os.listdir(step_dir)
                       if f.startswith("state.shard-"))
        reader = ShardedCheckpointer(ContinuousCheckpointConfig(
            directory=base, async_save=False))
        restored = reader.restore(fresh)
        reader.close()
    if (manifest["num_hosts"] != 2 or len(files) != 2
            or not manifest["plan"] or restored["step"] != state.step):
        raise AssertionError(f"gang checkpoint: manifest {manifest}, "
                             f"files {files}")
    for k, v in state.lora.items():
        if not (torch.equal(restored["lora"][k], v) and torch.equal(
                restored["opt_state"][0].mu[k], state.opt_state[0].mu[k])
                and torch.equal(restored["opt_state"][0].nu[k],
                                state.opt_state[0].nu[k])):
            raise AssertionError(f"gang checkpoint: {k} not restored bitwise")
    log(f"gang checkpoint: 2 hosts wrote {files}, plan of "
        f"{len(manifest['plan'])} leaves; restored into one host bitwise in "
        f"{time.monotonic() - t0:.1f} s [{card}]")


def gang_lm(card, params):
    """The gang phase's llama3-8b half in a one-rank nccl group: the
    meshed LoRA steps and the two-host checkpoint of their state (the
    sharded export is the tensor gang's, ``gang_tensor``). Returns the
    meshed runs' launches."""
    with nccl_gang():
        state, launches = timed(gang_lora, card, params)
        timed(gang_checkpoint, card, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- the tensor gang: the tensor axis on one card ------------------------------

#: A tensor=2 rank's llama3-8b decode products: (name, K, N, dtype,
#: launches a step). q, gate and up keep half their columns, o and down
#: half their rows, k and v the rank's kv-head group (4 of 8 heads),
#: the fp32 head half the vocabulary.
TENSOR_DECODE_GEMMS = (
    ("q_proj [4096→2048] bf16", 4096, 2048, torch.bfloat16, 32),
    ("k_proj/v_proj [4096→512] bf16", 4096, 512, torch.bfloat16, 64),
    ("o_proj [2048→4096] bf16", 2048, 4096, torch.bfloat16, 32),
    ("gate_proj/up_proj [4096→7168] bf16", 4096, 7168, torch.bfloat16, 64),
    ("down_proj [7168→4096] bf16", 7168, 4096, torch.bfloat16, 32),
    ("lm_head [4096→64128] fp32", 4096, 64128, torch.float32, 1),
)
#: The same rank's prefill products at M = 512.
TENSOR_PREFILL_GEMMS = tuple((name.rsplit(" ", 1)[0], k, n, per)
                             for name, k, n, dtype, per in
                             TENSOR_DECODE_GEMMS if dtype == torch.bfloat16)
#: llama3-8b's depth in the tensor gang's export. At full width a block
#: is 0.87 GB of fp32 export and the embedding and head 4.2 GB. The
#: phase's time grows about 11 s a block, and the smoke's 1200 s limit,
#: most of it spent before this phase, has no room for another (PERF.md
#: §4 gives the phase's split and the smoke's total), so the depth is
#: cut to 4 blocks.
GANG_TENSOR_LAYERS = 4
#: The engine's four requests: the engine mix's first four prompts, an
#: 8-token budget each, keys PRNGKey(100 + i).
GANG_TENSOR_PROMPTS = ENGINE_PROMPTS[:4]
GANG_TENSOR_TOKENS = 8
GANG_TENSOR_CONFIG = {"max_new_tokens": GANG_TENSOR_TOKENS,
                      "engine_slots": 4, "engine_page_size": 16,
                      "engine_slice_tokens": 4}
GANG_TENSOR_MODES = {"greedy": {"temperature": 0.0}, "sampled": SAMPLING}
#: The prefill's logits, gang vs the monolithic load: relative RMS (the
#: bf16 Llama tolerance of ROADMAP's "held against").
TENSOR_LOGITS_TOL = 3e-2
#: Seconds a rank may take before the phase kills the gang and fails.
GANG_TENSOR_TIMEOUT = 720
#: The tensor gang's kernels: the Llama path's.
TENSOR_KERNELS = ("flash_attention", "decode_gemm", "rms_norm",
                  "add_rms_norm", "decode_attention", "prefill_gemm")
#: The engine lanes the gang runs on its own load, each greedy and
#: sampled: the plain lane (its B = 1 runs, resumes and handoffs), the
#: prefix lane, chunked prefill (chunks of 64) and speculative decoding
#: (k = SPEC_K, with ``weak_draft`` loaded whole on every rank).
GANG_LANES = {"plain": {}, "prefix": {"engine_prefix_cache": True},
              "chunk": {"engine_prefix_cache": True,
                        "engine_prefill_chunk": PREFILL_CHUNK},
              "spec": {"engine_draft_tokens": SPEC_K}}
#: The prefix mix: request 1's prompt, one sharing its first 360 tokens
#: and 100 of its own, then request 1's again.
GANG_PREFIX_SHARED = 360
GANG_PREFIX_TAIL = 100
#: Resumes of request 0 after 1, 4 and 7 of its 8 tokens.
GANG_RESUME_CUTS = (1, GANG_TENSOR_TOKENS // 2, GANG_TENSOR_TOKENS - 1)
#: The handoffs' request: the engine mix's 77-token prompt.
GANG_HANDOFF_REQUEST = 2
#: The fsdp=2 load's greedy run: request 0's first 3 tokens (the prefill
#: and two decode steps). Every forward of that load gathers its 4.9 GB of
#: weights through gloo's host path on the shared card, 5.5 s a forward
#: (measured on one H100): 8 tokens took 44 s of the smoke's limit.
GANG_FSDP_TOKENS = 3


def tensor_rows(kernels):
    """Each kernel at a tensor=2 rank's llama3-8b shapes, held against
    its plain version and timed as the one-rank rows are: the decode
    GEMM at the rank's seven products and half the fp32 head, the
    prefill GEMM at its bf16 ones (M = 512), decode attention at 16
    query heads over 4 kv heads, flash at a [1, 512] causal block of
    those heads. RMSNorm's width (4096) does not change."""
    rows = {"decode_gemm": decode_gemm_rows(TENSOR_DECODE_GEMMS),
            "prefill_gemm": prefill_gemm_rows(TENSOR_PREFILL_GEMMS),
            "decode_attention": decode_attention_rows(16, 4, False),
            "flash_attention": [check_flash(
                kernels, "t: B1 L512 H16/4 D128 causal (tensor=2 rank)", 1,
                512, 16, 4, 128, torch.bfloat16, True, False)]}
    log(f"tensor=2 rank rows: "
        f"{ {k: len(v) for k, v in rows.items()} } held")
    return rows


def spawn_gang(world, transport, case_path, out_dir, *,
               script="tensor_gang.py", timeout=GANG_TENSOR_TIMEOUT,
               tag="[tensor_gang]"):
    """``world`` rank processes of ``scripts/<script>``; each one's
    results. A rank that fails fails the phase; a rank still running at
    ``timeout`` seconds is killed, with its peers, and fails it. The
    ranks' lines that start with ``tag`` are logged."""
    name = script.split(".")[0].replace("_", " ")
    script = os.path.join(ROOT, "scripts", script)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, script, "--rank", str(r), "--world", str(world),
         "--transport", transport, "--port", str(port), "--case", case_path,
         "--out", os.path.join(out_dir, f"rank{r}.pkl")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outputs = []
    try:
        for r, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"{name}: rank {r} still running after {timeout} s; "
                    f"the gang was killed")
            outputs.append(out)
            for line in out.splitlines():
                if line.startswith(tag):
                    log(line)
            if proc.returncode != 0:
                raise AssertionError(f"{name}: rank {r} exited "
                                     f"{proc.returncode}:\n{out[-6000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [pickle.loads(open(os.path.join(out_dir, f"rank{r}.pkl"),
                              "rb").read()) for r in range(world)]


def gang_manager_bases(export, base, modes):
    """A base path a mode for the gang's ``ModelManager``: version 1 is
    the sharded export's shard files (linked, not copied) under a
    signature whose generate config asks for the mode's sampling with
    deterministic keys (so ``ServedModel.submit`` and the version's B = 1
    ``run`` draw the same key)."""
    meta = read_metadata(export)
    bases = {}
    for mode, sampling in modes.items():
        version = os.path.join(base, f"manager-{mode}", "1")
        os.makedirs(version)
        for name in meta.sharding["shards"]:
            os.symlink(os.path.join(export, name),
                       os.path.join(version, name))
        config = dict(meta.generate_config, **sampling, deterministic=True,
                      seed=5)
        with open(os.path.join(version, "signature.json"), "w") as f:
            f.write(dataclasses.replace(meta,
                                        generate_config=config).dumps())
        bases[mode] = os.path.dirname(version)
    return bases


def flax_views(params, model, *, boxed=True):
    """Port params as the Flax tree's leaves (kernels back to ``[in,
    out]``; the same tensors, no copy), boxed where the reference boxes
    them."""
    views = {}
    for name, t in params.items():
        key = flax_key(name)
        leaf = t.T if key.endswith("/kernel") else t
        views[key] = ({"value": leaf} if boxed and model.partitioned(key)
                      else leaf)
    return {"params": unflatten_tree(views)}


def gang_fsdp_export(base, meta, params, model, world):
    """The ``fsdp=world`` export of ``params`` (the monolithic load's: every
    weight in the dtype the load keeps it in, so a load of this export
    holds the same bits) under ``meta``, its generate budget cut to
    GANG_FSDP_TOKENS, by the reference's plan."""
    host = {k: v.cpu() for k, v in params.items()}
    variables = flax_views(host, model)
    spec = sharding.ShardSpec(fsdp=world)
    plan = sharding.build_shard_plan(variables, spec, model)
    config = dict(meta.generate_config, max_new_tokens=GANG_FSDP_TOKENS)
    path = sharding.export_model_sharded(
        os.path.join(base, "fsdp"), 1, dataclasses.replace(
            meta, sharding=None, generate_config=config),
        variables, spec, plan=plan)
    return str(path), plan


def gang_draft_export(base, meta, cache_size):
    """``weak_draft`` as an export (bf16, as it serves) that a gang's
    engine loads whole on every rank (``engine_draft_export``)."""
    draft, params = weak_draft(LLAMA, cache_size)
    dmeta = dataclasses.replace(
        meta, model_name="draft", registry_name=LLAMA, sharding=None,
        model_kwargs={"num_layers": 1, "dtype": "bfloat16",
                      "cache_size": cache_size})
    host = {k: v.to(torch.bfloat16).cpu() for k, v in params.items()}
    del params
    path = export_model(os.path.join(base, "draft"), 1, dmeta,
                        flax_views(host, draft, boxed=False))
    return str(path)


def handoff_kv_rel_rms(blob, ref):
    """The largest relative RMS over a handoff's layers, k and v, of its
    cache against another's of the same prompt (every KV head, in head
    order: a wrong order gives errors of order 1)."""
    a = wire.decode_kv_handoff(blob, model="llama", version=1)
    b = wire.decode_kv_handoff(ref, model="llama", version=1)
    return max(rel_rms(getattr(x, n).float(), getattr(y, n).float())
               for x, y in zip(a.cache, b.cache) for n in ("k", "v"))


def gang_tensor(card, *, transport="gloo", world=2):
    """``kft-export --shards tensor=world`` of llama3-8b at full width,
    cut to GANG_TENSOR_LAYERS blocks (fp32 weights from seed 0, bf16
    compute), served by a gang of ``world`` rank processes
    (``scripts/tensor_gang.py``), each reading only its own shard file,
    and held against the same weights loaded monolithically here.
    Asserted: the manifest's mesh, its shard files and no
    ``params.msgpack``; the export joined on the host is the weights
    kft-export drew, bitwise, and the manifest's plan is
    ``build_shard_plan`` of that tree; each rank opened its own shard
    alone. The gang, in turn:

    - a ``ModelManager`` on rank 0 (a model a mode, loaded onto the gang
      by its poll) with a gRPC server, ``ModelManager.follow()`` on the
      others: the engine mix through ``ServedModel.submit``,
      ``submit_stream`` and a gRPC Predict equal to the version's B = 1
      ``run``, bitwise, greedy and sampled; the followers loaded and
      closed both versions;
    - on its own load: the prefill's logits ([1, 512]) within
      TENSOR_LOGITS_TOL relative RMS of the monolithic forward's; greedy
      tokens of ``run`` equal to the monolithic ``run``'s, or, at a step
      where they first differ, the monolithic top-two margin there at
      most twice the step's max |Δ| of logits between the two; and
      bitwise inside the gang, greedy and sampled: every lane's engine
      streams equal to the gang's B = 1 ``run``; the prefix mix's hits
      equal their cold runs; speculative decoding with ``weak_draft``
      (an export loaded whole on every rank) equal to vanilla; chunked
      prefill equal to one-shot; three resumes (at 1, the middle and
      budget - 1) equal to the uninterrupted stream; the gang's own
      handoff blob adopted by the gang equal to its local stream;
    - a handoff each way with the monolithic load here (its engine's
      blob adopted by the gang, the gang's by its engine): each blob's
      cache, every KV head in head order, within TENSOR_LOGITS_TOL of
      the other side's own prefill of the prompt, and the adopted
      streams' agreement with the other side's reported (the tensor
      split's bf16 sums part the two loads);
    - the ``fsdp=2`` export of the same weights: each rank reads its
      own shard, holds half of the weights at rest, and gives the
      prefill's logits and request 0's first GANG_FSDP_TOKENS greedy
      tokens bitwise the monolithic load's; each rank's peak memory and the fsdp gathers'
      share of a prefill and of a ``run`` reported.

    Every rank's tokens equal rank 0's; every kernel of the path
    launched on every rank. Returns the phase's figures."""
    entry = get_model(LLAMA)
    vocab = entry.num_classes_or_vocab
    kwargs = {"num_layers": GANG_TENSOR_LAYERS, "dtype": "bfloat16"}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in GANG_TENSOR_PROMPTS]
    keys = [np.asarray(prng.PRNGKey(100 + i), np.uint32)
            for i in range(len(prompts))]
    prefill = rng.integers(0, vocab, (1, max(GANG_TENSOR_PROMPTS))).astype(
        np.int32)
    shared = np.concatenate([prompts[1][:GANG_PREFIX_SHARED], rng.integers(
        0, vocab, GANG_PREFIX_TAIL)]).astype(np.int32)
    mix = [prompts[1], shared, prompts[1]]
    mix_keys = [keys[1], np.asarray(prng.PRNGKey(200), np.uint32), keys[1]]
    hand_prompt, hand_key = prompts[GANG_HANDOFF_REQUEST], np.asarray(
        prng.PRNGKey(300), np.uint32)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".tensor-") as base:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = export_cli.main([
                "--model", LLAMA, "--out", f"{base}/export",
                "--seq_len", str(max(GANG_TENSOR_PROMPTS)),
                "--generate", json.dumps(GANG_TENSOR_CONFIG),
                "--model_kwargs", json.dumps(kwargs),
                "--shards", f"tensor={world}"])
        if rc != 0:
            raise AssertionError(f"kft-export --shards tensor={world}: "
                                 f"exit {rc}")
        path = out.getvalue().strip().splitlines()[-1]
        export_s = time.monotonic() - t0
        sizes = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        # The sharded layout: the manifest's mesh and shard files, and
        # no params.msgpack (a server that ignored the manifest fails).
        meta = read_metadata(path)
        manifest = meta.sharding
        if (manifest["num_shards"] != world
                or manifest["mesh"] != {"tensor": world, "fsdp": 1}
                or sorted(sizes) != sorted(["signature.json",
                                            *manifest["shards"]])):
            raise AssertionError(f"sharded export: {manifest} files "
                                 f"{sorted(sizes)}")
        # The same weights on one device, joined on the host.
        t1 = time.monotonic()
        mono = load_version(path, max_batch=1)
        forward = entry.make(**kwargs)
        # The joined weights are those kft-export drew from seed 0, which
        # its monolithic export carries: the sharded write and the joined
        # read lose no bit, so the monolithic export's tokens are this
        # load's. The manifest's plan is the reference's rule on them.
        drawn = init_params(forward, seed=0)
        lost = [k for k, v in drawn.items()
                if not torch.equal(mono.params[k], v)]
        del drawn
        if lost:
            raise AssertionError(f"sharded export joined: {lost[:5]} differ "
                                 f"from the weights kft-export drew")
        # The plan reads shapes alone.
        plan = sharding.build_shard_plan(
            flax_views(mono.params, forward),
            sharding.ShardSpec(tensor=world), forward)
        if manifest["plan"] != plan:
            raise AssertionError(f"sharded export's plan {manifest['plan']} "
                                 f"!= build_shard_plan's {plan}")
        with torch.inference_mode():
            mono_logits = apply(forward, mono.params, torch.from_numpy(
                prefill).cuda()).float().cpu()
        mono_tokens, mono_s = [], []
        for prompt, key in zip(prompts, keys):
            t2 = time.monotonic()
            mono_tokens.append(mono.run(
                {"input_ids": prompt[None]},
                row_rngs=np.asarray([key], np.uint32))["tokens"][0])
            mono_s.append(time.monotonic() - t2)
        fed_mono = []
        with torch.inference_mode():
            for prompt, tokens in zip(prompts, mono_tokens):
                seq = np.concatenate([prompt, tokens[:-1]])[None]
                step = apply(forward, mono.params,
                             torch.from_numpy(seq).cuda())
                fed_mono.append(step[0, len(prompt) - 1:].float().cpu())
        # The card's side of the handoffs: its classic engine a mode,
        # its own stream of the handoff request and its blob.
        card_engines, card_local, card_blobs = {}, {}, {}
        for mode, sampling in GANG_TENSOR_MODES.items():
            (_, spec), = meta.signatures["serving_default"].inputs.items()
            # Eager: capture is not what the handoffs hold.
            engine = card_engines[mode] = DecodeEngine(
                mono._module, mono.params, EngineConfig.from_generate_config(
                    dict(meta.generate_config, **sampling), spec.shape[1]),
                name=f"gang-card-{mode}", capture_graphs=False)
            card_local[mode] = engine.submit(hand_prompt,
                                             rng=hand_key).result(600.0)
            card_blobs[mode] = wire.encode_kv_handoff(
                "llama", 1, engine.run_prefill(hand_prompt, rng=hand_key))
        t2 = time.monotonic()
        fsdp_path, fsdp_plan = gang_fsdp_export(base, meta, mono.params,
                                                forward, world)
        draft_path = gang_draft_export(base, meta,
                                       meta.model_kwargs["cache_size"])
        bases = gang_manager_bases(path, base, GANG_TENSOR_MODES)
        extra_export_s = time.monotonic() - t2
        mono_total = time.monotonic() - t1
        del forward
        gc.collect()
        torch.cuda.empty_cache()
        lanes = dict(GANG_LANES, spec=dict(GANG_LANES["spec"],
                                           engine_draft_export=draft_path))
        case = {"export": path, "model": LLAMA,
                "layers": GANG_TENSOR_LAYERS, "dtype": kwargs["dtype"],
                "prefill": prefill, "prompts": prompts, "keys": keys,
                "mono_tokens": mono_tokens, "modes": GANG_TENSOR_MODES,
                "lanes": lanes, "cuts": GANG_RESUME_CUTS,
                "prefix_prompts": mix, "prefix_keys": mix_keys,
                "handoff_prompt": hand_prompt, "handoff_key": hand_key,
                "incoming": card_blobs, "manager_bases": bases,
                "fsdp_export": fsdp_path}
        case_path = os.path.join(base, "case.pkl")
        with open(case_path, "wb") as f:
            pickle.dump(case, f)
        t1 = time.monotonic()
        ranks = spawn_gang(world, transport, case_path, base)
        gang_s = time.monotonic() - t1
        # The gang's blobs adopted by the card's engines.
        card_adopted, kv_err = {}, {}
        for mode, engine in card_engines.items():
            blob = ranks[0][mode, "plain"]["blob"]
            card_adopted[mode] = engine.submit(handoff=wire.decode_kv_handoff(
                blob, model="llama", version=1)).result(600.0)
            kv_err[mode] = handoff_kv_rel_rms(blob, card_blobs[mode])
            engine.stop()
        del card_engines, mono
        gc.collect()
        torch.cuda.empty_cache()
    shards = [f"params.shard-{r:05d}-of-{world:05d}.msgpack"
              for r in range(world)]
    for r, res in enumerate(ranks):
        if res["opened"] != [shards[r]] or not res["topology"]["on_mesh"]:
            raise AssertionError(f"tensor gang rank {r} opened "
                                 f"{res['opened']}, topology "
                                 f"{res['topology']}")
        missing = [k for k in TENSOR_KERNELS if not res["launches"][k]]
        if missing:
            raise AssertionError(f"tensor gang rank {r}: {missing} never "
                                 f"launched ({res['launches']})")
    lead = ranks[0]
    got = torch.from_numpy(lead["prefill_logits"])
    err = rel_rms(got, mono_logits)
    max_err = float((got - mono_logits).abs().max())
    if not torch.isfinite(got).all() or err > TENSOR_LOGITS_TOL:
        raise AssertionError(f"tensor gang prefill logits: relative RMS "
                             f"{err} > {TENSOR_LOGITS_TOL} (max |Δ| "
                             f"{max_err})")
    gang_manager_ok(ranks, lead)
    divergences = gang_lanes_ok(ranks, lead, mono_tokens, fed_mono)
    handoffs = {}
    for mode in GANG_TENSOR_MODES:
        plain = lead[mode, "plain"]
        kv = max(kv_err[mode], handoff_kv_rel_rms(card_blobs[mode],
                                                  plain["blob"]))
        if kv > TENSOR_LOGITS_TOL:
            raise AssertionError(f"tensor gang {mode} handoff: the two "
                                 f"loads' caches part by {kv} relative RMS")
        handoffs[mode] = {
            "kv_rel_rms": kv,
            "card_to_gang_first_differs": first_divergence(
                plain["adopted"], card_local[mode]),
            "gang_to_card_first_differs": first_divergence(
                card_adopted[mode], card_local[mode])}
    fsdp = gang_fsdp_ok(ranks, world, mono_logits, mono_tokens)
    per_token = {"gang_ms": statistics.median(lead["greedy", "plain"]["b1_s"])
                 * 1e3 / GANG_TENSOR_TOKENS,
                 "one_rank_ms": statistics.median(mono_s) * 1e3
                 / GANG_TENSOR_TOKENS}
    figures = {
        "card": card, "transport": transport, "ranks": world,
        "layers": GANG_TENSOR_LAYERS, "plan_leaves": len(plan),
        "fsdp_plan_leaves": len(fsdp_plan),
        "export_s": export_s, "extra_exports_s": extra_export_s,
        "mono_s": mono_total, "gang_s": gang_s,
        "load_s": [r["load_s"] for r in ranks],
        "manager_load_s": lead["manager"]["load_s"],
        "manager_s": [r["manager_s"] for r in ranks],
        "lanes_s": [r["lanes_s"] for r in ranks],
        "fsdp_s": [r["fsdp_s"] for r in ranks],
        "lane_s": {f"{m}/{lane}": lead[m, lane]["s"]
                   for m in GANG_TENSOR_MODES for lane in GANG_LANES},
        "shard_bytes": sizes, "prefill_logits_rel_rms": err,
        "prefill_logits_max_abs": max_err,
        "greedy_divergences": divergences, "handoffs": handoffs,
        "fsdp": fsdp,
        # B = 1 run's wall a new token (prefill included): the gang's
        # ranks share one card, so this times its time-slicing, not
        # tensor parallelism.
        "b1_ms_per_token": per_token,
        # Each rank's wall over the phase's main path, and the share of
        # it its stream spent in collectives (CUDA events around each
        # call on CUDA tensors, a wait for the peers included); the
        # calls, control broadcasts included, and the host seconds of
        # those on CPU tensors (gloo's object broadcasts).
        "main_s": [r["main_s"] for r in ranks],
        "collective_share": [r["collectives"]["device_s"] / r["main_s"]
                             for r in ranks],
        "collective_calls": [r["collectives"]["calls"] for r in ranks],
        "collective_host_s": [r["collectives"]["host_s"] for r in ranks],
        "launches": [r["launches"] for r in ranks],
    }
    log(f"tensor gang: {json.dumps(figures)}")
    return figures


def gang_manager_ok(ranks, lead):
    """The manager part: each mode's unary, streamed and gRPC tokens
    equal the version's B = 1 ``run``; greedy equal the gang's own B = 1
    runs of the lanes; the followers loaded and closed each version."""
    for mode in GANG_TENSOR_MODES:
        got = lead["manager"][mode]
        if got["topology"]["mesh"] != {"tensor": len(ranks), "fsdp": 1}:
            raise AssertionError(f"gang manager {mode}: {got['topology']}")
        for what in ("unary", "streamed"):
            for i, (a, b) in enumerate(zip(got[what], got["b1"])):
                if not np.array_equal(a, b):
                    raise AssertionError(
                        f"gang manager {mode} request {i}: {what} {a} != "
                        f"B=1 run {b}")
        if not np.array_equal(got["grpc"], got["b1"][0]):
            raise AssertionError(f"gang manager {mode}: gRPC "
                                 f"{got['grpc']} != B=1 {got['b1'][0]}")
        if mode == "greedy":
            for i, (a, b) in enumerate(zip(got["b1"],
                                           lead[mode, "plain"]["b1"])):
                if not np.array_equal(a, b):
                    raise AssertionError(f"gang manager greedy request {i}: "
                                         f"{a} != the lanes' B=1 {b}")
    keys = [(mode, 1) for mode in GANG_TENSOR_MODES]
    for r, res in enumerate(ranks[1:], start=1):
        if res["manager"] != {"loaded": keys, "closed": keys}:
            raise AssertionError(f"gang manager rank {r} followed "
                                 f"{res['manager']}")


def gang_lanes_ok(ranks, lead, mono_tokens, fed_mono):
    """Every lane bitwise inside the gang (its docstring's list), the
    followers' tokens equal rank 0's, and the greedy B = 1 runs against
    the monolithic ones. Returns the greedy divergences."""
    for mode in GANG_TENSOR_MODES:
        for lane in GANG_LANES:
            mine = lead[mode, lane]
            for r, res in enumerate(ranks[1:], start=1):
                theirs = res[mode, lane]
                if theirs["engine"] != mine["engine"] or not theirs["laps"]:
                    raise AssertionError(f"tensor gang {mode} {lane}: rank "
                                         f"{r}'s tokens differ from rank 0's")
                if lane == "plain" and [list(x["tokens"][0]) for x in
                                        theirs["runs"]] != [
                        list(t) for t in mine["b1"]]:
                    raise AssertionError(f"tensor gang {mode}: rank {r}'s "
                                         f"B=1 runs differ from rank 0's")
            if mine["stats"]["gang"]["capture_graphs"]:
                raise AssertionError("a tensor gang's engine captured "
                                     "graphs")
        plain = lead[mode, "plain"]
        checks = [(f"request {i}", s, b) for i, (s, b) in enumerate(
            zip(plain["streams"], plain["b1"]))]
        checks += [(f"spec request {i}", s, b) for i, (s, b) in enumerate(
            zip(lead[mode, "spec"]["streams"], plain["streams"]))]
        checks += [(f"resume at {cut}", r, plain["streams"][0][cut:])
                   for cut, r in zip(GANG_RESUME_CUTS, plain["resumes"])]
        checks += [("own handoff", plain["own_adopted"], plain["local"])]
        prefix, chunk = lead[mode, "prefix"], lead[mode, "chunk"]
        checks += [(f"prefix hit {i}", w, c) for i, (w, c) in enumerate(
            zip(prefix["warm"], prefix["cold"]))]
        checks += [(f"chunked {what} {i}", a, b) for what in ("cold", "warm")
                   for i, (a, b) in enumerate(zip(chunk[what],
                                                  prefix[what]))]
        for what, a, b in checks:
            if not np.array_equal(a, b):
                raise AssertionError(f"tensor gang {mode} {what}: {a} != "
                                     f"{b}")
        if prefix["stats"]["prefix_cache"]["hits"] < 2:
            raise AssertionError(f"tensor gang {mode} prefix: "
                                 f"{prefix['stats']['prefix_cache']}")
        if not lead[mode, "spec"]["stats"]["spec"]["rounds"]:
            raise AssertionError(f"tensor gang {mode}: no speculative round")
    divergences = []
    for i, (b1, want) in enumerate(zip(lead["greedy", "plain"]["b1"],
                                       mono_tokens)):
        step = first_divergence(b1, want)
        if step is None:
            continue
        mono_row = fed_mono[i][step]
        top2 = torch.topk(mono_row, 2).values
        margin = float(top2[0] - top2[1])
        delta = float((torch.from_numpy(lead["fed_logits"][i][step])
                       - mono_row).abs().max())
        divergences.append({"request": i, "step": step, "margin": margin,
                            "max_abs_delta": delta})
        log(f"tensor gang greedy request {i}: first differs from the "
            f"monolithic run at step {step}, top-two margin {margin}, "
            f"max |Δ| logits {delta}")
        if margin > 2 * delta:
            raise AssertionError(
                f"tensor gang request {i} diverges at step {step} with "
                f"margin {margin} > 2 × max |Δ| {delta}: rounding cannot "
                f"explain it")
    return divergences


def gang_fsdp_ok(ranks, world, mono_logits, mono_tokens):
    """The fsdp=2 load: each rank's own shard, half the weights at rest,
    logits and greedy tokens bitwise the monolithic load's. Returns its
    figures."""
    shards = [f"params.shard-{r:05d}-of-{world:05d}.msgpack"
              for r in range(world)]
    lead = ranks[0]["fsdp"]
    for r, res in enumerate(ranks):
        got = res["fsdp"]
        if got["opened"] != [shards[r]] or got["topology"]["mesh"] != {
                "tensor": 1, "fsdp": world}:
            raise AssertionError(f"fsdp gang rank {r}: {got['opened']} "
                                 f"{got['topology']}")
        tokens = got["tokens"] if r == 0 else got["runs"][0]["tokens"][0]
        want = mono_tokens[0][:GANG_FSDP_TOKENS]
        if not np.array_equal(tokens, want):
            raise AssertionError(f"fsdp gang rank {r}: tokens {tokens} != "
                                 f"the monolithic run's {want}")
    if not torch.equal(torch.from_numpy(lead["prefill_logits"]),
                       mono_logits):
        raise AssertionError(
            f"fsdp gang prefill logits differ from the monolithic load's "
            f"(max |Δ| {float((torch.from_numpy(lead['prefill_logits']) - mono_logits).abs().max())})")
    return {k: [r["fsdp"][k] for r in ranks]
            for k in ("load_s", "held_bytes", "peak_bytes", "prefill_s",
                      "prefill_gather_s", "run_s", "run_gather_s")}


# -- the seq and pipeline axes on one card (gang_axes) -------------------------

#: Part (a): attention at llama3-8b's shape on seq=2 (4,096 positions a
#: rank), and BERT-base's training batch with a key mask. (name, B, L,
#: H, Hkv, D, causal, masked, gradients?)
AXES_ATTENTION = (
    ("llama3-8b B1 L8192 H32/8 D128 causal", 1, 8192, 32, 8, 128, True,
     False, True),
    ("bert-base B32 L128 H12 D64 key mask", 32, 128, 12, 12, 64, False,
     True, False),
)
#: Query rows a block of the plain twin's gradient takes (its scores,
#: [B, H, 1024, L] fp32, stay a few GB).
AXES_GRAD_BLOCK = 1024
#: Part (b): a cache-free llama3-8b forward, full width, 4 blocks, of
#: [1, AXES_LLAMA_TOKENS] with the ring as its attention_fn.
AXES_LLAMA_LAYERS = 4
AXES_LLAMA_TOKENS = 4096
#: Part (c): the pretraining cell (llama3-8b at depth 4, fp32 masters,
#: bf16 compute, the tpu-lm chain) at batch 4 × L1024 from seed 0, two
#: steps of GPipe (4 microbatches) and of the interleaved schedule (2
#: virtual stages a rank). Depth 4 for the smoke's time limit (PERF.md
#: §4), as the tensor gang's.
AXES_PIPELINE = {"layers": 4, "batch": 4, "seq": 1024, "micro": 4,
                 "steps": 2, "virtual": 2}
#: The pipeline steps' grad norm, updated params and updates (each
#: leaf's w - w0) against the unpipelined step's: relative, one bf16
#: step. The first step's rate is 0, so the update is the second's.
AXES_PARAM_TOL = 2.0 ** -7
#: Seconds the gang may take before the phase kills it and fails.
GANG_AXES_TIMEOUT = 300


#: The flash kernel at the axes gang's shapes (PERF.md §6): a Ulysses
#: rank's call (the whole sequence, its half of the heads) at
#: llama3-8b's shape and BERT-base's, and one pipeline stage's block at
#: a microbatch's rows.
AXES_FLASH_SHAPES = (
    ("u: Ulysses rank B1 L8192 H16/4 D128 causal (seq=2)", 1, 8192, 16, 4,
     128, torch.bfloat16, True, False),
    ("u2: Ulysses rank BERT B32 L128 H6 D64 key mask (seq=2)", 32, 128, 6,
     6, 64, torch.bfloat16, False, True),
    ("p: pipeline stage block B1 L1024 H32/8 D128 causal (a microbatch)",
     1, 1024, 32, 8, 128, torch.bfloat16, True, False),
)


def axes_flash_rows(kernels):
    """The flash kernel held against its plain version and timed at the
    axes gang's shapes (AXES_FLASH_SHAPES)."""
    return [check_flash(kernels, *shape) for shape in AXES_FLASH_SHAPES]


def axes_qkv(shape, seed, device):
    """q, k, v (and the output's cotangent) of an attention case, drawn
    in fp32 from ``seed`` on ``device`` and cast to bf16: the parent and
    every rank draw the same."""
    _, b, l, h, hkv, d, _, masked, _ = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(heads):
        return torch.randn((b, l, heads, d), generator=gen, device=device
                           ).to(torch.bfloat16)

    q, k, v, g = draw(h), draw(hkv), draw(hkv), draw(h)
    mask = None
    if masked:  # every other row padded past 3/4 of its keys
        mask = torch.ones((b, l), dtype=torch.int32, device=device)
        mask[1::2, 3 * l // 4:] = 0
    return q, k, v, g, mask


def plain_attention_grads(q, k, v, g, causal, mask, dtype, attention):
    """``attention``'s output and gradients of ``sum(out · g)`` in
    ``dtype`` (the plain twin, ``flash_attention_reference``, or the
    dense route), a block of AXES_GRAD_BLOCK query rows at a time at
    their offset (dq a block's own, dk and dv summed over the blocks)."""
    q, k, v = (t.to(dtype) for t in (q, k, v))
    kk, vv = (t.detach().requires_grad_(True) for t in (k, v))
    outs, dqs = [], []
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for start in range(0, q.shape[1], AXES_GRAD_BLOCK):
        qb = q[:, start:start + AXES_GRAD_BLOCK].detach().requires_grad_(
            True)
        with torch.enable_grad():
            out = attention(qb, kk, vv, causal=causal, q_offset=start,
                            kv_segment_valid=mask)
            got = torch.autograd.grad(
                out, (qb, kk, vv),
                g[:, start:start + AXES_GRAD_BLOCK].to(dtype))
        outs.append(out.detach())
        dqs.append(got[0].float())
        dk += got[1].float()
        dv += got[2].float()
    return torch.cat(outs, 1), (torch.cat(dqs, 1), dk, dv)


def axes_attention_refs(device):
    """Part (a)'s yardsticks in this process, for each case: the
    one-process flash call's output (one launch) and the bf16 floor
    (the plain twin, flash_attention_reference, in bf16 against the
    dense route in fp32), and, for the llama3-8b case, the plain twin's
    bf16 gradients (the flash gradient's own route: its backward
    recomputes the plain twin) and their floor against the dense route's
    fp32 gradients."""
    refs = {}
    for i, shape in enumerate(AXES_ATTENTION):
        name, causal, masked, grads = shape[0], shape[6], shape[7], shape[8]
        q, k, v, g, mask = axes_qkv(shape, 100 + i, device)
        with torch.no_grad():
            zero_counts()
            flash = flash_attention(q, k, v, causal=causal,
                                    kv_segment_valid=mask)
            launches = read_counts()["flash_attention"]
            plain = flash_attention_reference(q, k, v, causal=causal,
                                              kv_segment_valid=mask)
        ref = {"out": flash.cpu(), "launches": launches, "seed": 100 + i,
               "shape": shape}
        if grads:
            _, bf16 = plain_attention_grads(q, k, v, g, causal, mask,
                                            torch.bfloat16,
                                            flash_attention_reference)
            exact, fp32 = plain_attention_grads(q, k, v, g, causal, mask,
                                                torch.float32,
                                                dense_attention)
            ref["grads"] = [t.cpu() for t in bf16]
            ref["grad_floor"] = [rel_rms(a, b) for a, b in zip(bf16, fp32)]
        else:
            with torch.no_grad():
                exact = dense_attention(q.float(), k.float(), v.float(),
                                        causal=causal, kv_segment_valid=mask)
        # The bf16 floor: the plain twin in bf16 against fp32.
        ref["floor"] = rel_rms(plain.float(), exact.float())
        refs[name] = ref
        del q, k, v, g, mask, flash, plain, exact
    return refs


def axes_llama_refs(device):
    """Part (b)'s yardstick: the one-process cache-free forward of
    llama3-8b at AXES_LLAMA_LAYERS blocks (bf16 params from seed 0) on
    ``[1, AXES_LLAMA_TOKENS]``, and the bf16 floor: its logits against
    the same weights' forward in fp32 (dense attention)."""
    entry = get_model(LLAMA)
    kwargs = {"dtype": "bfloat16", "num_layers": AXES_LLAMA_LAYERS}
    model = entry.make(**kwargs)
    params = init_params(model, seed=0, device=device)
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, entry.num_classes_or_vocab, (1, AXES_LLAMA_TOKENS)).astype(
            np.int32)).to(device)

    with torch.inference_mode():
        logits = apply(model, params, ids).cpu()
        exact = entry.make(**dict(kwargs, dtype="float32"),
                           attention_fn=functools.partial(dense_attention,
                                                          causal=True))
        wide = {k: v.float() for k, v in params.items()}
        del params
        floor = rel_rms(logits, apply(exact, wide, ids).cpu())
    del wide
    return {"kwargs": kwargs, "ids": ids.cpu().numpy(), "logits": logits,
            "floor": floor}


def axes_pipeline_config(name, cfg, mesh=None):
    """(model, tx, batches) of part (c) for the registry model ``name``
    and ``cfg`` (AXES_PIPELINE's keys): the tpu-lm chain at the
    pretraining cell's rates; the batches' rows those of ``mesh``'s
    batch position (all of them without one, in one process)."""
    model = get_model(name).make(num_layers=cfg["layers"],
                                 param_dtype="float32")
    steps = cfg["steps"]
    tx = optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(optim.warmup_cosine_decay_schedule(
            0.0, PRETRAIN_LR, PRETRAIN_WARMUP,
            max(steps, PRETRAIN_WARMUP + 1)), weight_decay=0.01))
    batches = list(itertools.islice(synthetic_causal_lm(
        cfg["batch"], cfg["seq"], get_model(name).num_classes_or_vocab,
        seed=0, mesh=mesh), steps))
    return model, tx, batches


def axes_pipeline_refs(device, base):
    """Part (c)'s yardstick: the unpipelined step of the same model,
    params, optimizer and batches, in this process, before the gang
    (its fp32 state is ~31 GB; a pipeline=2 rank's ~24 GB). Each step's
    loss and grad norm; the updated params written under ``base`` (one
    raw fp32 file a leaf, for the ranks to read); whether the
    cache-free forward's rows depend on its row count (its first
    product at M = B·L against the first microbatch's rows); and each
    leaf's update norm, ``|w - w0|``, that the ranks' updates are held
    to."""
    model, tx, batches = axes_pipeline_config(LLAMA, AXES_PIPELINE)
    params = init_params(model, seed=0, device=device)
    state, _ = create_lm_state(model, tx, params)
    # The state's params share the init's storage: keep w0 apart.
    initial = {k: v.detach().clone() for k, v in state.params.items()}
    step = make_lm_train_step()
    zero_counts()
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = read_counts()["flash_attention"]
    files, update_norms = {}, {}
    for name, t in state.params.items():
        path = os.path.join(base, f"ref-{name}.f32")
        t.detach().float().cpu().numpy().tofile(path)
        files[name] = (path, tuple(t.shape))
        update_norms[name] = float((t.detach().float()
                                    - initial.pop(name).float()).norm())
    # The row-count check: layer 0's q projection input (the first
    # norm's rows) at the whole batch and at one microbatch's rows.
    with torch.no_grad():
        x = torch.randn((AXES_PIPELINE["batch"] * AXES_PIPELINE["seq"],
                         model.d_model), generator=torch.Generator(
            device=device).manual_seed(3), device=device).to(torch.bfloat16)
        w = state.params["layers.0.attention.q_proj.weight"].to(
            torch.bfloat16)
        rows = x.shape[0] // AXES_PIPELINE["micro"]
        row_delta = float((F.linear(x, w)[:rows].float()
                           - F.linear(x[:rows], w).float()).abs().max())
    del state, params
    return {"metrics": metrics, "files": files, "launches": launches,
            "update_norms": update_norms, "linear_row_delta": row_delta}


def gang_axes(card, *, transport="gloo", world=2):
    """The seq and pipeline axes on a gang of ``world`` rank processes
    of ``scripts/axes_gang.py`` (two gloo ranks sharing the card, or one
    nccl rank a card), held against the one-process runs made here
    first. Asserted: (a) Ulysses and the ring at llama3-8b's attention
    shape and at BERT-base's with a key mask, each within twice its
    bf16 floor (relative RMS) of the one-process flash call (Ulysses
    bitwise reported: the all-to-all moves bits and a flash row does not
    depend on the head count), the llama3-8b case's dq, dk and dv within
    twice their floor of the plain twin's, every rank's outputs equal,
    and flash launched once a Ulysses call and never by the ring;
    (b) the llama3-8b forward with the ring ``attention_fn`` within
    twice its floor of the one-process forward, the ranks bitwise equal;
    (c) two GPipe and two interleaved steps of the pretraining cell: the
    step-0 loss equal to the unpipelined step's bit for bit where the
    cache-free forward's rows do not depend on the row count (else its
    max |Δ| printed beside the product's), each step's loss and grad
    norm, the updated params and each leaf's update (w - w0) within
    AXES_PARAM_TOL relative, the ranks' metrics equal, each rank's flash
    launches its blocks × microbatches a step. Returns the phase's
    figures."""
    device = resolve_device()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".axes-") as base:
        attention = axes_attention_refs(device)
        llama_ref = axes_llama_refs(device)
        pipe_ref = axes_pipeline_refs(device, base)
        gc.collect()
        torch.cuda.empty_cache()
        parent_s = time.monotonic() - t0
        case = {"transport": transport, "model": LLAMA,
                "attention": [r["shape"] for r in attention.values()],
                "seeds": [r["seed"] for r in attention.values()],
                "llama": {k: llama_ref[k] for k in ("kwargs", "ids")},
                "pipeline": dict(AXES_PIPELINE, files=pipe_ref["files"],
                                 update_norms=pipe_ref["update_norms"]),
                "micro": (AXES_PIPELINE["micro"] if world == 2
                          else AXES_PIPELINE["micro"] // 2)}
        case_path = os.path.join(base, "case.pkl")
        with open(case_path, "wb") as f:
            pickle.dump(case, f)
        t1 = time.monotonic()
        ranks = spawn_gang(world, transport, case_path, base,
                           script="axes_gang.py", timeout=GANG_AXES_TIMEOUT,
                           tag="[axes_gang]")
        gang_s = time.monotonic() - t1
    figures = {"card": card, "transport": transport, "ranks": world,
               "parent_s": parent_s, "gang_s": gang_s,
               "main_s": [r["main_s"] for r in ranks], "attention": {}}
    lead = ranks[0]
    for name, ref in attention.items():
        rows = {}
        for strategy in ("ulysses", "ring"):
            got = lead["attention"][name][strategy]
            err = rel_rms(got["out"].float(), ref["out"].float())
            row = {"rel_rms": err, "floor": ref["floor"],
                   "bitwise": bool(torch.equal(got["out"], ref["out"])),
                   "max_abs": float((got["out"].float()
                                     - ref["out"].float()).abs().max()),
                   "flash_launches": got["launches"], "ms": got["ms"]}
            if "grads" in ref:
                row["grad_rel_rms"] = [rel_rms(a.float(), b.float()) for a, b
                                       in zip(got["grads"], ref["grads"])]
                row["grad_floor"] = ref["grad_floor"]
            rows[strategy] = row
            want_launches = 1 if strategy == "ulysses" else 0
            bad = [err > 2 * ref["floor"], got["launches"] != want_launches,
                   any(not torch.equal(r["attention"][name][strategy]["out"],
                                       got["out"]) for r in ranks[1:])]
            if "grads" in ref:
                bad += [e > 2 * f for e, f in zip(row["grad_rel_rms"],
                                                  ref["grad_floor"])]
            if strategy == "ulysses" and not row["bitwise"]:
                log(f"axes gang {name}: Ulysses parts from the one-process "
                    f"flash call by max |Δ| {row['max_abs']}")
            if any(bad):
                raise AssertionError(f"axes gang attention {name} "
                                     f"{strategy}: {row}; failed checks "
                                     f"{[i for i, b in enumerate(bad) if b]}")
        figures["attention"][name] = rows
    llama_row = lead["llama"]
    err = rel_rms(llama_row["logits"], llama_ref["logits"])
    figures["llama"] = {"rel_rms": err, "floor": llama_ref["floor"],
                        "ms": llama_row["ms"],
                        "fingerprints": [r["llama"]["fingerprint"]
                                         for r in ranks]}
    if (err > 2 * llama_ref["floor"]
            or not torch.isfinite(llama_row["logits"]).all()
            or len({r["llama"]["fingerprint"] for r in ranks}) != 1):
        raise AssertionError(f"axes gang llama ring forward: "
                             f"{figures['llama']}")
    figures["pipeline"] = {"unpipelined": pipe_ref["metrics"],
                           "linear_row_delta": pipe_ref["linear_row_delta"]}
    blocks = AXES_PIPELINE["layers"] // 2  # pipeline=2 either way
    for schedule in ("gpipe", "interleaved"):
        got = lead["pipeline"][schedule]
        ref_m = pipe_ref["metrics"]
        delta0 = abs(got["metrics"][0]["loss"] - ref_m[0]["loss"])
        row = {**got, "loss_delta_step0": delta0,
               "rel": [{k: abs(g[k] / w[k] - 1) for k in ("loss", "grad_norm")}
                       for g, w in zip(got["metrics"], ref_m)],
               "param_rel_rms_max": max(max(r["pipeline"][schedule][
                   "param_rel_rms"].values()) for r in ranks),
               "update_rel_max": max(max(r["pipeline"][schedule][
                   "update_rel"].values()) for r in ranks)}
        per_step = blocks * case["micro"]
        bad = [any(r["pipeline"][schedule]["metrics"] != got["metrics"]
                   for r in ranks[1:]),
               any(v > AXES_PARAM_TOL for e in row["rel"] for v in e.values()),
               row["param_rel_rms_max"] > AXES_PARAM_TOL,
               not row["update_rel_max"] <= AXES_PARAM_TOL,
               any(r["pipeline"][schedule]["flash_launches"]
                   != per_step * AXES_PIPELINE["steps"] for r in ranks)]
        if pipe_ref["linear_row_delta"] == 0.0:
            bad.append(delta0 != 0.0)
        else:
            log(f"axes gang {schedule}: step-0 loss parts from the "
                f"unpipelined step's by {delta0}; the cache-free forward's "
                f"F.linear (cuBLAS) rows depend on the row count: layer 0's "
                f"q product at M = {AXES_PIPELINE['batch']} × "
                f"{AXES_PIPELINE['seq']} against one microbatch's rows, max "
                f"|Δ| {pipe_ref['linear_row_delta']}")
        figures["pipeline"][schedule] = row
        if any(bad):
            raise AssertionError(f"axes gang pipeline {schedule}: {row}; "
                                 f"failed checks "
                                 f"{[i for i, b in enumerate(bad) if b]}")
    figures["launches"] = [r["launches"] for r in ranks]
    missing = [(i, k) for i, r in enumerate(ranks)
               for k, n in r["launches"].items() if not n]
    if missing:
        raise AssertionError(f"axes gang: kernels never launched on a "
                             f"rank's main path: {missing}")
    figures["collective_share"] = [r["collectives"]["device_s"]
                                   / r["main_s"] for r in ranks]
    figures["collective_calls"] = [r["collectives"]["calls"] for r in ranks]
    log(f"axes gang: {json.dumps(figures, default=str)}")
    log(f"phase gang_axes: {time.monotonic() - t0:.1f} s [{card}]")
    return figures


# -- the expert axis and BERT's tensor axis on one card (gang_expert) --------

#: Part (a): llama-moe-bench at its registered config, nothing cut (4
#: layers, d 1024, 16/8 heads, 8 experts top-2, mlp 3584, vocab 8192),
#: fp32 masters, bf16 compute, b8 × L1024 from seed 0 at the MoE pricing
#: runs' rates (MOE_LR, MOE_WARMUP): two steps on ``expert=2`` (4
#: experts a rank), then two on ``data=2``. Part (b): bert-base mlm at
#: tpu-lm's defaults (lr 1e-4, warmup 10), B32 × L128 with padded rows,
#: two steps on ``tensor=2`` (6 heads a rank).
EXPERT_RUNS = (
    ("moe expert=2", "moe", {"expert": 2}),
    ("moe data=2", "moe", {"data": 2}),
    ("bert tensor=2", "bert", {"tensor": 2}),
)
EXPERT_STEPS = 2
#: Each run's step metrics, updated params and updates (w - w0) against
#: the one-process step's: relative, one bf16 step. The first step's
#: rate is 0, so the update is the second's. Where another valid order
#: of the one-process steps (two microbatches) already moves a leaf
#: past it (bert-base's zero-initialised biases and LayerNorm vectors,
#: whose adam step at a rate of 1e-5 follows gradients near their
#: rounding), the params and updates are held to twice that floor
#: (``order_floor``).
EXPERT_PARAM_TOL = 2.0 ** -7
#: Seconds the gang may take before the phase kills it and fails.
GANG_EXPERT_TIMEOUT = 300
#: Leaves whose gradient is 0 in exact arithmetic: BERT's key bias (a
#: softmax over keys is invariant to a shift of every key's score by the
#: query's dot product with it). Adam moves them by its step on the sign
#: of rounding noise, in any run, so they are held to the size of that
#: step and not to the one-process run's elements.
ZERO_GRADIENT_LEAVES = (".attention.key.bias",)

#: The flash kernel at the expert gang's shapes (PERF.md §6): a
#: llama-moe-bench block's call (the batch whole on an expert=2 rank) and
#: a BERT-base tensor=2 rank's (its 6 of 12 heads).
EXPERT_FLASH_SHAPES = (
    ("x: llama-moe-bench block B8 L1024 H16/8 D64 causal", 8, 1024, 16, 8,
     64, torch.bfloat16, True, False),
    ("xb: BERT tensor=2 rank B32 L128 H6 D64 key mask", 32, 128, 6, 6, 64,
     torch.bfloat16, False, True),
)


def expert_flash_rows(kernels):
    """The flash kernel held against its plain version and timed at the
    expert gang's shapes (EXPERT_FLASH_SHAPES)."""
    return [check_flash(kernels, *shape) for shape in EXPERT_FLASH_SHAPES]


def expert_rates(kind):
    """A run's tpu-lm rate and warmup: the MoE pricing runs' for
    llama-moe-bench, tpu-lm's defaults for bert-base."""
    return (MOE_LR, MOE_WARMUP) if kind == "moe" else (1e-4, 10)


def expert_lr_sum(kind):
    """The sum of the schedule's rates over a run's steps: adam moves no
    element (of a leaf without weight decay's pull, as a zero-initialised
    bias) by more than about this."""
    lr, warmup = expert_rates(kind)
    sched = optim.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(EXPERT_STEPS, warmup + 1))
    return sum(float(sched(t)) for t in range(EXPERT_STEPS))


def tpu_lm_chain(lr, warmup, steps):
    """tpu-lm's optimizer: ``clip_by_global_norm(1.0)``, then adamw over
    ``warmup_cosine_decay_schedule(0, lr, warmup, ...)`` with weight
    decay 0.01."""
    return optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(optim.warmup_cosine_decay_schedule(
            0.0, lr, warmup, max(steps, warmup + 1)), weight_decay=0.01))


def expert_config(kind, mesh=None):
    """(whole model, model, tx, batches, objective) of a run of
    ``kind`` ("moe" or "bert"): the model built on ``mesh`` where given
    (its rank's pieces), the whole one to draw the init from (seed 0)
    and the batches this mesh position reads (every row without a mesh,
    in one process)."""
    steps, device = EXPERT_STEPS, resolve_device()
    on = {} if mesh is None else {"mesh": mesh}
    if kind == "moe":
        name = MOE_MODELS[0]
        whole = get_model(name).make(param_dtype="float32")
        model = get_model(name).make(param_dtype="float32", **on)
        batches = list(itertools.islice(synthetic_causal_lm(
            MOE_BATCH, MOE_SEQ, get_model(name).num_classes_or_vocab,
            seed=0, mesh=mesh), steps))
        return (whole, model, tpu_lm_chain(*expert_rates(kind), steps),
                [place_batch(b, device) for b in batches], "causal")
    entry = get_model(BERT)
    whole, model = entry.make(), entry.make(**on)
    rows = host_shard_range(BERT_BATCH, mesh=mesh)
    batches = [{k: v[rows.start:rows.stop] for k, v in mlm_batch(
        BERT_BATCH, BERT_SEQ, entry.num_classes_or_vocab, seed,
        device).items()} for seed in range(1, steps + 1)]
    return (whole, model, tpu_lm_chain(*expert_rates(kind), steps),
            batches, "mlm")


def expert_launches(kind, model):
    """One train step's launches and plain recomputes (the formula of
    every LM run: BERT has no RMSNorm)."""
    if kind == "moe":
        return train_launch_formula(model.num_layers, remat=False,
                                    frozen_embed=False)
    layers = model.num_layers
    return {"flash_attention": layers, "rms_norm": 0, "add_rms_norm": 0,
            "flash_backward": layers, "rms_norm_backward": 0,
            "forward_plain": 0}


def expert_refs(device, base):
    """Each kind's yardstick: the one-process run of the same model,
    params, optimizer and batches, in this process before the gang.
    Each step's metrics and the updated params (one raw fp32 file a
    leaf under ``base``, for the ranks to read)."""
    refs = {}
    for kind in ("moe", "bert"):
        whole, _, tx, batches, objective = expert_config(kind)
        params = init_params(whole, seed=0, device=device)
        state, _ = create_lm_state(whole, tx, params)
        step = make_lm_train_step(objective=objective)
        metrics = []
        with counted_run(f"{kind} one process", EXPERT_STEPS,
                         expert_launches(kind, whole)):
            for batch in batches:
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        files = {}
        for name, t in state.params.items():
            path = os.path.join(base, f"{kind}-{name}.f32")
            t.detach().float().cpu().numpy().tofile(path)
            files[name] = (path, tuple(t.shape))
        refs[kind] = {"metrics": metrics, "files": files, "floor": None}
        if kind == "bert":
            refs[kind]["floor"] = order_floor(state, objective, tx, batches,
                                              whole, device)
        else:
            refs[kind]["linear_row_delta"] = linear_row_delta(
                state.params["layers.0.attention.q_proj.weight"], device)
        del state, params, step
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def linear_row_delta(weight, device):
    """Whether the cache-free forward's ``F.linear`` rows depend on the
    row count: the max |Δ| of layer 0's q product's first half of rows
    at M = B·L against the same rows alone (a data=2 rank's M)."""
    with torch.no_grad():
        x = torch.randn((MOE_BATCH * MOE_SEQ, weight.shape[1]),
                        generator=torch.Generator(device=device).manual_seed(
                            3), device=device).to(torch.bfloat16)
        w = weight.to(torch.bfloat16)
        rows = x.shape[0] // 2
        return float((F.linear(x, w)[:rows].float()
                      - F.linear(x[:rows], w).float()).abs().max())


def order_floor(state, objective, tx, batches, model, device):
    """How far another valid order of the same one-process steps moves
    each leaf: the run again with each batch as two microbatches (the
    reference's gradient accumulation), every leaf's ``|w - w_ref|``
    over ``|w_ref|`` and over its update ``|w_ref - w0|``; the largest
    of each, and the leaves that reach them. A gang's split sums are
    another such order, so where this floor passes EXPERT_PARAM_TOL the
    run is held to twice it."""
    params = init_params(model, seed=0, device=device)
    initial = {k: v.detach().clone() for k, v in params.items()}
    other, _ = create_lm_state(model, tx, params)
    step = make_lm_train_step(objective=objective, grad_accum=2)
    for batch in batches:
        other, _ = step(other, batch)
    param_rel, update_rel = {}, {}
    for key, ref in state.params.items():
        if key.endswith(ZERO_GRADIENT_LEAVES):
            continue
        ref = ref.detach().float()
        diff = float((other.params[key].detach().float() - ref).norm())
        param_rel[key] = diff / float(ref.norm())
        moved = float((ref - initial[key].float()).norm())
        update_rel[key] = diff / moved if moved else 0.0
    worst = {name: sorted(rel.items(), key=lambda kv: -kv[1])[:4]
             for name, rel in (("param_rel", param_rel),
                               ("update_rel", update_rel))}
    return {"param_rel": worst["param_rel"][0][1],
            "update_rel": worst["update_rel"][0][1], "worst": worst,
            "over_tol": sum(v > EXPERT_PARAM_TOL
                            for v in update_rel.values()),
            "leaves": len(update_rel)}


def layer_ms(fn, x, reps=5):
    """Device ms of ``fn(x)`` forward and backward (CUDA events around
    each of ``reps`` calls after one warm call; the median)."""
    x = x.detach().requires_grad_(True)
    g = torch.randn_like(x)
    times = []
    for i in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.backward(fn(x), g)
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def moe_layer_rows(device, mesh=None):
    """llama-moe-bench's MoE layer (8 experts top-2, mlp 3584, built on
    ``mesh`` where given) forward and backward at b8 × L1024 bf16, device
    ms; without a mesh also the dense twin's SwiGLU MLP (mlp 7168) at the
    same rows, the reference's pricing pair."""
    from kubeflow_tpu_torch.ops.moe import MoE

    gen = torch.Generator(device=device).manual_seed(11)
    d = 1024
    x = torch.randn((MOE_BATCH, MOE_SEQ, d), generator=gen, device=device
                    ).to(torch.bfloat16)
    moe = MoE(d, 8, 3584, 2, dtype=torch.bfloat16,
              param_dtype=torch.float32, device=device, mesh=mesh)
    with torch.no_grad():
        for p in moe.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    rows = {"moe_ms": layer_ms(moe, x)}
    if mesh is None:
        w = [torch.randn(shape, generator=gen, device=device) * 0.02
             for shape in ((7168, d), (7168, d), (d, 7168))]
        for t in w:
            t.requires_grad_(True)

        def dense(h):
            h = h.to(torch.bfloat16)
            return F.linear(F.silu(F.linear(h, w[0].to(h.dtype)))
                            * F.linear(h, w[1].to(h.dtype)),
                            w[2].to(h.dtype))

        rows["dense_twin_mlp_ms"] = layer_ms(dense, x)
    return rows


def gang_expert(card, *, transport="gloo", world=2):
    """The expert axis and BERT's tensor axis on a gang of ``world``
    rank processes of ``scripts/expert_gang.py`` (two gloo ranks sharing
    the card, or one nccl rank a card), held against the one-process
    runs made here first. Asserted for each run of EXPERT_RUNS (a)
    llama-moe-bench on ``expert=2`` and on ``data=2`` and (b) bert-base
    mlm on ``tensor=2``: each step's loss, aux loss (the global batch's)
    and grad norm (the MoE's step-0 loss bit for bit where the forward's
    ``F.linear`` rows do not depend on the row count, checked here), and
    every updated leaf (``|w - w_ref|`` over ``|w_ref|`` and over the
    update ``|w_ref - w0|``) within
    EXPERT_PARAM_TOL, the leaves at twice the one-process run's order
    floor where that floor passes it (bert-base's); the ranks' metrics
    equal; each rank holding only its experts' ``w_in`` and ``w_out``
    or its heads; and, on each rank, every step's flash and RMSNorm
    launches the one-process step's, each flash gradient through its
    plain recompute and no plain twin in a forward. Reported: whether
    BERT's step-0 loss is bitwise, step s, the collectives' share, and the
    MoE layer's device ms on an expert=2 rank beside the one-process
    layer's and the dense twin's MLP. Returns the phase's figures."""
    device = resolve_device()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".expert-") as base:
        refs = expert_refs(device, base)
        layer = moe_layer_rows(device)
        gc.collect()
        torch.cuda.empty_cache()
        parent_s = time.monotonic() - t0
        case = {"transport": transport, "runs": EXPERT_RUNS,
                "files": {k: r["files"] for k, r in refs.items()}}
        case_path = os.path.join(base, "case.pkl")
        with open(case_path, "wb") as f:
            pickle.dump(case, f)
        t1 = time.monotonic()
        ranks = spawn_gang(world, transport, case_path, base,
                           script="expert_gang.py",
                           timeout=GANG_EXPERT_TIMEOUT, tag="[expert_gang]")
        gang_s = time.monotonic() - t1
    figures = {"card": card, "transport": transport, "ranks": world,
               "parent_s": parent_s, "gang_s": gang_s,
               "main_s": [r["main_s"] for r in ranks], "runs": {},
               "moe_layer": {**layer,
                             "expert_rank_ms": [r["moe_layer_ms"]
                                                for r in ranks]}}
    lead = ranks[0]
    failed = {}
    for name, kind, spec in EXPERT_RUNS:
        got = lead["runs"][name]
        want = refs[kind]["metrics"]
        rel = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                for k in ("loss", "aux_loss", "grad_norm")}
               for g, w in zip(got["metrics"], want)]
        worst = {}
        for key in ("param_rel", "update_rel"):
            merged = {}
            for r in ranks:
                for leaf, v in r["runs"][name][key].items():
                    merged[leaf] = max(merged.get(leaf, 0.0), v)
            worst[key] = sorted(merged.items(), key=lambda kv: -kv[1])[:4]
        noise = {leaf: v for r in ranks
                 for leaf, v in r["runs"][name]["noise_moves"].items()}
        floor = refs[kind]["floor"]
        tol = {k: EXPERT_PARAM_TOL if floor is None
               else max(EXPERT_PARAM_TOL, 2 * floor[k])
               for k in ("param_rel", "update_rel")}
        row = {"metrics": got["metrics"], "reference": want, "rel": rel,
               "tol": tol, "order_floor": floor,
               "step0_loss_bitwise": got["metrics"][0]["loss"]
               == want[0]["loss"],
               "step_s": got["step_s"],
               "collective_share": got["collective_share"],
               "pieces": got["pieces"], "worst": worst,
               "zero_gradient_moves": noise,
               "param_rel_max": worst["param_rel"][0][1],
               "update_rel_max": worst["update_rel"][0][1]}
        bad = [any(r["runs"][name]["metrics"] != got["metrics"]
                   for r in ranks[1:]),
               any(v > EXPERT_PARAM_TOL for e in rel for v in e.values()),
               not row["param_rel_max"] <= tol["param_rel"],
               not row["update_rel_max"] <= tol["update_rel"],
               not all(r["runs"][name]["own_pieces"] for r in ranks),
               # A leaf whose gradient is 0 in exact arithmetic moves by
               # adam's step on the sign of rounding noise in either run:
               # no element by more than the steps' rates allow.
               any(max(a, b) > 1.5 * expert_lr_sum(kind)
                   for a, b in noise.values())]
        if kind == "moe":
            bad.append(not all(m["aux_loss"] > 0 for m in got["metrics"]))
            # The MoE's dispatch and combine are the whole layer's on
            # every rank: without a tensor axis (whose row pieces' sums
            # are split), where a product's rows do not depend on M (a
            # data=2 rank's half batch), the step-0 loss is the one
            # process's bit for bit.
            row["linear_row_delta"] = refs[kind]["linear_row_delta"]
            if (row["linear_row_delta"] == 0.0
                    and spec.get("tensor", 1) == 1):
                bad.append(not row["step0_loss_bitwise"])
        if not row["step0_loss_bitwise"]:
            log(f"expert gang {name}: step-0 loss parts from the "
                f"one-process step's by "
                f"{got['metrics'][0]['loss'] - want[0]['loss']}")
        figures["runs"][name] = row
        if any(bad):
            failed[name] = [i for i, b in enumerate(bad) if b]
    figures["launches"] = [r["launches"] for r in ranks]
    missing = [(i, k) for i, r in enumerate(ranks)
               for k, n in r["launches"].items() if not n]
    if missing:
        raise AssertionError(f"expert gang: kernels never launched on a "
                             f"rank's main path: {missing}")
    figures["collective_share"] = [r["collectives"]["device_s"]
                                   / r["main_s"] for r in ranks]
    figures["collective_calls"] = [r["collectives"]["calls"] for r in ranks]
    log(f"expert gang: {json.dumps(figures, default=str)}")
    if failed:
        raise AssertionError(f"expert gang: failed checks by run {failed}")
    log(f"phase gang_expert: {time.monotonic() - t0:.1f} s [{card}]")
    return figures


def gang_resnet50(card):
    """One ResNet-50 training step at the bench batch (b256, exact BN,
    SGD 0.1 nesterov, seed 0) unmeshed, then meshed on
    ``MeshSpec(data=-1)`` of the one-rank nccl group, from the same
    params and batch. Every BN layer of the meshed step takes the sync
    route: 53 stats and 53 apply launches and no fused one. The stats
    kernel keeps the fused launch's partial-sum order and apply its
    arithmetic, so the forward is the unmeshed one's: the loss and the
    running statistics bit for bit. The gradients recompute through each
    route's own plain formula (the fused route's ``mean(0)``, the sync
    route's Σ/count), so the grad norm and the updated params are held
    within ``BN_Y_REL_TOL`` bf16 (2**-7, the tolerance ``check_bn``
    holds the fused kernel's y to). Returns the sync launches."""
    entry = get_model("resnet50")
    config = BenchConfig(model="resnet50", batch_size=RESNET_BATCH, steps=1,
                         warmup_steps=0, seed=0,
                         model_kwargs={"bn_stat_rows": 0})
    model = entry.make(bn_stat_rows=0)
    params, stats = init_vision(model, seed=0)
    batch = synthetic_batch(config, entry.num_classes_or_vocab,
                            entry.input_spec[0], torch.device("cuda"))

    def run(mesh):
        state = create_train_state(
            model, sgd(0.1, 0.9), {k: v.clone() for k, v in params.items()},
            {k: v.clone() for k, v in stats.items()})
        if mesh is not None:
            state = place_state(mesh, state)
        counters = (fused_bn_train_forward, bn_stats, bn_apply)
        for fn in counters:
            fn.launches = 0
        state, m = make_train_step(mesh)(state, batch)
        torch.cuda.synchronize()
        return state, {k: float(v) for k, v in m.items()}, [
            fn.launches for fn in counters]

    ref_state, ref, ref_launches = run(None)
    with nccl_gang():
        state, got, launches = run(build_mesh(MeshSpec(data=-1)))
    tol = BN_Y_REL_TOL["bfloat16"]
    stats_equal = all(torch.equal(state.batch_stats[k], v)
                      for k, v in ref_state.batch_stats.items())
    param_err = _max_abs(state.params, ref_state.params)
    norm_err = abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    row = {"loss": got["loss"], "loss_unmeshed": ref["loss"],
           "batch_stats_bitwise": stats_equal,
           "grad_norm_rel_err": norm_err, "params_max_abs_err": param_err,
           "tol": tol, "launches_fused_stats_apply": launches,
           "unmeshed_launches": ref_launches}
    log(f"gang resnet50 b256 exact BN, meshed vs unmeshed: "
        f"{json.dumps(row)} [{card}]")
    if (launches != [0, RESNET50_BN_LAYERS, RESNET50_BN_LAYERS]
            or got["loss"] != ref["loss"] or not stats_equal
            or norm_err > tol or param_err > tol):
        raise AssertionError(f"gang resnet50: {row}")
    return {"bn_stats": launches[1], "bn_apply": launches[2]}


def stats_bound(m, c, dtype):
    """The stats entry's least time: x read once, 2·C fp32 sums written;
    a square and two adds an element in fp32."""
    elem = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (m * c * elem + 2 * c * 4) / PEAK_BYTES * 1e3
    t_ops = 3.0 * m * c / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def apply_bound(m, c, dtype):
    """The apply entry's least time: x read and y written once, sums,
    scale and bias read, mean and var written; a subtract, a multiply
    and an add an element in fp32."""
    elem = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (2 * m * c * elem + 6 * c * 4) / PEAK_BYTES * 1e3
    t_ops = 3.0 * m * c / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def check_bn_route(name, m, c, dtype, layers, full=False):
    """The sync route at one [M, C] shape on the one-rank nccl group:
    stats against its twin (the derived mean and var within
    ``BN_STAT_TOL``), apply against its twin (y within ``BN_Y_REL_TOL``),
    and stats + all-reduce + apply against the fused launch bit for bit.
    Times (events, ``KERNEL_TIMING``): the route, the fused launch and
    the route's device time from the profiler; with ``full``, also each
    entry alone, its twin and its library counterpart
    (``torch.batch_norm_stats`` / ``torch.batch_norm_elemt``, SyncBN's
    split of the same work) and ``F.batch_norm``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(m, c, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    scale = torch.rand(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)

    def route():
        sums = bn_stats(x)
        torch.distributed.all_reduce(sums)
        return bn_apply(x, sums, m, scale, bias)

    fused = functools.partial(fused_bn_train_forward, x, scale, bias)
    sums = bn_stats(x)
    want = reference_bn_stats(x)
    stat_err = max(float((sums[0] / m - want[0] / m).abs().max()),
                   float((sums[1] / m - want[1] / m).abs().max()))
    y, mean, var = route()
    y_ref, _, _ = reference_bn_apply(x, sums, m, scale, bias)
    err = float((y.float() - y_ref.float()).abs().max())
    y_tol = BN_Y_REL_TOL[str(dtype).replace("torch.", "")] * max(
        1.0, float(y_ref.float().abs().max()))
    bitwise = all(torch.equal(a, b) for a, b in zip((y, mean, var), fused()))
    del y_ref
    if stat_err > BN_STAT_TOL or err > y_tol or not bitwise:
        raise AssertionError(f"bn route {name}: stats |Δ| {stat_err}, y |Δ| "
                             f"{err} (tol {y_tol}), fused bits {bitwise}")
    bound = bn_bound(m, m, c, dtype)
    row = {"shape": name, "layers": layers, "stats_max_abs_err": stat_err,
           "max_abs_err": err, "tol": y_tol, "fused_bitwise": bitwise,
           "route_ms": time_ms(route, **KERNEL_TIMING),
           "route_device_ms": profiled_ms(route),
           "fused_ms": time_ms(fused, **KERNEL_TIMING),
           "one_read_bound_ms": bound["bound_ms"],
           "two_read_bound_ms": bound["two_read_ms"]}
    if full:
        nchw = x.view(m, 1, 1, c).permute(0, 3, 1, 2)
        mean_l, invstd = torch.batch_norm_stats(nchw, 1e-5)
        row.update(
            stats_ms=time_ms(lambda: bn_stats(x), **KERNEL_TIMING),
            stats_plain_ms=time_ms(lambda: reference_bn_stats(x), reps=3),
            stats_library_ms=time_ms(
                lambda: torch.batch_norm_stats(nchw, 1e-5), **KERNEL_TIMING),
            apply_ms=time_ms(lambda: bn_apply(x, sums, m, scale, bias),
                             **KERNEL_TIMING),
            apply_plain_ms=time_ms(lambda: reference_bn_apply(
                x, sums, m, scale, bias), reps=3),
            apply_library_ms=time_ms(lambda: torch.batch_norm_elemt(
                nchw, scale, bias, mean_l, invstd, 1e-5), **KERNEL_TIMING),
            library_ms=time_ms(lambda: F.batch_norm(
                nchw, None, None, weight=scale, bias=bias, training=True,
                momentum=0.0, eps=1e-5), **KERNEL_TIMING),
            library_device_ms=profiled_ms(lambda: F.batch_norm(
                nchw, None, None, weight=scale, bias=bias, training=True,
                momentum=0.0, eps=1e-5)),
            fused_device_ms=profiled_ms(fused))
        (row["stats_bound_ms"], row["stats_bound_by"]) = stats_bound(m, c,
                                                                     dtype)
        (row["apply_bound_ms"], row["apply_bound_by"]) = apply_bound(m, c,
                                                                     dtype)
    log(f"bn route {name}: {json.dumps(row)}")
    return row


def bn_route_table():
    """The sync route at ``BN_MAIN`` bf16 (every figure) and at each of
    ResNet-50's BN shapes at b256 (route, fused and the route's device
    time), with the per-step sums over the 53 layers."""
    m, c = BN_MAIN
    rows = [check_bn_route(f"[{m},{c}] bf16", m, c, torch.bfloat16, 0,
                           full=True)]
    for m, c, n in resnet50_bn_shapes():
        rows.append(check_bn_route(f"[{m},{c}] bf16", m, c, torch.bfloat16,
                                   n))
    step = [r for r in rows if r["layers"]]
    sums = {k: sum(r["layers"] * r[k] for r in step) for k in (
        "route_ms", "route_device_ms", "fused_ms", "one_read_bound_ms",
        "two_read_bound_ms")}
    log(f"bn route per ResNet-50 step: Σ layers·ms {json.dumps(sums)} over "
        f"{sum(r['layers'] for r in step)} layers")
    return rows


def gang_vision(card):
    """The gang phase's BN half: the meshed ResNet-50 step on the sync
    route, then the route's rows in the one-rank nccl group. Returns the
    step's stats and apply launches and the rows."""
    launches = timed(gang_resnet50, card)
    gc.collect()
    torch.cuda.empty_cache()
    with nccl_gang():
        rows = timed(bn_route_table)
    return launches, rows


# -- the rest of the registry: BERT, vision, MoE ------------------------------

#: tpu-lm's default model and objective (bert-base, mlm) at L128, and
#: bert-large's one forward.
BERT = "bert-base"
BERT_LARGE = "bert-large"
BERT_BATCH = 32
BERT_SEQ = 128
BERT_STEPS = 10
BERT_LR = 1e-4
BERT_LARGE_BATCH = 8
#: The mask token and rate of the reference's mlm data.
MASK_TOKEN = 103
MASK_RATE = 0.15
#: (model, batch, warmup, timed steps, lr, falls): the tpu-cnn path at
#: each vision family's registry input size. On a fixed synthetic batch
#: some of the benchmark's rates make the loss rise (port-only CPU
#: probes at b8–b16: vit-b16 at SGD 0.1 2.6 → 79 in 5 steps;
#: inception-v3 at 0.1 3.7 → 6.8; alexnet at its bench_lr 0.01 4.8 →
#: 116), so each of those runs twice: at the benchmark's own rate (lr
#: None: ``bench_lr``, else 0.1), where the loss is held finite, and at
#: a rate whose loss falls there (vit-b16 0.003: 3.5 → 1.2; inception-v3
#: 0.01: 6.6 → 4.7; alexnet 0.001: 6.6 → 4.8), where it is held lower
#: at the last step; vgg16 once, at its bench_lr 0.01 (6.9 → 6.6).
VISION_RUNS = (("vit-b16", 64, 1, 3, None, False),
               ("vit-b16", 64, 1, 5, 0.003, True),
               ("inception-v3", 128, 1, 3, None, False),
               ("inception-v3", 128, 1, 5, 0.01, True),
               ("vgg16", 64, 1, 3, None, True),
               ("alexnet", 128, 1, 5, None, False),
               ("alexnet", 128, 1, 5, 0.001, True))
INCEPTION_BATCH = 128
INCEPTION_BN_LAYERS = 94
#: (model, batch): the first step's logits through the kernels against
#: the plain twins.
VISION_AGREEMENT = (("vit-b16", 64), ("inception-v3", 32))
#: (model, image size): the served vision exports.
SERVED_VISION = (("vit-b16", 224), ("inception-v3", 299))
#: The MoE pricing pair: tpu-lm steps of each at b8 × L1024.
MOE_MODELS = ("llama-moe-bench", "llama-moe-dense-twin")
MOE_BATCH = 8
MOE_SEQ = 1024
MOE_STEPS = 8
MOE_LR = 3e-4
MOE_WARMUP = 2
MOE_PROMPTS = (300, 512, 77, 410)
MOE_NEW_TOKENS = 16


def plain_attention(q, k, v, causal=False, kv_segment_valid=None,
                    **kw):
    """The second plain route, for the bf16 floor: softmax attention in
    one piece (``dense_attention``) where the plain twin is the
    kernel's online softmax over 64-key tiles."""
    return dense_attention(q, k, v, causal=causal,
                           kv_segment_valid=kv_segment_valid, **kw)


def agreement(label, forwards):
    """``forwards``: {"kernel", "plain", "floor"} → logits. The kernel's
    logits against the plain twin's, relative RMS, within twice the bf16
    floor (plain twin against the other plain route) measured beside
    it."""
    logits = {k: f() for k, f in forwards.items()}
    if not all(torch.isfinite(v).all() for v in logits.values()):
        raise AssertionError(f"{label}: logits are not finite")
    err = rel_rms(logits["kernel"].float(), logits["plain"].float())
    floor = rel_rms(logits["floor"].float(), logits["plain"].float())
    row = {"logits_rel_rms": err, "floor_rel_rms": floor, "tol": 2 * floor}
    log(f"{label}, kernel vs plain: {json.dumps(row)}")
    if err > 2 * floor:
        raise AssertionError(f"{label}: relative RMS {err} > twice the "
                             f"floor {floor}")
    return row


def mlm_batch(b, l, vocab, seed, device):
    """A BERT mlm batch with padded rows: row 0 full, the others valid
    for a random length of at least l/2; 15% of the valid positions
    masked."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (b, l))
    lengths = rng.integers(l // 2, l + 1, b)
    lengths[0] = l
    valid = np.arange(l)[None] < lengths[:, None]
    masked = (rng.random((b, l)) < MASK_RATE) & valid
    batch = {"input_ids": np.where(masked, MASK_TOKEN, ids),
             "type_ids": np.zeros((b, l)), "valid": valid,
             "mlm_labels": ids, "mlm_weights": masked}
    return place_batch({k: v.astype(np.int32) for k, v in batch.items()},
                       device)


@contextlib.contextmanager
def environ(**env):
    """``os.environ`` with ``env`` set for the block (a child process
    the launcher starts inherits it)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_drain_agreement():
    """An nccl group of one process on the card (a TCP rendezvous on
    localhost): the training loop's drain agreement, an all-reduce MAX
    on the card, gives each flag back."""
    dist = torch.distributed
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        got = (agree_on_drain(True), agree_on_drain(False))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if got != (True, False) or backend != "nccl":
        raise AssertionError(f"nccl drain agreement: {got} on {backend}")
    log("nccl group of 1 on the card: drain agreement True/False held")


def bert_cli_through_launcher(card):
    """The tpu-lm CLI at its defaults (bert-base, mlm) as the pod command
    under ``launcher.launch``, with the operator's env of a one-process
    gang (no rendezvous: the reference's contract), on a token shard of
    one repeated 128-token sequence masked anew each step; 10 steps, the
    loss lower at the last."""
    entry = get_model(BERT)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        shard = write_token_shard(tmp, BERT_SEQ, entry.num_classes_or_vocab,
                                  seed=3, repeats=BERT_BATCH * 2)
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        root = logging.getLogger()
        handlers, level = list(root.handlers), root.level
        t0 = time.monotonic()
        with environ(KFT_COORDINATOR_ADDRESS=f"localhost:{free_port()}",
                     KFT_NUM_PROCESSES="1", KFT_PROCESS_ID="0",
                     PYTHONPATH=ROOT):
            rc = launcher.launch([
                sys.executable, "-m", "kubeflow_tpu_torch.training.pretrain",
                "--global_batch", str(BERT_BATCH), "--seq_len",
                str(BERT_SEQ), "--steps", str(BERT_STEPS), "--log_every",
                "1", "--warmup_steps", "2", "--data", shard,
                "--metrics_path", metrics_path], env=os.environ)
        wall_s = time.monotonic() - t0
        for h in root.handlers[len(handlers):]:
            root.removeHandler(h)
        root.setLevel(level)
        with open(metrics_path) as f:
            records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    if rc != 0 or len(losses) != BERT_STEPS:
        raise AssertionError(f"tpu-lm through the launcher: exit {rc}, "
                             f"{len(losses)} logged steps")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"tpu-lm bert-base: the loss did not fall: "
                             f"{losses}")
    report = {"card": card, "exit_code": rc, "wall_s": wall_s,
              "losses": losses,
              "step_ms_each": [1e3 / r["steps_per_sec"] for r in records]}
    log(f"tpu-lm CLI (bert-base, mlm) under the launcher: "
        f"{json.dumps(report)}")


def train_bert(card):
    """BERT on the card: the drain agreement on an nccl group; the
    tpu-lm CLI at its defaults under the launcher; then in process,
    bert-base at full width and depth, bf16, fp32 masters, b32 × L128
    with padded rows: the first step's logits through the kernel against
    the plain attention (within twice the bf16 floor), 12 flash launches
    a forward, 10 mlm steps on the fixed batch through the tpu-lm step
    (the loss falls, 12 flash launches and 12 plain gradient recomputes
    a step, no plain twin in a forward), peak < 80 GB, a profiled step's
    split; then one bert-large forward against the plain attention.
    Returns the in-process run's flash launches."""
    nccl_drain_agreement()
    bert_cli_through_launcher(card)
    entry = get_model(BERT)
    model = entry.make()
    params = init_params(model, seed=0)
    batch = mlm_batch(BERT_BATCH, BERT_SEQ, entry.num_classes_or_vocab, 1,
                      resolve_device())
    args = (batch["input_ids"], batch["type_ids"], batch["valid"])
    variants = {"kernel": model,
                "plain": entry.make(attention_fn=flash_attention_reference),
                "floor": entry.make(attention_fn=plain_attention)}
    layers = model.num_layers
    with torch.no_grad():
        zero_counts()
        agreement(f"{BERT} b{BERT_BATCH} L{BERT_SEQ} padded, first-step "
                  f"logits", {k: functools.partial(apply, m, params, *args)
                              for k, m in variants.items()})
        torch.cuda.synchronize()
        if flash_attention.launches != layers:
            raise AssertionError(f"{BERT} forward: "
                                 f"{flash_attention.launches} flash "
                                 f"launches, expected {layers}")
    state, _ = create_lm_state(model, adamw(BERT_LR), params)
    step = make_lm_train_step(objective="mlm")
    want = {"flash_attention": layers, "rms_norm": 0, "add_rms_norm": 0,
            "flash_backward": layers, "rms_norm_backward": 0,
            "forward_plain": 0}
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with counted_run(BERT, BERT_STEPS, want) as launches:
        for _ in range(BERT_STEPS):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{BERT}: the loss did not fall: {losses}")
    if peak_gb >= 80:
        raise AssertionError(f"{BERT}: peak {peak_gb} GB")
    # Step time on the warm step, outside the counted run's wrappers.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, metrics = step(state, batch)
    float(metrics["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3 / 3
    state, profile = profiled_step(step, state, batch)
    flops = lm_train_flops(model, BERT_BATCH, BERT_SEQ)
    report = {"card": card, "model": BERT, "batch": BERT_BATCH,
              "seq_len": BERT_SEQ, "losses": losses, "step_ms": step_ms,
              "tokens_per_s": BERT_BATCH * BERT_SEQ / step_ms * 1e3,
              "flops_per_step": flops,
              "hfu_pct": flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
              * 100, "peak_memory_gb": peak_gb, "per_step": want,
              "profiled_step": profile}
    log(f"{BERT} mlm steps: {json.dumps(report)}")
    del state, params, variants
    gc.collect()
    torch.cuda.empty_cache()

    entry = get_model(BERT_LARGE)
    params = init_params(entry.make(), seed=0)
    batch = mlm_batch(BERT_LARGE_BATCH, BERT_SEQ, entry.num_classes_or_vocab,
                      2, resolve_device())
    args = (batch["input_ids"], batch["type_ids"], batch["valid"])
    with torch.no_grad():
        zero_counts()
        agreement(f"{BERT_LARGE} b{BERT_LARGE_BATCH} L{BERT_SEQ} padded "
                  f"forward", {
                      "kernel": functools.partial(apply, entry.make(),
                                                  params, *args),
                      "plain": functools.partial(apply, entry.make(
                          attention_fn=flash_attention_reference), params,
                          *args),
                      "floor": functools.partial(apply, entry.make(
                          attention_fn=plain_attention), params, *args)})
        torch.cuda.synchronize()
        layers = entry.make().num_layers
        if flash_attention.launches != layers:
            raise AssertionError(f"{BERT_LARGE} forward: "
                                 f"{flash_attention.launches} flash "
                                 f"launches, expected {layers}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def inception_bn_shapes(batch: int = INCEPTION_BATCH) -> list:
    """``[(M, C, layers)]``: each distinct [M, C] Inception-v3's BN
    layers hand the kernel in a training forward at ``batch``, 299², as
    :func:`resnet50_bn_shapes` reads ResNet-50's."""
    seen = {}

    def record(x, scale, bias, eps=1e-5, stat_rows=None):
        seen[tuple(x.shape)] = seen.get(tuple(x.shape), 0) + 1
        c = x.shape[1]
        return (torch.empty_like(x), x.new_empty(c, dtype=torch.float32),
                x.new_empty(c, dtype=torch.float32))

    entry = get_model("inception-v3")
    model = entry.make(norm_fn=record)
    for mod in model.modules():
        if isinstance(mod, GhostBatchNorm):
            mod.register_forward_pre_hook(lambda _, args: (
                args[0].contiguous(memory_format=torch.channels_last),
                *args[1:]))
    x = torch.empty(batch, *entry.input_spec[0], device="meta")
    with torch.no_grad():
        model(x, train=True)
    return [(m, c, n) for (m, c), n in seen.items()]


def inception_bn_table():
    """The BN kernel at every distinct BN shape of Inception-v3 at b128
    (ε = 1e-3), bf16, and one fp32 shape, against its plain version and
    ``F.batch_norm``, with the launch plan of each; the sums over the
    94 layers of a step."""
    shapes = inception_bn_shapes()
    if sum(n for *_, n in shapes) != INCEPTION_BN_LAYERS:
        raise AssertionError(f"inception-v3 BN shapes {shapes}")
    lib = bn_fused._library()
    coresident, slab = bn_fused.device_limits(
        lib, torch.device("cuda", torch.cuda.current_device()), 1, 8)
    rows = []
    for m, c, n in shapes:
        plan = bn_fused.launch_plan(m, c, 8, 2, coresident=coresident,
                                    slab_bytes=slab)
        log(f"bn plan inception [{m},{c}]: "
            f"{json.dumps(dataclasses.asdict(plan))}")
        side = math.isqrt(m // INCEPTION_BATCH)
        rows.append(check_bn(f"inception [{m},{c}] bf16",
                             (INCEPTION_BATCH, side, side), c,
                             torch.bfloat16, layers=n, eps=1e-3))
    rows.append(check_bn("inception [156800,288] fp32",
                         (INCEPTION_BATCH, 35, 35), 288, torch.float32,
                         eps=1e-3))
    step = [r for r in rows if r["layers"]]
    sums = {k: sum(r["layers"] * r[k] for r in step)
            for k in ("ms", "device_ms", "bound_ms", "library_ms")}
    log(f"bn per Inception-v3 b{INCEPTION_BATCH} step: Σ layers·ms "
        f"{json.dumps(sums)} over {sum(r['layers'] for r in step)} layers")
    return rows


def vision_agreement(name, entry, params, stats, batch):
    """The first step's train-mode logits through the kernels against
    the plain twins: ViT's flash (floor: the other plain attention),
    Inception's BN (floor: BN with fp64 statistics)."""
    if isinstance(entry.make(), ViT):
        variants = {"kernel": {}, "plain": {
            "attention_fn": flash_attention_reference},
            "floor": {"attention_fn": plain_attention}}
    else:
        variants = {"kernel": {}, "plain": {
            "norm_fn": reference_bn_train_forward},
            "floor": {"norm_fn": bn_fp64_stats}}

    def forward(kw):
        with torch.no_grad():
            return apply_vision(entry.make(**kw), params,
                                {k: v.clone() for k, v in stats.items()},
                                batch["inputs"], train=True)

    return agreement(f"{name} first step", {
        k: functools.partial(forward, kw) for k, kw in variants.items()})


def config_lr(name, lr):
    """The rate ``run_benchmark`` trains ``name`` at for ``lr``."""
    bench_lr = get_model(name).bench_lr
    return lr if lr is not None else (bench_lr if bench_lr is not None
                                      else 0.1)


def train_vision(card):
    """The tpu-cnn path (``run_benchmark``) for ViT-B/16, Inception-v3,
    VGG-16 and AlexNet at full width and depth: each a fixed synthetic
    batch, bf16, SGD-Nesterov, its launches counted (ViT: 12 flash a
    forward; Inception: 94 BN a forward), the loss finite at the
    benchmark's own rate and lower at the last step at the rate of a
    ``falls`` run (VISION_RUNS), peak < 80 GB (asserted); images/s, step
    ms and a profiled run's split (ViT and Inception) reported. Then the
    BN kernel at Inception's shapes, and the first step's logits through
    the kernels against the plain twins. Returns the flash and BN
    launches of the last run of each path."""
    launches = {}
    for name, batch, warmup, steps, lr, falls in VISION_RUNS:
        template = get_model(name).make()
        profile = falls and isinstance(template, (ViT, InceptionV3))
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            config = BenchConfig(model=name, batch_size=batch, steps=steps,
                                 warmup_steps=warmup, learning_rate=lr,
                                 seed=0,
                                 profile_dir=tmp if profile else None)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            fused_bn_train_forward.launches = 0
            result = run_benchmark(config)
            torch.cuda.synchronize()
            got = {"flash_attention": flash_attention.launches,
                   "bn_forward": fused_bn_train_forward.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        forwards = max(warmup, 1) + steps
        want = {"flash_attention": forwards * (
                    template.num_layers if isinstance(template, ViT) else 0),
                "bn_forward": forwards * bn_layers(template)}
        losses = result.pop("losses")
        rate = config_lr(name, lr)
        result.update(card=card, peak_memory_gb=peak_gb, launches=got,
                      losses=losses, learning_rate=rate)
        log(f"{name} tpu-cnn: {json.dumps(result)}")
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name} at lr {rate}: a loss is not "
                                 f"finite: {losses}")
        if falls and not losses[-1] < losses[0]:
            raise AssertionError(f"{name} at lr {rate}: the loss did not "
                                 f"fall on the fixed batch: {losses}")
        if peak_gb >= 80:
            raise AssertionError(f"{name}: peak {peak_gb} GB")
        for k, v in got.items():
            if v:
                launches[k] = v
    inception_rows = inception_bn_table()
    for name, batch in VISION_AGREEMENT:
        entry = get_model(name)
        params, stats = init_vision(entry.make(), seed=0)
        config = BenchConfig(model=name, batch_size=batch, seed=0)
        data = synthetic_batch(config, entry.num_classes_or_vocab,
                               entry.input_spec[0], resolve_device())
        vision_agreement(name, entry, params, stats, data)
        del params, stats, data
    gc.collect()
    torch.cuda.empty_cache()
    return launches, inception_rows


def serve_vision(card):
    """Port exports of vit-b16 (params) and inception-v3 (params and
    ``batch_stats``, made non-trivial by two training forwards) through
    ``load_version``: ``predict`` equal to the module applied to the same
    images, and ``classify`` to the top 5 of its softmax, bit for bit;
    12 flash launches a ViT predict (asserted)."""
    x = np.random.default_rng(7).standard_normal(
        (4, 299, 299, 3)).astype(np.float32)
    for name, size in SERVED_VISION:
        entry = get_model(name)
        model = entry.make()
        layers = model.num_layers if isinstance(model, ViT) else 0
        params, stats = init_vision(model, seed=1)
        images = torch.from_numpy(x[:, :size, :size]).to(resolve_device())
        if stats:
            with torch.no_grad():
                for _ in range(2):
                    apply_vision(model, params, stats, images, train=True)
        tree = {"params": unflatten_tree(params_to_flax(params))}
        if stats:
            tree["batch_stats"] = unflatten_tree({
                k.replace(".", "/"): v.cpu().numpy()
                for k, v in stats.items()})
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".export-") as base:
            out = {}
            for version, method in ((1, "predict"), (2, "classify")):
                classes = entry.num_classes_or_vocab
                outputs = ({"logits": TensorSpec("float32", (-1, classes))}
                           if method == "predict" else
                           {"classes": TensorSpec("int32", (-1, 5)),
                            "scores": TensorSpec("float32", (-1, 5))})
                meta = ModelMetadata(
                    model_name=name, registry_name=name, model_kwargs={},
                    signatures={"serving_default": Signature(
                        method=method, inputs={"images": TensorSpec(
                            "float32", (-1, size, size, 3))},
                        outputs=outputs)})
                path = export_model(base, version, meta, tree)
                t0 = time.monotonic()
                loaded = load_version(str(path), max_batch=4)
                load_s = time.monotonic() - t0
                zero_counts()
                t0 = time.monotonic()
                out[method] = loaded.run({"images": np.ascontiguousarray(
                    x[:, :size, :size])})
                run_ms = (time.monotonic() - t0) * 1e3
                flash = flash_attention.launches
                log(f"served {name} {method}: load {load_s:.2f} s, a "
                    f"[4, {size}, {size}, 3] request {run_ms:.1f} ms, flash "
                    f"launches {flash}")
                if flash != layers:
                    raise AssertionError(f"served {name}: {flash} flash "
                                         f"launches, expected {layers}")
                del loaded
        with torch.inference_mode():
            logits = apply_vision(model, params, stats, images, train=False)
            scores, classes = torch.topk(torch.softmax(logits.float(), -1),
                                         5, dim=-1)
        if not (np.array_equal(out["predict"]["logits"],
                               logits.cpu().numpy())
                and np.array_equal(out["classify"]["scores"],
                                   scores.cpu().numpy())
                and np.array_equal(out["classify"]["classes"],
                                   classes.to(torch.int32).cpu().numpy())):
            raise AssertionError(f"served {name} differs from its module")
        log(f"served {name} ({'params and batch_stats' if stats else 'params'}"
            f"): predict and classify equal to the module applied, bitwise "
            f"({card})")
        del params, stats
    gc.collect()
    torch.cuda.empty_cache()


def moe_pretrain(card, name):
    """tpu-lm pretraining steps of one model of the MoE pricing pair at
    b8 × L1024 (fp32 masters) on a token shard of one repeated sequence:
    4 flash and 9 RMSNorm launches a step, the loss falls, an MoE model's
    aux loss in its metrics (asserted); step ms and tokens/s."""
    entry = get_model(name)
    model = entry.make()
    layers = model.num_layers
    want = train_launch_formula(layers, remat=False, frozen_embed=False)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        shard = write_token_shard(tmp, MOE_SEQ, entry.num_classes_or_vocab,
                                  seed=4, repeats=MOE_BATCH * 2)
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        with counted_run(name, MOE_STEPS, want) as launches:
            run_cli(pretrain_main, [
                "--model", name, "--global_batch", str(MOE_BATCH),
                "--seq_len", str(MOE_SEQ), "--steps", str(MOE_STEPS),
                "--warmup_steps", str(MOE_WARMUP), "--learning_rate",
                str(MOE_LR), "--log_every", "1", "--data", shard,
                "--metrics_path", metrics_path])
        with open(metrics_path) as f:
            records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    aux = [r["aux_loss"] for r in records]
    moe = getattr(model, "num_experts", 0) > 0
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    if moe != all(a > 0 for a in aux) or (not moe and any(aux)):
        raise AssertionError(f"{name}: aux losses {aux}")
    step_ms = statistics.median(1e3 / r["steps_per_sec"]
                                for r in records[2:])
    report = {"card": card, "model": name, "batch": MOE_BATCH,
              "seq_len": MOE_SEQ, "losses": losses, "aux_losses": aux,
              "step_ms": step_ms,
              "tokens_per_s": MOE_BATCH * MOE_SEQ / step_ms * 1e3,
              "flops_per_step": lm_train_flops(model, MOE_BATCH, MOE_SEQ),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{name} tpu-lm steps: {json.dumps(report)}")
    return report, launches["flash_attention"]


def moe_serving(card):
    """llama-moe-bench served from seed 0 (bf16): a [2, 512] predict
    (4 flash launches) and a B = 1 greedy generate through
    ``LoadedModel.run``; then the engine's four-slot streams against
    B = 1 ``generate``, reported and not asserted (the reference does
    not pin engine == B=1 for MoE: capacity drops depend on the
    group)."""
    name = MOE_MODELS[0]
    entry = get_model(name)
    params = init_params(entry.make(dtype="bfloat16"), seed=0)
    vocab = entry.num_classes_or_vocab
    rng = np.random.default_rng(5)
    predict = LoadedModel(dataclasses.replace(
        llama_metadata("predict", 512, {"dtype": "bfloat16"}),
        model_name=name, registry_name=name), 1, params, max_batch=2)
    zero_counts()
    logits = predict.run({"input_ids": rng.integers(0, vocab, (2, 512))
                          .astype(np.int32)})["logits"]
    flash = flash_attention.launches
    if flash != predict._module.num_layers or not np.isfinite(logits).all():
        raise AssertionError(f"{name} predict: {flash} flash launches, "
                             f"finite {np.isfinite(logits).all()}")
    config = {"max_new_tokens": MOE_NEW_TOKENS, "temperature": 0.0,
              "engine_slots": 4, "engine_page_size": 16,
              "engine_slice_tokens": 4}
    gen = engine_model(name, params, {"dtype": "bfloat16", "cache_size":
                                      max(MOE_PROMPTS) + MOE_NEW_TOKENS},
                       max(MOE_PROMPTS), config, None)
    prompt = rng.integers(0, vocab, (1, 300)).astype(np.int32)
    t0 = time.monotonic()
    tokens = gen.run({"input_ids": prompt})["tokens"]
    gen_ms = (time.monotonic() - t0) * 1e3
    if tokens.shape != (1, MOE_NEW_TOKENS):
        raise AssertionError(f"{name} generate: {tokens.shape}")
    engine = gen.ensure_engine()
    requests = [(rng.integers(0, vocab, n).astype(np.int32), MOE_NEW_TOKENS,
                 prng.PRNGKey(200 + i)) for i, n in enumerate(MOE_PROMPTS)]
    streams, timing = run_engine(engine, requests)
    equal = [np.array_equal(np.asarray(s), b1_reference(
        gen, p, k, budget, {"temperature": 0.0}))
        for s, (p, budget, k) in zip(streams, requests)]
    gen.close()
    log(f"{name} served ({card}): predict [2, 512] {flash} flash launches; "
        f"B=1 greedy generate of {MOE_NEW_TOKENS} tokens {gen_ms:.1f} ms; "
        f"engine four-slot streams equal to B=1: {sum(equal)} of "
        f"{len(equal)} (reported, not asserted); engine "
        f"{json.dumps(timing)}")
    del params, predict, gen
    gc.collect()
    torch.cuda.empty_cache()


def train_moe(card):
    """The MoE pricing pair's tpu-lm steps, their tokens/s side by side,
    then llama-moe-bench served. Returns the training runs' flash
    launches."""
    reports, flash = {}, 0
    for name in MOE_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        reports[name], got = moe_pretrain(card, name)
        flash += got
    moe, dense = (reports[n]["tokens_per_s"] for n in MOE_MODELS)
    log(f"MoE pricing ({card}): {MOE_MODELS[0]} {moe:.0f} tokens/s vs "
        f"{MOE_MODELS[1]} {dense:.0f} tokens/s, ratio {moe / dense:.3f}")
    moe_serving(card)
    return flash


# -- phase 8: the measuring entry points -------------------------------------

#: The decode sweep (``inference/benchmark.py``): llama3-8b, every weight
#: bf16, prompt 128, 128 new tokens, at B = 1, 4 and 8.
MEASURE_SIZES = (1, 4, 8)
MEASURE_PROMPT = 128
MEASURE_NEW_TOKENS = 128
#: llama3-8b's parameter count: the embedding and the head (128256 ×
#: 4096 each), 32 layers of q/o (4096²), k/v (4096 × 1024), the three
#: MLP products (4096 × 14336) and two norms, and the final norm.
LLAMA3_8B_PARAMS = (2 * 128256 * 4096 + 32 * (2 * 4096 ** 2
                                               + 2 * 4096 * 1024
                                               + 3 * 4096 * 14336
                                               + 2 * 4096) + 4096)
#: The card's memory rate in GB/s: a weight-stream rate above it means
#: a clock stopped before the device finished.
HBM_PEAK_GBS = PEAK_BYTES / 1e9
#: The engine legs at llama3-8b bf16, each at its own default shapes.
ENGINE_LEGS = (("prefix", serving_bench.run_prefix_benchmark,
                serving_bench.PrefixBenchConfig),
               ("tiered", serving_bench.run_tiered_prefix_benchmark,
                serving_bench.TieredPrefixBenchConfig),
               ("speculative", serving_bench.run_speculative_benchmark,
                serving_bench.SpeculativeBenchConfig))
#: The overload leg's seconds an offered-load phase (the reference's
#: 4.0 cut to 2.0: six phases are most of the leg, and the smoke's time
#: limit is shared; a phase still fires ~800 requests at 2× capacity).
OVERLOAD_PHASE_S = 2.0
#: The kernels a Llama leg's path runs (a bf16 model's prefills run
#: their projections on the prefill GEMM; an fp32 model's on cuBLAS).
LLAMA_KERNELS = ("flash_attention", "decode_gemm", "rms_norm",
                 "decode_attention")


def fresh_leg():
    """Free the previous leg's tensors and start this one's peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def leg_memory(card, name):
    log(f"  {name}: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"[{card}]")


def check_verdicts(name, result):
    verdicts = {k: v for k, v in result.items() if k.startswith("bitwise_")}
    if not verdicts or not all(v is True for v in verdicts.values()):
        raise AssertionError(f"{name}: bitwise verdicts {verdicts}")
    log(f"  {name}: {verdicts}")


def counted_leg(name, fn, kernels):
    """Run ``fn`` with every count zeroed just before and read just
    after; each of ``kernels`` must have run and no plain twin may
    have."""
    zero_counts()
    with twin_calls() as twins:
        out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    missing = [k for k in kernels if counts[k] == 0]
    if missing or any(twins.values()):
        raise AssertionError(f"{name}: kernels not launched {missing}, "
                             f"plain twins {twins}")
    log(f"  {name} launches {counts}")
    return out, counts


def measure_decode(card):
    """``run_decode_batch_sweep`` on llama3-8b: each batch size runs
    two 128-token and two 1-token generates, so 4 prefill forwards and
    254 decode steps, every one on the kernels (asserted by the launch
    formulas); ``param_bytes`` twice the parameter count; each row's
    weight-stream rate under the card's peak."""
    fresh_leg()
    sweep, counts = counted_leg(
        "decode sweep", lambda: run_decode_batch_sweep(DecodeBenchConfig(
            model=LLAMA, prompt_len=MEASURE_PROMPT,
            max_new_tokens=MEASURE_NEW_TOKENS), MEASURE_SIZES),
        tuple(COUNTERS))
    forwards = 4 * len(MEASURE_SIZES)
    steps = 2 * (MEASURE_NEW_TOKENS - 1) * len(MEASURE_SIZES)
    if (not prefill_launches_ok(counts, forwards, steps)
            or counts["rms_norm"]
            != STEP_LAUNCHES["rms_norm"] * (forwards + steps)
            or counts["add_rms_norm"]
            != STEP_LAUNCHES["add_rms_norm"] * (forwards + steps)):
        raise AssertionError(f"decode sweep launches {counts} for "
                             f"{forwards} forwards and {steps} steps")
    if sweep["param_bytes"] != 2 * LLAMA3_8B_PARAMS:
        raise AssertionError(f"param_bytes {sweep['param_bytes']} != 2 × "
                             f"{LLAMA3_8B_PARAMS}")
    bound_ms = sweep["param_bytes"] / PEAK_BYTES * 1e3
    for row in sweep["rows"]:
        gbs = row["weight_stream_gb_per_sec"]
        log(f"  decode sweep {LLAMA} B{row['batch_size']}: "
            f"{row['decode_tokens_per_sec']:.1f} tokens/s, "
            f"{row['per_token_ms']:.3f} ms/token (bound {bound_ms:.3f}), "
            f"prefill {row['prefill_ms']:.2f} ms, weights {gbs:.1f} GB/s "
            f"({gbs / HBM_PEAK_GBS:.1%} of {HBM_PEAK_GBS:.0f}), warmup "
            f"{row['compile_plus_warmup_s']:.1f} s [{card}]")
        if not 0 < gbs < HBM_PEAK_GBS:
            raise AssertionError(f"B{row['batch_size']}: {gbs} GB/s is "
                                 f"not under the card's peak: a run timed "
                                 f"without its fence?")
    log(f"  decode sweep speedup vs B1 {sweep['speedup_vs_b1']}")
    leg_memory(card, "decode sweep")
    return counts


def measure_engine_legs(card):
    """The prefix, tiered-prefix and speculative legs at llama3-8b bf16
    (their default shapes): every bitwise verdict holds (asserted); hit
    rates, the TTFT ratio, acceptance and verifier forwards per token
    printed (the benchmark's to judge)."""
    total = dict.fromkeys(COUNTERS, 0)
    for name, run, config in ENGINE_LEGS:
        fresh_leg()
        t0 = time.monotonic()
        result, counts = counted_leg(
            name, lambda: run(config(model=LLAMA, model_dtype="bfloat16")),
            tuple(COUNTERS))
        for k, v in counts.items():
            total[k] += v
        check_verdicts(name, result)
        if name == "prefix":
            log(f"  prefix: hit rate {result['hit_rate']}, mean TTFT cold "
                f"{result['cold']['mean_ttft_ms']} / warm "
                f"{result['warm']['mean_ttft_ms']} ms (ratio "
                f"{result['mean_ttft_ratio']}), prefill-role hits "
                f"{result['prefill_role_hits']}, cold request "
                f"{result['cold_request_ms']} ms [{card}]")
        elif name == "tiered":
            log(f"  tiered: effective hit rate baseline "
                f"{result['baseline']['effective_hit_rate']} / tiered "
                f"{result['tiered']['effective_hit_rate']}, readopted "
                f"{result['host_tier']['readopted_blocks']} (sampled "
                f"{result['sampled_readopted_blocks']}), mean request "
                f"{result['baseline']['mean_request_ms']} / "
                f"{result['tiered']['mean_request_ms']} ms [{card}]")
        else:
            rows = result["rows"]
            log(f"  speculative: strong acceptance "
                f"{result['acceptance_rate']}, verifier forwards a token "
                f"{result['verify_forwards_per_token']}, weak acceptance "
                f"{rows['weak']['acceptance_rate']}, sampled acceptance "
                f"{result['sampled_acceptance_rate']}, tokens/s vanilla "
                f"{rows['vanilla']['tokens_per_s']} / strong "
                f"{rows['strong']['tokens_per_s']} / weak "
                f"{rows['weak']['tokens_per_s']} [{card}]")
        leg_memory(card, f"{name} ({time.monotonic() - t0:.1f} s)")
    return total


def measure_served_legs(card):
    """The export-backed legs at the reference's own models: continuous
    batching (llama-test), gRPC serving (inception-v3 at 299²), mixed
    load (resnet-test + llama-test) and overload (resnet-test). Their
    verdicts and completion counts asserted; latencies printed. Each
    leg is counted: a Llama leg launches every kernel of its path, and
    no leg reaches a plain twin. The REST transport needs tornado,
    which this machine may lack."""
    fresh_leg()
    config = serving_bench.ContinuousBenchConfig()
    result, _ = counted_leg(
        "continuous", lambda: serving_bench.run_continuous_benchmark(config),
        LLAMA_KERNELS)
    check_verdicts("continuous", result)
    for row in result["rows"]:
        for stack in ("static", "continuous"):
            if row[stack]["completed"] != config.num_requests:
                raise AssertionError(f"continuous {stack}: {row}")
        log(f"  continuous x{row['offered_x']}: goodput ratio "
            f"{row['goodput_ratio']}, p50 ratio {row['p50_ratio']}, "
            f"p50 static {row['static']['p50_ms']} / continuous "
            f"{row['continuous']['p50_ms']} ms [{card}]")
    log(f"  continuous: TTFT short {result['ttft_short_ms']} ms vs long "
        f"decode {result['long_decode_ms']} ms")
    leg_memory(card, "continuous")

    fresh_leg()
    config = serving_bench.ServingBenchConfig(transport="grpc")
    grpc, _ = counted_leg(
        "gRPC serving", lambda: serving_bench.run_serving_benchmark(config),
        ())
    if grpc["requests"] != config.clients * config.requests_per_client:
        raise AssertionError(f"gRPC serving: {grpc}")
    log(f"  gRPC {config.model} {config.image_hw}²: p50 {grpc['p50_ms']} / "
        f"p99 {grpc['p99_ms']} ms, {grpc['throughput_rps']} requests/s, "
        f"direct {grpc['direct_model_ms']} ms, request "
        f"{grpc['grpc_request_bytes']} bytes [{card}]")
    leg_memory(card, "gRPC serving")

    fresh_leg()
    config = serving_bench.MixedLoadConfig()
    mixed, _ = counted_leg(
        "mixed", lambda: serving_bench.run_mixed_load_benchmark(config),
        LLAMA_KERNELS)
    for phase, per in (("generate_alone", config.generate_requests
                        * config.generate_clients),
                       ("classify_alone", config.classify_requests
                        * config.classify_clients),
                       ("classify_under_generate", config.classify_requests
                        * config.classify_clients)):
        if mixed[phase]["requests"] != per:
            raise AssertionError(f"mixed load {phase}: {mixed[phase]}")
    log(f"  mixed: classify p99 alone {mixed['classify_alone']['p99_ms']} / "
        f"under generate {mixed['classify_under_generate']['p99_ms']} ms "
        f"({mixed['classify_p99_degradation_x']}x), generate "
        f"{mixed['generate_rps_under_mix']} requests/s under the mix "
        f"[{card}]")
    leg_memory(card, "mixed load")

    fresh_leg()
    overload, _ = counted_leg(
        "overload", lambda: serving_bench.run_overload_benchmark(
            serving_bench.OverloadBenchConfig(
                phase_seconds=OVERLOAD_PHASE_S)), ())
    for row in overload["phases"]:
        if not row["never_dispatched_ok"] or row["sent"] != (
                row["ok"] + row["shed"] + row["expired"]
                + row["client_timeout"]):
            raise AssertionError(f"overload phase {row}")
        log(f"  overload x{row['offered_x']} shedding "
            f"{'on' if row['shedding'] else 'off'}: sent {row['sent']}, ok "
            f"{row['ok']}, shed {row['shed']}, expired {row['expired']}, "
            f"timeouts {row['client_timeout']}, goodput "
            f"{row['goodput_rps']} requests/s")
    log(f"  overload: capacity {overload['capacity_rps']} requests/s, "
        f"goodput at x2 on {overload['goodput_overload_on_vs_capacity']} / "
        f"off {overload['goodput_overload_off_vs_capacity']} of the "
        f"ceiling [{card}]")
    leg_memory(card, "overload")
    try:
        import tornado  # noqa: F401
    except ImportError:
        log("  REST transport: not driven, tornado does not import here "
            "(held against the reference on the CPU, "
            "tests/test_torch_serving_bench.py)")
    else:
        rest = serving_bench.run_serving_benchmark(
            serving_bench.ServingBenchConfig(transport="http"))
        log(f"  REST: p50 {rest['p50_ms']} / p99 {rest['p99_ms']} ms")


def measure_export(card):
    """``kft-export`` round trip: a port checkpoint of llama-test (fp32,
    seed 3) written here, exported by the CLI, loaded with
    ``load_version`` on the card: its params the checkpoint's bit for
    bit, and its greedy tokens equal to the module's own ``generate``
    at the same shapes, both counted as one leg."""
    counted_leg("kft-export", lambda: kft_export_round_trip(card),
                LLAMA_KERNELS)


def kft_export_round_trip(card):
    model = llama_test(dtype="float32")
    params = init_params(model, seed=3)
    prompt = prng.randint(prng.PRNGKey(0), (2, 16), 0, 512)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".export-") as base:
        ckpt = Checkpointer(CheckpointConfig(directory=f"{base}/ckpt"))
        ckpt.save(0, {"step": 0, "params": params}, force=True)
        ckpt.close()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            export_cli.main([
                "--model", "llama-test", "--out", f"{base}/models",
                "--checkpoint", f"{base}/ckpt", "--seq_len", "16",
                "--generate", '{"max_new_tokens": 8}',
                "--model_kwargs", '{"dtype": "float32"}'])
        path = out.getvalue().strip().splitlines()[-1]
        loaded = load_version(path, max_batch=2)
        for name, t in params.items():
            if not torch.equal(loaded.params[name], t):
                raise AssertionError(f"kft-export: {name} changed")
        tokens = loaded.run({"input_ids": prompt})["tokens"]
        module = get_model("llama-test").make(**loaded.metadata.model_kwargs)
        device = resolve_device()
        want, _ = generate(module, params,
                           torch.from_numpy(prompt).to(device),
                           max_new_tokens=8, prompt_lengths=torch.full(
                               (2,), 16, device=device))
        if not np.array_equal(tokens, want.cpu().numpy()):
            raise AssertionError(f"kft-export round trip: served {tokens} "
                                 f"!= the module's {want}")
        size = os.path.getsize(os.path.join(path, "params.msgpack"))
        log(f"  kft-export round trip: {size} bytes, params bit-equal, "
            f"2 × 8 greedy tokens equal [{card}]")


def measure_phases(card):
    """Phase 8: the port's measuring entry points, each leg's counts
    zeroed just before it and read just after. Returns the launches of
    the decode sweep and the engine legs, by kernel."""
    t0 = time.monotonic()
    decode = timed(measure_decode, card)
    engines = timed(measure_engine_legs, card)
    timed(measure_served_legs, card)
    timed(measure_export, card)
    fresh_leg()
    log(f"phase measure: {time.monotonic() - t0:.1f} s [{card}]")
    return {k: decode[k] + engines[k] for k in COUNTERS}



def environment() -> str:
    """The card's name and power limit, and the versions."""
    resolve_device()  # TF32 off for the fp32 head and the fp32 checks
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return card


#: The flash kernel at the rest of the registry's shapes (rows f and g).
REGISTRY_FLASH_SHAPES = (
    # ViT-B/16's training batch: 196 tokens, a 128-row q tile and a
    # 68-row tail.
    ("f: ViT-B16 B64 L196 H12 D64 non-causal", 64, 196, 12, 12, 64,
     torch.bfloat16, False, False),
    # BERT-base's tpu-lm batch, every other row padded.
    ("g: BERT B32 L128 H12 D64 key mask", 32, 128, 12, 12, 64,
     torch.bfloat16, False, True),
)


def registry_phases(card):
    """The rest of the registry: ``train_bert``, ``train_vision``,
    ``serve_vision`` and ``train_moe``, each path's counts zeroed just
    before it and read just after. Returns BERT's flash launches, the
    vision paths' launches, the Inception BN rows and the MoE's flash
    launches."""
    flash_bert = timed(train_bert, card)
    vision, inception_rows = timed(train_vision, card)
    timed(serve_vision, card)
    flash_moe = timed(train_moe, card)
    log(f"registry path launches: bert flash {flash_bert}, vision "
        f"{vision}, moe flash {flash_moe}")
    return flash_bert, vision, inception_rows, flash_moe


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--bn_only", action="store_true",
        help="build, then only hold and time the BN kernel at every "
        "ResNet-50 BN shape (no result line); run from another checkout's "
        "root, it times that checkout's kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on a GPU", file=sys.stderr)
        return 1

    card = environment()
    t0 = time.monotonic()
    reports = _build.build_all()
    log(f"built {sorted(reports)} in {time.monotonic() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    if args.bn_only:
        bn_kernel_table()
        return 0
    kernels = compiler_report(reports["flash_attention"])
    for dtype, dims in HEAD_DIMS.items():
        for d in dims:
            plan, built = launch_plan(dtype, d, 1).smem_bytes, \
                kernel_smem_bytes(dtype, d)
            if plan != built:
                raise AssertionError(f"flash {dtype} D={d}: launch_plan "
                                     f"says {plan} bytes, the kernel {built}")
    log(f"flash launch_plan shared memory = the kernel's for "
        f"{ {str(k): v for k, v in HEAD_DIMS.items()} }")

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
        # Llama-3-8B's full context, where the kernel runs at its
        # steady rate.
        ("e: B1 L8192 H32/8 D128 causal", 1, 8192, 32, 8, 128, bf16, True,
         False),
        *REGISTRY_FLASH_SHAPES,
    ]
    rows = [check_flash(kernels, *s) for s in shapes]
    flash_gradient_rows()
    gemm_rows = decode_gemm_rows()
    fp32_head_rows(earlier_fp32_route())
    norm_rows = rms_norm_rows()
    attn_rows = decode_attention_rows()
    prefill_attention_rows()
    prefill_rows = prefill_gemm_rows()
    tensor_kernel_rows = tensor_rows(kernels)
    small_model_agreement()
    export_round_trip()
    launches = serve_llama(card)
    gc.collect()  # the Llama params go before the axes gang and ResNet
    torch.cuda.empty_cache()
    axes_rows = axes_flash_rows(kernels)
    axes = timed(gang_axes, card)
    gc.collect()
    torch.cuda.empty_cache()
    expert_rows = expert_flash_rows(kernels)
    expert = timed(gang_expert, card)
    gc.collect()
    torch.cuda.empty_cache()

    bn_routes(resnet50_bn_shapes())
    bn_rows = bn_kernel_table()
    resnet_test_agreement()
    launches["bn_forward"] = train_resnet50(card)
    log(f"resnet path launches: bn_forward {launches['bn_forward']}")
    gc.collect()
    torch.cuda.empty_cache()
    gang_bn, route_rows = gang_vision(card)
    log(f"gang resnet path launches: {gang_bn}")
    gc.collect()
    torch.cuda.empty_cache()

    (launches["flash_attention_bert"], vision, inception_rows,
     launches["flash_attention_moe"]) = registry_phases(card)
    measure = measure_phases(card)

    main_row = rows[0]
    # [802816, 256], exact BN: the row every PR has reported.
    bn_main = next(r for r in bn_rows if r["shape"] == "[802816,256] bf16")
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:83",
        "launches": launches["flash_attention"],
        "launches_prefill": launches.pop("flash_attention_prefill"),
        "launches_train": launches.pop("flash_attention_train"),
        "launches_gang": launches.pop("flash_attention_gang"),
        "launches_bert": launches.pop("flash_attention_bert"),
        "launches_vit": vision["flash_attention"],
        "launches_moe": launches.pop("flash_attention_moe"),
        "launches_measure": measure["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    # The decode kernels: sums over one llama3-8b decode step's launches
    # at M = 4 (4 slots), each shape's figure times its launches a step.
    # RMSNorm's two entries, a line each with its own launches: the
    # plain one (layer 0's attention norm, 1 a step) and the fused one
    # (64). rms_norm's counter counts either entry's launches, so the
    # plain entry's are that count less add_rms_norm's.
    norm_train = {k: launches.pop(f"{k}_train")
                  for k in ("rms_norm", "add_rms_norm")}
    norm_gang = {k: launches.pop(f"{k}_gang")
                 for k in ("rms_norm", "add_rms_norm")}

    def own(counts, name):
        return counts[name] - (counts["add_rms_norm"]
                               if name == "rms_norm" else 0)

    for name, source, replaces, krows in (
            ("decode_gemm", "decode_gemm.cu",
             "kubeflow_tpu/models/llama.py:72", gemm_rows),
            ("rms_norm", "rms_norm.cu", "kubeflow_tpu/models/llama.py:46",
             [r for r in norm_rows if r["entry"] == "plain"]),
            ("add_rms_norm", "rms_norm.cu",
             "kubeflow_tpu/models/llama.py:267",
             [r for r in norm_rows if r["entry"] == "fused"]),
            ("decode_attention", "decode_attention.cu",
             "kubeflow_tpu/ops/attention.py:57", attn_rows)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": own(launches, name),
            **({"launches_train": own(norm_train, name),
                "launches_gang": own(norm_gang, name)}
               if name in norm_train else {}),
            "launches_measure": own(measure, name),
            "max_abs_err": max(r["max_abs_err"] for r in krows),
            **{k: per_step(krows, k) for k in ("ms", "plain_ms",
                                               "bound_ms", "library_ms")},
            "bound_by": "bytes",
        })
    # No one PyTorch call adds and normalises: the fused entry's
    # yardstick is a pair (x + d, then F.rms_norm), kept beside it.
    fused_line = next(k for k in kernels if k["name"] == "add_rms_norm")
    fused_line["library_pair_ms"] = fused_line["library_ms"]
    fused_line["library_ms"] = None
    # The prefill GEMM: sums over one llama3-8b prefill forward at
    # M = 512, each shape's figure times its launches a forward.
    kernels.append({
        "name": "prefill_gemm", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/prefill_gemm.cu",
        "replaces": "kubeflow_tpu/models/llama.py:72",
        "launches": launches["prefill_gemm"],
        "launches_measure": measure["prefill_gemm"],
        "max_abs_err": max(r["max_abs_err"] for r in prefill_rows),
        **{k: sum(r["launches_per_forward"] * r[k] for r in prefill_rows)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "operations",
    })
    kernels += [{
        "name": "bn_forward",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/bn_forward.cu",
        "replaces": "kubeflow_tpu/ops/bn_pallas.py:49",
        "launches": launches["bn_forward"],
        "launches_inception": vision["bn_forward"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in bn_rows + inception_rows),
        "ms": bn_main["ms"],
        "plain_ms": bn_main["plain_ms"],
        "bound_ms": bn_main["bound_ms"],
        "bound_by": bn_main["bound_by"],
        "library_ms": bn_main["library_ms"],
    }]
    # The sync route's two entries (phase 0 and phase 1 of the same TPU
    # kernel, split around the all-reduce): the meshed ResNet-50 step's
    # launches, the [802816, 256] bf16 row's figures.
    route_main = route_rows[0]
    for name in ("bn_stats", "bn_apply"):
        part = name.split("_")[1]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kubeflow_tpu_torch/csrc/bn_forward.cu",
            "replaces": "kubeflow_tpu/ops/bn_pallas.py:49",
            "launches": gang_bn[name],
            "max_abs_err": max(r["stats_max_abs_err" if part == "stats"
                                 else "max_abs_err"] for r in route_rows),
            "ms": route_main[f"{part}_ms"],
            "plain_ms": route_main[f"{part}_plain_ms"],
            "bound_ms": route_main[f"{part}_bound_ms"],
            "bound_by": route_main[f"{part}_bound_by"],
            "library_ms": route_main[f"{part}_library_ms"],
        })
    # The tensor gang's ranks (tensor=2, one card): each kernel's launches
    # on each rank over the gang's main path, and its figures at a rank's
    # shapes (sums over a decode step's or a prefill forward's launches,
    # as the one-rank figures are).
    tensor_launches = launches.pop("tensor_ranks")
    for line in kernels:
        krows = tensor_kernel_rows.get(line["name"])
        if krows is None:
            if line["name"] in ("rms_norm", "add_rms_norm"):
                line["launches_tensor_ranks"] = [
                    own(r, line["name"]) for r in tensor_launches]
            continue
        line["launches_tensor_ranks"] = [r[line["name"]]
                                         for r in tensor_launches]
        if line["name"] == "prefill_gemm":
            figures = {k: sum(r["launches_per_forward"] * r[k] for r in krows)
                       for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        elif line["name"] == "flash_attention":
            figures = {k: krows[0][k] for k in ("ms", "plain_ms",
                                                "bound_ms", "library_ms")}
        else:
            figures = {k: per_step(krows, k) for k in
                       ("ms", "plain_ms", "bound_ms", "library_ms")}
        line["tensor_rank"] = {
            **figures,
            "max_abs_err": max(r["max_abs_err"] for r in krows)}
    # The axes gang's ranks (seq=2, then pipeline=2; one card): each
    # kernel's launches on each rank over the phase's main path, and
    # flash's figures at a Ulysses rank's and a pipeline stage's shapes.
    for line in kernels:
        if line["name"] in axes["launches"][0]:
            line["launches_axes_ranks"] = [
                own(r, line["name"]) if line["name"] in ("rms_norm",
                                                         "add_rms_norm")
                else r[line["name"]] for r in axes["launches"]]
        if line["name"] == "flash_attention":
            line["axes_rank"] = [{k: r[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for r in axes_rows]
    # The expert gang's ranks (the MoE on expert=2 and data=2, BERT on
    # tensor=2; one card): each kernel's launches on each rank over the
    # phase's main path, and flash's figures at an MoE block's and a
    # BERT tensor rank's shapes.
    for line in kernels:
        if line["name"] in expert["launches"][0]:
            line["launches_expert_ranks"] = [
                own(r, line["name"]) if line["name"] in ("rms_norm",
                                                         "add_rms_norm")
                else r[line["name"]] for r in expert["launches"]]
        if line["name"] == "flash_attention":
            line["expert_rank"] = [{k: r[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for r in expert_rows]
    log(f"profiled figures timed with CUDA events instead: "
        f"{PROFILER_FALLBACKS or 'none'}")
    log(f"smoke wall: {time.monotonic() - t0:.1f} s from the build")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
