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

"""Which of llama3-8b's ops round a row differently with the row count.

Op by op, on one GPU, bitwise: each op runs once on a batch of rows and
once on every row alone, and the script reports whether the batch's
row i has the bits of row i computed alone (and the largest |Δ| where
not). Five comparisons:

- ``decode``: one decode step at the continuous-batching engine's
  shapes (4 slots, cache 544 = 34 pages of 16), M = 4 distinct rows
  against each row at M = 1: the q/k/v projections, rope, attention
  (scores, softmax sum, PV and the whole), ``o_proj``, both RMSNorms,
  gate/up/down, the final norm, the fp32 ``lm_head``, the top-k/top-p
  truncation (with its softmax and cumsum) and the sampler;
- ``prefill``: a [2, 512] prompt block against each [1, 512] row;
- ``tail``: one row's last W positions computed in a block of width W
  (a prefix-cache hit's tail prefill or a chunked prefill's last chunk:
  W = 2, 4, 8, 16, 32, 64, 128, 256, and the exact tails 140 and 184
  near the cache end) against the same
  positions inside the block of width 512 (the cold prefill): both
  RMSNorms, the seven projections, rope, attention over the 544-slot
  cache and the fp32 head, each width's result under ``widths``;
- ``verify``: a speculative verify's block, 4 slots × 5 tokens (20
  rows), against the one-token step of the 4 slots at each of the 5
  positions: both RMSNorms, the seven projections, rope and the fp32
  head; and a whole verify forward through the 32-layer model, each
  logit column j against the one-token steps at ``start + j``;
- ``chunk``: every chunk of a 512-token prompt prefilled in chunks of 64
  and of 128 against the same positions of the 512-wide block: the
  row-wise ops, attention over the 544-slot cache from the chunk's
  offset, and the fp32 head (a chunked prefill's);
- ``route``: the resume question. A stream of a 300-token prompt killed
  after 1, 16 or 31 tokens resumes on a peer that prefills the whole
  context. Each emitted token's row from a decode step at 4 slots (the
  uninterrupted stream: the decode GEMM, decode attention) against the
  same token's row inside the prefill block of the resumed context (the
  prefill GEMM, flash at the block's offset), in two layouts: ``pad0``
  (the prefix lane: the context at slot 0, one block) and ``classic``
  (the original prompt left-padded in its 512 bucket, the context in
  the continuation's bucket and pad); and ``classic prompt rows``, the
  prompt's own rows prefilled at the original pad against the
  continuation's: both RMSNorms, the seven projections, rope, attention
  over the 544-slot cache and the fp32 head. The ``replay`` layout is
  the split resume's route (``submit(prompt_len=)``): each emitted
  token's row from the replay forward (the emitted tokens as one
  ``decode_positions`` block at B = 1 on the decode kernels, attention
  one query at a time over the original layout) against the same
  token's row from a decode step at 4 slots; its ``port`` cells must
  read ``equal``.

Each op has a ``today`` column (the plain PyTorch op the port ran
before its kernels: cuBLAS for every linear, the RMSNorm formula,
``dense_attention``) and a ``port`` column (what the port runs now on
the card: the decode kernels in a decode step; in a prefill the
prefill GEMM, the RMSNorm kernel, the flash kernel at the block's
offset, and the decode GEMM's fp32 route for the head). A last row runs a
whole decode step through the port's ``llama3-8b`` (32 layers, random
weights from seed 0), both ways.

Weights are random from seed 0; activations are N(0, 1) draws from seed
1 (bitwise invariance does not depend on the values). Run from the
repository root; ``--out`` writes the tables as JSON too::

    python3 scripts/decode_invariance.py [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from kubeflow_tpu_torch.inference import generate as gen  # noqa: E402
from kubeflow_tpu_torch.inference import prng  # noqa: E402
from kubeflow_tpu_torch.models import llama  # noqa: E402
from kubeflow_tpu_torch.models.convert import init_params  # noqa: E402
from kubeflow_tpu_torch.ops.attention import dense_attention  # noqa: E402
from kubeflow_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention,
)
from kubeflow_tpu_torch.ops.decode_gemm import decode_linear  # noqa: E402
from kubeflow_tpu_torch.ops.flash_attention import (  # noqa: E402
    prefill_attention,
)
from kubeflow_tpu_torch.ops.prefill_gemm import prefill_linear  # noqa: E402
from kubeflow_tpu_torch.ops.rms_norm import rms_norm  # noqa: E402
from kubeflow_tpu_torch.utils.device import resolve_device  # noqa: E402

CACHE = 544
#: The decode rows' cache positions (prompt lengths of the engine mix).
DECODE_POS = (300, 511, 77, 410)
PREFILL_W = 512
#: A prefix hit's tail block widths: the buckets (2 to 16 for short
#: tails and a chunked prefill's last chunk), and exact tails near the
#: cache end, where a bucket would overrun it.
TAIL_WIDTHS = (2, 4, 8, 16, 32, 64, 128, 256, 140, 184)
#: A prefill's seven bf16 projections.
PREFILL_LINEARS = tuple(f"attention.{n}_proj.weight" for n in "qkvo") + (
    "gate_proj.weight", "up_proj.weight", "down_proj.weight")
SAMPLING = {"temperature": 0.7, "top_k": 40, "top_p": 0.9}
EPS = 1e-5
#: A speculative verify's block: draft tokens a round plus one.
VERIFY_WIDTH = 5
#: A chunked prefill's chunk widths.
CHUNK_WIDTHS = (64, 128)
#: The resume question: a prompt of 300 in the 512 bucket, and the kill
#: points of a 32-token budget (after the first token, the middle, and
#: budget - 1).
ROUTE_PROMPT = 300
ROUTE_BUCKET = 512
ROUTE_KILLS = (1, 16, 31)


def llama3_8b(num_layers: int = 32) -> llama.Llama:
    return llama.Llama(vocab_size=128256, num_layers=num_layers,
                       d_model=4096, num_heads=32, num_kv_heads=8,
                       mlp_dim=14336, rope_theta=500000.0,
                       dtype="bfloat16", cache_size=CACHE)


def compare(fn, inputs):
    """``fn`` on the whole batch vs on each of its rows alone. Inputs
    whose leading dimension is 1 (weights) go whole to every call.
    Returns ``{"equal": bool, "max_abs": float}``."""
    whole = fn(*inputs)
    n = max(t.shape[0] for t in inputs)
    equal, worst = True, 0.0
    for i in range(n):
        piece = fn(*[t if t.shape[0] == 1 else t[i:i + 1] for t in inputs])
        d = _diff(piece, whole[i:i + 1])
        equal &= d["equal"]
        worst = max(worst, d["max_abs"])
    return {"equal": equal, "max_abs": worst}


def plain_rms_norm(x, scale):
    """The RMSNorm formula the port ran before its kernel."""
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + EPS).to(x.dtype) * scale


def scores(q, k):
    return torch.einsum("bqhd,bkhd->bhqk", q.float(),
                        llama_repeat(k, q).float()) * q.shape[-1] ** -0.5


def llama_repeat(kv, q):
    rep = q.shape[2] // kv.shape[2]
    return kv.repeat_interleave(rep, dim=2)


def softmax_sum(q, k, mask):
    s = scores(q, k).masked_fill(~mask[:, None, None, :], -1e30)
    m = torch.clamp_min(s.amax(-1, keepdim=True), -5e29)
    return torch.exp(s - m).sum(-1)


def pv(q, k, v, mask):
    s = scores(q, k).masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.exp(s - torch.clamp_min(s.amax(-1, keepdim=True), -5e29))
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        llama_repeat(v, q).float())


def truncate_parts(logits):
    """The pieces of ``_truncate_logits`` whose reduction order could
    depend on the row count: top-k's k-th value, the sorted logits, the
    softmax over them and its cumsum."""
    kth = torch.topk(logits, SAMPLING["top_k"], dim=-1).values[..., -1:]
    kept = torch.where(logits < kth, float("-inf"), logits)
    srt = torch.sort(kept, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    return kth, srt, probs, torch.cumsum(probs, dim=-1)


@contextlib.contextmanager
def today_routes():
    """Run the port's model on the ops it used before its decode
    kernels: cuBLAS for every linear, the residual add and the RMSNorm
    formula,
    ``dense_attention`` over the cache, one cumsum over the batch."""
    saved = (llama.decode_linear, llama.rms_norm, llama.add_rms_norm,
             llama.decode_attention, gen._row_cumsum)
    llama.decode_linear = F.linear
    llama.rms_norm = lambda x, scale, eps: plain_rms_norm(x, scale)
    llama.add_rms_norm = lambda x, delta, scale, eps: (
        x + delta, plain_rms_norm(x + delta, scale))
    llama.decode_attention = lambda q, k, v, valid: dense_attention(
        q, k, v, kv_segment_valid=valid)
    gen._row_cumsum = lambda probs: torch.cumsum(probs, dim=-1)
    try:
        yield
    finally:
        (llama.decode_linear, llama.rms_norm, llama.add_rms_norm,
         llama.decode_attention, gen._row_cumsum) = saved


def decode_table(p, cfg, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    n = len(DECODE_POS)

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    d, hkv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    x = randn(n, 1, d)
    kc, vc = randn(n, CACHE, hkv, hd), randn(n, CACHE, hkv, hd)
    pos = torch.tensor(DECODE_POS, device=dev)
    valid = torch.arange(CACHE, device=dev)[None, :] <= pos[:, None]
    w = {k.split(".", 2)[-1]: v for k, v in p.items()
         if k.startswith("layers.0.")}
    wq, wk, wv, wo = (w[f"attention.{n_}_proj.weight"] for n_ in "qkvo")
    scale = w["attn_norm.scale"]
    h = plain_rms_norm(x, scale)
    q = F.linear(h, wq).reshape(n, 1, cfg.num_heads, hd)
    positions = pos[:, None]
    qr = llama.rope(q, positions, cfg.rope_theta)
    attn = dense_attention(qr, kc, vc, kv_segment_valid=valid)
    mlp_in = randn(n, 1, d)
    act = randn(n, 1, cfg.mlp_dim)
    head_in = randn(n, 1, d, dtype=torch.float32)
    logits = (F.linear(head_in, p["lm_head.weight"])[:, 0]
              / SAMPLING["temperature"])
    keys = gen._device_keys(np.stack([prng.PRNGKey(100 + i)
                                      for i in range(n)]), dev)
    cum = gen._row_cumsum
    ops = [
        ("attn_norm (RMSNorm)", [x, scale[None]],
         lambda a, s: plain_rms_norm(a, s[0]),
         lambda a, s: rms_norm(a, s[0], EPS)),
        ("q_proj [4096→4096] bf16", [h, wq[None]],
         lambda a, m: F.linear(a, m[0]), lambda a, m: decode_linear(a, m[0])),
        ("k_proj [4096→1024] bf16", [h, wk[None]],
         lambda a, m: F.linear(a, m[0]), lambda a, m: decode_linear(a, m[0])),
        ("v_proj [4096→1024] bf16", [h, wv[None]],
         lambda a, m: F.linear(a, m[0]), lambda a, m: decode_linear(a, m[0])),
        ("rope (q)", [q, positions],
         lambda a, s: llama.rope(a, s, cfg.rope_theta), None),
        ("attention scores QKᵀ (fp32 einsum)", [qr, kc],
         scores, None),
        ("attention softmax sum", [qr, kc, valid], softmax_sum, None),
        ("attention PV (fp32 einsum)", [qr, kc, vc, valid], pv, None),
        ("attention, whole (S = 544)", [qr, kc, vc, valid],
         lambda a, b, c, m: dense_attention(a, b, c, kv_segment_valid=m),
         decode_attention),
        ("o_proj [4096→4096] bf16", [attn.reshape(n, 1, d), wo[None]],
         lambda a, m: F.linear(a, m[0]), lambda a, m: decode_linear(a, m[0])),
        ("mlp_norm (RMSNorm)", [mlp_in, w["mlp_norm.scale"][None]],
         lambda a, s: plain_rms_norm(a, s[0]),
         lambda a, s: rms_norm(a, s[0], EPS)),
        ("gate_proj [4096→14336] bf16",
         [mlp_in, w["gate_proj.weight"][None]],
         lambda a, m: F.linear(a, m[0]), lambda a, m: decode_linear(a, m[0])),
        ("up_proj [4096→14336] bf16", [mlp_in, w["up_proj.weight"][None]],
         lambda a, m: F.linear(a, m[0]), lambda a, m: decode_linear(a, m[0])),
        ("down_proj [14336→4096] bf16", [act, w["down_proj.weight"][None]],
         lambda a, m: F.linear(a, m[0]), lambda a, m: decode_linear(a, m[0])),
        ("final_norm (RMSNorm)", [mlp_in, p["final_norm.scale"][None]],
         lambda a, s: plain_rms_norm(a, s[0]),
         lambda a, s: rms_norm(a, s[0], EPS)),
        ("lm_head [4096→128256] fp32", [head_in, p["lm_head.weight"][None]],
         lambda a, m: F.linear(a, m[0]), lambda a, m: decode_linear(a, m[0])),
        ("top-k k-th value", [logits], lambda a: truncate_parts(a)[0], None),
        ("sorted logits", [logits], lambda a: truncate_parts(a)[1], None),
        ("softmax of sorted", [logits], lambda a: truncate_parts(a)[2], None),
        ("cumsum of softmax", [logits],
         lambda a: torch.cumsum(truncate_parts(a)[2], dim=-1),
         lambda a: cum(truncate_parts(a)[2])),
        ("_truncate_logits (top-k 40, top-p 0.9)", [logits],
         lambda a: gen._truncate_logits(a, 40, 0.9), None),
        ("_sample_logits (per-row keys)", [logits, keys],
         lambda a, k_: gen._sample_logits(a, k_, 1.0, 40, 0.9), None),
        ("argmax (greedy)", [logits], lambda a: torch.argmax(a, -1), None),
    ]
    return _run_ops(ops)


def _run_ops(ops):
    """Each op's plain form under today's routes, and the port's form
    (the plain one where the port kept it) under the port's."""
    table = []
    for name, inputs, plain, port in ops:
        with today_routes():
            today_row = compare(plain, inputs)
        table.append({"op": name, "today": today_row,
                      "port": compare(port or plain, inputs)})
    return table


def prefill_tables(p, cfg, dev):
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(bf)

    w = {k.split(".", 2)[-1]: v for k, v in p.items()
         if k.startswith("layers.0.")}
    d, hkv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    x = randn(2, PREFILL_W, d)
    act = randn(2, PREFILL_W, cfg.mlp_dim)
    q = randn(2, PREFILL_W, cfg.num_heads, hd)
    kc, vc = randn(2, CACHE, hkv, hd), randn(2, CACHE, hkv, hd)
    valid = (torch.arange(CACHE, device=dev) < PREFILL_W)[None].expand(2, -1)
    head_in = torch.randn(2, PREFILL_W, d, device=dev, generator=g)

    def attention(qq, k_, v_, m, offset=0):
        return dense_attention(qq, k_, v_, causal=True, q_offset=offset,
                               kv_offset=0, kv_segment_valid=m)

    def port_attention(qq, k_, v_, m, offset=0):
        return prefill_attention(qq, k_, v_, offset, m)

    def rows_ops():
        """(name, input, today's op, the port's op) for each row-wise
        op of a prefill."""
        ops = []
        for norm in ("attn_norm", "mlp_norm"):
            scale = w[f"{norm}.scale"]
            ops.append((f"{norm} (RMSNorm)", x,
                        lambda a, s_=scale: plain_rms_norm(a, s_),
                        lambda a, s_=scale: rms_norm(a, s_, EPS)))
        for name in PREFILL_LINEARS:
            weight = w[name]
            ops.append((f"{name.split('.')[-2]} bf16 "
                        f"[{weight.shape[1]}→{weight.shape[0]}]",
                        act if name == "down_proj.weight" else x,
                        lambda a, m=weight: F.linear(a, m),
                        lambda a, m=weight: prefill_linear(a, m)))
        ops.append(("lm_head fp32", head_in,
                    lambda a: F.linear(a, p["lm_head.weight"]),
                    lambda a: decode_linear(a, p["lm_head.weight"])))
        return ops

    batch_ops = [(name, [a], plain, port)
                 for name, a, plain, port in rows_ops()]
    batch_ops.append(("attention (causal, cache 544)", [q, kc, vc, valid],
                      attention, port_attention))
    prefill = _run_ops(batch_ops)

    # Tail vs cold: the last W positions of row 0 in a W-wide block (a
    # prefix hit's tail prefill) against the same positions inside the
    # 512-wide block (the cold prefill), at every width the prefix mix
    # reaches.
    tail = []
    for name, a, plain, port in rows_ops():
        a = a[:1]
        row = {"op": name}
        for label, fn in (("today", plain), ("port", port or plain)):
            cold = fn(a)
            row[label] = _widths(lambda lo: fn(a[:, lo:].contiguous()),
                                 lambda lo: cold[:, lo:])
        tail.append(row)
    positions = torch.arange(PREFILL_W, device=dev)[None]
    qr = llama.rope(q[:1], positions, cfg.rope_theta)
    row = _widths(lambda lo: llama.rope(q[:1, lo:].contiguous(),
                                        positions[:, lo:], cfg.rope_theta),
                  lambda lo: qr[:, lo:])
    tail.append({"op": "rope (q)", "today": row, "port": row})
    row = {"op": "attention (causal, cache 544)"}
    for label, fn in (("today", attention), ("port", port_attention)):
        cold = fn(q[:1], kc[:1], vc[:1], valid[:1])
        row[label] = _widths(lambda lo: fn(q[:1, lo:].contiguous(), kc[:1],
                                           vc[:1], valid[:1], offset=lo),
                             lambda lo: cold[:, lo:])
    tail.append(row)

    # Chunk vs cold: every chunk of the 512-token prompt in a block of
    # its own (a chunked prefill) against the same positions inside the
    # 512-wide block.
    chunk = []
    for name, a, plain, port in rows_ops():
        a = a[:1]
        row = {"op": name}
        for label, fn in (("today", plain), ("port", port or plain)):
            cold = fn(a)
            row[label] = _chunks(lambda lo, wd: fn(a[:, lo:lo + wd]
                                                   .contiguous()),
                                 lambda lo, wd: cold[:, lo:lo + wd])
        chunk.append(row)
    row = _chunks(lambda lo, wd: llama.rope(
        q[:1, lo:lo + wd].contiguous(), positions[:, lo:lo + wd],
        cfg.rope_theta), lambda lo, wd: qr[:, lo:lo + wd])
    chunk.append({"op": "rope (q)", "today": row, "port": row})
    row = {"op": "attention (causal, cache 544)"}
    for label, fn in (("today", attention), ("port", port_attention)):
        cold = fn(q[:1], kc[:1], vc[:1], valid[:1])
        row[label] = _chunks(lambda lo, wd: fn(
            q[:1, lo:lo + wd].contiguous(), kc[:1], vc[:1], valid[:1],
            offset=lo), lambda lo, wd: cold[:, lo:lo + wd])
    chunk.append(row)
    return prefill, tail, chunk


def _chunks(narrow, wide):
    """Each chunk width's blocks against the cold block's same positions:
    ``{"equal", "max_abs", "widths": {W: diff over its chunks}}``."""
    per = {}
    for wd in CHUNK_WIDTHS:
        diffs = [_diff(narrow(lo, wd), wide(lo, wd))
                 for lo in range(0, PREFILL_W, wd)]
        per[str(wd)] = {"equal": all(d["equal"] for d in diffs),
                        "max_abs": max(d["max_abs"] for d in diffs)}
    return {"equal": all(r["equal"] for r in per.values()),
            "max_abs": max(r["max_abs"] for r in per.values()),
            "widths": per}


def verify_table(p, cfg, dev):
    """Each op of a verify's 4 × 5 block against the one-token step's
    4 rows at each of the 5 positions."""
    g = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    n, wd = len(DECODE_POS), VERIFY_WIDTH

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    w = {k.split(".", 2)[-1]: v for k, v in p.items()
         if k.startswith("layers.0.")}
    d, hd = cfg.d_model, cfg.head_dim
    x = randn(n, wd, d)
    act = randn(n, wd, cfg.mlp_dim)
    q = randn(n, wd, cfg.num_heads, hd)
    positions = torch.tensor(DECODE_POS, device=dev)[:, None] + \
        torch.arange(wd, device=dev)[None]
    head_in = randn(n, wd, d, dtype=torch.float32)
    ops = []
    for norm in ("attn_norm", "mlp_norm", "final_norm"):
        scale = (p["final_norm.scale"] if norm == "final_norm"
                 else w[f"{norm}.scale"])
        ops.append((f"{norm} (RMSNorm)", x,
                    lambda a, s_=scale: plain_rms_norm(a, s_),
                    lambda a, s_=scale: rms_norm(a, s_, EPS)))
    for name in PREFILL_LINEARS:
        weight = w[name]
        ops.append((f"{name.split('.')[-2]} bf16 "
                    f"[{weight.shape[1]}→{weight.shape[0]}]",
                    act if name == "down_proj.weight" else x,
                    lambda a, m=weight: F.linear(a, m),
                    lambda a, m=weight: decode_linear(a, m)))
    ops.append(("lm_head fp32 [4096→128256]", head_in,
                lambda a: F.linear(a, p["lm_head.weight"]),
                lambda a: decode_linear(a, p["lm_head.weight"])))
    table = []
    for name, a, plain, port in ops:
        row = {"op": name}
        for label, fn in (("today", plain), ("port", port)):
            block = fn(a)
            diffs = [_diff(fn(a[:, j:j + 1].contiguous()), block[:, j:j + 1])
                     for j in range(wd)]
            row[label] = {"equal": all(r["equal"] for r in diffs),
                          "max_abs": max(r["max_abs"] for r in diffs)}
        table.append(row)
    block = llama.rope(q, positions, cfg.rope_theta)
    diffs = [_diff(llama.rope(q[:, j:j + 1].contiguous(),
                              positions[:, j:j + 1], cfg.rope_theta),
                   block[:, j:j + 1]) for j in range(wd)]
    row = {"equal": all(r["equal"] for r in diffs),
           "max_abs": max(r["max_abs"] for r in diffs)}
    table.append({"op": "rope (q)", "today": row, "port": row})
    return table


def route_table(p, cfg, dev):
    """Each op's row for an emitted token from a decode step at 4 slots
    against the same token's row in the resumed context's prefill
    block, per layout (see the module doc). ``today``: the plain ops on
    both routes; ``port``: the decode kernels against the prefill
    kernels."""
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    w = {k.split(".", 2)[-1]: v for k, v in p.items()
         if k.startswith("layers.0.")}
    d, hkv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    n_ctx = ROUTE_PROMPT + max(ROUTE_KILLS)
    x, act = randn(n_ctx, d), randn(n_ctx, cfg.mlp_dim)
    head_in = randn(n_ctx, d, dtype=torch.float32)
    others = {n_: randn(3, n_) for n_ in (d, cfg.mlp_dim)}
    others_f32 = randn(3, d, dtype=torch.float32)
    q = randn(n_ctx, cfg.num_heads, hd)
    kseq, vseq = randn(n_ctx, hkv, hd), randn(n_ctx, hkv, hd)
    slots = torch.arange(CACHE, device=dev)
    orig_pad = ROUTE_BUCKET - ROUTE_PROMPT

    def row_ops():
        ops = []
        for norm in ("attn_norm", "mlp_norm"):
            scale = w[f"{norm}.scale"]
            ops.append((f"{norm} (RMSNorm)", x,
                        lambda a, s_=scale: plain_rms_norm(a, s_),
                        lambda a, s_=scale: rms_norm(a, s_, EPS),
                        lambda a, s_=scale: rms_norm(a, s_, EPS)))
        for name in PREFILL_LINEARS:
            weight = w[name]
            ops.append((f"{name.split('.')[-2]} bf16 "
                        f"[{weight.shape[1]}→{weight.shape[0]}]",
                        act if name == "down_proj.weight" else x,
                        lambda a, m=weight: F.linear(a, m),
                        lambda a, m=weight: decode_linear(a, m),
                        lambda a, m=weight: prefill_linear(a, m)))
        ops.append(("lm_head fp32", head_in,
                    lambda a: F.linear(a, p["lm_head.weight"]),
                    lambda a: decode_linear(a, p["lm_head.weight"]),
                    lambda a: decode_linear(a, p["lm_head.weight"])))
        return ops

    def step_rows(fn, a, positions):
        """The decode route: each position's row at M = 4 beside three
        other slots' rows, one step a position."""
        rest = (others_f32 if a.dtype == torch.float32
                else others[a.shape[-1]])
        return torch.stack([fn(torch.cat([a[i:i + 1], rest])[:, None])[0, 0]
                            for i in positions])

    def padded(a, pad):
        return torch.cat([a.new_zeros((pad,) + a.shape[1:]), a])

    table = []
    for name, a, plain, dec, pre in row_ops():
        row = {"op": name}
        for label, d_fn, p_fn in (("today", plain, plain),
                                  ("port", dec, pre)):
            layouts = {"pad0": [], "classic": [], "classic prompt rows": [],
                       "replay": []}
            for kill in ROUTE_KILLS:
                ctx = ROUTE_PROMPT + kill
                emitted = range(ROUTE_PROMPT, ctx)
                want = step_rows(d_fn, a, emitted)
                layouts["replay"].append(
                    _diff(d_fn(a[None, ROUTE_PROMPT:ctx])[0], want))
                block = p_fn(a[None, :ctx])[0]
                layouts["pad0"].append(_diff(block[ROUTE_PROMPT:ctx], want))
                pad = ROUTE_BUCKET - ctx
                block = p_fn(padded(a[:ctx], pad)[None])[0]
                layouts["classic"].append(
                    _diff(block[pad + ROUTE_PROMPT:], want))
                orig = p_fn(padded(a[:ROUTE_PROMPT], orig_pad)[None])[0]
                layouts["classic prompt rows"].append(
                    _diff(block[pad:pad + ROUTE_PROMPT], orig[orig_pad:]))
            row[label] = _layouts(layouts)
        table.append(row)
    positions = torch.arange(n_ctx, device=dev)
    qr = llama.rope(q[None], positions[None], cfg.rope_theta)[0]
    one = torch.stack([llama.rope(q[None, i:i + 1], positions[None, i:i + 1],
                                  cfg.rope_theta)[0, 0]
                       for i in range(ROUTE_PROMPT, n_ctx)])
    r = _diff(qr[ROUTE_PROMPT:], one)
    same = _layouts({k: [r] for k in ("pad0", "classic", "replay")})
    table.append({"op": "rope (q)", "today": same, "port": same})

    def cache_at(pad):
        """A [1, 544] cache holding the context's K/V from slot ``pad``
        (random K/V elsewhere: masked)."""
        kc, vc = randn(1, CACHE, hkv, hd), randn(1, CACHE, hkv, hd)
        kc[0, pad:pad + n_ctx], vc[0, pad:pad + n_ctx] = kseq, vseq
        return kc, vc

    def decode_rows(attend, pad, emitted, cache=None):
        """The decode route: each emitted token's query at 4 slots (three
        other slots over their own random caches)."""
        kc, vc = cache_at(pad) if cache is None else cache
        k4 = torch.cat([kc, randn(3, CACHE, hkv, hd)])
        v4 = torch.cat([vc, randn(3, CACHE, hkv, hd)])
        out = []
        for i in emitted:
            q4 = torch.cat([q[None, i:i + 1], randn(3, 1, cfg.num_heads, hd)])
            valid = torch.stack([(slots >= pad) & (slots <= pad + i)] + [
                slots <= s for s in DECODE_POS[1:]])
            out.append(attend(q4, k4, v4, valid)[0, 0])
        return torch.stack(out)

    def replay_rows(attend, pad, emitted, cache):
        """The replay forward's attention: each emitted token's query
        alone (B = 1) over the original layout, valid up to itself."""
        kc, vc = cache
        return torch.stack([
            attend(q[None, i:i + 1], kc, vc,
                   ((slots >= pad) & (slots <= pad + i))[None])[0, 0]
            for i in emitted])

    def prefill_rows(attend, pad, ctx, width):
        kc, vc = cache_at(pad)
        qb = padded(q[:ctx], pad)
        qb = torch.cat([qb, qb.new_zeros((width - qb.shape[0],)
                                         + qb.shape[1:])])[None]
        valid = ((slots < width) & (slots >= pad))[None]
        return attend(qb, kc, vc, valid)[0]

    dense_dec = (lambda q_, k_, v_, m: dense_attention(
        q_, k_, v_, kv_segment_valid=m))
    dense_pre = (lambda q_, k_, v_, m: dense_attention(
        q_, k_, v_, causal=True, q_offset=0, kv_offset=0,
        kv_segment_valid=m))
    flash_pre = (lambda q_, k_, v_, m: prefill_attention(q_, k_, v_, 0, m))
    row = {"op": "attention (cache 544)"}
    for label, d_fn, p_fn in (("today", dense_dec, dense_pre),
                              ("port", decode_attention, flash_pre)):
        layouts = {"pad0": [], "classic": [], "classic prompt rows": [],
                   "replay": []}
        orig = prefill_rows(p_fn, orig_pad, ROUTE_PROMPT, ROUTE_BUCKET)
        for kill in ROUTE_KILLS:
            ctx = ROUTE_PROMPT + kill
            emitted = range(ROUTE_PROMPT, ctx)
            cache = cache_at(orig_pad)
            layouts["replay"].append(_diff(
                replay_rows(d_fn, orig_pad, emitted, cache),
                decode_rows(d_fn, orig_pad, emitted, cache)))
            block = prefill_rows(p_fn, 0, ctx, ctx)
            layouts["pad0"].append(_diff(block[ROUTE_PROMPT:ctx],
                                         decode_rows(d_fn, 0, emitted)))
            pad = ROUTE_BUCKET - ctx
            block = prefill_rows(p_fn, pad, ctx, ROUTE_BUCKET)
            layouts["classic"].append(_diff(
                block[pad + ROUTE_PROMPT:pad + ctx],
                decode_rows(d_fn, orig_pad, emitted)))
            layouts["classic prompt rows"].append(_diff(
                block[pad:pad + ROUTE_PROMPT],
                orig[orig_pad:orig_pad + ROUTE_PROMPT]))
        row[label] = _layouts(layouts)
    table.append(row)
    return table


def _layouts(per):
    """Each layout's diffs (one a kill point) folded: ``{"equal",
    "max_abs", "layouts": {name: {"equal", "max_abs"}}}``."""
    out = {name: {"equal": all(d["equal"] for d in diffs),
                  "max_abs": max(d["max_abs"] for d in diffs)}
           for name, diffs in per.items()}
    return {"equal": all(r["equal"] for r in out.values()),
            "max_abs": max(r["max_abs"] for r in out.values()),
            "layouts": out}


def _widths(narrow, wide):
    """Each tail width's block against the cold block's same positions:
    ``{"equal": all equal, "max_abs": the worst, "widths": {W: diff}}``."""
    per = {str(wd): _diff(narrow(PREFILL_W - wd), wide(PREFILL_W - wd))
           for wd in TAIL_WIDTHS}
    return {"equal": all(r["equal"] for r in per.values()),
            "max_abs": max(r["max_abs"] for r in per.values()),
            "widths": per}


def _diff(a, b):
    if torch.equal(a, b):
        return {"equal": True, "max_abs": 0.0}
    return {"equal": False,
            "max_abs": float((a.double() - b.double()).abs().max())}


def decode_step(dev):
    """One decode step through the port's llama3-8b (32 layers) at
    M = 4 vs each row at M = 1: the logits, today's ops and the port's;
    and one verify forward of 4 slots × 5 tokens against the 5
    one-token steps from the same cache, column by column."""
    model = llama3_8b()
    params = init_params(model, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    n = len(DECODE_POS)
    shape = (n, CACHE, model.num_kv_heads, model.head_dim)
    caches = [llama.LayerCache(
        torch.randn(shape, device=dev, generator=g).to(torch.bfloat16),
        torch.randn(shape, device=dev, generator=g).to(torch.bfloat16))
        for _ in range(model.num_layers)]
    tokens = torch.randint(0, model.vocab_size, (n, 1), device=dev,
                           generator=g)
    pos = torch.tensor(DECODE_POS, device=dev)
    pads = torch.zeros(n, dtype=torch.int64, device=dev)

    def step(rows):
        cache = [llama.LayerCache(c.k[rows].clone(), c.v[rows].clone())
                 for c in caches]
        with torch.inference_mode():
            return llama.apply(model, params, tokens[rows], pos[rows, None],
                               pad_lengths=pads[rows],
                               decode_positions=pos[rows], cache=cache)

    wd = VERIFY_WIDTH
    block = torch.randint(0, model.vocab_size, (n, wd), device=dev,
                          generator=g)

    def verify():
        cache = [llama.LayerCache(c.k.clone(), c.v.clone()) for c in caches]
        with torch.inference_mode():
            return llama.apply(
                model, params, block,
                pos[:, None] + torch.arange(wd, device=dev)[None],
                pad_lengths=pads, decode_positions=pos, cache=cache)

    def one_token_steps():
        cache = [llama.LayerCache(c.k.clone(), c.v.clone()) for c in caches]
        with torch.inference_mode():
            return torch.cat([llama.apply(
                model, params, block[:, j:j + 1], pos[:, None] + j,
                pad_lengths=pads, decode_positions=pos + j, cache=cache)
                for j in range(wd)], dim=1)

    out, ver = {}, {}
    for label, ctx in (("today", today_routes), ("port",
                                                 contextlib.nullcontext)):
        with ctx():
            whole = step(slice(None))
            pieces = torch.cat([step(slice(i, i + 1)) for i in range(n)])
            out[label] = _diff(pieces, whole)
            ver[label] = _diff(verify(), one_token_steps())
    del params
    return ({"op": "decode step, llama3-8b 32 layers: logits", **out},
            {"op": "verify forward 4 × 5, llama3-8b 32 layers: logits",
             **ver})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the tables to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_invariance: needs a GPU", file=sys.stderr)
        return 1
    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with torch.inference_mode():
        cfg = llama3_8b(num_layers=1)
        p = init_params(cfg, seed=0, device=dev)
        tables = {"decode": decode_table(p, cfg, dev)}
        tables["prefill"], tables["tail"], tables["chunk"] = \
            prefill_tables(p, cfg, dev)
        tables["verify"] = verify_table(p, cfg, dev)
        tables["route"] = route_table(p, cfg, dev)
        del p
    step_row, verify_row = decode_step(dev)
    tables["decode"].append(step_row)
    tables["verify"].append(verify_row)
    for section, rows in tables.items():
        print(f"-- {section}", flush=True)
        for r in rows:
            today, port = (("equal" if r[c]["equal"] else r[c]["max_abs"])
                           for c in ("today", "port"))
            print(f"{r['op']:45s} today {today} | port {port}", flush=True)
            for c in ("today", "port"):
                for part in ("widths", "layouts"):
                    apart = {wd: x["max_abs"] for wd, x in
                             r[c].get(part, {}).items() if not x["equal"]}
                    if apart:
                        print(f"{'':45s} {c} apart at {part} {apart}",
                              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "tables": tables}, f, indent=1)
    print(json.dumps({"card": card, "tables": tables}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
