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

"""Llama-family decoder (RMSNorm / RoPE / SwiGLU / GQA) in PyTorch.

Port of ``kubeflow_tpu/models/llama.py``, dense and MoE. Parameter names
follow the Flax tree (``models/convert.py`` maps one onto the other).

Modules are templates, as Flax modules are: the registry builds them on
the meta device, and weights travel as a ``params`` dict applied with
:func:`apply` (``torch.func.functional_call``), the counterpart of
``model.apply({"params": params}, ...)``. Each weight is stored in the
dtype its op consumes (see models/convert.py).

Attention: the cache-free forward calls :func:`flash_attention` (the
CUDA kernel on the GPU).

A cache forward runs on kernels whose rows depend neither on the row
count nor on the block width. A decode step (one token per row:
``generate``'s steps and the decode engine's; and every forward given
``decode_positions``, so also the engine's speculative verify of k + 1
tokens a row) sends every linear layer through :func:`decode_linear`
(the fp32 ``lm_head`` included) on its ``[B·l, d]`` rows and attention
through :func:`decode_attention`, one query at a time, so an engine
slot's stream has the bits of the same request at B=1, and a verify
row those of the one-token step at its position. A prefill into the
cache (more than one token per row without ``decode_positions``:
``generate``'s prompt pass, the engine's admissions, a prefix hit's
tail and a chunk of a chunked prefill) sends its seven bf16 projections
through :func:`prefill_linear` and its attention over the cache through
:func:`prefill_attention`: one launch a layer of the flash kernel for
the whole ``[B, L]`` block, causal at the block's offset in the cache
(``cache.index``), with its key tiles aligned at slot 0. Both kernels'
rows depend neither on the block's width nor on its offset, so a prompt
position's row has the same bits in a hit's narrow tail block or a
chunk as in the cold run's full-width block.
Every cache forward's fp32 ``lm_head`` runs on the decode GEMM's fp32
route, because cuBLAS's rows differ at narrow widths
(scripts/decode_invariance.py, ``tail``); a prefill's callers ask for
the one position a row they read (``logits_at``), so the head runs on
B rows, not B·L.
:func:`rms_norm` takes every norm on the card. On the CPU each is its
plain version. The cache-free forward (predict, classify, training)
keeps ``F.linear``: a plain large product, as the reference leaves it
to XLA.

Training. ``param_dtype`` is the storage dtype of every weight; by
default each weight is stored in the dtype its op consumes (serving).
Training keeps fp32 masters (``param_dtype="float32"``) and casts each
weight to ``dtype`` at its op, as Flax does, so gradients reach the
fp32 masters; a LoRA base stored in bf16 (the reference's
``cast_floating``) is cast only where the op wants another dtype (the
fp32 ``lm_head``). In serving storage every such cast is a no-op.
``lora_rank > 0`` puts :class:`~kubeflow_tpu_torch.ops.lora.LoRALinear`
adapters on q/k/v/o (the reference's ``LoRADense``); ``remat=True``
recomputes each block in the backward pass
(``torch.utils.checkpoint``, the reference's ``nn.remat``), so the
block's flash and RMSNorm kernels launch again there: a remat forward
and backward launch flash twice a layer and RMSNorm twice a block norm.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from kubeflow_tpu_torch.models.registry import ModelEntry, register_model
from kubeflow_tpu_torch.ops.decode_attention import decode_attention
from kubeflow_tpu_torch.ops.decode_gemm import decode_linear
from kubeflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    prefill_attention,
)
from kubeflow_tpu_torch.ops.lora import LoRALinear
from kubeflow_tpu_torch.ops.moe import MoE
from kubeflow_tpu_torch.ops.prefill_gemm import prefill_linear
from kubeflow_tpu_torch.ops.rms_norm import rms_norm
from kubeflow_tpu_torch.utils.device import torch_dtype

AttentionFn = Callable[..., torch.Tensor]


@dataclasses.dataclass
class LayerCache:
    """One layer's KV cache. Unlike the reference's functional "cache"
    collection, the port updates these tensors and ``index`` in place:
    each forward writes its K/V at ``index`` and advances it."""

    k: torch.Tensor  # [B, cache_size, Hkv, D]
    v: torch.Tensor
    index: int = 0


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(
            dim, dtype=param_dtype or dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale.to(self.dtype), self.eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings for [B, L, H, D] (D even) on *interleaved*
    even/odd pairs, as the reference does. fp32 trig."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[:, :, None, None].float() * freqs  # B,L,1,D/2
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1
    ).reshape(x.shape)
    return rotated.to(x.dtype)


def _linear(d_in: int, d_out: int, dtype, device, lora_rank: int = 0,
            lora_alpha: float = 16.0) -> nn.Linear:
    if lora_rank:
        return LoRALinear(d_in, d_out, lora_rank, lora_alpha, dtype=dtype,
                          device=device)
    return nn.Linear(d_in, d_out, bias=False, dtype=dtype, device=device)


#: A forward's routes for its linear layers: a decode step, a prefill
#: into the cache, or neither (the cache-free forward).
DECODE, PREFILL = "decode", "prefill"


def _project(layer: nn.Linear, x: torch.Tensor,
             route: Optional[str]) -> torch.Tensor:
    """``x·W`` with W cast to x's dtype at the op (a no-op in serving
    storage); in a decode step through :func:`decode_linear`, and a bf16
    layer in a prefill into the cache through :func:`prefill_linear`. A
    LoRA layer adds its adapter's delta on any route."""
    weight = layer.weight.to(x.dtype)
    if route == DECODE:
        y = decode_linear(x, weight)
    elif route == PREFILL and weight.dtype == torch.bfloat16:
        y = prefill_linear(x, weight)
    else:
        y = F.linear(x, weight)
    if isinstance(layer, LoRALinear):
        y = y + layer.delta(x)
    return y


def _route(x: torch.Tensor, cache, decode_positions=None) -> Optional[str]:
    """A cache forward given per-row ``decode_positions`` (the decode
    engine's step, and its speculative verify of l tokens a row) is a
    decode step whatever its l, so a verify row has the bits of the
    one-token step at its position. Without them, a cache forward with
    one token per row is a decode step (``generate``'s), with more a
    prefill; a forward without a cache is neither."""
    if cache is None:
        return None
    if decode_positions is not None or x.shape[1] == 1:
        return DECODE
    return PREFILL


class LlamaAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, rope_theta: float, dtype: torch.dtype,
                 attention_fn: Optional[AttentionFn] = None, device=None,
                 param_dtype: Optional[torch.dtype] = None,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.attention_fn = attention_fn
        store = param_dtype or dtype
        lora = (lora_rank, lora_alpha)
        self.q_proj = _linear(d_model, num_heads * head_dim, store, device,
                              *lora)
        self.k_proj = _linear(d_model, num_kv_heads * head_dim, store,
                              device, *lora)
        self.v_proj = _linear(d_model, num_kv_heads * head_dim, store,
                              device, *lora)
        self.o_proj = _linear(num_heads * head_dim, d_model, store, device,
                              *lora)

    def forward(self, x, positions, pad_lengths=None,
                cache: Optional[LayerCache] = None, decode_positions=None):
        b, l, _ = x.shape
        route = _route(x, cache, decode_positions)
        q = _project(self.q_proj, x, route).reshape(
            b, l, self.num_heads, self.head_dim)
        k = _project(self.k_proj, x, route).reshape(
            b, l, self.num_kv_heads, self.head_dim)
        v = _project(self.v_proj, x, route).reshape(
            b, l, self.num_kv_heads, self.head_dim)
        q = rope(q, positions, self.rope_theta)
        k = rope(k, positions, self.rope_theta)
        if cache is not None and decode_positions is not None:
            out = self._decode_rows(q, k, v, cache, decode_positions,
                                    pad_lengths)
        elif cache is not None:
            # Decode path: write this call's K/V at the cache index and
            # attend over the valid prefix.
            start = cache.index
            cache.k[:, start:start + l] = k.to(self.dtype)
            cache.v[:, start:start + l] = v.to(self.dtype)
            cache.index = start + l
            slots = torch.arange(cache.k.shape[1], device=x.device)
            valid = (slots[None, :] < start + l).expand(b, -1)
            if pad_lengths is not None:
                # Batched mixed-length prompts are LEFT-padded: row i's
                # first pad_lengths[i] slots hold pad K/V that must never
                # receive attention mass.
                valid = valid & (slots[None, :] >= pad_lengths[:, None])
            if route == DECODE:
                # One query at ``start``: causality is the validity.
                out = decode_attention(q, cache.k, cache.v, valid)
            else:
                out = prefill_attention(q, cache.k, cache.v, start, valid)
        elif self.attention_fn is not None:
            out = self.attention_fn(q, k, v)
        else:
            out = flash_attention(q, k, v, causal=True)
        return _project(self.o_proj, out.reshape(
            b, l, self.num_heads * self.head_dim), route)

    def _decode_rows(self, q, k, v, cache: LayerCache, start, pad_lengths):
        """The slot engine's decode step: every row sits at its own
        cache position ``start[b]`` (rows joined the batch at different
        times), so the write is per row and the scalar ``index`` is left
        alone. With l = 1, validity (``slot <= start``, and ``>=
        pad_lengths``) is the whole mask: the new token may attend to
        every valid slot, so the masked score set equals the scalar
        path's causal + valid one; a start past the cache end is clamped
        for the write, as XLA's ``dynamic_update_slice`` clamps it (only
        an overshooting row, whose tokens are discarded, gets there).
        l > 1 is the speculative verify: row b's token j sits at
        ``start[b] + j`` and attends with validity ``<= start[b] + j``,
        one query at a time at the one-token step's shapes, as the
        reference unrolls it: query j's output then has the bits of the
        one-token step at that position. A block that runs past the
        cache end (the last round of a request whose budget ends there)
        drops the cells past it, which hold only tokens the engine
        discards; the reference's clamp would move the whole block back
        over valid K/V (ROADMAP C5)."""
        b, l = q.shape[:2]
        slots = cache.k.shape[1]
        rows = torch.arange(b, device=q.device)[:, None]
        pos = torch.arange(slots, device=q.device)[None, :]
        if l == 1:
            write = torch.clamp(start.long(), 0, slots - 1)[:, None]
            cache.k[rows, write] = k.to(self.dtype)
            cache.v[rows, write] = v.to(self.dtype)
        else:
            self._write_block(cache, k, v, start.long(), rows)
        outs = []
        for j in range(l):
            valid = pos <= (start + j)[:, None]
            if pad_lengths is not None:
                valid = valid & (pos >= pad_lengths[:, None])
            outs.append(decode_attention(q[:, j:j + 1], cache.k, cache.v,
                                         valid))
        return outs[0] if l == 1 else torch.cat(outs, dim=1)

    def _write_block(self, cache: LayerCache, k, v, start, rows):
        """Write row b's l tokens at ``start[b] + j``. A cell past the
        cache end instead writes position ``start[b] - 1`` (the last
        slot where the row starts past the end) with the K/V it holds
        already, so nothing valid moves and no two cells write different
        values to one position (the block fits the cache: l is at most
        its length)."""
        slots = cache.k.shape[1]
        cells = start[:, None] + torch.arange(k.shape[1],
                                              device=k.device)[None, :]
        over = cells >= slots
        back = torch.clamp(start - 1, 0, slots - 1)[:, None]
        dst = torch.where(over, back, cells)
        for pool, new in ((cache.k, k), (cache.v, v)):
            pool[rows, dst] = torch.where(over[:, :, None, None],
                                          pool[rows, dst],
                                          new.to(self.dtype))


class LlamaBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, mlp_dim: int, rope_theta: float,
                 dtype: torch.dtype, attention_fn: Optional[AttentionFn],
                 device=None, param_dtype: Optional[torch.dtype] = None,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 num_experts: int = 0, num_selected: int = 2):
        super().__init__()
        store = param_dtype or dtype
        self.attn_norm = RMSNorm(d_model, dtype=dtype, device=device,
                                 param_dtype=store)
        self.attention = LlamaAttention(
            d_model, num_heads, num_kv_heads, head_dim, rope_theta, dtype,
            attention_fn, device, store, lora_rank, lora_alpha)
        self.mlp_norm = RMSNorm(d_model, dtype=dtype, device=device,
                                param_dtype=store)
        if num_experts > 0:
            # The reference's MoE FFN in place of SwiGLU (param "moe").
            self.moe = MoE(d_model, num_experts, mlp_dim, num_selected,
                           dtype=dtype, param_dtype=store, device=device)
            return
        self.moe = None
        self.gate_proj = _linear(d_model, mlp_dim, store, device)
        self.up_proj = _linear(d_model, mlp_dim, store, device)
        self.down_proj = _linear(mlp_dim, d_model, store, device)

    def forward(self, x, positions, pad_lengths=None, cache=None,
                decode_positions=None):
        route = _route(x, cache, decode_positions)
        x = x + self.attention(self.attn_norm(x), positions, pad_lengths,
                               cache, decode_positions)
        h = self.mlp_norm(x)
        if self.moe is not None:
            return x + self.moe(h)
        h = (F.silu(_project(self.gate_proj, h, route))
             * _project(self.up_proj, h, route))
        return x + _project(self.down_proj, h, route)


class Llama(nn.Module):
    """Decoder-only LM: ``forward(input_ids)`` → fp32 logits
    [B, L, vocab]. Built on the meta device unless ``device`` is given.

    ``cache_size > 0`` makes it a generation model: every forward then
    takes ``cache`` (from ``inference.generate.init_cache``).
    ``param_dtype`` (default: serving storage, each weight in the dtype
    its op consumes) stores every weight in that dtype, cast at the op;
    ``lora_rank``/``lora_alpha`` add adapters on q/k/v/o; ``remat``
    recomputes each block in the backward pass. ``num_experts > 0``
    puts the MoE FFN (ops/moe.py, top-``num_selected`` routing) in
    every block in place of SwiGLU; each forward sows its load-balance
    loss (``ops.moe.collect_losses`` gathers them).
    """

    def __init__(self, vocab_size: int = 32000, num_layers: int = 32,
                 d_model: int = 4096, num_heads: int = 32,
                 num_kv_heads: int = 32, mlp_dim: int = 11008,
                 rope_theta: float = 10000.0, dtype="bfloat16",
                 attention_fn: Optional[AttentionFn] = None,
                 cache_size: int = 0, num_experts: int = 0,
                 num_selected: int = 2,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 remat: bool = False, param_dtype=None, device="meta"):
        super().__init__()
        if lora_rank < 0:
            raise ValueError(f"lora_rank must be >= 0, got {lora_rank}")
        if cache_size and attention_fn is not None:
            raise ValueError(
                "cache_size and attention_fn are mutually exclusive: the "
                "decode path always uses dense attention over the cache")
        dtype = torch_dtype(dtype)
        store = None if param_dtype is None else torch_dtype(param_dtype)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = d_model // num_heads
        self.mlp_dim = mlp_dim
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.cache_size = cache_size
        self.num_experts = num_experts
        self.num_selected = num_selected
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.remat = remat
        self.tok_embed = nn.Embedding(vocab_size, d_model,
                                      dtype=store or dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(d_model, num_heads, num_kv_heads, self.head_dim,
                       mlp_dim, rope_theta, dtype, attention_fn, device,
                       store, lora_rank, lora_alpha, num_experts,
                       num_selected)
            for _ in range(num_layers))
        self.final_norm = RMSNorm(d_model, dtype=dtype, device=device,
                                  param_dtype=store)
        # fp32 head over an fp32-cast input, as the reference.
        self.lm_head = _linear(d_model, vocab_size, store or torch.float32,
                               device)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                pad_lengths: Optional[torch.Tensor] = None,
                decode_positions: Optional[torch.Tensor] = None,
                cache: Optional[List[LayerCache]] = None,
                logits_at: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``pad_lengths`` ([B], cache models only): per-row count of
        LEFT-pad cache slots, masked out of attention.
        ``decode_positions`` ([B], cache models only): the
        continuous-batching engine's per-row cache write position of the
        row's first token (a speculative verify writes l tokens from
        there); the caches' scalar ``index`` is then left as it is.
        ``logits_at`` ([B], cache models only): one column a row whose
        logits alone are returned, ``[B, 1, vocab]``. A cache forward's
        head runs on the decode GEMM's fp32 route, whose rows do not
        depend on the block's width as cuBLAS's do not promise: a
        chunk's or a hit tail's last row has the bits of the one-shot
        block's."""
        if decode_positions is not None and not self.cache_size:
            raise ValueError(
                "decode_positions requires a cache_size model (the "
                "slot-based decode engine writes each row's K/V into its "
                "own cache slot)")
        if self.cache_size:
            if cache is None or len(cache) != self.num_layers:
                raise ValueError(
                    "a cache_size model needs one LayerCache per layer "
                    "(inference.generate.init_cache)")
        elif cache is not None:
            raise ValueError("cache requires a cache_size model")
        elif pad_lengths is not None:
            raise ValueError(
                "pad_lengths requires a cache_size model (batched "
                "generation left-pads into the KV cache)")
        elif logits_at is not None:
            raise ValueError("logits_at requires a cache_size model")
        b, l = input_ids.shape
        if positions is None:
            positions = torch.arange(l, device=input_ids.device)[None].expand(
                b, l)
        # Gather, then cast: the rows of Flax's cast-then-gather.
        x = self.tok_embed(input_ids).to(self.dtype)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = _rematerialized(layer, x, positions)
            else:
                x = layer(x, positions, pad_lengths,
                          None if cache is None else cache[i],
                          decode_positions)
        if logits_at is not None:
            x = x[torch.arange(b, device=x.device), logits_at.long()][:, None]
        x = self.final_norm(x).float()
        head = self.lm_head.weight.float()
        if cache is None:
            return F.linear(x, head)
        return decode_linear(x, head)


def _rematerialized(layer: nn.Module, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """``layer(x, positions)``, its activations dropped and recomputed in
    the backward pass. The recompute runs after :func:`apply` has put
    the template's own (meta) parameters back, so it applies the
    layer's weights of this call explicitly."""
    weights = dict(layer.named_parameters())
    return torch.utils.checkpoint.checkpoint(
        lambda h, pos: torch.func.functional_call(layer, weights, (h, pos)),
        x, positions, use_reentrant=False, preserve_rng_state=False)


def apply(model: nn.Module, params: Dict[str, torch.Tensor], *args,
          **kwargs):
    """``model(*args, **kwargs)`` with ``params`` as its weights — the
    port's ``model.apply({"params": params}, ...)``. Every parameter
    must be given. ``functional_call`` swaps the weights into ``model``
    for the call, so one module object must not be applied from two
    threads at once: a thread of its own (the decode engine's) takes a
    ``copy.deepcopy`` of the template, which on the meta device costs
    nothing."""
    return torch.func.functional_call(model, params, args, kwargs,
                                      strict=True)


def llama2_7b(**kw) -> Llama:
    return Llama(**kw)


# A config's depth may be cut (``num_layers=``); its widths are fixed.


def llama2_13b(**kw) -> Llama:
    kw.setdefault("num_layers", 40)
    return Llama(d_model=5120, num_heads=40, num_kv_heads=40,
                 mlp_dim=13824, **kw)


def llama3_8b(**kw) -> Llama:
    kw.setdefault("num_layers", 32)
    return Llama(vocab_size=128256, d_model=4096, num_heads=32,
                 num_kv_heads=8, mlp_dim=14336, rope_theta=500000.0, **kw)


def llama_test(**kw) -> Llama:
    """Tiny GQA config for CI."""
    kw.setdefault("vocab_size", 512)
    kw.setdefault("num_layers", 2)
    return Llama(d_model=64, num_heads=4, num_kv_heads=2, mlp_dim=128, **kw)


def llama_moe_test(**kw) -> Llama:
    """Tiny MoE config for CI (4 experts, top-2)."""
    kw.setdefault("vocab_size", 512)
    kw.setdefault("num_experts", 4)
    kw.setdefault("num_layers", 2)
    return Llama(d_model=64, num_heads=4, num_kv_heads=2, mlp_dim=128, **kw)


def llama_moe_bench(**kw) -> Llama:
    """One-card MoE pricing config: 8 experts, top-2. Its active FLOPs a
    token equal llama-moe-dense-twin's (2 selected experts × mlp 3584 =
    the twin's dense mlp 7168), so the tokens/s ratio of the two prices
    the router and the capacity dispatch."""
    kw.setdefault("vocab_size", 8192)
    kw.setdefault("num_experts", 8)
    kw.setdefault("num_layers", 4)
    return Llama(d_model=1024, num_heads=16, num_kv_heads=8, mlp_dim=3584,
                 **kw)


def llama_moe_dense_twin(**kw) -> Llama:
    """FLOP-matched dense twin of :func:`llama_moe_bench`."""
    kw.setdefault("vocab_size", 8192)
    kw.setdefault("num_layers", 4)
    return Llama(d_model=1024, num_heads=16, num_kv_heads=8, mlp_dim=7168,
                 **kw)


register_model(ModelEntry("llama2-7b", "language", llama2_7b,
                          ((2048,), "int32"), 32000, decoder=True))
register_model(ModelEntry("llama2-13b", "language", llama2_13b,
                          ((2048,), "int32"), 32000, decoder=True))
register_model(ModelEntry("llama3-8b", "language", llama3_8b,
                          ((2048,), "int32"), 128256, decoder=True))
register_model(ModelEntry("llama-test", "language", llama_test,
                          ((128,), "int32"), 512, decoder=True))
register_model(ModelEntry("llama-moe-test", "language", llama_moe_test,
                          ((128,), "int32"), 512, decoder=True))
register_model(ModelEntry("llama-moe-bench", "language", llama_moe_bench,
                          ((1024,), "int32"), 8192, decoder=True))
register_model(ModelEntry("llama-moe-dense-twin", "language",
                          llama_moe_dense_twin, ((1024,), "int32"), 8192,
                          decoder=True))
