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
Every norm runs on the RMSNorm kernel on the card: a block hands on its
residual branch's output un-added, and the next norm adds it
(:func:`add_rms_norm`, ``s = x + delta`` and the norm of ``s`` in one
launch): block i's attention output with its ``mlp_norm``, its MLP (or
MoE) output with block i + 1's ``attn_norm`` or, after the last block,
``final_norm``. Layer 0's ``attn_norm`` alone takes :func:`rms_norm`, so
a forward launches 1 plain and 2·layers fused norms and no residual add
of its own. On the CPU each is its plain version. The cache-free
forward (predict, classify, training) keeps ``F.linear``: a plain large
product, as the reference leaves it to XLA.

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
(``torch.utils.checkpoint``, the reference's ``nn.remat``, its boundary
carrying the stream and the pending residual), so the block's flash and
RMSNorm kernels launch again there: a remat forward and backward launch
flash twice a layer and RMSNorm twice a block norm.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from kubeflow_tpu_torch.models.layers import logical_axes_by_suffix
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
from kubeflow_tpu_torch.ops.rms_norm import add_rms_norm, rms_norm
from kubeflow_tpu_torch.parallel.collectives import (
    all_gather_dim,
    copy_to_tensor,
    gather_from_tensor,
    reduce_from_tensor,
)
from kubeflow_tpu_torch.parallel.mesh import (
    Mesh,
    check_batch_axes,
    tensor_axis,
)
from kubeflow_tpu_torch.parallel.tensor_parallel import (
    kv_group,
    kv_heads_split,
)
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

    def add(self, x: torch.Tensor,
            delta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x + delta, norm(x + delta))`` from one launch: ``delta`` is
        the residual branch's output still to be added."""
        return add_rms_norm(x, delta, self.scale.to(self.dtype), self.eps)


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


def _product(x: torch.Tensor, weight: torch.Tensor,
             route: Optional[str]) -> torch.Tensor:
    if route == DECODE:
        return decode_linear(x, weight)
    if route == PREFILL and weight.dtype == torch.bfloat16:
        return prefill_linear(x, weight)
    return F.linear(x, weight)


def _lora_scale(layer: LoRALinear, dtype: torch.dtype) -> float:
    return float(torch.tensor(layer.alpha / layer.rank, dtype=dtype))


def _whole(weight: torch.Tensor, fsdp: Optional[Mesh],
           dim: int) -> torch.Tensor:
    """``weight`` whole over the fsdp line: a serving rank's fsdp piece
    gathered along ``dim`` (its ``embed`` dim) just before the op that
    reads it, and dropped with the op's inputs; as it is without one.
    The gather joins the pieces' bytes, so the op then runs on exactly
    the weight a rank without the fsdp split holds."""
    if fsdp is None:
        return weight
    return all_gather_dim(weight, fsdp, dim, "fsdp")


def _project(layer: nn.Linear, x: torch.Tensor, route: Optional[str],
             mesh: Optional[Mesh] = None,
             shared: bool = False,
             fsdp: Optional[Mesh] = None) -> torch.Tensor:
    """``x·W`` with W cast to x's dtype at the op (a no-op in serving
    storage); in a decode step through :func:`decode_linear`, and a bf16
    layer in a prefill into the cache through :func:`prefill_linear`. A
    LoRA layer adds its adapter's delta on any route. ``fsdp``: W is the
    rank's fsdp piece on its input features, gathered first.

    On a tensor axis (``mesh``) this is a column-parallel product: W is
    the rank's column slice and x the replicated input, so the adapter's
    A, which every rank holds whole, has its gradient summed over the
    tensor line; ``shared`` (a k/v kernel every rank holds whole and
    reads a part of) sums W's and B's gradients too."""
    weight = _whole(layer.weight, fsdp, 1)
    if shared:
        weight = copy_to_tensor(weight, mesh)
    y = _product(x, weight.to(x.dtype), route)
    if isinstance(layer, LoRALinear):
        if mesh is None:
            return y + layer.delta(x)
        a = copy_to_tensor(layer.lora_a, mesh).to(x.dtype)
        b = layer.lora_b
        if shared:
            b = copy_to_tensor(b, mesh)
        y = y + ((x @ a) @ b.to(x.dtype)) * _lora_scale(layer, x.dtype)
    return y


def _row_project(layer: nn.Linear, x: torch.Tensor, route: Optional[str],
                 mesh: Optional[Mesh],
                 fsdp: Optional[Mesh] = None) -> torch.Tensor:
    """A row-parallel product (o, down) on a tensor axis: x is the
    rank's slice of the input features and W the matching rows, so the
    product is a partial sum, finished by an all-reduce over the tensor
    line before the next norm adds it. A LoRA adapter's ``x·A`` (A split
    on its input rows) is all-reduced before B. Without a tensor axis,
    :func:`_project`. ``fsdp``: W is the rank's fsdp piece on its output
    features, gathered first."""
    if mesh is None and fsdp is None:
        return _project(layer, x, route)
    y = _product(x, _whole(layer.weight, fsdp, 0).to(x.dtype), route)
    if mesh is None:
        return y
    y = reduce_from_tensor(y, mesh)
    if isinstance(layer, LoRALinear):
        xa = reduce_from_tensor(x @ layer.lora_a.to(x.dtype), mesh)
        y = y + (xa @ layer.lora_b.to(x.dtype)) * _lora_scale(layer,
                                                              x.dtype)
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
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 mesh: Optional[Mesh] = None,
                 fsdp: Optional[Mesh] = None):
        super().__init__()
        # On a tensor axis of T: this rank's H/T query heads, and its
        # kv-head group where Hkv % T == 0, else every kv head, each
        # query head reading its own (``kv_index``).
        self.mesh, tensor, rank = tensor_axis(mesh)
        split = kv_heads_split(num_kv_heads, tensor)
        self.kv_index = None if split else torch.tensor(
            kv_group(num_heads, num_kv_heads, tensor, rank))
        self.shared_kv = not split
        num_heads //= tensor
        if split:
            num_kv_heads //= tensor
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.attention_fn = attention_fn
        store = param_dtype or dtype
        lora = (lora_rank, lora_alpha)
        # With ``fsdp`` each kernel's embed dim holds the rank's piece.
        self.fsdp = fsdp
        embed = d_model // (1 if fsdp is None else fsdp.shape["fsdp"])
        self.q_proj = _linear(embed, num_heads * head_dim, store, device,
                              *lora)
        self.k_proj = _linear(embed, num_kv_heads * head_dim, store,
                              device, *lora)
        self.v_proj = _linear(embed, num_kv_heads * head_dim, store,
                              device, *lora)
        self.o_proj = _linear(num_heads * head_dim, embed, store, device,
                              *lora)

    def forward(self, x, positions, pad_lengths=None,
                cache: Optional[LayerCache] = None, decode_positions=None):
        b, l, _ = x.shape
        route = _route(x, cache, decode_positions)
        mesh, fsdp = self.mesh, self.fsdp
        x = copy_to_tensor(x, mesh)
        q = _project(self.q_proj, x, route, mesh, fsdp=fsdp).reshape(
            b, l, self.num_heads, self.head_dim)
        k = _project(self.k_proj, x, route, mesh, self.shared_kv,
                     fsdp).reshape(b, l, self.num_kv_heads, self.head_dim)
        v = _project(self.v_proj, x, route, mesh, self.shared_kv,
                     fsdp).reshape(b, l, self.num_kv_heads, self.head_dim)
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
                out = decode_attention(q, self._kv(cache.k),
                                       self._kv(cache.v), valid)
            else:
                out = prefill_attention(q, self._kv(cache.k),
                                        self._kv(cache.v), start, valid)
        elif self.attention_fn is not None:
            out = self.attention_fn(q, self._kv(k), self._kv(v))
        else:
            out = flash_attention(q, self._kv(k), self._kv(v), causal=True)
        return _row_project(self.o_proj, out.reshape(
            b, l, self.num_heads * self.head_dim), route, mesh, fsdp)

    def _kv(self, t: torch.Tensor) -> torch.Tensor:
        """K or V ``[B, S, kv heads, D]`` as this rank's query heads read
        it: as it is, or (every kv head held) one head a query head."""
        if self.kv_index is None:
            return t
        return t[:, :, self.kv_index.to(t.device)]

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
            outs.append(decode_attention(q[:, j:j + 1], self._kv(cache.k),
                                         self._kv(cache.v), valid))
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
                 num_experts: int = 0, num_selected: int = 2,
                 mesh: Optional[Mesh] = None, fsdp: Optional[Mesh] = None):
        super().__init__()
        store = param_dtype or dtype
        self.mesh, tensor, _ = tensor_axis(mesh)
        self.fsdp = fsdp
        self.attn_norm = RMSNorm(d_model, dtype=dtype, device=device,
                                 param_dtype=store)
        self.attention = LlamaAttention(
            d_model, num_heads, num_kv_heads, head_dim, rope_theta, dtype,
            attention_fn, device, store, lora_rank, lora_alpha, mesh, fsdp)
        self.mlp_norm = RMSNorm(d_model, dtype=dtype, device=device,
                                param_dtype=store)
        if num_experts > 0:
            # The reference's MoE FFN in place of SwiGLU (param "moe"),
            # on a mesh this rank's experts and hidden columns.
            self.moe = MoE(d_model, num_experts, mlp_dim, num_selected,
                           dtype=dtype, param_dtype=store, device=device,
                           mesh=mesh)
            return
        self.moe = None
        # Column-parallel gate and up, row-parallel down: mlp_dim / T a
        # rank.
        mlp_dim //= tensor
        embed = d_model // (1 if fsdp is None else fsdp.shape["fsdp"])
        self.gate_proj = _linear(embed, mlp_dim, store, device)
        self.up_proj = _linear(embed, mlp_dim, store, device)
        self.down_proj = _linear(mlp_dim, embed, store, device)

    def forward(self, x, positions, pad_lengths=None, cache=None,
                decode_positions=None, pending=None):
        """``(x, delta)``: the residual stream before this block's MLP
        (or MoE) output ``delta`` is added, and ``delta``; the next norm
        adds it. ``pending`` is the previous block's ``delta`` (None for
        the first block), which this block's ``attn_norm`` adds. On a
        tensor axis both branch outputs are all-reduced where they are
        made, so ``delta`` is whole before a norm adds it; so is an MoE's
        output (its experts' outputs joined over the expert line)."""
        route = _route(x, cache, decode_positions)
        if pending is None:
            h = self.attn_norm(x)
        else:
            x, h = self.attn_norm.add(x, pending)
        x, h = self.mlp_norm.add(x, self.attention(
            h, positions, pad_lengths, cache, decode_positions))
        if self.moe is not None:
            return x, self.moe(h)
        mesh, fsdp = self.mesh, self.fsdp
        h = copy_to_tensor(h, mesh)
        h = (F.silu(_project(self.gate_proj, h, route, mesh, fsdp=fsdp))
             * _project(self.up_proj, h, route, mesh, fsdp=fsdp))
        return x, _row_project(self.down_proj, h, route, mesh, fsdp)


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

    ``mesh`` builds this rank's slice of the model on a gang's mesh. An
    MoE Llama built on it routes the global batch and runs this rank's
    experts (``ops/moe.py``, ``MoE(mesh=)``: E/X experts on an
    ``expert`` axis of X, their hidden width split over ``tensor``); a
    ``tensor`` axis of T > 1 splits the rest in Megatron's layout,
    written out: q, k, v, gate, up and the
    ``lm_head`` column-parallel (the rank's H/T heads, its kv-head group
    or every kv head, mlp/T, vocab/T), o and down row-parallel with
    their partial sums all-reduced where the block makes them, the
    token table split on vocab (each rank looks up the ids in its row
    range, zeros elsewhere, and an all-reduce sums them: bitwise the
    whole table's lookup) and the head's logits all-gathered. The
    kernels run unchanged at the per-rank shapes; the widths, ``num_heads``
    and ``num_kv_heads`` are the model's (a layer's are its rank's).

    ``fsdp_pieces`` (serving, on a mesh whose ``fsdp`` axis is F > 1):
    every weight with an ``embed`` dim holds the rank's 1/F piece of it
    at rest, cut by the rule table as a sharded export's fsdp plan cuts
    it, and all-gathers it over the fsdp line just before the op that
    reads it (the token table, each block's projections, the head),
    dropping the whole leaf after the op; the norms stay whole. The
    gather rebuilds the piece the rank would otherwise hold, so the same
    kernels run at the same shapes and the logits are bitwise those of a
    rank without the fsdp split. Every rank of a serving mesh runs the
    same rows (the reference's serving mesh has no batch axis). A
    trainer's fsdp mesh leaves it off: the trainer gathers its pieces
    itself (``parallel/collectives.py`` ``gather_leaf``).
    """

    #: The model axes its layers split over (``parallel/mesh.py``):
    #: tensor, and expert for an MoE Llama (a dense one has no param on
    #: it, so there it is a replicated axis).
    PARALLEL_AXES = ("tensor", "expert")

    def __init__(self, vocab_size: int = 32000, num_layers: int = 32,
                 d_model: int = 4096, num_heads: int = 32,
                 num_kv_heads: int = 32, mlp_dim: int = 11008,
                 rope_theta: float = 10000.0, dtype="bfloat16",
                 attention_fn: Optional[AttentionFn] = None,
                 cache_size: int = 0, num_experts: int = 0,
                 num_selected: int = 2,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 remat: bool = False, param_dtype=None, device="meta",
                 mesh: Optional[Mesh] = None, fsdp_pieces: bool = False):
        super().__init__()
        if mesh is not None:
            check_batch_axes(mesh, "Llama", self)
        #: The mesh whose fsdp pieces this rank holds (``fsdp_pieces``).
        self.fsdp_mesh = (mesh if fsdp_pieces and mesh is not None
                          and mesh.shape["fsdp"] > 1 else None)
        if self.fsdp_mesh is not None:
            if num_experts or lora_rank:
                raise ValueError(
                    "fsdp_pieces serves a dense Llama without adapters "
                    "(an MoE's experts and LoRA adapters are not cut)")
            if d_model % mesh.shape["fsdp"]:
                raise ValueError(f"d_model {d_model} does not split over "
                                 f"fsdp={mesh.shape['fsdp']}")
        tp_mesh, tensor, rank = tensor_axis(mesh)
        if tp_mesh is not None:
            for what, n in (("num_heads", num_heads), ("mlp_dim", mlp_dim),
                            ("vocab_size", vocab_size)):
                if n % tensor:
                    raise ValueError(f"{what} {n} does not split over "
                                     f"tensor={tensor}")
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
        self.mesh = tp_mesh
        #: The mesh an MoE Llama routes and splits its experts on (None
        #: for a dense one, or without a mesh).
        self.moe_mesh = mesh if num_experts else None
        self.tensor = tensor
        #: The rank's first vocab id (its rows of the token table and
        #: its columns of the head).
        self.vocab_start = rank * (vocab_size // tensor)
        self.kv_split = kv_heads_split(num_kv_heads, tensor)
        #: Kv heads a rank's KV cache holds.
        self.cache_kv_heads = (num_kv_heads // tensor if self.kv_split
                               else num_kv_heads)
        embed = d_model // (1 if self.fsdp_mesh is None
                            else mesh.shape["fsdp"])
        self.tok_embed = nn.Embedding(vocab_size // tensor, embed,
                                      dtype=store or dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(d_model, num_heads, num_kv_heads, self.head_dim,
                       mlp_dim, rope_theta, dtype, attention_fn, device,
                       store, lora_rank, lora_alpha, num_experts,
                       num_selected, mesh, self.fsdp_mesh)
            for _ in range(num_layers))
        self.final_norm = RMSNorm(d_model, dtype=dtype, device=device,
                                  param_dtype=store)
        # fp32 head over an fp32-cast input, as the reference.
        self.lm_head = _linear(embed, vocab_size // tensor,
                               store or torch.float32, device)

    #: The reference's ``nn.with_partitioning`` axes, by Flax key suffix.
    LOGICAL_AXES = (
        ("attention/q_proj/kernel", ("embed", "heads")),
        ("attention/k_proj/kernel", ("embed", "kv")),
        ("attention/v_proj/kernel", ("embed", "kv")),
        ("attention/o_proj/kernel", ("heads", "embed")),
        ("gate_proj/kernel", ("embed", "mlp")),
        ("up_proj/kernel", ("embed", "mlp")),
        ("down_proj/kernel", ("mlp", "embed")),
        ("moe/router/kernel", ("embed", None)),
        ("moe/w_in", ("expert", "embed", "mlp")),
        ("moe/w_out", ("expert", "mlp", "embed")),
        ("lm_head/kernel", ("embed", "vocab")),
        ("tok_embed/embedding", ("vocab", "embed")),
    )

    def logical_axes(self, key: str) -> Optional[Tuple[Optional[str], ...]]:
        """The logical axes the reference's Llama gives the Flax param
        ``key`` (``nn.with_partitioning``), or None. A LoRA adapter of a
        projection (``.../q_proj/lora_a``, the ``"lora"`` collection)
        takes ``(in_axis, "lora")`` and ``lora_b`` ``("lora", out_axis)``
        of its kernel's axes."""
        for adapter in ("lora_a", "lora_b"):
            if key.endswith("/" + adapter):
                kernel = self.logical_axes(
                    key[:-len(adapter)] + "kernel")
                if kernel is None:
                    return None
                return ((kernel[0], "lora") if adapter == "lora_a"
                        else ("lora", kernel[1]))
        return logical_axes_by_suffix(self.LOGICAL_AXES, key)

    def split_axes(self, key: str) -> Optional[Tuple[Optional[str], ...]]:
        """:meth:`logical_axes`, but a k/v kernel's (and its ``lora_b``'s)
        ``kv`` dim is ``kv_heads`` where each tensor rank holds its
        kv-head group (``parallel/tensor_parallel.py``)."""
        axes = self.logical_axes(key)
        if (axes and self.tensor > 1 and self.kv_split
                and ("/k_proj/" in key or "/v_proj/" in key)):
            axes = tuple("kv_heads" if a == "kv" else a for a in axes)
        return axes

    def partitioned(self, key: str) -> bool:
        """Whether the reference's Llama annotates the Flax param ``key``
        with a partitioning (``nn.with_partitioning``), which its exports
        store boxed: every kernel, the token embedding and the MoE
        experts."""
        return self.logical_axes(key) is not None

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
        x = self._embed(input_ids).to(self.dtype)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        pending = None
        for i, layer in enumerate(self.layers):
            if remat:
                x, pending = _rematerialized(layer, x, pending, positions)
            else:
                x, pending = layer(x, positions, pad_lengths,
                                   None if cache is None else cache[i],
                                   decode_positions, pending)
        if logits_at is not None:
            rows = torch.arange(b, device=x.device), logits_at.long()
            x = x[rows][:, None]
            if pending is not None:
                pending = pending[rows][:, None]
        if pending is None:
            x = self.final_norm(x).float()
        else:
            x = self.final_norm.add(x, pending)[1].float()
        head = _whole(self.lm_head.weight, self.fsdp_mesh, 1).float()
        x = copy_to_tensor(x, self.mesh)
        if cache is None:
            return gather_from_tensor(F.linear(x, head), self.mesh)
        return gather_from_tensor(decode_linear(x, head), self.mesh)

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The token rows; on a tensor axis each rank's rows of its vocab
        range, zeros for the other ids, summed over the tensor line."""
        table = _whole(self.tok_embed.weight, self.fsdp_mesh, 1)
        if self.mesh is None:
            return F.embedding(input_ids, table)
        local = input_ids - self.vocab_start
        mine = (local >= 0) & (local < table.shape[0])
        rows = F.embedding(torch.where(mine, local, 0), table)
        rows = torch.where(mine[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
        return reduce_from_tensor(rows, self.mesh)


def _rematerialized(layer: nn.Module, x: torch.Tensor,
                    pending: Optional[torch.Tensor],
                    positions: torch.Tensor):
    """``layer(x, positions, pending=pending)``, its activations dropped
    and recomputed in the backward pass (its fused norms launch again
    there). The recompute runs after :func:`apply` has put the
    template's own (meta) parameters back, so it applies the layer's
    weights of this call explicitly."""
    weights = dict(layer.named_parameters())
    return torch.utils.checkpoint.checkpoint(
        lambda h, p, pos: torch.func.functional_call(
            layer, weights, (h, pos), {"pending": p}),
        x, pending, positions, use_reentrant=False, preserve_rng_state=False)


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
