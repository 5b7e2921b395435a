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

Port of ``kubeflow_tpu/models/llama.py`` (dense path). Parameter names
follow the Flax tree (``models/convert.py`` maps one onto the other).

Modules are templates, as Flax modules are: the registry builds them on
the meta device, and weights travel as a ``params`` dict applied with
:func:`apply` (``torch.func.functional_call``), the counterpart of
``model.apply({"params": params}, ...)``. Each weight is stored in the
dtype its op consumes (see models/convert.py).

Attention: the cache-free forward calls :func:`flash_attention` (the
CUDA kernel on the GPU); the KV-cache path calls ``dense_attention``
in plain PyTorch, as the reference runs it under XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.registry import ModelEntry, register_model
from kubeflow_tpu_torch.ops.attention import dense_attention
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
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
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Variance in fp32 regardless of activation dtype.
        var = x.float().square().mean(-1, keepdim=True)
        normed = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return normed * self.scale.to(self.dtype)


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


def _linear(d_in: int, d_out: int, dtype, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, dtype=dtype, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, rope_theta: float, dtype: torch.dtype,
                 attention_fn: Optional[AttentionFn] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.attention_fn = attention_fn
        self.q_proj = _linear(d_model, num_heads * head_dim, dtype, device)
        self.k_proj = _linear(d_model, num_kv_heads * head_dim, dtype, device)
        self.v_proj = _linear(d_model, num_kv_heads * head_dim, dtype, device)
        self.o_proj = _linear(num_heads * head_dim, d_model, dtype, device)

    def forward(self, x, positions, pad_lengths=None,
                cache: Optional[LayerCache] = None):
        b, l, _ = x.shape
        q = self.q_proj(x).reshape(b, l, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, l, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, l, self.num_kv_heads, self.head_dim)
        q = rope(q, positions, self.rope_theta)
        k = rope(k, positions, self.rope_theta)
        if cache is not None:
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
            out = dense_attention(
                q, cache.k, cache.v, causal=True, q_offset=start,
                kv_offset=0, kv_segment_valid=valid)
        elif self.attention_fn is not None:
            out = self.attention_fn(q, k, v)
        else:
            out = flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, l, self.num_heads * self.head_dim))


class LlamaBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, mlp_dim: int, rope_theta: float,
                 dtype: torch.dtype, attention_fn: Optional[AttentionFn],
                 device=None):
        super().__init__()
        self.attn_norm = RMSNorm(d_model, dtype=dtype, device=device)
        self.attention = LlamaAttention(
            d_model, num_heads, num_kv_heads, head_dim, rope_theta, dtype,
            attention_fn, device)
        self.mlp_norm = RMSNorm(d_model, dtype=dtype, device=device)
        self.gate_proj = _linear(d_model, mlp_dim, dtype, device)
        self.up_proj = _linear(d_model, mlp_dim, dtype, device)
        self.down_proj = _linear(mlp_dim, d_model, dtype, device)

    def forward(self, x, positions, pad_lengths=None, cache=None):
        x = x + self.attention(self.attn_norm(x), positions, pad_lengths,
                               cache)
        h = self.mlp_norm(x)
        h = F.silu(self.gate_proj(h)) * self.up_proj(h)
        return x + self.down_proj(h)


class Llama(nn.Module):
    """Decoder-only LM: ``forward(input_ids)`` → fp32 logits
    [B, L, vocab]. Built on the meta device unless ``device`` is given.

    ``cache_size > 0`` makes it a generation model: every forward then
    takes ``cache`` (from ``inference.generate.init_cache``).
    """

    def __init__(self, vocab_size: int = 32000, num_layers: int = 32,
                 d_model: int = 4096, num_heads: int = 32,
                 num_kv_heads: int = 32, mlp_dim: int = 11008,
                 rope_theta: float = 10000.0, dtype="bfloat16",
                 attention_fn: Optional[AttentionFn] = None,
                 cache_size: int = 0, num_experts: int = 0,
                 lora_rank: int = 0, device="meta"):
        super().__init__()
        if num_experts > 0:
            raise NotImplementedError(
                "MoE Llama (num_experts > 0) is not ported yet")
        if lora_rank > 0:
            raise NotImplementedError(
                "LoRA Llama (lora_rank > 0) is not ported yet")
        if cache_size and attention_fn is not None:
            raise ValueError(
                "cache_size and attention_fn are mutually exclusive: the "
                "decode path always uses dense attention over the cache")
        dtype = torch_dtype(dtype)
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
        self.tok_embed = nn.Embedding(vocab_size, d_model, dtype=dtype,
                                      device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(d_model, num_heads, num_kv_heads, self.head_dim,
                       mlp_dim, rope_theta, dtype, attention_fn, device)
            for _ in range(num_layers))
        self.final_norm = RMSNorm(d_model, dtype=dtype, device=device)
        # fp32 head over an fp32-cast input, as the reference.
        self.lm_head = _linear(d_model, vocab_size, torch.float32, device)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                pad_lengths: Optional[torch.Tensor] = None,
                decode_positions: Optional[torch.Tensor] = None,
                cache: Optional[List[LayerCache]] = None) -> torch.Tensor:
        """``pad_lengths`` ([B], cache models only): per-row count of
        LEFT-pad cache slots, masked out of attention.
        ``decode_positions`` is the continuous-batching engine's per-row
        cache index; that engine is not ported yet."""
        if decode_positions is not None:
            raise NotImplementedError(
                "decode_positions (the slot-based decode engine) is not "
                "ported yet")
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
        b, l = input_ids.shape
        if positions is None:
            positions = torch.arange(l, device=input_ids.device)[None].expand(
                b, l)
        x = self.tok_embed(input_ids)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, pad_lengths,
                      None if cache is None else cache[i])
        x = self.final_norm(x)
        return self.lm_head(x.float())


def apply(model: nn.Module, params: Dict[str, torch.Tensor], *args,
          **kwargs):
    """``model(*args, **kwargs)`` with ``params`` as its weights — the
    port's ``model.apply({"params": params}, ...)``. Every parameter
    must be given."""
    return torch.func.functional_call(model, params, args, kwargs,
                                      strict=True)


def llama2_7b(**kw) -> Llama:
    return Llama(**kw)


def llama2_13b(**kw) -> Llama:
    return Llama(num_layers=40, d_model=5120, num_heads=40, num_kv_heads=40,
                 mlp_dim=13824, **kw)


def llama3_8b(**kw) -> Llama:
    return Llama(vocab_size=128256, num_layers=32, d_model=4096,
                 num_heads=32, num_kv_heads=8, mlp_dim=14336,
                 rope_theta=500000.0, **kw)


def llama_test(**kw) -> Llama:
    """Tiny GQA config for CI."""
    kw.setdefault("vocab_size", 512)
    return Llama(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                 mlp_dim=128, **kw)


register_model(ModelEntry("llama2-7b", "language", llama2_7b,
                          ((2048,), "int32"), 32000, decoder=True))
register_model(ModelEntry("llama2-13b", "language", llama2_13b,
                          ((2048,), "int32"), 32000, decoder=True))
register_model(ModelEntry("llama3-8b", "language", llama3_8b,
                          ((2048,), "int32"), 128256, decoder=True))
register_model(ModelEntry("llama-test", "language", llama_test,
                          ((128,), "int32"), 512, decoder=True))
