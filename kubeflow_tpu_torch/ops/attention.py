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

"""Attention primitives in plain PyTorch: dense + blockwise (online softmax).

Port of ``kubeflow_tpu/ops/attention.py`` with its exact constants:
``NEG_INF = -1e30``, the ``m_safe = max(m, NEG_INF / 2)`` clamp and the
``max(l, 1e-30)`` normalizer, so fully-masked rows give 0 as they do
in the reference.

Convention: ``q, k, v`` are ``[batch, seq, heads, head_dim]``; KV may
have fewer heads than Q (grouped-query attention) as long as
``q_heads % kv_heads == 0``. Scores, softmax statistics and the PV
accumulator are fp32 for any input dtype: the reference's
``preferred_element_type=float32`` is written here as an fp32 product
of the (exactly representable) low-precision operands.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30

Offset = Union[int, torch.Tensor]


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention: [B,L,Hkv,D] →
    [B,L,Hkv*n_rep,D]."""
    if n_rep == 1:
        return x
    b, l, h, d = x.shape
    return x[:, :, :, None, :].expand(b, l, h, n_rep, d).reshape(
        b, l, h * n_rep, d)


def _scores(q, k, scale, causal, q_offset, kv_offset):
    """fp32 ``[B, H, Lq, Lk]`` scores with the causal mask applied."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
    return s


def _pv(p, v):
    """P cast to V's dtype (as the reference does before PV), then an
    fp32 product: ``[B, H, Lq, Lk] x [B, Lk, H, D] → [B, Lq, H, D]``."""
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: Offset = 0,
    kv_offset: Offset = 0,
    kv_segment_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference softmax attention (fp32 statistics).

    ``q_offset``/``kv_offset`` are the global positions of the first
    query/key. ``kv_segment_valid`` is an optional [B, Lk] 0/1 mask for
    padded keys, or [B, Lq, Lk] for a per-query mask.
    """
    q_heads, kv_heads = q.shape[2], k.shape[2]
    if q_heads != kv_heads:
        k = _repeat_kv(k, q_heads // kv_heads)
        v = _repeat_kv(v, q_heads // kv_heads)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, scale, causal, q_offset, kv_offset)
    if kv_segment_valid is not None:
        mask = kv_segment_valid != 0
        mask = mask[:, None, :, :] if mask.ndim == 3 else mask[:, None, None, :]
        s = s.masked_fill(~mask, NEG_INF)
    # Guard fully-masked rows: keep the max finite so exp() never sees
    # -inf - -inf.
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF / 2)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = _pv(p, v)
    o = o / torch.clamp_min(l, 1e-30).transpose(1, 2)
    return o.to(q.dtype)


def attention_block_update(
    carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    q: torch.Tensor,
    k_block: torch.Tensor,
    v_block: torch.Tensor,
    *,
    scale: float,
    q_offset: Offset,
    kv_offset: Offset,
    causal: bool,
    kv_segment_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax update of (o, m, l) with a new KV block.

    ``o`` is the unnormalized fp32 accumulator [B,Lq,H,D]; ``m``/``l``
    are the fp32 running max / normalizer [B,H,Lq].
    """
    o, m, l = carry
    q_heads, kv_heads = q.shape[2], k_block.shape[2]
    if q_heads != kv_heads:
        k_block = _repeat_kv(k_block, q_heads // kv_heads)
        v_block = _repeat_kv(v_block, q_heads // kv_heads)
    s = _scores(q, k_block, scale, causal, q_offset, kv_offset)
    if kv_segment_valid is not None:
        s = s.masked_fill(~(kv_segment_valid != 0)[:, None, None, :],
                          NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.clamp_min(m_new, NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    correction = torch.exp(m - m_safe)  # == 1 where m was still -inf-ish
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction.transpose(1, 2)[..., None] + _pv(p, v_block)
    return o_new, m_new, l_new


def attention_init_carry(
    batch: int, q_len: int, heads: int, head_dim: int,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero-state (o, m, l) carry for :func:`attention_block_update`."""
    return (
        torch.zeros((batch, q_len, heads, head_dim), dtype=torch.float32,
                    device=device),
        torch.full((batch, heads, q_len), NEG_INF, dtype=torch.float32,
                   device=device),
        torch.zeros((batch, heads, q_len), dtype=torch.float32,
                    device=device),
    )


def attention_finalize(o: torch.Tensor, l: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Normalize the accumulator: o / l (fully-masked rows → 0)."""
    norm = torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return (o / norm).to(dtype)


def _fit_block_size(length: int, block_size: int) -> int:
    """Largest divisor of ``length`` ≤ ``block_size``."""
    if length % block_size == 0:
        return block_size
    for candidate in range(block_size, 0, -1):
        if length % candidate == 0:
            return candidate
    return length


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_size: int = 512,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_segment_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Memory-efficient attention: a loop over KV blocks with online
    softmax. O(Lq · block) live memory instead of O(Lq · Lk).
    ``kv_segment_valid`` is an optional [B, Lk] 0/1 mask for padded
    keys. The reference's ``lax.scan`` is a Python loop here.
    """
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    block_size = min(block_size, lk)
    if lk % block_size:
        best = _fit_block_size(lk, block_size)
        if best >= min(128, block_size):
            block_size = best
        else:
            # Awkward lengths (primes, near-primes) have no usable
            # divisor: pad KV to a block multiple; the validity mask
            # makes padded keys inert.
            pad = block_size - lk % block_size
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            if kv_segment_valid is None:
                kv_segment_valid = torch.ones((b, lk), dtype=torch.int32,
                                              device=q.device)
            kv_segment_valid = F.pad(kv_segment_valid, (0, pad))
            lk += pad
    carry = attention_init_carry(b, lq, h, d, device=q.device)
    for start in range(0, lk, block_size):
        end = start + block_size
        carry = attention_block_update(
            carry, q, k[:, start:end], v[:, start:end],
            scale=scale, q_offset=0, kv_offset=start, causal=causal,
            kv_segment_valid=(None if kv_segment_valid is None
                              else kv_segment_valid[:, start:end]))
    o, _, l = carry
    return attention_finalize(o, l, q.dtype)
