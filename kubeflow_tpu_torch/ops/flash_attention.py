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

"""Fused flash attention: a hand-written CUDA kernel for Hopper.

Source note. The kernel (``csrc/flash_attention.cu``) replaces the TPU
kernel ``kubeflow_tpu/ops/flash_attention.py::_flash_kernel``. At the
serving shapes (L = 2048, head_dim 128) attention does hundreds of
operations per byte it must read, so on the H100 it is bound by
operations: the tensor cores' rate, which only ``wgmma`` reaches. The
bf16 kernel is warp-specialised: a producer warp keeps a 2-stage ring
of K and V tiles in flight with TMA (tensor maps over q/k/v's own
``[B, L, H, D]`` strides, 128-byte swizzle, ``mbarrier`` full/empty
pairs), and two consumer warpgroups of 64 q rows each run QKᵀ and PV
as ``wgmma`` chains. The scores, the online softmax (scale·log2 e
folded into one FMA before ``exp2`` when scale > 0; any other scale
multiplies the scores before the max, as the plain version does), P and
the O accumulator stay in registers: P's accumulator layout is
``wgmma``'s register-A layout.
Each consumer runs the softmax of tile t while its PV of tile t-1 is on
the tensor cores, and the two take turns to issue (ping-pong). GQA
indexes the KV head ``h / (H / Hkv)``; ragged lengths are masked in the
kernel (TMA zero-fills past Lq and Lk; keys ≥ Lk are masked from a
per-tile bitmask). fp32 takes plain FMA loops, for parity checks only.
A causal call may give a query offset: query i sits at cache position
``q_offset + i`` over keys at 0 … Lk − 1, the reference's
``dense_attention(causal=True, q_offset=...)``, which its Pallas kernel
does not take. Key tiles stay aligned at key 0, so a query's row has
the same bits in a block of any width at any offset.
The design it replaces (WMMA ``mma.sync`` with S, P and O in shared
memory, synchronous loads) took 1.08–1.18 ms at B1 L2048 H32/8 D128
causal and 2.10–2.21 ms at B2 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).

:func:`launch_plan` mirrors the kernel's instantiations, tiles, grid
and shared memory in Python, so the CPU tests reach them; the library's
``kft_flash_attention_smem_bytes`` lets the card check the mirror.

Dispatch. A CPU tensor goes to :func:`flash_attention_reference`, the
plain PyTorch version (the kernel's online softmax, written with torch
ops). A CUDA tensor goes to the kernel, or the call raises: there is
no fallback. ``flash_attention.launches`` counts kernel launches.

:func:`prefill_attention` is a cache prefill's attention (generate's
prompt pass, an engine admission, a prefix hit's tail, a chunk): one
causal launch at the block's offset on the card, ``dense_attention``
on the CPU.

Gradient. Where an input wants one, the kernel runs inside an
``autograd.Function`` whose backward recomputes the plain version under
autograd and differentiates it, as the reference's ``_flash`` and
``_flash_masked`` custom VJPs recompute through ``blockwise_attention``
(``kubeflow_tpu/ops/flash_attention.py:194-252``).
"""

from __future__ import annotations

import ctypes
import operator
from typing import NamedTuple, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import (
    attention_block_update,
    attention_finalize,
    attention_init_carry,
    dense_attention,
)

#: kv tile of the plain version.
BLOCK_K = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Head dims the kernel is instantiated for: the bf16 wgmma kernel is a
#: template over D; the fp32 FMA kernel takes D at run time.
HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256),
             torch.float32: tuple(range(16, 129, 16))}
#: A block's shared memory on Hopper.
MAX_SMEM_BYTES = 232448


class LaunchPlan(NamedTuple):
    route: str                 # "wgmma" (bf16) or "fma" (fp32)
    block_q: int               # q rows per block
    block_k: int               # keys per kv tile
    threads: int
    grid: Tuple[int, int]      # (batch * heads, q tiles)
    smem_bytes: int            # dynamic shared memory per block
    kv_tiles: Tuple[int, ...] = ()  # kv tiles each q tile runs, given lk


def _kv_tiles(block_q: int, block_k: int, q_tiles: int, lq: int,
              lk: Optional[int], causal: bool, q_offset: int):
    """The kernel's ``kv_end`` over each block-local q tile, in tiles:
    every key, or under causality the keys up to the tile's last
    query's position ``q_offset + min(lq, q0 + block_q) - 1``."""
    if lk is None:
        return ()
    ends = [min(lk, q_offset + min(lq, i * block_q + block_q)) if causal
            else lk for i in range(q_tiles)]
    return tuple(-(-end // block_k) for end in ends)


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def launch_plan(dtype: torch.dtype, d: int, lq: int,
                batch_heads: int = 1, *, lk: Optional[int] = None,
                causal: bool = False, q_offset: int = 0) -> LaunchPlan:
    """The kernel launch for (dtype, head_dim) over ``lq`` queries, as
    ``csrc/flash_attention.cu`` makes it; raises ValueError where no
    kernel is instantiated. Given ``lk``, ``kv_tiles`` holds the kv
    tiles each block-local q tile runs (the kernel's
    ``kft_flash_attention_kv_tiles``).

    bf16: 384 threads (a producer warpgroup and two consumer warpgroups
    of 64 q rows), 128-row q tiles, 128-key kv tiles (64 at D = 256,
    where O takes 128 registers a thread), shared memory for Q, two
    K/V stages, their key bitmasks and nine mbarriers, plus 1 KB to
    align the swizzled tiles. fp32: 128 threads over 64 x 64 tiles."""
    if d not in HEAD_DIMS.get(dtype, ()):
        raise ValueError(
            f"head_dim {d} in {dtype}: the kernel takes "
            f"{HEAD_DIMS.get(dtype, ())}")
    if dtype == torch.bfloat16:
        block_q, block_k, stages = 128, (128 if d <= 128 else 64), 2
        smem = (1024 + block_q * d * 2 + stages * 2 * block_k * d * 2
                + stages * (block_k // 32) * 4 + (1 + 4 * stages) * 8)
        q_tiles = -(-lq // block_q)
        return LaunchPlan("wgmma", block_q, block_k, 384,
                          (batch_heads, q_tiles), smem,
                          _kv_tiles(block_q, block_k, q_tiles, lq, lk,
                                    causal, q_offset))
    block, pitch = 64, d + 4  # fp32 rows padded by 4 floats
    tile = block * pitch * 4
    k_off = _align(tile, 128)
    v_off = _align(k_off + tile, 128)
    s_off = _align(v_off + tile, 128)
    o_off = _align(s_off + block * (block + 4) * 4, 128)
    stat_off = _align(o_off + tile, 128)
    q_tiles = -(-lq // block)
    return LaunchPlan("fma", block, block, 128, (batch_heads, q_tiles),
                      stat_off + 3 * block * 4,
                      _kv_tiles(block, block, q_tiles, lq, lk, causal,
                                q_offset))


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_segment_valid: Optional[torch.Tensor] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: an online
    softmax over 64-key tiles from key 0 (the last one ragged), fp32
    statistics, P cast to V's dtype before PV, query i at position
    ``q_offset + i``. Tiles wholly in the causal future of every query
    are skipped, as the kernel skips them."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    carry = attention_init_carry(b, lq, h, d, device=q.device)
    for start in range(0, lk, BLOCK_K):
        if causal and start > q_offset + lq - 1:
            break
        end = start + BLOCK_K
        carry = attention_block_update(
            carry, q, k[:, start:end], v[:, start:end],
            scale=scale, q_offset=q_offset, kv_offset=start, causal=causal,
            kv_segment_valid=(None if kv_segment_valid is None
                              else kv_segment_valid[:, start:end]))
    o, _, l = carry
    return attention_finalize(o, l, q.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_kft_bound", False):
        fn = lib.kft_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.kft_flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.kft_flash_attention_smem_bytes.restype = ctypes.c_int
        lib.kft_flash_attention_kv_tiles.argtypes = [ctypes.c_int] * 7
        lib.kft_flash_attention_kv_tiles.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


def kernel_smem_bytes(dtype: torch.dtype, d: int) -> int:
    """The built kernel's own shared memory for (dtype, head_dim), or
    -1 where none is instantiated: what :func:`launch_plan` mirrors."""
    return _library().kft_flash_attention_smem_bytes(_DTYPES[dtype], d)


def kernel_kv_tiles(dtype: torch.dtype, d: int, lq: int, lk: int,
                    causal: bool, q_offset: int, q_tile: int) -> int:
    """The built kernel's kv tile count for block-local q tile
    ``q_tile``, or -1 where none is instantiated: what
    :func:`launch_plan`'s ``kv_tiles`` mirrors."""
    return _library().kft_flash_attention_kv_tiles(
        _DTYPES[dtype], d, lq, lk, int(causal), q_offset, q_tile)


def _check_offset(q, k, causal, q_offset) -> int:
    """The query offset as an int. A nonzero one must place the block
    inside the keys (``0 < q_offset``, ``q_offset + Lq <= Lk``) in a
    causal call: without causality an offset changes nothing. At 0 any
    Lq and Lk go, as before offsets."""
    try:
        q_offset = operator.index(q_offset)
    except TypeError:
        raise ValueError(f"q_offset must be an integer, got "
                         f"{q_offset!r}") from None
    if q_offset and not causal:
        raise ValueError(f"q_offset {q_offset} without causal: a query "
                         "offset places the causal frontier")
    if q_offset < 0 or (q_offset and q_offset + q.shape[1] > k.shape[1]):
        raise ValueError(f"q_offset {q_offset} + Lq {q.shape[1]} must lie "
                         f"within Lk {k.shape[1]}, from 0")
    return q_offset


def _check_inputs(q, k, v, kv_segment_valid):
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, all three alike")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v must be on one device")
    launch_plan(q.dtype, d, q.shape[1])
    elem = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if (t.data_ptr() % 16
                or any((s * elem) % 16 for s in t.stride()[:3])):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             "that are multiples of 16 bytes")
    if kv_segment_valid is not None:
        if tuple(kv_segment_valid.shape) != (b, k.shape[1]):
            raise ValueError(
                f"kv_segment_valid shape {tuple(kv_segment_valid.shape)} "
                f"!= (batch, Lk) = ({b}, {k.shape[1]})")
        if kv_segment_valid.device != q.device:
            raise ValueError("kv_segment_valid must be on q's device")


def _launch(q, k, v, causal, scale, kv_segment_valid, q_offset):
    _check_inputs(q, k, v, kv_segment_valid)
    lib = _library()
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if lk == 0:  # no keys: every row is fully masked
        return out.zero_()
    mask = None
    if kv_segment_valid is not None:
        mask = (kv_segment_valid != 0).to(torch.int32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kft_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, hkv, lq, lk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            0 if mask is None else mask.stride(0),
            float(scale), int(causal), q_offset, stream)
    _build.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_segment_valid, q_offset=0):
        ctx.save_for_backward(q, k, v, kv_segment_valid)
        ctx.causal, ctx.scale, ctx.q_offset = causal, scale, q_offset
        return _launch(q, k, v, causal, scale, kv_segment_valid, q_offset)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, mask = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad(), torch.profiler.record_function(
                "flash_backward_recompute"):
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip((q, k, v), wanted)]
            out = flash_attention_reference(
                *inputs, causal=ctx.causal, scale=ctx.scale,
                kv_segment_valid=mask, q_offset=ctx.q_offset)
            got = iter(torch.autograd.grad(
                out, [t for t, w in zip(inputs, wanted) if w], grad))
        return (*(next(got) if w else None for w in wanted), None, None,
                None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_segment_valid: Optional[torch.Tensor] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Fused attention on [B, L, H, D]; KV may have fewer heads (GQA).

    ``kv_segment_valid`` is an optional [B, Lk] 0/1 mask for padded
    keys, shared by every head of a batch element. ``q_offset`` (causal
    only) is query 0's position among the keys, which sit at 0 … Lk − 1:
    ``0 <= q_offset`` and ``q_offset + Lq <= Lk``, else ValueError. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel on
    the current stream (no synchronisation) or raises. Differentiable in
    q, k and v: on the card the backward recomputes through the plain
    version.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    q_offset = _check_offset(q, k, causal, q_offset)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, scale=scale,
            kv_segment_valid=kv_segment_valid, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale,
                                     kv_segment_valid, q_offset)
    return _launch(q, k, v, causal, scale, kv_segment_valid, q_offset)


#: Kernel launches since the count was last set to 0.
flash_attention.launches = 0


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_offset: int, valid: torch.Tensor) -> torch.Tensor:
    """Causal attention of a prefill block ``q [B, L, H, D]``, query j at
    cache position ``q_offset + j``, over the cache ``k, v [B, S, Hkv,
    D]`` where the ``[B, S]`` bool ``valid`` is True: ``dense_attention(q,
    k, v, causal=True, q_offset=q_offset, kv_segment_valid=valid)``. A CPU
    tensor takes that plain version. On the card it is one
    :func:`flash_attention` launch for the whole block at its offset,
    whose rows do not depend on the block's width, offset or B (a chunk's,
    a prefix hit's tail's and the one-shot prompt's rows agree bit for
    bit), or the call raises: a block the kernel refuses has no other
    route."""
    if q.device.type == "cpu":
        return dense_attention(q, k, v, causal=True, q_offset=q_offset,
                               kv_offset=0, kv_segment_valid=valid)
    return flash_attention(q, k, v, causal=True, q_offset=q_offset,
                           kv_segment_valid=valid)
