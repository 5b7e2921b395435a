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
operations, not by memory. The design keeps the L x L scores out of
device memory (a 64 x 64 fp32 score tile per block in shared memory),
runs QKᵀ and PV on the tensor cores (WMMA ``mma.sync``, bf16 in, fp32
accumulate), reads q/k/v through their ``[B, L, H, D]`` strides, and
indexes the KV head ``h / (H / Hkv)`` so GQA never materialises the
repeat. The TPU block sizes and the reference's divisibility fallback
do not carry over: ragged lengths are masked inside the kernel.

Dispatch. A CPU tensor goes to :func:`flash_attention_reference`, the
plain PyTorch version (the kernel's online softmax, written with torch
ops). A CUDA tensor goes to the kernel, or the call raises: there is
no fallback. ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import (
    attention_block_update,
    attention_finalize,
    attention_init_carry,
)

#: kv tile of the plain version; the kernel's tiles are 64 x 64 too.
BLOCK_K = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Largest head_dim per dtype whose tiles fit a block's 227 KB of
#: shared memory (the layout is in csrc/flash_attention.cu).
_MAX_HEAD_DIM = {torch.float32: 128, torch.bfloat16: 256}


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_segment_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: an online
    softmax over 64-key tiles (the last one ragged), fp32 statistics,
    P cast to V's dtype before PV. Tiles wholly in the causal future of
    every query are skipped, as the kernel skips them."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    carry = attention_init_carry(b, lq, h, d, device=q.device)
    for start in range(0, lk, BLOCK_K):
        if causal and start >= lq:
            break
        end = start + BLOCK_K
        carry = attention_block_update(
            carry, q, k[:, start:end], v[:, start:end],
            scale=scale, q_offset=0, kv_offset=start, causal=causal,
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
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


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
    if d % 16 or d > _MAX_HEAD_DIM[q.dtype]:
        raise ValueError(f"head_dim {d} in {q.dtype}: the kernel takes "
                         f"multiples of 16 up to {_MAX_HEAD_DIM[q.dtype]}")
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


def _launch(q, k, v, causal, scale, kv_segment_valid):
    _check_inputs(q, k, v, kv_segment_valid)
    lib = _library()
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
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
            float(scale), int(causal), stream)
    _build.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_segment_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention on [B, L, H, D]; KV may have fewer heads (GQA).

    ``kv_segment_valid`` is an optional [B, Lk] 0/1 mask for padded
    keys, shared by every head of a batch element. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel on the current
    stream (no synchronisation) or raises.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, scale=scale,
            kv_segment_valid=kv_segment_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, scale, kv_segment_valid)


#: Kernel launches since the count was last set to 0.
flash_attention.launches = 0
