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

"""The decode step's linear layer: a hand-written CUDA kernel for Hopper
whose rows do not depend on the row count.

Source note. The kernel (``csrc/decode_gemm.cu``) has no Pallas
original: the reference leaves a decode step's products to XLA (the
``nn.Dense`` layers of ``kubeflow_tpu/models/llama.py``). It computes
``y = x · Wᵀ`` for ``x [..., K]`` and ``W [N, K]`` (``nn.Linear``'s
layout), bf16 or fp32 (the fp32 ``lm_head``, in full fp32 FMA), with
fp32 accumulation and one rounding. Each output element's reduction
order depends on K alone, never on the row count: no split-K, no
atomics, rows in fixed tiles handled alike. So a row of a decode step
at M = 4 slots has the bits it has at M = 1, which cuBLAS (kernels
picked by shape) does not promise, and the decode engine's contract
(every slot's stream equals B=1 ``generate``) needs. It is bound by
bytes: a weight read, 16.06 GB per ``llama3-8b`` decode step.

Dispatch. A CPU tensor goes to :func:`decode_linear_reference`, the
plain version: each row its own M = 1 ``F.linear``, batch-invariant by
construction. A CUDA tensor goes to the kernel, or the call raises.
``decode_linear.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_linear_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x · Wᵀ`` with every row computed as its own M = 1 product."""
    rows = x.reshape(-1, x.shape[-1])
    out = torch.cat([F.linear(r[None], w) for r in rows]) if len(rows) \
        else rows.new_empty((0, w.shape[0]))
    return out.reshape(*x.shape[:-1], w.shape[0])


def _library() -> ctypes.CDLL:
    lib = _build.load("decode_gemm")
    if not getattr(lib, "_kft_bound", False):
        lib.kft_decode_gemm.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_longlong, ctypes.c_void_p])
        lib.kft_decode_gemm.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


def _check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if w.dim() != 2 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and W {tuple(w.shape)} do not "
                         "make x · Wᵀ")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{w.dtype}: the kernel takes "
                         "float32 or bfloat16, x and W alike")
    if x.device != w.device:
        raise ValueError("x and W must be on one device")
    vec = 16 // x.element_size()
    if x.shape[-1] % vec:
        raise ValueError(f"K = {x.shape[-1]} is not a multiple of {vec} "
                         f"(16 bytes of {x.dtype})")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("W must be contiguous and 16-byte aligned")


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_inputs(x, w)
    k, n = w.shape[1], w.shape[0]
    rows = x.reshape(-1, k)
    if rows.stride(1) != 1 or rows.data_ptr() % 16 or (
            rows.stride(0) * x.element_size()) % 16:
        rows = rows.contiguous()
    out = torch.empty((rows.shape[0], n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(*x.shape[:-1], n)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.kft_decode_gemm(rows.data_ptr(), w.data_ptr(),
                                  out.data_ptr(), _DTYPES[x.dtype],
                                  rows.shape[0], n, k, rows.stride(0), stream)
    _build.check(lib, err, "decode_gemm launch")
    decode_linear.launches += 1
    return out.reshape(*x.shape[:-1], n)


def decode_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] · W[N, K]ᵀ → [..., N]`` in x's dtype, each row's bits
    independent of how many rows there are. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel on the current
    stream (no synchronisation) or raises, also where a gradient is
    wanted: the decode step runs under ``inference_mode``."""
    if x.device.type == "cpu":
        return decode_linear_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"decode_linear runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("decode_linear has no gradient on the card: the "
                           "decode step runs under inference_mode")
    return _launch(x, w)


#: Kernel launches since the count was last set to 0.
decode_linear.launches = 0
