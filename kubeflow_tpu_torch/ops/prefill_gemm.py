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

"""The prefill's linear layer: a hand-written tensor-core CUDA kernel for
Hopper whose rows do not depend on the block width.

Source note. The kernel (``csrc/prefill_gemm.cu``) has no Pallas
original: the reference computes these products with ``nn.Dense``
under XLA (``kubeflow_tpu/models/llama.py:72``, ``_dense``). It computes
bf16 ``y = x · Wᵀ`` for ``x [..., K]`` and ``W [N, K]`` (``nn.Linear``'s
layout) on the tensor cores (``mma.sync`` fed by ``ldmatrix`` and
``cp.async``), fp32 accumulation and one rounding. Each output element's
reduction order depends on K alone: one fixed tile for every M, K walked
in order, no split-K, no atomics, an M tail zero-filled in shared
memory. So a prompt position's row has the same bits in a prefix hit's
narrow tail block as in the cold run's full-width block, which cuBLAS
(kernels picked by M) does not promise. It is bound by operations at a
prefill's M.

Dispatch. A CPU tensor goes to :func:`prefill_linear_reference`, the
plain version: ``F.linear``, the op the port's CPU path has always run.
A CUDA tensor goes to the kernel, or the call raises.
``prefill_linear.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops import _build


def prefill_linear_reference(x: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """``x · Wᵀ``: one ``F.linear``."""
    return F.linear(x, w)


def _library() -> ctypes.CDLL:
    lib = _build.load("prefill_gemm")
    if not getattr(lib, "_kft_bound", False):
        lib.kft_prefill_gemm.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_longlong, ctypes.c_void_p])
        lib.kft_prefill_gemm.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


def _check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and W {tuple(w.shape)} do not "
                         "make x · Wᵀ")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"dtypes {x.dtype}/{w.dtype}: the kernel takes "
                         "bfloat16 x and W")
    if x.device != w.device:
        raise ValueError("x and W must be on one device")
    if x.shape[-1] % 8:
        raise ValueError(f"K = {x.shape[-1]} is not a multiple of 8 "
                         "(16 bytes of bfloat16)")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("W must be contiguous and 16-byte aligned")


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_inputs(x, w)
    k, n = w.shape[1], w.shape[0]
    rows = x.reshape(-1, k)
    if rows.stride(1) != 1 or rows.data_ptr() % 16 or (
            rows.stride(0) * x.element_size()) % 16:
        raise ValueError("x's rows must be contiguous and 16-byte aligned")
    out = torch.empty((rows.shape[0], n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(*x.shape[:-1], n)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.kft_prefill_gemm(rows.data_ptr(), w.data_ptr(),
                                   out.data_ptr(), rows.shape[0], n, k,
                                   rows.stride(0), stream)
    _build.check(lib, err, "prefill_gemm launch")
    prefill_linear.launches += 1
    return out.reshape(*x.shape[:-1], n)


def prefill_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] · W[N, K]ᵀ → [..., N]`` in bf16, each row's bits
    independent of how many rows the block holds. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel on the current
    stream (no synchronisation) or raises, also where a gradient is
    wanted: prefills run under ``inference_mode``."""
    if x.device.type == "cpu":
        return prefill_linear_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"prefill_linear runs on cuda or cpu, not "
                         f"{x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("prefill_linear has no gradient on the card: "
                           "prefills run under inference_mode")
    return _launch(x, w)


#: Kernel launches since the count was last set to 0.
prefill_linear.launches = 0
