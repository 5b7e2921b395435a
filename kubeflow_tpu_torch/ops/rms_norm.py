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

"""Row-wise RMSNorm: a hand-written CUDA kernel for Hopper.

Source note. The kernel (``csrc/rms_norm.cu``) has no Pallas original
(the reference's ``RMSNorm``, ``kubeflow_tpu/models/llama.py:53-56``,
runs under XLA). It rounds where the reference rounds: the fp32 mean of
squares, ``rsqrt(var + eps)`` cast to x's dtype, the product, then the
scale. One block takes one row and sums its squares in an order fixed
by the width alone, so a row has the same bits at any row count (the
decode engine's M = slots against B=1 ``generate``'s M = 1), where
PyTorch's reduction sizes its block from the row count. One launch
where the formula is about eight. Bound by bytes.

Dispatch. A CPU tensor goes to :func:`rms_norm_reference`, the plain
formula. A CUDA tensor goes to the kernel, or the call raises. The
kernel's gradient recomputes through the plain formula's autograd.
``rms_norm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """The formula: variance in fp32 whatever x's dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    normed = x * torch.rsqrt(var + eps).to(x.dtype)
    return normed * scale


def _library() -> ctypes.CDLL:
    lib = _build.load("rms_norm")
    if not getattr(lib, "_kft_bound", False):
        lib.kft_rms_norm.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                     + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_float,
                                        ctypes.c_void_p])
        lib.kft_rms_norm.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


def _check_inputs(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} != ({d},)")
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{scale.dtype}: the kernel takes "
                         "float32 or bfloat16, x and scale alike")
    if x.device != scale.device:
        raise ValueError("x and scale must be on one device")
    vec = 16 // x.element_size()
    if d % vec:
        raise ValueError(f"width {d} is not a multiple of {vec} (16 bytes "
                         f"of {x.dtype})")
    if not scale.is_contiguous() or scale.data_ptr() % 16:
        raise ValueError("scale must be contiguous and 16-byte aligned")


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    _check_inputs(x, scale)
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    if rows.stride(1) != 1 or rows.data_ptr() % 16 or (
            rows.stride(0) * x.element_size()) % 16:
        rows = rows.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.kft_rms_norm(rows.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), _DTYPES[x.dtype], rows.shape[0],
                               d, rows.stride(0), float(eps), stream)
    _build.check(lib, err, "rms_norm launch")
    rms_norm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain formula
    under autograd and differentiates it."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, gy):
        wanted = ctx.needs_input_grad[:2]
        with torch.enable_grad(), torch.profiler.record_function(
                "rms_norm_backward_recompute"):
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, wanted)]
            y = rms_norm_reference(*inputs, ctx.eps)
            got = iter(torch.autograd.grad(
                y, [t for t, w in zip(inputs, wanted) if w], gy))
        return (*(next(got) if w else None for w in wanted), None)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` with a ``[D]`` scale of x's
    dtype. A CPU tensor takes the plain formula; a CUDA tensor launches
    the kernel on the current stream (no synchronisation) or raises.
    Differentiable in x and scale."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _launch(x, scale, eps)


#: Kernel launches since the count was last set to 0.
rms_norm.launches = 0
