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

"""Row-wise RMSNorm, and the residual add fused into it: a hand-written
CUDA kernel for Hopper.

Source note. The kernel (``csrc/rms_norm.cu``) has no Pallas original
(the reference's ``RMSNorm``, ``kubeflow_tpu/models/llama.py:53-56``,
runs under XLA). It rounds where the reference rounds: the fp32 mean of
squares, ``rsqrt(var + eps)`` cast to x's dtype, the product, then the
scale. Its second entry, :func:`add_rms_norm`, takes the residual add
that comes before a norm (64 of a Llama forward's 65): ``s = x + delta``
rounded as PyTorch rounds the add, then the norm of ``s``, both written
by one launch. A row's sum of squares is taken in an order fixed by the
width alone, so a row has the same bits at any row count (the decode
engine's M = slots against B=1 ``generate``'s M = 1) and in either
entry, where PyTorch's reduction sizes its block from the row count.
The row is held in registers, a CTA a row at every row count. Bound by
bytes.

Dispatch. A CPU tensor goes to the plain version
(:func:`rms_norm_reference`, :func:`add_rms_norm_reference`). A CUDA
tensor goes to the kernel, or the call raises. The kernel's gradient
recomputes through the plain version's autograd. ``rms_norm.launches``
counts launches of either entry, ``add_rms_norm.launches`` the fused
entry's.

Host work. What depends only on (dtype, width, device) (the kernel's
entry, the dtype's code) is looked up once and cached; a call checks
only what relates its own tensors (dtype, device and shape agreement,
contiguity and 16-byte alignment) and hands the kernel its arguments as
one packed block.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The widths the kernel is built for: every registered Llama's d_model
#: (llama-test's 64, the MoE pair's 1024, llama3-8b's and llama2-7b's
#: 4096, llama2-13b's 5120) and the serving benchmark's weak draft's 32.
WIDTHS = (32, 64, 1024, 4096, 5120)


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """The formula: variance in fp32 whatever x's dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    normed = x * torch.rsqrt(var + eps).to(x.dtype)
    return normed * scale


def add_rms_norm_reference(x: torch.Tensor, delta: torch.Tensor,
                           scale: torch.Tensor,
                           eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's order: the residual add, then the norm."""
    s = x + delta
    return s, rms_norm_reference(s, scale, eps)


#: ``kft_rms_norm``'s one argument, a packed block (``KftRmsNormArgs``
#: in ``csrc/rms_norm.cu``): x, delta, scale, s, y, rows, stream, dtype,
#: d, eps. One foreign argument is converted faster than ten.
_ARGS = struct.Struct("<7q2if4x")
#: The current device and its current raw stream: None in a build of
#: PyTorch without CUDA, where no call reaches them.
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class _Entry(NamedTuple):
    """What a call of one (dtype, width, device) needs, found once."""

    launch: Callable[[bytes], int]
    dtype: int
    width: int
    device: int
    scale_shape: torch.Size


_entries: Dict[tuple, _Entry] = {}


def _check_width(dtype: torch.dtype, d: int) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or "
                         "bfloat16")
    if d not in WIDTHS:
        raise ValueError(f"width {d}: the kernel is built for {WIDTHS}")


def _entry(x: torch.Tensor) -> _Entry:
    """The entry for x's (dtype, width, device): cached on first use."""
    key = (x.dtype, x.shape[-1], x.get_device())
    found = _entries.get(key)
    if found is None:
        _check_width(x.dtype, key[1])
        launch = _build.load("rms_norm").kft_rms_norm
        launch.argtypes, launch.restype = (ctypes.c_char_p,), ctypes.c_int
        found = _entries[key] = _Entry(launch, _DTYPES[x.dtype], key[1],
                                       key[2], torch.Size([key[1]]))
    return found


def _check_inputs(x: torch.Tensor, scale: torch.Tensor,
                  delta: Optional[torch.Tensor] = None) -> None:
    """Raise on anything the kernel does not take."""
    d = x.shape[-1]
    _check_width(x.dtype, d)
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} != ({d},)")
    if scale.dtype != x.dtype or (delta is not None
                                  and delta.dtype != x.dtype):
        raise ValueError("x, delta and scale must have one dtype, not "
                         f"{x.dtype}/{None if delta is None else delta.dtype}"
                         f"/{scale.dtype}")
    if scale.device != x.device or (delta is not None
                                    and delta.device != x.device):
        raise ValueError("x, delta and scale must be on one device")
    if delta is not None and delta.shape != x.shape:
        raise ValueError(f"delta {tuple(delta.shape)} != x "
                         f"{tuple(x.shape)}")
    if not scale.is_contiguous():
        raise ValueError("scale must be contiguous")
    for name, t in (("x", x), ("delta", delta), ("scale", scale)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float,
            delta: Optional[torch.Tensor] = None):
    """One launch on x's device and its current stream, counted: ``y``,
    or ``(s, y)`` given ``delta``. A call checks only what relates its
    own tensors (the rest is the cached entry's), cheaply first: the
    full check runs, and raises, only where a cheap one fails."""
    entry = (_entries.get((x.dtype, x.shape[-1], x.get_device()))
             or _entry(x))
    dev = entry.device
    if (scale.dtype is not x.dtype or scale.get_device() != dev
            or scale.shape != entry.scale_shape or not scale.is_contiguous()
            or delta is not None and (delta.dtype is not x.dtype
                                      or delta.get_device() != dev
                                      or delta.shape != x.shape)):
        _check_inputs(x, scale, delta)
    x = x.contiguous()
    if delta is not None:
        delta = delta.contiguous()
    xp, sp = x.data_ptr(), scale.data_ptr()
    dp = 0 if delta is None else delta.data_ptr()
    if (xp | dp | sp) & 15:
        _check_inputs(x, scale, delta)
    y = torch.empty_like(x)
    s = None if delta is None else torch.empty_like(x)
    rows = x.numel() // entry.width
    if not rows:
        return y if s is None else (s, y)
    args = _ARGS.pack(xp, dp, sp, 0 if s is None else s.data_ptr(),
                      y.data_ptr(), rows, _raw_stream(dev), entry.dtype,
                      entry.width, eps)
    if _current_device() == dev:
        err = entry.launch(args)
    else:
        with torch.cuda.device(dev):
            err = entry.launch(args)
    if err:
        _build.check(_build.load("rms_norm"), err, "rms_norm launch")
    rms_norm.launches += 1
    if s is None:
        return y
    add_rms_norm.launches += 1
    return s, y


def _grads(inputs, wanted, outputs, grads):
    """``torch.autograd.grad`` over the inputs that want one, as a full
    tuple (None where not wanted)."""
    got = iter(torch.autograd.grad(
        outputs, [t for t, w in zip(inputs, wanted) if w], grads))
    return tuple(next(got) if w else None for w in wanted)


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
            return (*_grads(inputs, wanted, y, gy), None)


class _AddRMSNorm(torch.autograd.Function):
    """The fused kernel forward; the backward recomputes the plain
    formula on the saved sum ``s`` under autograd and differentiates it,
    then adds s's own incoming gradient, as autograd sums a residual's
    two uses: x and delta get that same gradient."""

    @staticmethod
    def forward(ctx, x, delta, scale, eps):
        s, y = _launch(x, scale, eps, delta)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        return s, y

    @staticmethod
    def backward(ctx, gs, gy):
        want_x, want_delta, want_scale = ctx.needs_input_grad[:3]
        wanted = (want_x or want_delta, want_scale)
        with torch.enable_grad(), torch.profiler.record_function(
                "rms_norm_backward_recompute"):
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, wanted)]
            y = rms_norm_reference(*inputs, ctx.eps)
            g_s, g_scale = _grads(inputs, wanted, y, gy)
        if g_s is not None:
            g_s = g_s + gs
        return (g_s if want_x else None, g_s if want_delta else None,
                g_scale, None)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` with a ``[D]`` scale of x's
    dtype. A CPU tensor takes the plain formula; a CUDA tensor launches
    the kernel on the current stream (no synchronisation) or raises.
    Differentiable in x and scale."""
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad
                                        or scale.requires_grad):
            return _RMSNorm.apply(x, scale, eps)
        return _launch(x, scale, eps)
    if x.device.type == "cpu":
        return rms_norm_reference(x, scale, eps)
    raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, y)``: the residual add ``s = x + delta`` and ``y =
    rms_norm(s, scale, eps)``, in one launch on the card. ``delta`` has
    x's shape and dtype. A CPU tensor takes the plain composition; a
    CUDA tensor launches the kernel on the current stream or raises.
    Differentiable in x, delta and scale."""
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or delta.requires_grad
                                        or scale.requires_grad):
            return _AddRMSNorm.apply(x, delta, scale, eps)
        return _launch(x, scale, eps, delta)
    if x.device.type == "cpu":
        return add_rms_norm_reference(x, delta, scale, eps)
    raise ValueError(f"add_rms_norm runs on cuda or cpu, not {x.device}")


#: Kernel launches since the count was last set to 0: either entry's.
rms_norm.launches = 0
#: The fused entry's launches since the count was last set to 0.
add_rms_norm.launches = 0
