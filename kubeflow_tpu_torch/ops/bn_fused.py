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

"""Batch-norm training forward: a hand-written CUDA kernel for Hopper.

Counterpart of ``kubeflow_tpu/ops/bn_pallas.py``. Source note: the
kernel (``csrc/bn_forward.cu``) replaces the TPU kernel
``kubeflow_tpu/ops/bn_pallas.py::_bn_fwd_kernel``. It is bound by bytes
(a few operations per element); it moves the least traffic the
function allows — read the stat rows, read x, write y — in 16-byte
vector loads, with hierarchical fp32 partial sums finished in a fixed
order (no atomics), so the same shape gives the same bits on every
run. The TPU's ``C % 128`` and ``M % block_m`` limits do not carry
over: tails are masked in the kernel.

On the ResNet path this is the training forward of every
``GhostBatchNorm`` layer (ops/batch_norm.py): 53 launches per
ResNet-50 forward. Its gradient recomputes through the plain version's
autograd, as the reference's BN gradient is XLA autodiff of the same
formula; a backward kernel is later work.

Dispatch. A CPU tensor goes to :func:`reference_bn_train_forward`, the
plain PyTorch version. A CUDA tensor goes to the kernel, or the call
raises: there is no fallback. ``fused_bn_train_forward.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from kubeflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Threads per block, and the blocks a launch aims for: eight waves
#: over the H100's 132 SMs.
THREADS = 256
TARGET_BLOCKS = 132 * 8
#: Fewest rows a thread sums or normalizes per chunk.
MIN_ROWS_PER_THREAD = 4

BNOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reference_bn_train_forward(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, *, eps: float = 1e-5,
                               stat_rows: Optional[int] = None) -> BNOutputs:
    """The kernel's function in plain PyTorch, on any device: fp32
    statistics over the first ``stat_rows`` rows (all when None) by the
    reference's formula, var = max(E[x²] − mean², 0), then
    ``GhostBatchNorm``'s op order, y = (x − mean)·(rsqrt(var + eps)·
    scale) + bias, cast to x's dtype."""
    xf = x.float()
    xs = xf if stat_rows is None else xf[:stat_rows]
    mean = xs.mean(0)
    var = torch.clamp(xs.square().mean(0) - mean.square(), min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    y = (xf - mean) * mul + bias.float()
    return y.to(x.dtype), mean, var


def vector_width(x: torch.Tensor) -> int:
    """Elements per 16-byte access, or 1 where C is not a multiple of
    it or x is not 16-byte aligned (the kernel's scalar path)."""
    vec = 16 // x.element_size()
    if x.shape[1] % vec == 0 and x.data_ptr() % 16 == 0:
        return vec
    return 1


def launch_plan(rows: int, c: int, vec: int) -> Tuple[int, int, int, int, int]:
    """Block and grid for one pass over ``rows`` rows of C channels:
    ``(tx, ty, c_tiles, chunks, rows_per_chunk)``. A block is tx
    channel-vectors wide (a power of two up to 32, so a warp reads
    whole rows even at C = 64) and ty = THREADS / tx rows deep; the
    grid is C tiles × row chunks, about TARGET_BLOCKS blocks, with at
    least MIN_ROWS_PER_THREAD rows per thread and no empty chunk."""
    groups = -(-c // vec)
    tx = min(32, 1 << (groups - 1).bit_length())
    ty = THREADS // tx
    c_tiles = -(-groups // tx)
    chunks = max(1, min(-(-TARGET_BLOCKS // c_tiles),
                        -(-rows // (ty * MIN_ROWS_PER_THREAD))))
    per_chunk = -(-rows // chunks)
    return tx, ty, c_tiles, -(-rows // per_chunk), per_chunk


def _check_inputs(x, scale, bias, stat_rows):
    """Raise on anything the kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, C]; got shape {tuple(x.shape)}")
    m, c = x.shape
    if m == 0 or c == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x is {x.dtype}; the kernel takes float32 or "
                         "bfloat16")
    if x.stride() != (c, 1):
        raise ValueError(f"x must be row-contiguous [M, C]; strides "
                         f"{x.stride()}")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({c},)")
        if t.device != x.device:
            raise ValueError(f"{name} must be on x's device")
    if stat_rows is not None and not 1 <= stat_rows <= m:
        raise ValueError(f"stat_rows {stat_rows} outside [1, {m}]")


def _library() -> ctypes.CDLL:
    lib = _build.load("bn_forward")
    if not getattr(lib, "_kft_bound", False):
        fn = lib.kft_bn_forward
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                ctypes.c_longlong,
                                                ctypes.c_int,
                                                ctypes.c_longlong,
                                                ctypes.c_float]
                       + [ctypes.c_int] * 5
                       + [ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


def _launch(x, scale, bias, eps, stat_rows) -> BNOutputs:
    lib = _library()
    m, c = x.shape
    m_stat = m if stat_rows is None else stat_rows
    scale = scale.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    vec = vector_width(x)
    tx, ty, c_tiles, stat_chunks, stat_per = launch_plan(m_stat, c, vec)
    _, _, _, norm_chunks, norm_per = launch_plan(m, c, vec)
    y = torch.empty_like(x)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    var = torch.empty(c, dtype=torch.float32, device=x.device)
    work = torch.empty((stat_chunks * 2 + 1) * c, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.kft_bn_forward(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), var.data_ptr(), work.data_ptr(), _DTYPES[x.dtype],
            m, c, m_stat, float(eps), vec, tx, ty, c_tiles, stat_chunks,
            stat_per, norm_chunks, norm_per, stream)
    _build.check(lib, err, "bn_forward launch")
    fused_bn_train_forward.launches += 1
    return y, mean, var


class _BNTrainForward(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain version
    under autograd and differentiates it (the reference's gradient is
    XLA autodiff of the same formula, stat-rows path included)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, stat_rows):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.stat_rows = eps, stat_rows
        y, mean, var = _launch(x, scale, bias, eps, stat_rows)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        wanted = ctx.needs_input_grad[:3]
        pairs = [(i, g) for i, g in enumerate((gy, gmean, gvar))
                 if g is not None]
        grads = [None, None, None]
        if not pairs or not any(wanted):
            return (*grads, None, None)
        with torch.enable_grad(), record_function("bn_backward_recompute"):
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, wanted)]
            outs = reference_bn_train_forward(
                *inputs, eps=ctx.eps, stat_rows=ctx.stat_rows)
            got = iter(torch.autograd.grad(
                [outs[i] for i, _ in pairs],
                [t for t, w in zip(inputs, wanted) if w],
                [g for _, g in pairs], allow_unused=True))
        grads = [next(got) if w else None for w in wanted]
        return (*grads, None, None)


def fused_bn_train_forward(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *, eps: float = 1e-5,
                           stat_rows: Optional[int] = None) -> BNOutputs:
    """[M, C] x → (y, mean, var): per-channel fp32 statistics over the
    first ``stat_rows`` rows (all when None), every row normalized.

    x is bf16 or fp32 and row-contiguous; scale and bias are [C]. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel on
    the current stream (no synchronisation) or raises. Differentiable
    in x, scale and bias.
    """
    _check_inputs(x, scale, bias, stat_rows)
    if x.device.type == "cpu":
        return reference_bn_train_forward(x, scale, bias, eps=eps,
                                          stat_rows=stat_rows)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_train_forward runs on cuda or cpu, not "
                         f"{x.device}")
    return _BNTrainForward.apply(x, scale, bias, eps, stat_rows)


#: Kernel launches since the count was last set to 0.
fused_bn_train_forward.launches = 0
