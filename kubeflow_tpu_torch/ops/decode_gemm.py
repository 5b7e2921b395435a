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
fp32 accumulation and one rounding. Both dtypes stream W through a ring
of ``cp.async`` copies with x staged beside it in shared memory, reading
W once for every M up to 32: bf16 on ``mma.sync``; fp32 as an 8 x 8
register tile in each of 8 lanes that split K into fixed classes, summed
by a fixed butterfly, in fp32 FMA (so a speculative verify's 20 rows
cost the fp32 head one read of its 2.10 GB, as a decode step's 4 do).
Each output element's reduction order depends on K alone (and N, which
a weight fixes), never on the row count: the tile is the same for every
M, the bf16 K split (a cluster of up to 8 CTAs) is chosen from N, K and
the card's SM count and its partials are added in rank order, fp32's K
classes and their butterfly are fixed by K, there are no atomics, and
rows past M are zero-filled or skipped. So a row of a decode step at
M = 4 slots has the bits it has at M = 1, which cuBLAS (kernels picked
by shape) does not promise, and the decode engine's contract (every
slot's stream equals B=1 ``generate``) needs; a speculative verify's
row has the bits of the one-token step at its position. It is bound by
bytes: a weight read, 16.06 GB per ``llama3-8b`` decode step.
:func:`launch_plan` mirrors the kernel's plan (``kft_decode_gemm_plan``).

Dispatch. A CPU tensor goes to :func:`decode_linear_reference`, the
plain version: each row its own M = 1 ``F.linear``, batch-invariant by
construction. A CUDA tensor goes to the kernel, or the call raises.
``decode_linear.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: bf16: x rows one pass over W serves, W rows (output columns) a CTA,
#: K a ring stage, the ring's depth, threads a CTA, the largest split.
ROWS_PER_PASS, TILE_N, TILE_K, STAGES, THREADS, MAX_SPLIT = \
    32, 64, 128, 3, 128, 8
#: bf16 dynamic shared memory: the ring (W and x tiles), which the fp32
#: partials (ROWS_PER_PASS + 1 floats a W row) reuse once it drains.
SMEM_BYTES = max(STAGES * (TILE_N + ROWS_PER_PASS) * TILE_K * 2,
                 TILE_N * (ROWS_PER_PASS + 1) * 4)
#: fp32: W rows (output columns) a CTA, K a ring stage, the ring's depth,
#: threads a CTA; rows a pass as bf16's.
FP32_TILE_N, FP32_TILE_K, FP32_STAGES, FP32_THREADS = 64, 64, 3, 256
#: fp32 dynamic shared memory: the ring (W and x tiles).
FP32_SMEM_BYTES = (FP32_STAGES * (FP32_TILE_N + ROWS_PER_PASS)
                   * FP32_TILE_K * 4)
#: SMs of an H100 SXM: the card a plan is for unless told another count.
H100_SMS = 132


class LaunchPlan(NamedTuple):
    """One launch's shape; ``M_FIELDS`` are the only ones that depend
    on M."""
    rows_per_pass: int
    tile_n: int
    tile_k: int
    split: int       # CTAs a cluster, each a fixed range of K (fp32: 1)
    stages: int
    threads: int
    smem_bytes: int  # dynamic shared memory a CTA
    grid_x: int
    grid_y: int      # passes over W: one per ROWS_PER_PASS rows


M_FIELDS = ("grid_y",)


def split_for(n: int, k: int, sms: int = H100_SMS) -> int:
    """The bf16 K split (the kernel's ``split_for``): the largest power
    of two up to MAX_SPLIT that keeps the CTAs within two an SM, halved
    while a CTA would get fewer than 2 stages of K."""
    slabs, k_tiles = -(-n // TILE_N), -(-k // TILE_K)
    split = 1
    while split < MAX_SPLIT and slabs * split * 2 <= 2 * sms:
        split *= 2
    while split > 1 and k_tiles < 2 * split:
        split //= 2
    return split


def launch_plan(dtype: torch.dtype, m: int, n: int, k: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's launch at ``x [m, k] · W[n, k]ᵀ`` in ``dtype`` on a
    card of ``sms`` SMs (its ``kft_decode_gemm_plan``)."""
    if dtype == torch.bfloat16:
        split = split_for(n, k, sms)
        return LaunchPlan(ROWS_PER_PASS, TILE_N, TILE_K, split, STAGES,
                          THREADS, SMEM_BYTES, -(-n // TILE_N) * split,
                          -(-m // ROWS_PER_PASS))
    if dtype == torch.float32:
        return LaunchPlan(ROWS_PER_PASS, FP32_TILE_N, FP32_TILE_K, 1,
                          FP32_STAGES, FP32_THREADS, FP32_SMEM_BYTES,
                          -(-n // FP32_TILE_N), -(-m // ROWS_PER_PASS))
    raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")


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
        lib.kft_decode_gemm_plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.kft_decode_gemm_plan.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


def kernel_plan(dtype: torch.dtype, m: int, n: int, k: int,
                sms: int) -> LaunchPlan:
    """The built kernel's own figure for :func:`launch_plan`."""
    out = (ctypes.c_int * len(LaunchPlan._fields))()
    if _library().kft_decode_gemm_plan(_DTYPES[dtype], m, n, k, sms, out):
        raise ValueError(f"dtype {dtype}: the kernel has no plan")
    return LaunchPlan(*out)


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
