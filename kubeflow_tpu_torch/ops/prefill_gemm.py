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
layout) on the tensor cores: ``wgmma`` fed by a TMA ring under a
producer warp, a persistent grid of 128-row tiles 128 or 256 wide,
fp32 accumulation and one rounding. Each output element's reduction
order depends on K alone (and N, which a weight fixes): the tile is the
same for every M, K is walked in order, the K split (a cluster of 2 or
3 CTAs where N gives few column blocks) is chosen from (N, K) and its
partials are added in rank order, there are no atomics, and M, N and K
tails are zero-filled by TMA. So a prompt position's row has the same
bits in a prefix hit's narrow tail block as in the cold run's
full-width block, which cuBLAS (kernels picked by M) does not promise.
It is bound by operations at a prefill's M. :func:`launch_plan`
mirrors the kernel's plan (``kft_prefill_gemm_plan``).

Dispatch. A CPU tensor goes to :func:`prefill_linear_reference`, the
plain version: ``F.linear``, the op the port's CPU path has always run.
A CUDA tensor goes to the kernel, or the call raises.
``prefill_linear.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops import _build

#: The kernel's tile: output rows, K a stage, and its two widths (256
#: where N has at least WIDE_BLOCKS blocks of 128).
TILE_M, TILE_K, TILE_N, WIDE_TILE_N, WIDE_BLOCKS = 128, 64, 128, 256, 64
#: A CTA: a producer warpgroup and two consumer warpgroups.
THREADS = 384
#: A split's fp32 partial tile (128 wide), rows padded by 4 floats.
SPLIT_BYTES = TILE_M * (TILE_N + 4) * 4


#: SMs of an H100 SXM: the card a plan is for unless told another count.
H100_SMS = 132


def stage_bytes(tile_n: int) -> int:
    """A ring stage: x's TILE_M x TILE_K tile and W's tile_n x TILE_K,
    bf16."""
    return (TILE_M + tile_n) * TILE_K * 2


class LaunchPlan(NamedTuple):
    """One launch's shape; ``M_FIELDS`` are the only ones that depend
    on M."""
    tile_m: int
    tile_n: int
    tile_k: int
    split: int       # CTAs a cluster, each a fixed range of K
    share: int       # column blocks a cluster, sharing x's tile
    stages: int      # ring depth
    threads: int
    smem_bytes: int  # dynamic shared memory a CTA
    ctas: int        # the persistent grid
    tiles_m: int     # output tiles along M


M_FIELDS = ("ctas", "tiles_m")


def launch_plan(m: int, n: int, k: int,
                clusters: Optional[int] = None) -> LaunchPlan:
    """The kernel's launch at ``x [m, k] · W[n, k]ᵀ`` on a card that
    holds ``clusters`` of its clusters at once (its ``plan_for``,
    ``units_for`` and ``ctas_for``; None: an H100's SMs over the cluster
    size, the most it could hold): tiles 256 wide where N has at least
    64 blocks of 128, else 128; fewer than 16 column blocks split K
    over 3 CTAs (at least 32 K tiles) or 2 (16); else two column blocks
    a cluster share x's tile. A split's ring is 4 stages deep beside its
    partial tile or of 256-wide stages, else 6; min(units, clusters)
    clusters walk the units of work."""
    tile_n = WIDE_TILE_N if -(-n // TILE_N) >= WIDE_BLOCKS else TILE_N
    n_tiles, k_tiles = -(-n // tile_n), -(-k // TILE_K)
    split = (1 if n_tiles >= 16 else 3 if k_tiles >= 32
             else 2 if k_tiles >= 16 else 1)
    share = 2 if split == 1 and n_tiles >= 2 else 1
    stages = 4 if split > 1 or tile_n == WIDE_TILE_N else 6
    smem = (1024 + stages * stage_bytes(tile_n)
            + (SPLIT_BYTES if split > 1 else 0) + 2 * stages * 8)
    tiles_m = -(-m // TILE_M)
    units = tiles_m * -(-n_tiles // share)
    cluster = split * share
    if clusters is None:
        clusters = H100_SMS // cluster
    ctas = max(1, min(units, clusters)) * cluster
    return LaunchPlan(TILE_M, tile_n, TILE_K, split, share, stages, THREADS,
                      smem, ctas, tiles_m)


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
        lib.kft_prefill_gemm_plan.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.kft_prefill_gemm_plan.restype = None
        lib.kft_prefill_gemm_max_clusters.argtypes = [ctypes.c_int] * 2
        lib.kft_prefill_gemm_max_clusters.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


def kernel_plan(m: int, n: int, k: int, clusters: int) -> LaunchPlan:
    """The built kernel's own figure for :func:`launch_plan`."""
    out = (ctypes.c_int * len(LaunchPlan._fields))()
    _library().kft_prefill_gemm_plan(m, n, k, clusters, out)
    return LaunchPlan(*out)


def kernel_max_clusters(n: int, k: int) -> int:
    """Clusters of the (n, k) plan's shape the current card holds at
    once: the ``clusters`` its launches use."""
    lib = _library()
    got = lib.kft_prefill_gemm_max_clusters(n, k)
    if got <= 0:
        _build.check(lib, -got, "prefill_gemm occupancy query")
    return got


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
