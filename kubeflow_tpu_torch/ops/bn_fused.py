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
(a few operations per element): the least traffic is x read once and y
written once. It is ONE cooperative launch of a persistent grid, every
block co-resident, in three phases split by grid-wide barriers: (a)
partial sums of x and x² over the stat rows, (b) a finalize spread over
the grid, each block finishing a slice of the channels in a fixed order
(double across blocks, no atomics, so the same shape gives the same
bits on every run), (c) normalize. Where a block's share of the stat
rows (its slab) fits in shared memory, 16-byte ``cp.async`` loads it
once, and phase (c) normalizes it from there: x is read from device memory
once (the "onchip" route). Elsewhere the block keeps as much of its
slab as fits, streams the rest with several 16-byte loads in flight a
thread, and normalizes the streamed rows in the reverse of the order it
summed them, so the last tens of MB are still in L2 (the "stream"
route). The TPU's ``C % 128`` and ``M % block_m`` limits do not carry
over: tails are masked in the kernel, and a C off the vector width or
an unaligned x takes the scalar path (stream route only).

On the ResNet path this is the training forward of every
``GhostBatchNorm`` layer (ops/batch_norm.py): 53 launches per
ResNet-50 forward. Its gradient recomputes through the plain version's
autograd, as the reference's BN gradient is XLA autodiff of the same
formula; a backward kernel is later work.

Dispatch. A CPU tensor goes to :func:`reference_bn_train_forward`, the
plain PyTorch version. A CUDA tensor goes to the kernel, or the call
raises: there is no fallback, and a grid too large to be co-resident
raises too. ``fused_bn_train_forward.launches`` counts kernel launches.

The sync route (:func:`sync_bn_train_forward`). On a batch-sharded mesh
the reference's exact BN takes its statistics over the global batch
(XLA reduces them across devices), and the fused launch leaves no point
between its phases for a collective. So the same source has two more
entries: :func:`bn_stats` (phase (a) and the finalize's sums, with the
fused launch's plan, so its partial-sum order) writes the rank's fp32
Σx and Σx² per channel; the 2·C sums are all-reduced over the batch
axes; :func:`bn_apply` (phase (c)) normalizes from the global sums and
the global row count, deriving mean, var and mul by the fused
finalize's arithmetic. On one rank the route gives the fused launch's
bits. Each has a plain twin (:func:`reference_bn_stats`,
:func:`reference_bn_apply`), which a CPU tensor takes, so a gloo gang
runs the same all-reduce. The gradient recomputes through the apply
twin, with the gradient of the sums all-reduced too (sync BN's
backward: the per-channel Σgy and Σgy·x̂ of every rank).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from kubeflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Threads per block (tx channel-vectors wide, ty rows deep), and the
#: widest tx: a warp reads 32 × 16 contiguous bytes of a row.
THREADS = 512
TX_MAX = 64

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


def reference_bn_stats(x: torch.Tensor,
                       stat_rows: Optional[int] = None) -> torch.Tensor:
    """The stats entry's function: ``[2, C]`` fp32, Σx and Σx² per
    channel over the first ``stat_rows`` rows of x (all when None)."""
    xs = x.float() if stat_rows is None else x[:stat_rows].float()
    return torch.stack((xs.sum(0), xs.square().sum(0)))


def reference_bn_apply(x: torch.Tensor, sums: torch.Tensor, count: int,
                       scale: torch.Tensor, bias: torch.Tensor, *,
                       eps: float = 1e-5) -> BNOutputs:
    """The apply entry's function: mean = Σx / count, var = max(Σx² /
    count − mean², 0), then ``GhostBatchNorm``'s op order, y = (x −
    mean)·(rsqrt(var + eps)·scale) + bias, cast to x's dtype."""
    mean = sums[0] / count
    var = torch.clamp(sums[1] / count - mean.square(), min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    y = (x.float() - mean) * mul + bias.float()
    return y.to(x.dtype), mean, var


def vector_width(x: torch.Tensor) -> int:
    """Elements per 16-byte access, or 1 where C is not a multiple of
    it or x is not 16-byte aligned (the kernel's scalar path)."""
    vec = 16 // x.element_size()
    if x.shape[1] % vec == 0 and x.data_ptr() % 16 == 0:
        return vec
    return 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's geometry, as ``csrc/bn_forward.cu`` takes it."""

    tx: int          # channel vectors a block spans (a power of two)
    ty: int          # row lanes: tx * ty = THREADS
    c_tiles: int     # blocks across C
    chunks: int      # blocks down the rows
    stat_per: int    # stat rows [0, m_stat) per chunk
    rest_per: int    # non-stat rows [m_stat, M) per chunk
    keep: int        # stat rows a block holds in shared memory
    smem_bytes: int  # dynamic shared memory a block takes
    route: str       # "onchip": every block keeps all its stat rows

    @property
    def grid(self) -> int:
        return self.c_tiles * self.chunks


def scratch_bytes(vec: int) -> int:
    """The kernel's shared memory besides the kept rows: the reduction
    tree's scratch, half the threads' fp32 sums of x and x²."""
    return (THREADS // 2) * vec * 2 * 4


def launch_plan(m: int, c: int, vec: int, elem_size: int,
                stat_rows: Optional[int] = None, *, coresident: int,
                slab_bytes: int) -> Plan:
    """The kernel's geometry for an [m, c] x, from the shape alone and
    the card's two limits: ``coresident`` blocks (SMs × blocks per SM
    at the most shared memory a launch may take) and ``slab_bytes``,
    the bytes of x one block may hold in shared memory.

    A block is tx channel-vectors wide (a power of two up to TX_MAX, so
    a warp reads whole rows even at C = 64) and ty = THREADS / tx rows
    deep. The grid is C tiles × row chunks, as many chunks as fit
    co-resident (at least ty rows each, none empty); chunk k sums stat rows
    [k·stat_per, (k+1)·stat_per) and also normalizes its share of the
    non-stat rows. A block keeps the last ``keep`` of its stat rows in
    shared memory, as many as fit (none on the scalar path); the route
    is "onchip" when that is all of them, so x is read once."""
    m_stat = m if stat_rows is None else stat_rows
    groups = -(-c // vec)
    tx = min(TX_MAX, 1 << (groups - 1).bit_length())
    ty = THREADS // tx
    c_tiles = -(-groups // tx)
    chunks = max(1, min(coresident // c_tiles, -(-m // ty)))
    stat_per = -(-m_stat // chunks)
    rest_per = -(-(m - m_stat) // chunks)
    # No chunk without a row: the rounding may leave the last ones empty.
    chunks = max(-(-m_stat // stat_per),
                 -(-(m - m_stat) // rest_per) if rest_per else 0)
    width = min(tx * vec, c) * elem_size
    keep = min(stat_per, slab_bytes // width) if vec > 1 else 0
    return Plan(tx, ty, c_tiles, chunks, stat_per, rest_per, keep,
                scratch_bytes(vec) + keep * width,
                "onchip" if keep == stat_per else "stream")


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


class _Geometry(ctypes.Structure):
    """A plan as ``csrc/bn_forward.cu``'s ``Geometry`` takes it."""

    _fields_ = ([(k, ctypes.c_longlong) for k in (
        "m", "m_stat", "stat_per", "rest_per", "smem_bytes")]
        + [(k, ctypes.c_int) for k in (
            "dtype", "vec", "c", "tx", "ty", "c_tiles", "chunks", "keep")])


def _library() -> ctypes.CDLL:
    lib = _build.load("bn_forward")
    if not getattr(lib, "_kft_bound", False):
        lib.kft_bn_forward.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_float, ctypes.c_void_p])
        lib.kft_bn_forward.restype = ctypes.c_int
        lib.kft_bn_limits.argtypes = [ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 3
        lib.kft_bn_limits.restype = ctypes.c_int
        lib.kft_bn_stats.argtypes = [ctypes.c_void_p] * 5
        lib.kft_bn_stats.restype = ctypes.c_int
        lib.kft_bn_apply.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_float, ctypes.c_void_p])
        lib.kft_bn_apply.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


#: (device index, dtype code, vec) → (co-resident blocks, slab bytes).
_limits: Dict[Tuple[int, int, int], Tuple[int, int]] = {}


def device_limits(lib: ctypes.CDLL, device: torch.device, dtype: int,
                  vec: int) -> Tuple[int, int]:
    """The card's limits for one instantiation of the kernel, asked of
    the card at first use: co-resident blocks (SMs × blocks per SM at
    the most shared memory a launch takes) and the bytes of x a block
    may keep in shared memory."""
    key = (device.index, dtype, vec)
    if key not in _limits:
        sms, per_sm = ctypes.c_int(), ctypes.c_int()
        slab = ctypes.c_longlong()
        with torch.cuda.device(device):
            err = lib.kft_bn_limits(dtype, vec, ctypes.byref(sms),
                                    ctypes.byref(per_sm), ctypes.byref(slab))
        _build.check(lib, err, "bn_forward limits")
        if per_sm.value < 1:
            raise RuntimeError("bn_forward: no block of the kernel fits on "
                               "an SM")
        _limits[key] = (sms.value * per_sm.value, slab.value)
    return _limits[key]


#: Plans by (device, dtype code, vec, M, C, stat_rows), each with its
#: _Geometry: a training step asks for the same few shapes every time.
_plans: Dict[tuple, Tuple[Plan, _Geometry]] = {}


def _plan_for(lib, x, dtype, vec, stat_rows) -> Tuple[Plan, _Geometry]:
    key = (x.device.index, dtype, vec, *x.shape, stat_rows)
    found = _plans.get(key)
    if found is None:
        m, c = x.shape
        coresident, slab = device_limits(lib, x.device, dtype, vec)
        plan = launch_plan(m, c, vec, x.element_size(), stat_rows,
                           coresident=coresident, slab_bytes=slab)
        geometry = _Geometry(
            m, m if stat_rows is None else stat_rows, plan.stat_per,
            plan.rest_per, plan.smem_bytes, dtype, vec, c, plan.tx, plan.ty,
            plan.c_tiles, plan.chunks, plan.keep)
        found = _plans[key] = (plan, geometry)
    return found


def _fp32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _call(fn, dev, *args):
    """``fn(*args)`` with card ``dev`` current."""
    if dev == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _launch(x, scale, bias, eps, stat_rows) -> BNOutputs:
    lib = _library()
    c = x.shape[1]
    scale, bias = _fp32(scale), _fp32(bias)
    dtype = _DTYPES[x.dtype]
    plan, geometry = _plan_for(lib, x, dtype, vector_width(x), stat_rows)
    y = torch.empty_like(x)
    # Rows: mean, var, then the work buffer (chunk partials and mul).
    stats = torch.empty((2 * plan.chunks + 3, c), dtype=torch.float32,
                        device=x.device)
    dev = x.device.index
    args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            stats.data_ptr(), ctypes.addressof(geometry), eps,
            torch._C._cuda_getCurrentRawStream(dev))
    err = _call(lib.kft_bn_forward, dev, *args)
    _build.check(lib, err, "bn_forward launch")
    fused_bn_train_forward.launches += 1
    return y, stats[0], stats[1]


def _launch_stats(x, stat_rows) -> torch.Tensor:
    lib = _library()
    xs = x if stat_rows is None else x[:stat_rows]
    dtype = _DTYPES[x.dtype]
    # The fused launch's plan for these rows: its partial-sum order.
    plan, geometry = _plan_for(lib, xs, dtype, vector_width(x), None)
    sums = torch.empty((2, x.shape[1]), dtype=torch.float32,
                       device=x.device)
    work = torch.empty((2 * plan.chunks, x.shape[1]), dtype=torch.float32,
                       device=x.device)
    dev = x.device.index
    err = _call(lib.kft_bn_stats, dev, xs.data_ptr(), sums.data_ptr(),
                work.data_ptr(), ctypes.addressof(geometry),
                torch._C._cuda_getCurrentRawStream(dev))
    _build.check(lib, err, "bn_stats launch")
    bn_stats.launches += 1
    return sums


#: Apply geometries by (device, dtype code, vec, M, C, count).
_apply_geometries: Dict[tuple, _Geometry] = {}


def _apply_geometry(lib, x, dtype, vec, count) -> _Geometry:
    key = (x.device.index, dtype, vec, *x.shape, count)
    found = _apply_geometries.get(key)
    if found is None:
        m, c = x.shape
        groups = -(-c // vec)
        tx = min(TX_MAX, 1 << (groups - 1).bit_length())
        ty = THREADS // tx
        c_tiles = -(-groups // tx)
        coresident, _ = device_limits(lib, x.device, dtype, vec)
        # A few blocks an SM, each at least ty rows.
        chunks = max(1, min(4 * coresident // c_tiles, -(-m // ty)))
        per = -(-m // chunks)
        chunks = -(-m // per)
        found = _apply_geometries[key] = _Geometry(
            m, count, per, 0, 0, dtype, vec, c, tx, ty, c_tiles, chunks, 0)
    return found


def _launch_apply(x, sums, count, scale, bias, eps) -> BNOutputs:
    lib = _library()
    c = x.shape[1]
    scale, bias = _fp32(scale), _fp32(bias)
    geometry = _apply_geometry(lib, x, _DTYPES[x.dtype], vector_width(x),
                               count)
    y = torch.empty_like(x)
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    dev = x.device.index
    err = _call(lib.kft_bn_apply, dev, x.data_ptr(), sums.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                stats[0].data_ptr(), stats[1].data_ptr(),
                ctypes.addressof(geometry), eps,
                torch._C._cuda_getCurrentRawStream(dev))
    _build.check(lib, err, "bn_apply launch")
    bn_apply.launches += 1
    return y, stats[0], stats[1]


def _on_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the
    twin); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return True


def bn_stats(x: torch.Tensor, *,
             stat_rows: Optional[int] = None) -> torch.Tensor:
    """``[2, C]`` fp32 Σx and Σx² per channel over x's first
    ``stat_rows`` rows (all when None): the stats kernel on a CUDA
    tensor (with the fused launch's partial-sum order), the plain twin
    on a CPU one. Not differentiable (the sync route's gradient is
    :func:`sync_bn_train_forward`'s)."""
    _check_inputs(x, x.new_empty(x.shape[1]), x.new_empty(x.shape[1]),
                  stat_rows)
    if not _on_device(x, "bn_stats"):
        return reference_bn_stats(x, stat_rows)
    return _launch_stats(x, stat_rows)


def bn_apply(x: torch.Tensor, sums: torch.Tensor, count: int,
             scale: torch.Tensor, bias: torch.Tensor, *,
             eps: float = 1e-5) -> BNOutputs:
    """(y, mean, var) of every row of x from per-channel sums ``[2, C]``
    (fp32, contiguous) over ``count`` rows: the apply kernel on a CUDA
    tensor, the plain twin on a CPU one. Not differentiable."""
    _check_inputs(x, scale, bias, None)
    c = x.shape[1]
    if (tuple(sums.shape) != (2, c) or sums.dtype != torch.float32
            or not sums.is_contiguous() or sums.device != x.device):
        raise ValueError(f"sums must be contiguous fp32 [2, {c}] on x's "
                         f"device; got {tuple(sums.shape)} {sums.dtype}")
    if count < 1:
        raise ValueError(f"count {count} < 1")
    if not _on_device(x, "bn_apply"):
        return reference_bn_apply(x, sums, count, scale, bias, eps=eps)
    return _launch_apply(x, sums, count, scale, bias, eps)


#: Kernel launches since the counts were last set to 0.
bn_stats.launches = 0
bn_apply.launches = 0


class _SyncBNTrainForward(torch.autograd.Function):
    """stats → all-reduce → apply; the backward recomputes through the
    apply twin and all-reduces the gradient of the sums before it flows
    into this rank's stat rows (every rank's backward reaches it at the
    same layer, so the collectives line up)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, stat_rows, count, reduce):
        ctx.set_materialize_grads(False)
        if stat_rows == 0:
            sums = torch.zeros((2, x.shape[1]), dtype=torch.float32,
                               device=x.device)
        else:
            sums = bn_stats(x, stat_rows=stat_rows)
        reduce(sums)
        y, mean, var = bn_apply(x, sums, count, scale, bias, eps=eps)
        ctx.save_for_backward(x, scale, bias, sums)
        ctx.eps, ctx.stat_rows, ctx.count, ctx.reduce = (
            eps, stat_rows, count, reduce)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        wanted = ctx.needs_input_grad[:3]
        pairs = [(i, g) for i, g in enumerate((gy, gmean, gvar))
                 if g is not None]
        if not pairs or not any(wanted):
            return (None,) * 7
        x, scale, bias, sums = ctx.saved_tensors
        with torch.enable_grad(), record_function("bn_backward_recompute"):
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip((x, scale, bias), wanted)]
            total = sums.detach().requires_grad_(wanted[0])
            outs = reference_bn_apply(inputs[0], total, ctx.count,
                                      inputs[1], inputs[2], eps=ctx.eps)
            leaves = [t for t, w in zip(inputs, wanted) if w]
            if wanted[0]:
                leaves.append(total)
            got = list(torch.autograd.grad(
                [outs[i] for i, _ in pairs], leaves,
                [g for _, g in pairs], allow_unused=True))
            grads = [got.pop(0) if w else None for w in wanted]
            if wanted[0]:
                # d(global sums)/d(this rank's stat rows), with the sums'
                # gradient summed over every rank's loss.
                g_sums = got.pop(0)
                g_sums = (torch.zeros_like(sums) if g_sums is None
                          else g_sums.contiguous())
                ctx.reduce(g_sums)
                if ctx.stat_rows != 0:
                    xs = inputs[0]
                    part = reference_bn_stats(xs, ctx.stat_rows)
                    (g_x,) = torch.autograd.grad(part, xs, g_sums)
                    grads[0] = g_x if grads[0] is None else grads[0] + g_x
        return (*grads, None, None, None, None)


def sync_bn_train_forward(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, *, eps: float = 1e-5,
                          stat_rows: Optional[int] = None, count: int,
                          reduce) -> BNOutputs:
    """Batch norm over a batch split across ranks: [M, C] x (this rank's
    rows) → (y, mean, var) with the statistics of every rank's stat rows.
    This rank's stat rows are its first ``stat_rows`` (all when None, 0
    for none); ``count`` is the stat-row count over every rank;
    ``reduce(t)`` sums a tensor in place over the ranks (an all-reduce
    over the mesh's batch axes). A CUDA tensor runs the stats and apply
    kernels, a CPU one their twins. Differentiable in x, scale and bias."""
    _check_inputs(x, scale, bias, stat_rows or None)
    return _SyncBNTrainForward.apply(x, scale, bias, eps, stat_rows, count,
                                     reduce)


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
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _BNTrainForward.apply(x, scale, bias, eps, stat_rows)
    return _launch(x, scale, bias, eps, stat_rows)


#: Kernel launches since the count was last set to 0.
fused_bn_train_forward.launches = 0
