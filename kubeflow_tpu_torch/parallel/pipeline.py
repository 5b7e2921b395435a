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

"""Pipeline parallelism over the ``pipeline`` axis: GPipe and the
circular (interleaved) schedule.

The port of ``kubeflow_tpu/parallel/pipeline.py``. The reference runs
one SPMD loop inside ``shard_map``: every device runs its stage on every
tick and the schedule is arithmetic on the stage index. Here each rank
of the gang is a process holding its stage(s), and the same arithmetic
(:func:`slots`) tells it, tick by tick, which microbatch and virtual
stage it holds: it runs its stage only on the ticks where it is active,
and after every tick but the last each rank hands its output to the
next stage with :func:`~kubeflow_tpu_torch.parallel.collectives.
ppermute` (``(i, i + 1)`` for GPipe, ``(i, (i + 1) % n)`` for the
circular schedule, whose wrap carries a microbatch to its next virtual
stage). So the tick counts (``n_micro + n - 1``; the circular
schedule's ``((M-1)//n)·n·v + (M-1)%n + n·v``) and the bubble formulas
are the reference's.

The backward is the reverse schedule (in the reference, JAX's transpose
of the loop): the ticks in reverse order, each rank first receiving the
cotangent of its tick's output from the next stage (the shift the other
way), then running its stage's backward through the graph kept from the
forward, and sending its input's cotangent back. The last stage's
outputs reach every rank of the pipeline line (the reference's psum of
the masked outputs) by a broadcast; since every rank computes the same
loss from them, the last stage takes its own cotangent, and stage 0's
input cotangent is broadcast back, so a leaf before the pipeline (an
embedding) gets its gradient once, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.mesh import Mesh

Params = Dict[str, torch.Tensor]
StageFn = Callable[[Params, torch.Tensor], torch.Tensor]


def total_ticks(n_stages: int, n_microbatches: int,
                n_virtual: int = 1) -> int:
    """The loop's tick count: GPipe's ``n_micro + n - 1`` at
    ``n_virtual = 1``, the circular schedule's otherwise."""
    n, m, v = n_stages, n_microbatches, n_virtual
    return ((m - 1) // n) * n * v + (m - 1) % n + n * v


def slots(n_stages: int, idx: int, n_microbatches: int,
          n_virtual: int = 1) -> List[Optional[Tuple[int, int]]]:
    """For each tick, ``(microbatch, virtual stage)`` that device ``idx``
    holds, or None where it is idle: the reference's decode. ``K =
    floor((t - idx) / n)`` is the device's slot counter; it splits into
    (group, virtual stage), and the microbatch residue ``r = (t - idx)
    mod n`` completes the id. At ``n_virtual = 1`` it is GPipe's
    ``m = t - idx``."""
    n, v = n_stages, n_virtual
    out = []
    for t in range(total_ticks(n, n_microbatches, v)):
        r = (t - idx) % n
        big_k = (t - idx - r) // n
        m = (big_k // v) * n + r
        out.append((m, big_k % v) if big_k >= 0 and m < n_microbatches
                   else None)
    return out


class _Schedule:
    """One call's schedule on this rank, and the graphs its backward
    runs."""

    def __init__(self, stage_fn: StageFn, names: Sequence[str], mesh: Mesh,
                 axis_name: str, n_virtual: int, circular: bool,
                 stats: Optional[dict]):
        self.stage_fn, self.names = stage_fn, list(names)
        self.mesh, self.axis = mesh, axis_name
        self.v, self.circular, self.stats = n_virtual, circular, stats
        self.n = mesh.shape[axis_name]
        self.idx = mesh.coords()[axis_name]
        self.records: Dict[int, tuple] = {}

    def _hop(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        return collectives.ppermute(t, self.mesh, self.axis, shift,
                                    self.circular)

    def _timed(self, fn):
        if self.stats is None or not torch.cuda.is_available():
            return fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self.stats.setdefault("compute_events", []).append((start, end))
        return out

    def forward(self, microbatches: torch.Tensor,
                leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        n, idx, v = self.n, self.idx, self.v
        n_micro = microbatches.shape[0]
        self.grad_mb = microbatches.requires_grad
        self.params = [p.detach().requires_grad_(p.requires_grad)
                       for p in leaves]
        self.want = self.grad_mb or any(p.requires_grad for p in leaves)
        self.shape = microbatches.shape
        plan = slots(n, idx, n_micro, v)
        self.ticks = len(plan)
        state = torch.zeros_like(microbatches[0])
        outputs: List[Optional[torch.Tensor]] = [None] * n_micro
        for t, slot in enumerate(plan):
            send = None
            if slot is not None:
                m, virt = slot
                ingest = idx == 0 and virt == 0
                inp = (microbatches[m] if ingest else state).detach()
                inp.requires_grad_(self.want and (self.grad_mb
                                                  or not ingest))
                with torch.set_grad_enabled(self.want):
                    stage = {k: p[virt, 0] if self.circular else p[0]
                             for k, p in zip(self.names, self.params)}
                    out = self._timed(lambda: self.stage_fn(stage, inp))
                if self.want:
                    self.records[t] = (m, virt, inp, out)
                send = out.detach()
                if idx == n - 1 and virt == v - 1:
                    outputs[m] = send
            if t < len(plan) - 1:
                state = self._hop(torch.zeros_like(state) if send is None
                                  else send, 1)
        if self.stats is not None:
            self.stats["ticks"] = self.stats.get("ticks", 0) + len(plan)
            self.stats["active"] = self.stats.get("active", 0) + sum(
                s is not None for s in plan)
        if idx == n - 1:
            result = torch.stack(outputs)
        else:
            result = torch.zeros_like(microbatches)
        return collectives.broadcast_from(result, self.mesh, self.axis,
                                          n - 1)

    def backward(self, grad: torch.Tensor):
        n, idx, v = self.n, self.idx, self.v
        grads: List[Optional[torch.Tensor]] = [
            torch.zeros_like(p) if p.requires_grad else None
            for p in self.params]
        g_mb = (torch.zeros(self.shape, dtype=grad.dtype, device=grad.device)
                if self.grad_mb else None)
        g_send = None
        zeros = torch.zeros(self.shape[1:], dtype=grad.dtype,
                            device=grad.device)
        for t in reversed(range(self.ticks)):
            g_recv = None
            if t < self.ticks - 1:
                g_recv = self._hop(zeros if g_send is None else g_send, -1)
            g_send = None
            rec = self.records.pop(t, None)
            if rec is None:
                continue
            m, virt, inp, out = rec
            g_out = grad[m] if idx == n - 1 and virt == v - 1 else g_recv
            targets = [p for p in self.params if p.requires_grad]
            if inp.requires_grad:
                targets.append(inp)
            got = self._timed(lambda: torch.autograd.grad(
                out, targets, g_out, allow_unused=True))
            it = iter(got)
            for i, p in enumerate(self.params):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        grads[i] += g
            if inp.requires_grad:
                g_inp = next(it)
                if g_inp is None:
                    g_inp = torch.zeros_like(inp)
                if idx == 0 and virt == 0:
                    g_mb[m] += g_inp
                else:
                    g_send = g_inp
        if g_mb is not None:
            g_mb = collectives.broadcast_from(g_mb, self.mesh, self.axis, 0)
        return g_mb, grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule, microbatches, *leaves):
        ctx.schedule = schedule
        return schedule.forward(microbatches, leaves)

    @staticmethod
    def backward(ctx, grad):
        g_mb, grads = ctx.schedule.backward(grad.contiguous())
        ctx.schedule = None
        return (None, g_mb, *grads)


def _run(stage_fn, params: Params, x: torch.Tensor, mesh: Mesh,
         n_microbatches: int, axis_name: str, n_virtual: int,
         circular: bool, stats: Optional[dict]) -> torch.Tensor:
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} % microbatches {n_microbatches}")
    microbatches = x.reshape((n_microbatches, batch // n_microbatches)
                             + tuple(x.shape[1:]))
    names = list(params)
    schedule = _Schedule(stage_fn, names, mesh, axis_name, n_virtual,
                         circular, stats)
    leaves = [params[k] for k in names]
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in leaves)):
        out = _Pipeline.apply(schedule, microbatches, *leaves)
    else:
        out = schedule.forward(microbatches, leaves)
    return out.reshape((batch,) + tuple(out.shape[2:]))


def _own_stages(leaf: torch.Tensor, dim: int, n: int, idx: int
                ) -> torch.Tensor:
    """A stacked leaf's piece for this rank along its device dim: a
    whole leaf (``n`` there) is cut, a piece (1 there) kept."""
    if leaf.shape[dim] == n:
        return leaf.narrow(dim, idx, 1)
    if leaf.shape[dim] == 1:
        return leaf
    raise ValueError(f"stacked leaf {tuple(leaf.shape)}: dim {dim} is "
                     f"{leaf.shape[dim]}, not the pipeline's {n} (whole) "
                     f"or 1 (this rank's piece)")


def spmd_pipeline(
    stage_fn: StageFn,
    stacked_params: Params,
    x: torch.Tensor,
    *,
    mesh: Mesh,
    n_microbatches: int,
    axis_name: str = "pipeline",
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` copies of ``stage_fn`` (GPipe).

    ``stacked_params``: ``{name: leaf}`` with a leading stage dim, whole
    (``n_stages``: this rank takes its stage) or this rank's piece (1),
    as the reference's ``P(axis_name)`` gives each device its stage.
    ``x``: ``[batch, ...]``, the rows this rank feeds: the whole batch,
    or on a mesh with batch axes (pp × dp) the rows of its batch
    position, as the data source gives them (the reference's
    ``batch_axis`` sharding of the microbatch rows); batch must divide
    by ``n_microbatches``. Every rank of the pipeline line gets the
    output of the same shape as ``x``. ``stats`` (a dict) collects the
    ticks, the active ones and, on the card, CUDA events around each
    stage forward and backward."""
    n = mesh.shape[axis_name]
    idx = mesh.coords()[axis_name]
    params = {k: _own_stages(p, 0, n, idx)
              for k, p in stacked_params.items()}
    return _run(stage_fn, params, x, mesh, n_microbatches, axis_name, 1,
                False, stats)


def spmd_pipeline_interleaved(
    stage_fn: StageFn,
    stacked_params: Params,
    x: torch.Tensor,
    *,
    mesh: Mesh,
    n_microbatches: int,
    n_virtual: int,
    axis_name: str = "pipeline",
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """The interleaved (virtual-stage, circular) schedule: the contract
    of :func:`spmd_pipeline` with ``S = n_virtual · n_devices`` stages,
    device d holding the cyclic set ``{q·n + d}``. ``stacked_params``
    leaves are ``[n_virtual, n_devices, ...]`` (the layout of
    :func:`interleave_stage_params`) or this rank's ``[n_virtual, 1,
    ...]``. Each tick runs one virtual stage, so the idle share drops
    from GPipe's ``(n-1)/(M + n-1)`` to about ``(n-1)/(M·v + n-1)``
    (:func:`bubble_fraction_interleaved`), for v times the hops."""
    n = mesh.shape[axis_name]
    idx = mesh.coords()[axis_name]
    params = {}
    for k, p in stacked_params.items():
        if p.dim() < 2 or p.shape[0] != n_virtual:
            raise ValueError(
                f"stacked_params leading dims {tuple(p.shape[:2])} != "
                f"(n_virtual={n_virtual}, pipeline={n})")
        params[k] = _own_stages(p, 1, n, idx)
    return _run(stage_fn, params, x, mesh, n_microbatches, axis_name,
                n_virtual, True, stats)


def interleave_stage_params(stacked_params: Params,
                            n_devices: int) -> Params:
    """``[S, ...]``-stacked stage params → the ``[v, n_devices, ...]``
    layout :func:`spmd_pipeline_interleaved` takes (stage ``s = q·n + d``
    at ``[q, d]``: a reshape)."""
    out = {}
    for k, p in stacked_params.items():
        if p.shape[0] % n_devices:
            raise ValueError(
                f"stage count {p.shape[0]} % devices {n_devices}")
        out[k] = p.reshape((p.shape[0] // n_devices, n_devices)
                           + tuple(p.shape[1:]))
    return out


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe's idle share, ``(n_stages - 1) / (n_micro + n_stages - 1)``:
    of the loop's ``n_micro + n_stages - 1`` ticks a stage carries a
    live microbatch on ``n_micro``; the reverse schedule of the backward
    has the same share, so it is the whole step's."""
    if n_stages < 1 or n_microbatches < 1:
        raise ValueError(
            f"need n_stages >= 1 and n_microbatches >= 1; got "
            f"{n_stages}, {n_microbatches}")
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def bubble_fraction_interleaved(n_stages: int, n_microbatches: int,
                                n_virtual: int) -> float:
    """The circular schedule's idle share: ``(ticks - M·v) / ticks``
    over :func:`total_ticks`; ``(n-1)/(M·v + n-1)`` where n divides M."""
    if n_stages < 1 or n_microbatches < 1 or n_virtual < 1:
        raise ValueError(
            f"need n_stages, n_microbatches, n_virtual >= 1; got "
            f"{n_stages}, {n_microbatches}, {n_virtual}")
    ticks = total_ticks(n_stages, n_microbatches, n_virtual)
    return (ticks - n_microbatches * n_virtual) / ticks


def stack_stage_params(param_list: Sequence[Params]) -> Params:
    """Per-stage ``{name: leaf}`` trees stacked into one with a leading
    stage dim (the layout :func:`spmd_pipeline` takes)."""
    return {k: torch.stack([p[k] for p in param_list])
            for k in param_list[0]}


def stage_piece(stacked_params: Params, mesh: Mesh, n_virtual: int = 1,
                axis_name: str = "pipeline") -> Dict[str, Any]:
    """This rank's piece of whole stacked params (a copy): ``[1, ...]``
    for GPipe, ``[v, 1, ...]`` interleaved."""
    n = mesh.shape[axis_name]
    idx = mesh.coords()[axis_name]
    dim = 0 if n_virtual == 1 else 1
    return {k: _own_stages(p, dim, n, idx).contiguous().clone()
            for k, p in stacked_params.items()}
