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

"""Mixture-of-Experts FFN (GShard-style top-k routing with capacity).

Port of ``kubeflow_tpu/ops/moe.py``. Static shapes: every expert has a
fixed number of token slots (its capacity); a token past it is dropped
(its FFN contribution is 0, and the block's residual carries it).
Dispatch and combine are products against one-hot tensors, the expert
FFNs batched products, all plain PyTorch: the reference computes them
in XLA, outside any Pallas kernel.

Routing runs within groups of tokens taken row-major over ``[b, s]``.
The router and its softmax are fp32. The load-balance loss (Switch
eq. 4) is *sown*: :func:`sow` appends it to the innermost active
:func:`collect_losses` collector, the reference's ``"losses"``
collection (``mutable=["losses"]``); outside one it is dropped, as Flax
drops a sow into a collection that is not mutable.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to_tensor,
    gather_from,
    reduce_from,
    reduce_from_tensor,
    scatter_to,
)
from kubeflow_tpu_torch.parallel.mesh import BATCH_AXES

_COLLECTORS = threading.local()


@contextlib.contextmanager
def collect_losses() -> Iterator[List[torch.Tensor]]:
    """A list that collects every loss sown by this thread inside the
    ``with`` block, in the order sown."""
    stack = getattr(_COLLECTORS, "stack", None)
    if stack is None:
        stack = _COLLECTORS.stack = []
    losses: List[torch.Tensor] = []
    stack.append(losses)
    try:
        yield losses
    finally:
        stack.pop()


def sow(loss: torch.Tensor) -> None:
    """Add ``loss`` to the innermost active collector, if any."""
    stack = getattr(_COLLECTORS, "stack", None)
    if stack:
        stack[-1].append(loss)


def compute_capacity(tokens: int, num_experts: int, num_selected: int,
                     capacity_factor: float) -> int:
    """Per-expert token slots: even share × capacity factor, floor 4
    and rounded up to a multiple of 4."""
    ideal = tokens * num_selected / num_experts
    capacity = int(ideal * capacity_factor) + 1
    return max(4, -(-capacity // 4) * 4)


def top_k_dispatch(probs: torch.Tensor, num_selected: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine tensor of top-k routing with capacity.

    ``probs``: ``[..., T, E]`` fp32 router probabilities (leading dims
    are independent groups). Returns ``(combine [..., T, E, C] fp32,
    aux_fraction [..., E])``: ``combine`` carries the gate weight at each
    token's (expert, slot), renormalised over the kept choices when
    ``num_selected > 1`` (with one choice the raw probability stays, so
    the router gets a gradient from the main loss); ``aux_fraction`` is
    the fraction of tokens whose choices landed on each expert. A tie
    takes the first expert (argmax). A token's slot is its arrival rank
    among the round's tokens for that expert plus the slots earlier
    rounds filled."""
    *lead, t, e = probs.shape
    # XLA takes a mean as the sum times the fp32 reciprocal of the count.
    inv_t = float(np.float32(1) / np.float32(t))
    remaining = probs
    combine = torch.zeros((*lead, t, e, capacity), dtype=torch.float32,
                          device=probs.device)
    taken = torch.zeros((*lead, e), dtype=torch.int64, device=probs.device)
    chosen_fraction = torch.zeros((*lead, e), dtype=torch.float32,
                                  device=probs.device)
    kept_gate_sum = torch.zeros((*lead, t), dtype=torch.float32,
                                device=probs.device)
    for _ in range(num_selected):
        choice = torch.argmax(remaining, dim=-1)  # [..., T]
        onehot = F.one_hot(choice, e)  # [..., T, E] int64
        rank = torch.cumsum(onehot, dim=-2) - onehot
        pos = (torch.gather(rank, -1, choice[..., None])[..., 0]
               + torch.gather(taken, -1, choice))
        keep = pos < capacity
        gate = torch.gather(remaining, -1, choice[..., None])[..., 0]
        gate = torch.where(keep, gate, torch.zeros_like(gate))
        slot = F.one_hot(torch.clamp(pos, 0, capacity - 1),
                         capacity).float()  # [..., T, C]
        combine = combine + (gate[..., None, None]
                             * onehot.float()[..., None]
                             * slot[..., None, :])
        taken = taken + (onehot * keep[..., None]).sum(-2)
        chosen_fraction = chosen_fraction + onehot.float().sum(-2) * inv_t
        kept_gate_sum = kept_gate_sum + gate
        remaining = remaining * (1.0 - onehot.to(probs.dtype))
    if num_selected > 1:
        combine = combine / torch.clamp_min(kept_gate_sum,
                                            1e-9)[..., None, None]
    return combine, chosen_fraction / num_selected


def _fit_group_size(tokens: int, group_size: int) -> int:
    """Largest divisor of ``tokens`` ≤ ``group_size``."""
    group_size = min(group_size, tokens)
    for candidate in range(group_size, 0, -1):
        if tokens % candidate == 0:
            return candidate
    return tokens


class MoE(nn.Module):
    """Top-k routed expert FFN: ``[B, S, D] → [B, S, D]``.

    Params (the reference's names and layouts): ``router.weight``
    (``[E, D]``, the Flax ``router/kernel [D, E]`` transposed), ``w_in
    [E, D, F]`` and ``w_out [E, F, D]``, stored in ``param_dtype`` and
    cast at the op (the router to fp32, the experts to ``dtype``).

    ``mesh`` (a gang's, ``parallel/mesh.py``) builds this rank's part of
    the layout the reference's shardings give GSPMD: tokens split over
    the batch axes and whole over ``expert`` and ``tensor``; the experts
    split over ``expert`` (``w_in``, ``w_out``: this rank's E/X
    experts) and their hidden width over ``tensor`` (F/T); the router
    whole. Each rank routes and dispatches its batch position's tokens,
    runs its own experts' FFN on its F/T columns (the ``w_out``
    product's partial sums added over the tensor line), and the experts'
    outputs are all-gathered over the expert line for the whole combine
    (:meth:`_experts`): every rank of the line then holds the whole
    router gradient, which no line sums again, so the aux term is
    counted once. Routing groups are the global batch's, taken
    row-major over the global ``[B, S]``: where a group lies within a
    rank's rows (its tokens a multiple of the group) each rank routes
    its own groups; where groups straddle batch ranks, the tokens and
    their router probabilities are all-gathered over the batch line and
    every rank routes the whole batch and keeps its rows. The
    load-balance loss is the global batch's: the two means of Switch
    eq. 4 summed over the batch axes before their product.
    """

    def __init__(self, d_model: int, num_experts: int, mlp_dim: int,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 group_size: int = 512, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = None, device=None, mesh=None):
        super().__init__()
        self.num_experts = num_experts
        self.num_selected = num_selected
        self.capacity_factor = capacity_factor
        self.group_size = group_size
        self.dtype = dtype
        self.mesh = mesh
        experts, width = num_experts, mlp_dim
        if mesh is not None:
            x, t = mesh.shape["expert"], mesh.shape["tensor"]
            for what, n, parts in (("num_experts", num_experts, x),
                                   ("mlp_dim", mlp_dim, t)):
                if n % parts:
                    raise ValueError(f"{what} {n} does not split over "
                                     f"{parts} ranks")
            experts, width = num_experts // x, mlp_dim // t
        store = param_dtype or dtype
        self.router = nn.Linear(d_model, num_experts, bias=False,
                                dtype=store, device=device)
        self.w_in = nn.Parameter(torch.empty(
            experts, d_model, width, dtype=store, device=device))
        self.w_out = nn.Parameter(torch.empty(
            experts, width, d_model, dtype=store, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            return self._meshed(x)
        b, s, d = x.shape
        tokens = b * s
        group = _fit_group_size(tokens, self.group_size)
        grouped = x.reshape(tokens // group, group, d)
        logits = F.linear(grouped.float(), self.router.weight.float())
        probs = torch.softmax(logits, dim=-1)  # [n, G, E]
        capacity = compute_capacity(group, self.num_experts,
                                    self.num_selected, self.capacity_factor)
        combine, fraction = top_k_dispatch(probs, self.num_selected,
                                           capacity)
        sow(self.num_experts * torch.sum(fraction.mean(0)
                                         * probs.mean((0, 1))))
        return self._experts(grouped, combine).reshape(b, s, d)

    def _experts(self, grouped: torch.Tensor,
                 combine: torch.Tensor) -> torch.Tensor:
        """The experts' FFN of ``grouped [n, G, d]`` tokens under
        ``combine [n, G, E, C]``. On a mesh every rank of an expert line
        holds the same tokens: each dispatches all of them, runs its own
        E/X experts on its F/T hidden columns (the ``w_out`` product's
        partial sums taken in fp32 and added over the tensor line), and
        the experts' outputs are joined over the expert line before the
        combine. The dispatch and the combine are the whole layer's
        products, so on an expert axis alone a row's output and the
        router's gradient are the unmeshed layer's; each rank's expert
        pieces take their own gradients (the join's gradient is each
        rank's slice, the split's the whole)."""
        mesh = self.mesh
        dispatch = (combine > 0).to(self.dtype)  # [n, G, E, C]
        expert_in = torch.einsum("ngec,ngd->necd", dispatch,
                                 grouped.to(self.dtype))
        expert_in = copy_to_tensor(
            scatter_to(expert_in, mesh, ("expert",), 1), mesh)
        h = torch.einsum("necd,edf->necf", expert_in,
                         self.w_in.to(self.dtype))
        h = F.gelu(h, approximate="tanh")
        w_out = self.w_out.to(self.dtype)
        if mesh is not None and mesh.shape["tensor"] > 1:
            # The partial sums of the rank's hidden columns, in fp32 on
            # the compute dtype's values, added over the tensor line and
            # rounded once, as the whole product rounds its sum once.
            expert_out = reduce_from_tensor(torch.einsum(
                "necf,efd->necd", h.float(), w_out.float()), mesh).to(
                    self.dtype)
        else:
            expert_out = torch.einsum("necf,efd->necd", h, w_out)
        expert_out = gather_from(expert_out, mesh, ("expert",), 1)
        return torch.einsum("ngec,necd->ngd", combine.to(self.dtype),
                            expert_out)

    def _meshed(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        b, s, d = x.shape
        local = b * s
        ranks = mesh.axes_size(BATCH_AXES)
        tokens = local * ranks
        group = _fit_group_size(tokens, self.group_size)
        capacity = compute_capacity(group, self.num_experts,
                                    self.num_selected, self.capacity_factor)
        flat = x.reshape(local, d)
        probs = torch.softmax(F.linear(flat.float(),
                                       self.router.weight.float()), dim=-1)
        straddle = local % group != 0
        if straddle:
            # A group holds rows of more than one batch rank: route the
            # global batch on every rank and keep this rank's rows (the
            # gathers' gradients are this rank's slices).
            flat = gather_from(flat, mesh, BATCH_AXES, 0)
            probs = gather_from(probs, mesh, BATCH_AXES, 0)
        n = flat.shape[0] // group
        probs = probs.reshape(n, group, self.num_experts)
        combine, fraction = top_k_dispatch(probs, self.num_selected,
                                           capacity)
        if straddle or ranks == 1:
            aux = torch.sum(fraction.mean(0) * probs.mean((0, 1)))
        else:
            # Switch eq. 4 over the global batch: each mean's sum over
            # the batch line before the product (the fraction takes no
            # gradient; the probabilities' sum passes its gradient
            # through to each rank's own rows).
            frac = all_reduce_sum(fraction.sum(0).detach(), mesh)
            mass = reduce_from(probs.sum((0, 1)), mesh, BATCH_AXES)
            aux = torch.sum((frac / (tokens // group)) * (mass / tokens))
        sow(self.num_experts * aux)
        y = self._experts(flat.reshape(n, group, d), combine)
        y = y.reshape(n * group, d)
        if straddle:
            start = mesh.index(BATCH_AXES) * local
            y = y[start:start + local]
        return y.reshape(b, s, d)
