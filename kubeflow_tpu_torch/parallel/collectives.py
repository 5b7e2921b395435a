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

"""The collectives the mesh trainers issue, over a :class:`Mesh`'s axes.

Where the reference lets XLA insert them, the port's trainers call
these: a sum over the batch axes (the gradient all-reduce, the global
token count of a masked loss), an fsdp all-gather and reduce-scatter of
one leaf along its sharded dim, and the global norm of sharded leaves.
Each is one ``torch.distributed`` call that nccl and gloo both run
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``),
so a gloo gang on the CPU runs the code the card runs. On a mesh with
no process group (a mesh of one) each is the identity. On an nccl group
of one rank each is still launched: a one-rank sum is a copy, so the
meshed step keeps the unmeshed step's bits.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from kubeflow_tpu_torch.parallel.mesh import BATCH_AXES, Mesh, Sharding


def _dist():
    return torch.distributed


def all_reduce_sum(t: torch.Tensor, mesh: Mesh,
                   axes: Sequence[str] = BATCH_AXES) -> torch.Tensor:
    """``t`` summed in place over the mesh line along ``axes``."""
    group = mesh.group(axes)
    if group is not None:
        _dist().all_reduce(t, group=group)
    return t


def batch_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``t`` over the batch axes (a new tensor)."""
    return all_reduce_sum(t.clone(), mesh) / mesh.axes_size(BATCH_AXES)


def all_gather_dim(shard: torch.Tensor, mesh: Mesh, dim: int,
                   axis: str = "fsdp") -> torch.Tensor:
    """The whole leaf from each rank's piece along ``dim`` over
    ``axis``, in the axis's order."""
    group = mesh.group((axis,))
    parts = mesh.shape[axis]
    if group is None or parts == 1:
        return shard
    front = shard.movedim(dim, 0).contiguous()
    out = torch.empty((parts * front.shape[0], *front.shape[1:]),
                      dtype=front.dtype, device=front.device)
    _dist().all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(full: torch.Tensor, mesh: Mesh, dim: int,
                       axis: str = "fsdp") -> torch.Tensor:
    """``full`` summed over ``axis``, this rank's piece along ``dim``."""
    group = mesh.group((axis,))
    parts = mesh.shape[axis]
    if group is None or parts == 1:
        return full
    front = full.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // parts, *front.shape[1:]),
                      dtype=front.dtype, device=front.device)
    _dist().reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def fsdp_dim(sharding: Optional[Sharding]) -> Optional[int]:
    """The dim a leaf splits over ``fsdp``, or None (replicated). Any
    other live axis raises: the trainers run the batch axes only."""
    if sharding is None:
        return None
    dims = sharding.sharded_dims()
    for dim, axes in dims.items():
        if axes != ("fsdp",):
            raise NotImplementedError(
                f"a leaf split over {axes}: only fsdp shards params in the "
                f"port's trainers (the model axes are ROADMAP A18)")
    return next(iter(dims), None)


def gather_leaf(shard: torch.Tensor, sharding: Optional[Sharding],
                mesh: Mesh) -> torch.Tensor:
    dim = fsdp_dim(sharding)
    return shard if dim is None else all_gather_dim(shard, mesh, dim)


def reduce_grad(grad: torch.Tensor, sharding: Optional[Sharding],
                mesh: Mesh) -> torch.Tensor:
    """A whole leaf's gradient from this rank's rows → the gradient of
    the global batch for this rank's piece: reduce-scattered over fsdp
    and summed over the other batch axes for an fsdp leaf, summed over
    every batch axis for a replicated one."""
    dim = fsdp_dim(sharding)
    if dim is None:
        return all_reduce_sum(grad, mesh)
    piece = reduce_scatter_dim(grad, mesh, dim)
    return all_reduce_sum(piece, mesh, ("dcn_data", "data"))


def sharded_global_norm(tensors: Mapping[str, torch.Tensor],
                        shardings: Mapping[str, Optional[Sharding]],
                        mesh: Mesh) -> torch.Tensor:
    """``optax.global_norm`` of leaves held as this rank's pieces: each
    leaf's Σx² summed over ``fsdp`` where the leaf is split there, and
    counted once where it is replicated (its term enters on the first
    fsdp rank only). The terms are added in the leaves' order, as
    ``training/optim.global_norm`` adds them, so a mesh whose leaves are
    all whole gives that function's bits."""
    if not tensors:
        return torch.zeros(())
    first = mesh.coords()["fsdp"] == 0
    terms = []
    for k, x in tensors.items():
        s = (x * x).sum()
        if fsdp_dim(shardings.get(k)) is None and not first:
            s = torch.zeros_like(s)
        terms.append(s)
    stacked = all_reduce_sum(torch.stack(terms), mesh, ("fsdp",))
    total = stacked[0]
    for i in range(1, len(terms)):
        total = total + stacked[i]
    return torch.sqrt(total)


def norm_fn(shardings: Mapping[str, Optional[Sharding]], mesh: Mesh):
    """:func:`sharded_global_norm` over ``shardings``, as the
    ``global_norm`` of ``training/optim.py``'s ``sharded_norm``."""
    return lambda tensors: sharded_global_norm(tensors, shardings, mesh)


def global_sum(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A scalar's sum over the batch axes, as a new fp32 tensor."""
    return all_reduce_sum(value.detach().float().clone(), mesh)


def shard_tree(tree: Mapping[str, torch.Tensor],
               shardings: Mapping[str, Optional[Sharding]]
               ) -> Dict[str, torch.Tensor]:
    """This rank's pieces of a whole tree (a leaf without a sharding is
    kept as it is)."""
    out = {}
    for k, v in tree.items():
        sh = shardings.get(k)
        out[k] = v if sh is None or sh.replicated else sh.shard(v)
    return out
