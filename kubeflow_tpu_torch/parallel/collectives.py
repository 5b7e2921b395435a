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

"""The collectives the mesh trainers and the tensor-parallel model issue.

Where the reference lets XLA insert them, the port calls these: a sum
over the batch axes (the gradient all-reduce, the global token count of
a masked loss), an all-gather and reduce-scatter of one leaf along its
sharded dims, the global norm of sharded leaves, and the tensor axis's
Megatron pair (:func:`copy_to_tensor` before a column-parallel product,
:func:`reduce_from_tensor` after a row-parallel one) with
:func:`gather_from_tensor` for the vocab-split head. A leaf may be
split over several axes at once (a q kernel on ``fsdp=2, tensor=2``:
its embed dim over fsdp, its heads over tensor); :func:`dims_by_axis`
names each. Each is one ``torch.distributed`` call that nccl and gloo
both run (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``), so a gloo gang on the CPU runs the code the
card runs; a gloo gang whose ranks share one card (nccl refuses two
ranks on one device) gathers by an ``all_reduce`` of a zeroed buffer,
the one gloo collective documented for CUDA tensors beside
``broadcast``. On a mesh with no process group (a mesh of one) each is
the identity. On an nccl group of one rank each batch-axis collective
is still launched: a one-rank sum is a copy, so the meshed step keeps
the unmeshed step's bits. A tensor axis of 1 issues no collective.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from kubeflow_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
    Sharding,
    tensor_group,
    tensor_rank,
)


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


#: The axes a param may be split over.
PARAM_AXES = ("fsdp", "tensor")


def dims_by_axis(sharding: Optional[Sharding]) -> Dict[str, int]:
    """A leaf's split dims by mesh axis (``{"fsdp": 1, "tensor": 0}``
    for a q kernel in the port's layout on ``fsdp=2, tensor=2``); empty
    for a replicated leaf. A dim split over two axes at once, or over a
    model axis the port does not run, raises."""
    if sharding is None:
        return {}
    out = {}
    for dim, axes in sharding.sharded_dims().items():
        if len(axes) != 1 or axes[0] not in PARAM_AXES:
            raise NotImplementedError(
                f"a leaf split over {axes}: the port's params split over "
                f"fsdp and tensor, one axis a dim (the other model axes "
                f"are ROADMAP A18)")
        out[axes[0]] = dim
    return out


def fsdp_dim(sharding: Optional[Sharding]) -> Optional[int]:
    """The dim a leaf splits over ``fsdp``, or None."""
    return dims_by_axis(sharding).get("fsdp")


def gather_leaf(shard: torch.Tensor, sharding: Optional[Sharding],
                mesh: Mesh, axes: Sequence[str] = PARAM_AXES
                ) -> torch.Tensor:
    """The leaf gathered over each of ``axes`` it is split on (default:
    every one, the whole leaf); a trainer's forward gathers ``fsdp``
    alone and keeps the tensor pieces its model computes on."""
    out = shard
    for axis, dim in dims_by_axis(sharding).items():
        if axis in axes:
            out = all_gather_dim(out, mesh, dim, axis)
    return out


def reduce_grad(grad: torch.Tensor, sharding: Optional[Sharding],
                mesh: Mesh) -> torch.Tensor:
    """A leaf's gradient from this rank's rows (whole over fsdp, this
    rank's piece over tensor) → the gradient of the global batch for
    this rank's piece: reduce-scattered over fsdp and summed over the
    other batch axes for an fsdp leaf, summed over every batch axis for
    one whole over fsdp. The tensor pieces' gradients are their own
    (the model's collectives have summed what the tensor ranks share)."""
    dim = fsdp_dim(sharding)
    if dim is None:
        return all_reduce_sum(grad, mesh)
    piece = reduce_scatter_dim(grad, mesh, dim)
    return all_reduce_sum(piece, mesh, ("dcn_data", "data"))


def norm_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes a sharded norm sums its leaves' squares over: fsdp, and
    tensor where it is live (a mesh without a tensor axis keeps the
    fsdp line's group, and so its bits)."""
    return PARAM_AXES if mesh.shape["tensor"] > 1 else ("fsdp",)


def counts_here(sharding: Optional[Sharding], mesh: Mesh) -> bool:
    """Whether this rank adds a leaf's term to a sum over
    :func:`norm_axes`: on every such axis the leaf is not split over,
    only position 0 does, so each element enters once."""
    split = dims_by_axis(sharding)
    coords = mesh.coords()
    return all(coords[a] == 0 for a in norm_axes(mesh) if a not in split)


def sharded_global_norm(tensors: Mapping[str, torch.Tensor],
                        shardings: Mapping[str, Optional[Sharding]],
                        mesh: Mesh) -> torch.Tensor:
    """``optax.global_norm`` of leaves held as this rank's pieces: each
    leaf's Σx² summed over every axis it is split on, and counted once
    where it is replicated (:func:`counts_here`). The terms are added in
    the leaves' order, as ``training/optim.global_norm`` adds them, so a
    mesh whose leaves are all whole gives that function's bits."""
    if not tensors:
        return torch.zeros(())
    terms = []
    for k, x in tensors.items():
        s = (x * x).sum()
        if not counts_here(shardings.get(k), mesh):
            s = torch.zeros_like(s)
        terms.append(s)
    stacked = all_reduce_sum(torch.stack(terms), mesh, norm_axes(mesh))
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
               shardings: Mapping[str, Optional[Sharding]],
               local: Optional[Mapping[str, Sequence[int]]] = None
               ) -> Dict[str, torch.Tensor]:
    """This rank's pieces of a tree (a leaf without a sharding is kept
    as it is). ``local`` (a tensor-parallel model's parameter shapes:
    the rank's tensor piece, whole over fsdp) lets a leaf be given as
    its tensor piece, or as its piece over every axis, and be cut only
    where it is still whole."""
    out = {}
    for k, v in tree.items():
        sh = shardings.get(k)
        if sh is None or sh.replicated:
            out[k] = v
            continue
        shape = None if local is None else local.get(k)
        piece = v
        for axis, dim in dims_by_axis(sh).items():
            parts = sh.mesh.shape[axis]
            if shape is not None and (
                    (axis == "tensor" and v.shape[dim] == shape[dim])
                    or (axis == "fsdp"
                        and v.shape[dim] * parts == shape[dim])):
                continue
            piece = piece[sh.only((axis,)).index(tuple(piece.shape))]
        out[k] = piece.contiguous().clone() if piece is not v else v
    return out


# -- the tensor axis ------------------------------------------------------------

def _tensor_line(mesh: Optional[Mesh]):
    """``(group, size, rank)`` of this rank's tensor line, or None where
    no tensor collective is issued (no mesh, a tensor axis of 1, or no
    process group)."""
    if mesh is None:
        return None
    group = tensor_group(mesh)
    if group is None:
        return None
    return group, mesh.shape["tensor"], tensor_rank(mesh)


def _sum_in_place(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the tensor line, in place. Two ranks' sum is an
    all-reduce (a + b is b + a). Over more, an all-reduce's order of
    additions follows how the library splits the buffer, which depends
    on its size, so a row summed in a batch of 4 could differ from the
    same row alone; the pieces are gathered instead and added in rank
    order, which gives every rank, and every batch, the same bits."""
    size = _dist().get_world_size(group)
    if size <= 2:
        _dist().all_reduce(t, group=group)
        return t
    parts = _gather_last(t.unsqueeze(-1), group, size,
                         _dist().get_rank(group))
    total = parts[..., 0]
    for i in range(1, size):
        total = total + parts[..., i]
    return t.copy_(total)


def _gather_last(x: torch.Tensor, group, size: int, rank: int
                 ) -> torch.Tensor:
    """The tensor line's pieces of ``x`` joined on its last dim, in
    rank order."""
    x = x.contiguous()
    if x.is_cuda and _dist().get_backend(group) == "gloo":
        # Ranks sharing a card run gloo, whose documented CUDA
        # collectives are all_reduce and broadcast: each rank writes its
        # piece into a zeroed [T, ...] buffer and the sum is the gather
        # (x + 0 is x).
        buf = torch.zeros((size, *x.shape), dtype=x.dtype, device=x.device)
        buf[rank] = x
        _dist().all_reduce(buf, group=group)
    else:
        buf = torch.empty((size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _dist().all_gather_into_tensor(buf, x, group=group)
        buf = buf.view(size, *x.shape)
    return buf.movedim(0, -2).reshape(*x.shape[:-1], size * x.shape[-1])


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_in_place(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_in_place(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.size, ctx.rank = size, rank
        return _gather_last(x, group, size, rank)

    @staticmethod
    def backward(ctx, grad):
        piece = grad.shape[-1] // ctx.size
        return (grad[..., ctx.rank * piece:(ctx.rank + 1) * piece]
                .contiguous(), None, None, None)


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_tensor(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The input of a column-parallel product (or a weight every tensor
    rank holds whole but uses a part of): the identity forward, its
    gradient summed over the tensor line backward."""
    line = _tensor_line(mesh)
    if line is None or not _recorded(x):
        return x
    return _CopyToTensor.apply(x, line[0])


def reduce_from_tensor(x: torch.Tensor, mesh: Optional[Mesh]
                       ) -> torch.Tensor:
    """A row-parallel product's partial sums (or the vocab-split
    embedding's rows, zeros off the rank's range) summed over the tensor
    line; the gradient passes through. Outside autograd the sum is taken
    in place."""
    line = _tensor_line(mesh)
    if line is None:
        return x
    if not _recorded(x):
        return _sum_in_place(x if x.is_contiguous() else x.contiguous(),
                             line[0])
    return _ReduceFromTensor.apply(x, line[0])


def gather_from_tensor(x: torch.Tensor, mesh: Optional[Mesh]
                       ) -> torch.Tensor:
    """The tensor line's pieces joined on the last dim (the vocab-split
    head's logits); the gradient of this rank's piece is its slice."""
    line = _tensor_line(mesh)
    if line is None:
        return x
    if not _recorded(x):
        return _gather_last(x, *line)
    return _GatherFromTensor.apply(x, *line)
