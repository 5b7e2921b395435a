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
sharded dims, the global norm of sharded leaves, and Megatron's pair
on a line of model axes (:func:`copy_to` before the
work a rank does a part of, :func:`reduce_from` after it: on the tensor
line before a column-parallel product and after a row-parallel one,
on the expert and tensor lines around an MoE's experts) with
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
the unmeshed step's bits. A model axis of 1 issues no collective.

The seq and pipeline axes add the reference's shift and exchange
(:func:`ppermute`: the ring's KV hop and the pipeline's stage hop, its
gradient the shift the other way; :func:`all_to_all`: Ulysses's
re-shard, its gradient the inverse exchange) and the sequence pair
(:func:`scatter_to` takes a rank's piece and all-gathers its gradient,
:func:`gather_from` joins the pieces and slices its gradient). Over
gloo on the CPU a shift is ``send``/``recv`` and an exchange
``all_to_all_single``; over nccl ``batch_isend_irecv`` and
``all_to_all_single``; over gloo on CUDA each goes through an
all-reduce of a zeroed buffer with n slots (n times the bytes).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    BATCH_AXES,
    Mesh,
    Sharding,
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
    line = _line(mesh, (axis,))
    return shard if line is None else _gather_dim(shard, line, dim)


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


#: The axes a param may be split over (``pipeline``: a pipeline
#: trainer's stacked stages; ``expert``: an MoE layer's experts).
PARAM_AXES = ("fsdp", "pipeline", "expert", "tensor")
#: The model axes whose pieces a model computes on (a trainer gathers
#: fsdp alone and keeps these).
MODEL_PARAM_AXES = ("expert", "tensor")


def dims_by_axis(sharding: Optional[Sharding]) -> Dict[str, int]:
    """A leaf's split dims by mesh axis (``{"fsdp": 1, "tensor": 0}``
    for a q kernel in the port's layout on ``fsdp=2, tensor=2``;
    ``{"expert": 0, "fsdp": 1, "tensor": 2}`` for an MoE ``w_in`` on
    ``fsdp=2, expert=2, tensor=2``); empty for a replicated leaf. A dim
    split over two axes at once, or over an axis no param splits over
    (``seq``, the batch axes but fsdp), raises."""
    if sharding is None:
        return {}
    out = {}
    for dim, axes in sharding.sharded_dims().items():
        if len(axes) != 1 or axes[0] not in PARAM_AXES:
            raise NotImplementedError(
                f"a leaf split over {axes}: the port's params split over "
                f"fsdp, pipeline, expert and tensor, one axis a dim")
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
    rank's piece over expert and tensor) → the gradient of the global
    batch for this rank's piece: reduce-scattered over fsdp and summed
    over the other batch axes for an fsdp leaf, summed over every batch
    axis for one whole over fsdp. Nothing is summed over a model axis:
    an expert or tensor piece's gradient is its own, and a leaf
    replicated over expert or tensor (the router, a norm) already holds
    the whole gradient on every rank of the line, because the model's
    Megatron pairs (:func:`copy_to`) summed what the line's ranks share
    where the activations entered their pieces. Summing it again would
    count the MoE's load-balance term once a rank of the line."""
    dim = fsdp_dim(sharding)
    if dim is None:
        return all_reduce_sum(grad, mesh)
    piece = reduce_scatter_dim(grad, mesh, dim)
    return all_reduce_sum(piece, mesh, ("dcn_data", "data"))


def norm_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes a sharded norm sums its leaves' squares over: fsdp, and
    pipeline, expert and tensor where they are live (a mesh without any
    keeps the fsdp line's group, and so its bits)."""
    return ("fsdp",) + tuple(a for a in ("pipeline", "expert", "tensor")
                             if mesh.shape[a] > 1)


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
    as it is). ``local`` (a model's parameter shapes: the rank's expert
    and tensor piece, whole over fsdp) lets a leaf be given as that
    piece, or as its piece over every axis, and be cut only where it is
    still whole."""
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
                    (axis in MODEL_PARAM_AXES
                     and v.shape[dim] == shape[dim])
                    or (axis == "fsdp"
                        and v.shape[dim] * parts == shape[dim])):
                continue
            piece = piece[sh.only((axis,)).index(tuple(piece.shape))]
        out[k] = piece.contiguous().clone() if piece is not v else v
    return out


# -- lines of the mesh ----------------------------------------------------------

def _line(mesh: Optional[Mesh], axes: Sequence[str]):
    """``(group, size, position)`` of this rank's mesh line over ``axes``
    (taken in :data:`AXIS_ORDER`, the first major), or None where no
    collective is issued (no mesh, the axes of size 1, or no process
    group)."""
    if mesh is None:
        return None
    axes = tuple(a for a in AXIS_ORDER if a in axes)
    size = mesh.axes_size(axes)
    if size == 1:
        return None
    group = mesh.group(axes)
    if group is None:
        return None
    return group, size, mesh.index(axes)


def _gloo_cuda(t: torch.Tensor, group) -> bool:
    """Ranks sharing a card run gloo, whose documented CUDA collectives
    are ``all_reduce`` and ``broadcast``: the other collectives of a
    CUDA tensor go through an all-reduce of a zeroed buffer there."""
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def _gather_dim(x: torch.Tensor, line, dim: int) -> torch.Tensor:
    """The line's pieces of ``x`` joined along ``dim`` in rank order. Over
    gloo on CUDA each rank writes its piece into a zeroed ``[n, ...]``
    buffer and the all-reduce is the gather (x + 0 is x)."""
    group, n, pos = line
    x = x.contiguous()
    if _gloo_cuda(x, group):
        buf = torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device)
        buf[pos] = x
        _dist().all_reduce(buf, group=group)
    else:
        buf = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        _dist().all_gather_into_tensor(buf, x, group=group)
        buf = buf.view(n, *x.shape)
    dim %= x.dim()
    return buf.movedim(0, dim).reshape(
        *x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])


# -- the Megatron pair on a model line -----------------------------------------

def _sum_in_place(t: torch.Tensor, line) -> torch.Tensor:
    """``t`` summed over the line, in place. Two ranks' sum is an
    all-reduce (a + b is b + a). Over more, an all-reduce's order of
    additions follows how the library splits the buffer, which depends
    on its size, so a row summed in a batch of 4 could differ from the
    same row alone; the pieces are gathered instead and added in rank
    order, which gives every rank, and every batch, the same bits."""
    group, size, _ = line
    if size <= 2:
        _dist().all_reduce(t, group=group)
        return t
    parts = _gather_dim(t.unsqueeze(-1), line, -1)
    total = parts[..., 0]
    for i in range(1, size):
        total = total + parts[..., i]
    return t.copy_(total)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_in_place(grad.contiguous().clone(), ctx.line), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        return _sum_in_place(x.contiguous().clone(), line)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str]
            ) -> torch.Tensor:
    """The first of Megatron's pair on the mesh line over ``axes``: the
    identity forward, the gradient summed over the line backward. It
    marks where a tensor every rank of the line holds whole enters work
    that each rank does a part of (a column-parallel product's input,
    an MoE's tokens and combine weights before a rank's own experts), so
    every rank's gradient of it is the whole one."""
    line = _line(mesh, axes)
    if line is None or not _recorded(x):
        return x
    return _CopyTo.apply(x, line)


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str]
                ) -> torch.Tensor:
    """The second of the pair: partial sums (a row-parallel product's, a
    rank's experts' share of an MoE's output, the vocab-split
    embedding's rows, zeros off the rank's range) summed over the mesh
    line over ``axes``; the gradient passes through. Outside autograd
    the sum is taken in place."""
    line = _line(mesh, axes)
    if line is None:
        return x
    if not _recorded(x):
        return _sum_in_place(x if x.is_contiguous() else x.contiguous(),
                             line)
    return _ReduceFrom.apply(x, line)


def copy_to_tensor(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """:func:`copy_to` on the tensor line: the input of a column-parallel
    product (or a weight every tensor rank holds whole but uses a part
    of)."""
    return copy_to(x, mesh, ("tensor",))


def reduce_from_tensor(x: torch.Tensor, mesh: Optional[Mesh]
                       ) -> torch.Tensor:
    """:func:`reduce_from` on the tensor line: a row-parallel product's
    partial sums, or the vocab-split embedding's rows."""
    return reduce_from(x, mesh, ("tensor",))


def gather_from_tensor(x: torch.Tensor, mesh: Optional[Mesh]
                       ) -> torch.Tensor:
    """The tensor line's pieces joined on the last dim (the vocab-split
    head's logits); the gradient of this rank's piece is its slice."""
    return gather_from(x, mesh, ("tensor",), -1)


# -- the seq and pipeline axes --------------------------------------------------

def _shift(t: torch.Tensor, line, shift: int, circular: bool
           ) -> torch.Tensor:
    """What this rank receives when each rank of the line sends ``t`` to
    the position ``shift`` ahead: the piece of the rank ``shift`` behind
    (wrapping round where ``circular``; zeros where no rank is there).
    Over gloo on CUDA it is an all-reduce of a zeroed ``[n, ...]``
    buffer with each rank's piece at its destination's slot: n times
    the bytes a send moves."""
    group, n, pos = line
    dst, src = pos + shift, pos - shift
    if circular:
        dst, src = dst % n, src % n
    t = t.contiguous()
    if _gloo_cuda(t, group):
        buf = torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
        if 0 <= dst < n:
            buf[dst] = t
        _dist().all_reduce(buf, group=group)
        return buf[pos].clone()
    out = torch.zeros_like(t)
    ops = []
    dist = _dist()
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, t,
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, shift, circular, *tensors):
        ctx.line, ctx.shift, ctx.circular = line, shift, circular
        out = tuple(_shift(t, line, shift, circular) for t in tensors)
        ctx.mark_non_differentiable(*(o for o in out
                                      if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *(
            _shift(g, ctx.line, -ctx.shift, ctx.circular) if want else None
            for g, want in zip(grads, ctx.needs_input_grad[3:])))


def ppermute(tensors, mesh: Optional[Mesh], axis: str, shift: int = 1,
             circular: bool = True):
    """The reference's ``lax.ppermute`` by ``shift`` positions along
    ``axis``: each rank sends its tensors to the rank ``shift`` ahead on
    the axis and gets those of the rank ``shift`` behind; ``circular``
    wraps round (the ring's ``(j, j + 1) % n``), else the first ranks
    get zeros and the last ones' tensors go nowhere (the pipeline's
    ``(i, i + 1)``). ``tensors`` is a tensor or a tuple of them, sent in
    one node of the graph; the gradient is the shift the other way. An
    axis of 1 (or no process group) is the identity where circular,
    zeros where not."""
    single = isinstance(tensors, torch.Tensor)
    items = (tensors,) if single else tuple(tensors)
    line = _line(mesh, (axis,))
    if line is None:
        out = items if circular else tuple(torch.zeros_like(t)
                                           for t in items)
    elif any(_recorded(t) for t in items):
        out = _PPermute.apply(line, shift, circular, *items)
    else:
        out = tuple(_shift(t, line, shift, circular) for t in items)
    return out[0] if single else out


def _all_to_all(x: torch.Tensor, line, split_dim: int, concat_dim: int
                ) -> torch.Tensor:
    group, n, pos = line
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    if _gloo_cuda(send, group):
        # [source, destination, ...] with this rank's row filled: n
        # times the bytes of the exchange.
        buf = torch.zeros((n, *send.shape), dtype=send.dtype,
                          device=send.device)
        buf[pos] = send
        _dist().all_reduce(buf, group=group)
        recv = buf[:, pos]
    else:
        recv = torch.empty_like(send)
        _dist().all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, split_dim, concat_dim):
        ctx.line, ctx.dims = line, (split_dim, concat_dim)
        return _all_to_all(x, line, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(grad, ctx.line, concat_dim, split_dim), None,
                None, None)


def all_to_all(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """The reference's tiled ``lax.all_to_all`` over ``axis``: ``x``'s
    ``split_dim`` cut into n chunks, chunk j sent to the axis's rank j,
    and the chunks received joined along ``concat_dim`` in the senders'
    order. A dim that does not split over the axis raises. The gradient
    is the inverse all-to-all."""
    line = _line(mesh, (axis,))
    if line is None:
        return x
    if _recorded(x):
        return _AllToAll.apply(x, line, split_dim, concat_dim)
    return _all_to_all(x, line, split_dim, concat_dim)


def _piece(x: torch.Tensor, line, dim: int) -> torch.Tensor:
    _, n, pos = line
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    width = x.shape[dim] // n
    return x.narrow(dim, pos * width, width).contiguous()


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _piece(x, line, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.line, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _gather_dim(x, line, dim)

    @staticmethod
    def backward(ctx, grad):
        return _piece(grad, ctx.line, ctx.dim), None, None


def scatter_to(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """This rank's piece of ``x`` (whole on every rank of the line over
    ``axes``) along ``dim``; the gradient, each rank's piece's, is
    all-gathered back to the whole."""
    line = _line(mesh, axes)
    if line is None:
        return x
    if _recorded(x):
        return _ScatterTo.apply(x, line, dim)
    return _piece(x, line, dim)


def gather_from(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str],
                dim: int) -> torch.Tensor:
    """The line's pieces along ``dim`` joined in rank order (the whole on
    every rank); the gradient of this rank's piece is its slice of the
    whole's."""
    line = _line(mesh, axes)
    if line is None:
        return x
    if _recorded(x):
        return _GatherFrom.apply(x, line, dim)
    return _gather_dim(x, line, dim)


def broadcast_from(t: torch.Tensor, mesh: Optional[Mesh], axis: str,
                   position: int) -> torch.Tensor:
    """``t`` of the rank at ``position`` on ``axis``, on every rank of
    the line (in place)."""
    line = _line(mesh, (axis,))
    if line is not None:
        _dist().broadcast(t, _dist().get_global_rank(line[0], position),
                          group=line[0])
    return t
