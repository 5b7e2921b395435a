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

"""Ring attention and Ulysses all-to-all: sequence parallelism on a gang.

The port of ``kubeflow_tpu/parallel/ring_attention.py``. The reference
runs each strategy inside ``jax.shard_map`` over the mesh; here every
rank of the gang is a process holding one position of the mesh, so the
strategies take the rank's shards and the mesh, and issue the
collectives of ``parallel/collectives.py`` themselves:

- **Ring** (:func:`ring_attention`): each rank on the ``seq`` axis holds
  one sequence shard of Q/K/V; the KV shards (and their padding mask)
  rotate round the ring by :func:`~kubeflow_tpu_torch.parallel.
  collectives.ppermute` while each rank folds every shard into its
  queries' online softmax with the plain
  :func:`~kubeflow_tpu_torch.ops.attention.attention_block_update`, the
  reference's step, which it runs in XLA and not in Pallas. No shift
  follows the last step. The flash kernel is not launched.
- **Ulysses** (:func:`ulysses_attention`): re-shard sequence → heads by
  an all-to-all, run :func:`~kubeflow_tpu_torch.ops.flash_attention.
  flash_attention` over the whole sequence for H/N query heads and
  Hkv/N kv heads (the CUDA kernel on the card, its plain twin on the
  CPU; one launch a call), re-shard back. Both head counts must divide
  by the axis size, as the reference's tiled all-to-all requires.

:func:`make_sequence_parallel_attention` is the models' ``attention_fn``
hook: a function on the whole ``[B, L, H, D]`` that every rank of the
gang calls with the same tensors. Each rank takes its batch rows (over
the batch axes), its sequence shard (``seq``) and, for the ring, its
heads (``tensor``), runs the strategy, and all-gathers the output back
to the whole; each split's gradient is all-gathered, so the gradient
reaching the whole inputs is the whole gradient on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from kubeflow_tpu_torch.ops.attention import (
    attention_block_update,
    attention_finalize,
    attention_init_carry,
)
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.mesh import Mesh


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str = "seq",
    causal: bool = False,
    scale: Optional[float] = None,
    kv_segment_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ring attention over ``axis_name`` of ``mesh``, on this rank's
    shards ``[batch, seq_local, heads, head_dim]``: the global sequence
    laid out contiguously along the axis (rank i holds positions
    ``[i·L, (i+1)·L)``). ``kv_segment_valid`` is the local
    ``[batch, seq_local]`` 0/1 padding mask; it rotates with its KV
    shard."""
    b, l_local, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    n = mesh.shape[axis_name]
    my_idx = mesh.coords()[axis_name]
    q_offset = my_idx * l_local
    ring = (k, v) if kv_segment_valid is None else (k, v, kv_segment_valid)
    carry = attention_init_carry(b, l_local, h, d, device=q.device)
    for step in range(n):
        # After s shifts this rank holds the shard that started on rank
        # (i - s) mod n.
        src_idx = (my_idx - step) % n
        carry = attention_block_update(
            carry, q, ring[0], ring[1], scale=scale, q_offset=q_offset,
            kv_offset=src_idx * l_local, causal=causal,
            kv_segment_valid=ring[2] if len(ring) == 3 else None)
        if step < n - 1:
            ring = collectives.ppermute(ring, mesh, axis_name)
    o, _, l = carry
    return attention_finalize(o, l, q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str = "seq",
    causal: bool = False,
    scale: Optional[float] = None,
    kv_segment_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All-to-all sequence parallelism on this rank's shards
    ``[B, L/N, H, D]``: re-shard to ``[B, L, H/N, D]`` (the whole
    sequence, a head subset), run flash attention, re-shard back. Head
    counts must divide by the axis size. ``kv_segment_valid`` is the
    local ``[B, L/N]`` padding mask; every rank needs the whole one."""
    n = mesh.shape[axis_name]
    if n == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               kv_segment_valid=kv_segment_valid)
    for name, t in (("query", q), ("kv", k)):
        if t.shape[2] % n:
            raise ValueError(f"ulysses: {t.shape[2]} {name} heads do not "
                             f"split over {axis_name}={n}")

    def seq_to_heads(x):
        return collectives.all_to_all(x, mesh, axis_name, split_dim=2,
                                      concat_dim=1)

    full_mask = None
    if kv_segment_valid is not None:
        full_mask = collectives.gather_from(kv_segment_valid, mesh,
                                            (axis_name,), 1)
    o = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                        causal=causal, scale=scale,
                        kv_segment_valid=full_mask)
    return collectives.all_to_all(o, mesh, axis_name, split_dim=1,
                                  concat_dim=2)


STRATEGIES = {"ring": ring_attention, "ulysses": ulysses_attention}


def make_sequence_parallel_attention(
    mesh: Mesh,
    *,
    strategy: str = "ring",
    causal: bool = False,
    scale: Optional[float] = None,
    batch_axes: Sequence[str] = ("dcn_data", "data", "fsdp"),
    seq_axis: str = "seq",
    head_axis: Optional[str] = "tensor",
) -> Callable[..., torch.Tensor]:
    """``fn(q, k, v, *, kv_segment_valid=None)`` on the whole
    ``[B, L, H, D]`` (mask ``[B, L]``), which every rank of the gang calls
    with the same tensors: batch rows split over ``batch_axes``, the
    sequence over ``seq_axis``, heads (q's and kv's) over ``head_axis``
    for the ring only (Ulysses uses the heads for its own re-shard); the
    output is whole on every rank."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    inner = STRATEGIES[strategy]
    h_axis = head_axis if strategy == "ring" else None
    # (axes, dim) of each split, outermost first.
    splits = [(tuple(batch_axes), 0), ((seq_axis,), 1)]
    if h_axis is not None:
        splits.append(((h_axis,), 2))

    def shard(x, cuts):
        for axes, dim in cuts:
            x = collectives.scatter_to(x, mesh, axes, dim)
        return x

    def fn(q, k, v, *, kv_segment_valid=None):
        q, k, v = (shard(t, splits) for t in (q, k, v))
        mask = None
        if kv_segment_valid is not None:
            mask = shard((kv_segment_valid != 0).to(torch.int32),
                         splits[:2])
        o = inner(q, k, v, mesh=mesh, axis_name=seq_axis, causal=causal,
                  scale=scale, kv_segment_valid=mask)
        for axes, dim in reversed(splits):
            o = collectives.gather_from(o, mesh, axes, dim)
        return o

    return fn
