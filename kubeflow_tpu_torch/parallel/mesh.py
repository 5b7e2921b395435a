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

"""The device mesh of a gang, and sharding presets.

The port of ``kubeflow_tpu/parallel/mesh.py``. The reference shards one
SPMD program over a ``jax.sharding.Mesh`` of the devices of every
process; here one process drives one device, so the mesh's positions are
the ranks of a ``torch.distributed`` group (an nccl gang on the card, a
gloo gang on the CPU), laid out row-major over :data:`AXIS_ORDER`:
``dcn_data`` outermost, ``tensor`` fastest, as the reference lays its
devices out. Rank r sits where the reference's device r sits.

Axis names (the reference's):

- ``dcn_data``: data parallelism across slices (outermost).
- ``data``: data parallelism within a slice.
- ``fsdp``: parameter sharding (ZeRO-3), also a batch axis.
- ``pipeline``, ``seq``, ``expert``, ``tensor``: the model axes.
  ``expert`` splits an MoE layer's experts; a model with no param on
  ``expert`` or ``tensor`` runs either as a replicated axis, as every
  trainer runs ``seq`` (:func:`check_batch_axes`).

A sharding is a :class:`Sharding`: the reference's ``PartitionSpec``
(for each leading tensor dim, None, a mesh axis or a tuple of them) on a
mesh. Its :meth:`Sharding.index` is the piece of a leaf a mesh position
holds, which is the piece the reference's ``NamedSharding`` gives the
device at that position, and :meth:`Sharding.placements` the same layout
as DTensor placements (``Shard(dim)`` or ``Replicate()`` per mesh axis).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

# The multi-slice (megascale) env contract, the reference's names: the
# TPUJob operator injects them on every worker of a numSlices > 1 job;
# the launcher reads them too.
from kubeflow_tpu_torch.training.launcher import (  # noqa: F401
    ENV_MEGASCALE_COORD,
    ENV_MEGASCALE_SLICE_ID,
    ENV_MEGASCALE_SLICES,
    slice_count_from_env,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

AXIS_ORDER: Tuple[str, ...] = (
    "dcn_data", "data", "fsdp", "pipeline", "seq", "expert", "tensor")
#: The axes a batch's rows split over, outermost first.
BATCH_AXES: Tuple[str, ...] = ("dcn_data", "data", "fsdp")
#: The axes that change how a layer computes.
MODEL_AXES: Tuple[str, ...] = ("pipeline", "seq", "expert", "tensor")

MeshAxes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes for each mesh axis. ``-1`` on at most one axis means
    "all remaining devices" (like a reshape wildcard)."""

    data: int = 1
    fsdp: int = 1
    pipeline: int = 1
    seq: int = 1
    expert: int = 1
    tensor: int = 1
    dcn_data: int = 1  # cross-slice (DCN) data parallelism, outermost

    def sizes(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        wildcards = [k for k, v in sizes.items() if v == -1]
        if len(wildcards) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wildcards}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wildcards:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wildcards[0]] = n_devices // fixed
        total = math.prod(sizes.values())
        if total != n_devices:
            raise ValueError(
                f"mesh spec {sizes} needs {total} devices, have {n_devices}")
        return MeshSpec(**sizes)


def respec_for_devices(spec: MeshSpec, n_devices: int) -> MeshSpec:
    """Refit a MeshSpec to a different device count by re-solving its
    data-parallel axes (the elastic-gang resize): the model axes and
    ``dcn_data`` keep their sizes, ``fsdp`` keeps as much of its size as
    still divides the remainder (gcd), the rest folds into ``data``.
    Raises when the fixed axes alone do not divide ``n_devices``."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    sizes = spec.sizes()
    model_axes = {k: v for k, v in sizes.items()
                  if k not in ("data", "fsdp")}
    if any(v == -1 for v in model_axes.values()):
        raise ValueError(
            f"respec_for_devices needs concrete model axes, got "
            f"{model_axes}")
    fixed = math.prod(model_axes.values())
    if n_devices % fixed:
        raise ValueError(
            f"model axes {model_axes} (product {fixed}) do not "
            f"divide {n_devices} devices — not elastically "
            f"recoverable")
    remaining = n_devices // fixed
    fsdp = sizes["fsdp"] if sizes["fsdp"] != -1 else remaining
    fsdp = math.gcd(max(1, fsdp), remaining)
    return MeshSpec(**{**model_axes,
                       "fsdp": fsdp, "data": remaining // fsdp})


def parse_mesh(spec: Optional[str]) -> Optional[MeshSpec]:
    """``"data=2,tensor=4"`` → MeshSpec(data=2, tensor=4) (the CLIs'
    ``--mesh``); None for an empty spec."""
    if not spec:
        return None
    sizes: Dict[str, int] = {}
    for part in spec.split(","):
        name, _, value = part.partition("=")
        if not value:
            raise ValueError(f"bad mesh entry {part!r} (want axis=N)")
        sizes[name.strip()] = int(value)
    return MeshSpec(**sizes)


def resolve_mesh_spec(spec: Optional[MeshSpec], n_devices: int,
                      env=os.environ) -> MeshSpec:
    """``spec`` (default all-data) resolved over ``n_devices`` after the
    reference's megascale rule: a spec that does not name ``dcn_data``
    (1 or -1) takes the slice count of the env; one that names another
    count raises."""
    spec = spec or MeshSpec(data=-1)
    env_slices = slice_count_from_env(env)
    if env_slices > 1:
        if spec.dcn_data in (1, -1):
            spec = dataclasses.replace(spec, dcn_data=env_slices)
        elif spec.dcn_data != env_slices:
            raise ValueError(
                f"mesh spec dcn_data={spec.dcn_data} contradicts "
                f"{ENV_MEGASCALE_SLICES}={env_slices} — the job was "
                f"provisioned with {env_slices} slices")
    return spec.resolve(n_devices)


def _gang() -> Tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A resolved mesh over the gang's ranks, one device a rank.

    ``shape`` maps each :data:`AXIS_ORDER` axis to its size (the
    reference's ``mesh.shape``); ``rank`` is this process's position,
    ``device`` its device. With a process group, ``device_mesh`` is the
    ``torch.distributed.device_mesh.DeviceMesh`` of the same layout and
    :meth:`group` gives the process group over any set of axes; without
    one (a mesh of one) ``group`` is None and every collective is the
    identity."""

    def __init__(self, spec: MeshSpec, rank: int = 0,
                 device: DeviceLike = None, device_mesh: Any = None):
        self.spec = spec
        self.rank = rank
        self.device = torch.device(device) if device is not None else None
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, ...], Any] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.sizes()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __deepcopy__(self, memo) -> "Mesh":
        # A model template holds its mesh; a copy of the template (the
        # decode engine's) shares the mesh's process groups.
        return self

    def __repr__(self) -> str:
        live = {k: v for k, v in self.shape.items() if v > 1}
        return f"Mesh({live or '1'}, rank={self.rank}, device={self.device})"

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """A rank's position on each axis: row-major over
        :data:`AXIS_ORDER`, ``tensor`` fastest."""
        r = self.rank if rank is None else rank
        out = {}
        for name in reversed(AXIS_ORDER):
            size = self.shape[name]
            out[name] = r % size
            r //= size
        return {name: out[name] for name in AXIS_ORDER}

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """A rank's index along ``axes`` taken together, the first axis
        major (how a PartitionSpec entry of several axes splits a dim)."""
        coords = self.coords(rank)
        idx = 0
        for name in axes:
            idx = idx * self.shape[name] + coords[name]
        return idx

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def model_axes(self) -> Dict[str, int]:
        """The model axes above size 1."""
        return {a: self.shape[a] for a in MODEL_AXES if self.shape[a] > 1}

    def group(self, axes: Sequence[str]):
        """The process group of this rank's mesh line over ``axes`` (the
        ranks that differ only on them), or None without a process
        group. Every rank must ask for the same groups in the same order
        (a new group is a collective)."""
        if self.device_mesh is None:
            return None
        dist = torch.distributed
        key = tuple(a for a in AXIS_ORDER if a in axes)
        live = tuple(a for a in AXIS_ORDER if self.shape[a] > 1)
        if set(live) <= set(key):
            return dist.group.WORLD
        if len(key) == 1:
            return self.device_mesh.get_group(key[0])
        if key not in self._groups:
            mine = None
            others = [a for a in AXIS_ORDER if a not in key]
            lines: Dict[Tuple[int, ...], list] = {}
            for r in range(self.size):
                c = self.coords(r)
                lines.setdefault(tuple(c[a] for a in others), []).append(r)
            for ranks in lines.values():
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._groups[key] = mine
        return self._groups[key]


def build_mesh(spec: Optional[MeshSpec] = None,
               device: DeviceLike = None, *, env=os.environ) -> Mesh:
    """The mesh over the gang's ranks (the reference's ``build_mesh``
    over its devices).

    In a ``torch.distributed`` group the mesh spans its ranks, one
    device a rank: an nccl group on the card (``device`` is then this
    process's card), a gloo group on the CPU, or a gloo group whose
    ranks share one card (nccl refuses two ranks on one device; the
    caller names the card as ``device``, and the tensor collectives
    gather by all-reduce there). Without a process group it
    is a mesh of one on ``device``. The megascale env fills ``dcn_data``
    exactly as the reference's rules do, and a spec that contradicts it
    raises. ``device`` defaults as every entry point's: the card."""
    rank, world = _gang()
    spec = resolve_mesh_spec(spec, world, env)
    dist = torch.distributed
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh(spec, 0, resolve_device(device))
    backend = dist.get_backend()
    if backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
        if device is not None and resolve_device(device).type != "cuda":
            raise ValueError(f"an nccl gang runs on the card, not {device}")
    else:
        dev = resolve_device(device if device is not None else "cpu")
        if dev.type != "cpu" and backend != "gloo":
            raise ValueError(f"a {backend} gang runs on the CPU, not {dev}")
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(spec.sizes()[a] for a in AXIS_ORDER)
    # A gloo group's subgroups are gloo's whatever device its ranks
    # compute on; the device mesh only hands out those groups.
    device_mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                                   shape, mesh_dim_names=AXIS_ORDER)
    return Mesh(spec, rank, dev, device_mesh)


# -- shardings ------------------------------------------------------------------

def _members(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout on a mesh: for each leading dim, None (whole),
    a mesh axis, or a tuple of axes (split over them, the first major);
    dims past ``spec`` are whole. The reference's ``NamedSharding``."""

    mesh: Mesh = dataclasses.field(compare=False)
    spec: Tuple[MeshAxes, ...] = ()

    def sharded_dims(self) -> Dict[int, Tuple[str, ...]]:
        """dim → its mesh axes of size > 1."""
        out = {}
        for dim, entry in enumerate(self.spec):
            axes = tuple(a for a in _members(entry)
                         if self.mesh.shape[a] > 1)
            if axes:
                out[dim] = axes
        return out

    @property
    def replicated(self) -> bool:
        return not self.sharded_dims()

    def index(self, shape: Sequence[int],
              rank: Optional[int] = None) -> Tuple[slice, ...]:
        """The piece of a ``shape`` leaf at ``rank``'s mesh position."""
        out = [slice(None)] * len(shape)
        for dim, axes in self.sharded_dims().items():
            parts = self.mesh.axes_size(axes)
            if shape[dim] % parts:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split over {axes} ({parts})")
            width = shape[dim] // parts
            i = self.mesh.index(axes, rank)
            out[dim] = slice(i * width, (i + 1) * width)
        return tuple(out)

    def only(self, axes: Sequence[str]) -> "Sharding":
        """This layout with every mesh axis but ``axes`` taken out (the
        dims those axes split become whole)."""
        spec = []
        for entry in self.spec:
            kept = tuple(a for a in _members(entry) if a in axes)
            spec.append(None if not kept else
                        kept[0] if len(kept) == 1 else kept)
        return Sharding(self.mesh, tuple(spec))

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole leaf, a contiguous copy."""
        return full[self.index(full.shape)].contiguous().clone()

    def placements(self) -> list:
        """DTensor placements, one per mesh axis in :data:`AXIS_ORDER`:
        ``Shard(dim)`` where the axis splits a dim, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        by_axis = {a: Shard(dim) for dim, entry in enumerate(self.spec)
                   for a in _members(entry)}
        return [by_axis.get(a, Replicate()) for a in AXIS_ORDER]


def batch_sharding(mesh: Mesh, ndim: int = 0) -> Sharding:
    """A batch: its leading dim split over (dcn_data, data, fsdp)."""
    del ndim
    return Sharding(mesh, (BATCH_AXES,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def fsdp_params_sharding(mesh: Mesh, params: Mapping[str, Any],
                         min_weight_size: int = 2 ** 16) -> Dict[str, Sharding]:
    """ZeRO-3 shardings of a flat ``{key: leaf}`` tree (leaves with a
    ``shape``), the reference's rule: a large-enough leaf is split over
    ``fsdp`` along its largest fsdp-divisible dim (the last of equals);
    everything else is replicated."""
    fsdp_size = mesh.shape["fsdp"]

    def spec_for(x: Any) -> Sharding:
        shape = tuple(getattr(x, "shape", ()))
        if fsdp_size == 1 or math.prod(shape or (0,)) < min_weight_size:
            return Sharding(mesh, ())
        candidates = [(dim_size, idx) for idx, dim_size in enumerate(shape)
                      if dim_size % fsdp_size == 0]
        if not candidates:
            return Sharding(mesh, ())
        _, idx = max(candidates)
        spec: list = [None] * len(shape)
        spec[idx] = "fsdp"
        return Sharding(mesh, tuple(spec))

    return {k: spec_for(v) for k, v in params.items()}


def mirror_param_shardings(opt_paths: Sequence[str],
                           params_sh: Mapping[str, Sharding],
                           replicated_sh: Sharding) -> Dict[str, Sharding]:
    """Shardings of optimizer-state leaves, by ``"/"``-joined tree path:
    a leaf whose path ends with a param's full path takes that param's
    sharding (adam's ``mu``/``nu`` mirror the param tree); any other
    (step counters) is replicated. Matching by path, not shape, keeps
    same-shaped params with different layouts on their own."""
    out = {}
    for path in opt_paths:
        keys = path.split("/")
        found = replicated_sh
        for start in range(len(keys)):
            sh = params_sh.get("/".join(keys[start:]))
            if sh is not None:
                found = sh
                break
        out[path] = found
    return out


def logical_sharding(mesh: Mesh, logical_axes: Mapping[str, Any],
                     rules: Mapping[str, MeshAxes]) -> Dict[str, Sharding]:
    """Flat ``{key: logical-axis tuple or None}`` to shardings through
    ``rules`` (logical name → mesh axes, None to replicate)."""
    return {k: Sharding(mesh, () if axes is None
                        else tuple(rules.get(a) for a in axes))
            for k, axes in logical_axes.items()}


def runs_axis(model: Any, axis: str) -> bool:
    """Whether ``model`` declares layers that split over the model axis
    ``axis`` (its ``PARALLEL_AXES``: ``tensor`` for the Llama and BERT,
    ``expert`` for an MoE Llama)."""
    return axis in getattr(model, "PARALLEL_AXES", ())


def param_axes(model: Any) -> set:
    """The mesh axes any of ``model``'s params maps to under the
    reference's rule table (its ``logical_axes`` of each Flax key); a
    model without logical axes (the CNNs) maps to none."""
    from kubeflow_tpu_torch.models.convert import flax_key
    from kubeflow_tpu_torch.parallel.tensor_parallel import DEFAULT_RULES

    logical = getattr(model, "logical_axes", None)
    if logical is None:
        return set()
    out = set()
    for name, _ in model.named_parameters():
        for n in logical(flax_key(name)) or ():
            axes = DEFAULT_RULES.get(n) if n else None
            out.update((axes,) if isinstance(axes, str) else axes or ())
    return out


def check_batch_axes(mesh: Mesh, what: str, model: Any = None, *,
                     deferred: bool = False, pipeline_ok: bool = False,
                     replicated_ok: Sequence[str] = ()) -> None:
    """Raise on a mesh with a model axis above 1 that the step does not
    run. ``seq`` runs on every trainer as a replicated axis (the
    reference's rule table maps it to activations alone: each seq rank
    holds the whole params and batch and computes the unmeshed step);
    so do ``tensor`` and ``expert`` for a ``model`` none of whose params
    the rule table maps to them (``expert`` on a dense Llama or BERT),
    and the axes in ``replicated_ok`` (a trainer that lays its params
    out by fsdp alone, as the vision trainer does). ``tensor`` and
    ``expert`` run for a model that declares layers split over them
    (:func:`runs_axis`), or where ``deferred`` (a step built before its
    model is known checks it at its call). ``pipeline`` runs only where
    ``pipeline_ok`` (the pipeline trainer, ``training/pipeline_lm.py``)."""
    live = mesh.model_axes()
    live.pop("seq", None)
    for axis in replicated_ok:
        live.pop(axis, None)
    if pipeline_ok:
        live.pop("pipeline", None)
    for axis in ("tensor", "expert"):
        if axis in live and (deferred or (model is not None and (
                runs_axis(model, axis) or axis not in param_axes(model)))):
            del live[axis]
    if live:
        name = type(model).__name__ if model is not None else "this step"
        raise NotImplementedError(
            f"{what}: the model axes {live} do not run for {name}: "
            f"pipeline runs in the pipeline LM trainer "
            f"(training/pipeline_lm.py, tpu-lm --mesh pipeline=N); tensor "
            f"and expert run in the LM trainers (the Llama, its MoE and "
            f"BERT), and as replicated axes for a model with no param "
            f"on them and in the vision trainer; seq runs everywhere as a "
            f"replicated axis")


def tensor_group(mesh: Mesh):
    """The process group of this rank's ``tensor`` line, or None (no
    process group, or a ``tensor`` axis of 1)."""
    if mesh.shape["tensor"] == 1:
        return None
    return mesh.group(("tensor",))


def tensor_rank(mesh: Mesh) -> int:
    """This rank's position on the ``tensor`` axis."""
    return mesh.coords()["tensor"]


def tensor_axis(mesh: Optional[Mesh]) -> Tuple[Optional[Mesh], int, int]:
    """``(mesh, size, rank)`` of a layer's tensor axis; the mesh is None
    where there is none or it is 1 (the layer is whole and issues no
    tensor collective)."""
    if mesh is None or mesh.shape["tensor"] == 1:
        return None, 1, 0
    return mesh, mesh.shape["tensor"], tensor_rank(mesh)


def expert_group(mesh: Mesh):
    """The process group of this rank's ``expert`` line, or None (no
    process group, or an ``expert`` axis of 1)."""
    if mesh.shape["expert"] == 1:
        return None
    return mesh.group(("expert",))


def expert_rank(mesh: Mesh) -> int:
    """This rank's position on the ``expert`` axis."""
    return mesh.coords()["expert"]
