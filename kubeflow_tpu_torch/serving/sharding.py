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

"""Sharded serving exports: the writer, the one-card read and the gang's
read.

The port of ``kubeflow_tpu/serving/sharding.py``'s writer and reader. A sharded
version dir holds ``signature.json``, whose ``sharding`` field is the
shard manifest, and one variables file per serving-mesh position
(``params.shard-00000-of-0000N.msgpack``): Flax msgpack dicts keyed by
``"/"``-joined paths (``params/layer_0/attention/q_proj/kernel``),
plain arrays, bf16 included. A leaf in the manifest's ``plan`` is split
along its ``dim`` over the ``tensor`` or ``fsdp`` axis; a leaf not in
the plan is replicated and stored once, in shard 0. There is no
monolithic ``params.msgpack`` in such a dir.

:func:`export_model_sharded` writes one (byte for byte the
reference's): :func:`build_shard_plan` splits each annotated leaf over
``tensor`` where its logical axes map there under the rule table
(``parallel/tensor_parallel.py``), else over ``fsdp``; the model's
``logical_axes`` stand for the reference's boxed metadata.
:func:`read_sharded_variables` is the reference's n = 1 read: it joins
each planned leaf's slices on the host, which gives the monolithic
bytes back exactly, so a sharded export serves on one card that holds
the whole model (``serving/model.py`` ``load_version``).
:func:`serving_mesh` and :func:`load_sharded_variables` are the
reference's mesh load on a gang of ranks, one device a rank: rank r of
an ``fsdp=F, tensor=T`` export reads shard file r alone (its pieces of
every planned leaf: a tensor-planned leaf's tensor piece, an
fsdp-planned leaf's fsdp piece); the leaves the plan keeps whole are
stored once, in shard 0, and rank 0 broadcasts them over the gang. With
``fsdp > 1`` the model holds each leaf's fsdp piece at rest and gathers
it just before the op that reads it (``models/llama.py``, ``Llama(mesh=,
fsdp_pieces=True)``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.models.convert import flatten_tree, unflatten_tree
from kubeflow_tpu_torch.parallel.tensor_parallel import DEFAULT_RULES
from kubeflow_tpu_torch.serving import flax_msgpack
from kubeflow_tpu_torch.serving.export import (
    PARAMS_FILE,
    SIGNATURE_FILE,
    export_model,
    unbox,
)
from kubeflow_tpu_torch.serving.signature import ModelMetadata

SHARD_FILE_FMT = "params.shard-{i:05d}-of-{n:05d}.msgpack"
MANIFEST_FORMAT = 1

#: A serving mesh's two axes: ``tensor`` (mlp / heads / vocab dims) and
#: ``fsdp`` (embed dims).
SERVING_AXES = ("fsdp", "tensor")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Serving-mesh sizes. ``num_shards = tensor × fsdp``: one shard
    file per mesh position."""

    tensor: int = 1
    fsdp: int = 1

    def __post_init__(self):
        if self.tensor < 1 or self.fsdp < 1:
            raise ValueError(
                f"shard axes must be >= 1, got tensor={self.tensor} "
                f"fsdp={self.fsdp}")

    @property
    def num_shards(self) -> int:
        return self.tensor * self.fsdp

    def to_json(self) -> Dict[str, int]:
        return {"tensor": self.tensor, "fsdp": self.fsdp}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "ShardSpec":
        return ShardSpec(tensor=int(obj.get("tensor", 1)),
                         fsdp=int(obj.get("fsdp", 1)))


def _flatten(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The unboxed flat view, ``"/"``-joined path → leaf, in the
    reference's order (Flax walks a dict's keys sorted): the shard files
    carry plain tensors, the partitioning lives in the manifest."""
    flat: Dict[str, Any] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        else:
            flat[prefix] = node if isinstance(node, torch.Tensor) else (
                np.asarray(node))

    walk("", unbox(tree))
    return flat


def _boxed(tree: Mapping[str, Any], prefix: str = "") -> set:
    """The flat keys of ``tree``'s boxed leaves (``{"value": x}``, what
    the reference's ``nn.Partitioned`` serializes to)."""
    out = set()
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            if set(v) == {"value"} and not isinstance(v["value"], Mapping):
                out.add(key)
            else:
                out |= _boxed(v, key)
    return out


def _logical_axes_flat(variables: Mapping[str, Any], model
                       ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Flat key → logical axis names of each partitioned leaf (the
    reference's ``nn.get_partition_spec`` on the boxed tree): the
    model's ``logical_axes`` of a boxed leaf's key within its
    collection. Unannotated leaves are absent."""
    out = {}
    for key in _boxed(variables):
        axes = model.logical_axes(key.split("/", 1)[1])
        if axes:
            out[key] = tuple(axes)
    return out


def build_shard_plan(variables: Mapping[str, Any], spec: ShardSpec, model,
                     *, min_shard_size: int = 1024
                     ) -> Dict[str, Dict[str, Any]]:
    """Each leaf's split, the reference's rule: the first dim whose
    logical name maps to ``tensor`` under the rule table splits over
    tensor, else the first ``fsdp``-mapped dim over fsdp; an axis of
    size 1 never claims a dim. Unannotated, indivisible or small
    (``min_shard_size``) leaves replicate (absent from the plan)."""

    def axis_for(name: Optional[str]) -> Optional[str]:
        mapped = DEFAULT_RULES.get(name) if name else None
        if isinstance(mapped, tuple):
            mapped = next((a for a in mapped if a in SERVING_AXES), None)
        return mapped if mapped in SERVING_AXES else None

    flat = _flatten(variables)
    axes = _logical_axes_flat(variables, model)
    plan: Dict[str, Dict[str, Any]] = {}
    for key, value in flat.items():
        names = axes.get(key)
        shape = tuple(value.shape)
        if names is None or int(np.prod(shape)) < min_shard_size:
            continue
        best: Optional[Tuple[int, str, int]] = None
        for dim, name in enumerate(names):
            mesh_axis = axis_for(name)
            if mesh_axis is None:
                continue
            parts = getattr(spec, mesh_axis)
            if parts <= 1 or dim >= len(shape) or shape[dim] % parts:
                continue
            rank = 0 if mesh_axis == "tensor" else 1  # tp first
            if best is None or rank < best[0]:
                best = (rank, mesh_axis, dim)
        if best is not None:
            _, mesh_axis, dim = best
            plan[key] = {"dim": dim, "axis": mesh_axis}
    return plan


def _axis_index(spec: ShardSpec, shard: int, axis: str) -> int:
    """Which slice of ``axis`` shard file ``shard`` holds: shard ids run
    over mesh positions tensor-fastest (fsdp outer, tensor inner)."""
    if axis == "tensor":
        return shard % spec.tensor
    return shard // spec.tensor


def export_model_sharded(base_path: str, version: int,
                         metadata: ModelMetadata,
                         variables: Dict[str, Any], spec: ShardSpec,
                         model=None, *,
                         plan: Optional[Dict[str, Dict[str, Any]]] = None
                         ) -> Path:
    """Write one version dir in the sharded layout, atomically (a temp
    dir, then a rename: the watcher's contract). ``variables`` is the
    export tree (``serving/export_cli.py``'s, boxes where the reference
    boxes); ``model`` names each boxed leaf's logical axes (needed
    unless ``plan`` is given). With ``spec.num_shards == 1`` it writes
    the monolithic layout, which every server reads."""
    if spec.num_shards == 1:
        return export_model(base_path, version, metadata, variables)
    if plan is None:
        if model is None:
            raise ValueError("a sharded export's plan needs the model's "
                             "logical axes (model=...)")
        plan = build_shard_plan(variables, spec, model)
    flat = _flatten(variables)
    n = spec.num_shards
    shard_files = [SHARD_FILE_FMT.format(i=i, n=n) for i in range(n)]
    manifest = {
        "format": MANIFEST_FORMAT,
        "num_shards": n,
        "mesh": spec.to_json(),
        "shards": shard_files,
        "plan": plan,
    }
    metadata = dataclasses.replace(metadata, sharding=manifest)
    base = Path(base_path)
    base.mkdir(parents=True, exist_ok=True)
    final = base / str(version)
    if final.exists():
        raise FileExistsError(f"version dir {final} already exists")
    tmp = Path(tempfile.mkdtemp(dir=base, prefix=f".tmp-{version}-"))
    try:
        (tmp / SIGNATURE_FILE).write_text(metadata.dumps())
        for shard in range(n):
            part: Dict[str, Any] = {}
            for key, value in flat.items():
                entry = plan.get(key)
                if entry is None:
                    if shard == 0:  # replicated: stored once
                        part[key] = value
                    continue
                dim, axis = entry["dim"], entry["axis"]
                width = value.shape[dim] // getattr(spec, axis)
                idx = _axis_index(spec, shard, axis)
                sl = [slice(None)] * value.ndim
                sl[dim] = slice(idx * width, (idx + 1) * width)
                piece = value[tuple(sl)]
                part[key] = (piece.contiguous()
                             if isinstance(piece, torch.Tensor)
                             else np.ascontiguousarray(piece))
            (tmp / shard_files[shard]).write_bytes(flax_msgpack.dumps(part))
        # No monolithic file in a sharded dir: a server that ignores the
        # manifest fails at load instead of serving shard 0 as the model.
        if (tmp / PARAMS_FILE).exists():
            raise AssertionError("a sharded export holds params.msgpack")
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _read_shard(version_dir: str, filename: str) -> Dict[str, Any]:
    """One shard file's flat dict (numpy arrays; bf16 leaves as CPU
    tensors, which numpy has no type for)."""
    data = (Path(version_dir) / filename).read_bytes()
    restored = flax_msgpack.loads(data)
    if not isinstance(restored, dict):
        raise ValueError(f"shard file {filename} does not hold a dict")
    return restored


def _manifest_of(metadata: ModelMetadata) -> Dict[str, Any]:
    manifest = metadata.sharding
    if not manifest:
        raise ValueError("metadata carries no shard manifest")
    fmt = int(manifest.get("format", 0))
    if fmt != MANIFEST_FORMAT:
        raise ValueError(
            f"unsupported shard manifest format {fmt} (this build "
            f"reads format {MANIFEST_FORMAT}); re-export or upgrade "
            f"the server")
    n = int(manifest["num_shards"])
    if len(manifest["shards"]) != n:
        raise ValueError(
            f"manifest lists {len(manifest['shards'])} shard files "
            f"for num_shards={n}")
    return manifest


def _shape(leaf: Any):
    shape = getattr(leaf, "shape", leaf)
    return tuple(int(s) for s in shape)


def _restore_tree(template: Optional[Mapping[str, Any]],
                  flat: Dict[str, Any]) -> Dict[str, Any]:
    """The nested variables tree of ``flat``, checked against
    ``template``: a nested dict of the expected collections whose leaves
    carry a ``shape`` (arrays, tensors, or shape tuples). As the
    reference's, the restore keeps the collections present in the files
    and raises for a template collection they lack (``cache`` aside);
    within each kept collection every template leaf must be stored at
    its shape, and no other leaf may be. ``None``: no check (the port's
    ``load_version`` checks each leaf as it carries it across)."""
    stored = unflatten_tree(flat)
    if template is None:
        return stored
    missing = set(template) - set(stored) - {"cache"}
    if missing:
        raise ValueError(
            f"sharded export lacks collections {sorted(missing)}; "
            f"stored: {sorted(stored)}")
    out = {}
    for collection in sorted(set(template) & set(stored)):
        want = flatten_tree(template[collection])
        got = flatten_tree(stored[collection])
        if set(want) != set(got):
            raise ValueError(
                f"sharded export's {collection!r} differs from the model: "
                f"missing {sorted(set(want) - set(got))[:5]}, unknown "
                f"{sorted(set(got) - set(want))[:5]}")
        for key, leaf in want.items():
            if _shape(got[key]) != _shape(leaf):
                raise ValueError(
                    f"{collection}/{key}: stored shape "
                    f"{_shape(got[key])} != the model's {_shape(leaf)}")
        out[collection] = stored[collection]
    return out


def _concatenate(pieces, dim: int):
    """Join one leaf's slices along ``dim``: numpy arrays, or CPU
    tensors for bf16 (concatenation copies bytes, so either is exact)."""
    if any(isinstance(p, torch.Tensor) for p in pieces):
        return torch.cat([torch.as_tensor(p) for p in pieces], dim=dim)
    return np.concatenate([np.asarray(p) for p in pieces], axis=dim)


def read_sharded_variables(version_dir: str,
                           template: Optional[Mapping[str, Any]],
                           metadata: ModelMetadata) -> Dict[str, Any]:
    """The whole variables tree of a sharded export, joined on the host:
    each planned leaf's slices concatenated along its recorded dim (the
    slices are contiguous ranges of the original, so this is the
    monolithic bytes exactly), each replicated leaf from shard 0.
    ``template``: see :func:`_restore_tree`."""
    manifest = _manifest_of(metadata)
    spec = ShardSpec.from_json(manifest["mesh"])
    plan: Dict[str, Dict[str, Any]] = manifest["plan"]
    shards = [_read_shard(version_dir, f) for f in manifest["shards"]]
    flat: Dict[str, Any] = {}
    for key, value in shards[0].items():
        entry = plan.get(key)
        if entry is None:
            flat[key] = value
            continue
        dim, axis = int(entry["dim"]), entry["axis"]
        parts = getattr(spec, axis)
        # One slice per index of the leaf's axis (the slices along the
        # other serving axis are copies; take its index 0). Shard ids
        # run tensor-fastest: fsdp outer, tensor inner.
        pieces = [shards[idx if axis == "tensor" else idx * spec.tensor][key]
                  for idx in range(parts)]
        flat[key] = _concatenate(pieces, dim)
    for shard_id, shard in enumerate(shards[1:], start=1):
        for key in shard:
            if key not in flat:
                raise ValueError(
                    f"shard {shard_id} carries unplanned leaf {key!r} "
                    f"absent from shard 0")
    return _restore_tree(template, flat)


def shard_topology(metadata: ModelMetadata) -> Dict[str, Any]:
    """The healthz-facing summary of a version's layout
    (``{"num_shards": 1}`` for monolithic exports)."""
    manifest = metadata.sharding
    if not manifest:
        return {"num_shards": 1}
    try:
        return {"num_shards": int(manifest.get("num_shards", 1)),
                "mesh": dict(manifest.get("mesh") or {})}
    except (TypeError, ValueError):
        # A malformed manifest degrades; it never takes the status
        # endpoint down.
        return {"num_shards": 1, "malformed": True}


def serving_mesh(spec: ShardSpec, device: Any = None):
    """The serving mesh over the ``torch.distributed`` group's ranks
    (``parallel/mesh.py`` ``build_mesh``; tensor innermost, as the
    reference lays its devices out), one device a rank: ``device`` is
    this rank's (the card by default). Raises when the group has fewer
    ranks than ``spec.num_shards`` (the reference's message)."""
    from kubeflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    dist = torch.distributed
    ranks = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if ranks < spec.num_shards:
        raise ValueError(
            f"serving mesh {spec.to_json()} needs {spec.num_shards} "
            f"devices, have {ranks}")
    return build_mesh(MeshSpec(tensor=spec.tensor, fsdp=spec.fsdp), device)


def load_sharded_variables(version_dir: str,
                           template: Optional[Mapping[str, Any]],
                           metadata: ModelMetadata, mesh,
                           opened: Optional[list] = None
                           ) -> Dict[str, Any]:
    """This rank's variables of a sharded export on ``mesh`` (a
    :func:`serving_mesh`): each planned leaf's piece from this rank's
    own shard file, which is the rank's tensor or fsdp piece of the leaf
    by the rule table, and each leaf the plan keeps whole from shard 0, read by
    rank 0 alone and broadcast to the gang (a collective: every rank
    calls it). Raises, as the reference does, when the mesh's size or
    axes differ from the manifest's. ``opened`` collects the names of
    the shard files this rank read. ``template``: see
    :func:`_restore_tree` (leaf shapes are not checked: the pieces are
    the model's per-rank shapes)."""
    manifest = _manifest_of(metadata)
    spec = ShardSpec.from_json(manifest["mesh"])
    if mesh.size != spec.num_shards:
        raise ValueError(
            f"mesh has {mesh.size} devices but the manifest wants "
            f"{spec.num_shards} shards")
    for axis in SERVING_AXES:
        if mesh.shape.get(axis, 1) != getattr(spec, axis):
            raise ValueError(
                f"mesh axis {axis}={mesh.shape.get(axis, 1)} != "
                f"manifest {axis}={getattr(spec, axis)} — the load "
                f"mesh must match the export topology")
    plan: Dict[str, Dict[str, Any]] = manifest["plan"]
    # Shard ids run tensor-fastest (fsdp outer, tensor inner), as the
    # mesh's positions do.
    position = mesh.index(SERVING_AXES)
    mine = manifest["shards"][position]
    shard = _read_shard(version_dir, mine)
    if opened is not None:
        opened.append(mine)
    flat = {k: v for k, v in shard.items() if k in plan}
    whole = [{k: v for k, v in shard.items() if k not in plan}
             if position == 0 else None]
    group = mesh.group(SERVING_AXES)
    if group is not None:
        torch.distributed.broadcast_object_list(whole, src=0, group=group)
    flat.update(whole[0])
    missing = set(plan) - set(flat)
    if missing:
        raise ValueError(f"shard {mine} lacks planned leaves "
                         f"{sorted(missing)[:5]}")
    if template is None:
        return unflatten_tree(flat)
    stored = unflatten_tree(flat)
    absent = set(template) - set(stored) - {"cache"}
    if absent:
        raise ValueError(f"sharded export lacks collections "
                         f"{sorted(absent)}; stored: {sorted(stored)}")
    return {c: stored[c] for c in sorted(set(template) & set(stored))}


def parse_shard_spec(raw: Optional[str]) -> ShardSpec:
    """CLI form: ``"tensor=2,fsdp=1"`` or a bare int (→ tensor=N)."""
    if not raw:
        return ShardSpec()
    raw = raw.strip()
    if raw.isdigit():
        return ShardSpec(tensor=int(raw))
    sizes = {"tensor": 1, "fsdp": 1}
    for pair in raw.split(","):
        key, eq, value = pair.partition("=")
        key = key.strip()
        if not eq or key not in sizes:
            raise ValueError(
                f"bad shard spec {raw!r}; want 'tensor=T,fsdp=F' "
                f"or a bare tensor count")
        sizes[key] = int(value)
    return ShardSpec(**sizes)


def dumps_manifest(manifest: Dict[str, Any]) -> str:
    return json.dumps(manifest, indent=1, sort_keys=True)
