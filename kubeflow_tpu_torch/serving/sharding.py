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

"""Sharded serving exports: the read half.

The port of ``kubeflow_tpu/serving/sharding.py``'s reader. A sharded
version dir holds ``signature.json``, whose ``sharding`` field is the
shard manifest, and one variables file per serving-mesh position
(``params.shard-00000-of-0000N.msgpack``): Flax msgpack dicts keyed by
``"/"``-joined paths (``params/layer_0/attention/q_proj/kernel``),
plain arrays, bf16 included. A leaf in the manifest's ``plan`` is split
along its ``dim`` over the ``tensor`` or ``fsdp`` axis; a leaf not in
the plan is replicated and stored once, in shard 0. There is no
monolithic ``params.msgpack`` in such a dir.

:func:`read_sharded_variables` is the reference's n = 1 read: it joins
each planned leaf's slices on the host, which gives the monolithic
bytes back exactly, so a sharded export serves on one card that holds
the whole model (``serving/model.py`` ``load_version``). Writing a
sharded export, and loading one onto several devices, need the
tensor-parallel rule table and the device mesh (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.models.convert import flatten_tree, unflatten_tree
from kubeflow_tpu_torch.serving import flax_msgpack
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
