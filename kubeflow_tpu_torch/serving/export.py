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

"""Export a model to a versioned serving directory, and read one back.

Port of ``kubeflow_tpu/serving/export.py``, on the same layout, so an
export written by either package loads in the other::

    <base_path>/<version>/signature.json
    <base_path>/<version>/params.msgpack

``params.msgpack`` is the Flax msgpack of the variables
(``{"params": {...}}``, nested by the Flax module paths, fp32 as Flax
keeps params), read and written by the port's own codec
(:mod:`serving.flax_msgpack`). ``models/convert.py`` maps the tree to
the port's params and back. The reference's exporter keeps Flax's
partitioning boxes, which store a leaf as ``{"value": array}``;
:func:`unbox` takes them off.
"""

from __future__ import annotations

import mmap
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Mapping

from kubeflow_tpu_torch.serving import flax_msgpack
from kubeflow_tpu_torch.serving.signature import ModelMetadata

SIGNATURE_FILE = "signature.json"
PARAMS_FILE = "params.msgpack"


def export_model(
    base_path: str,
    version: int,
    metadata: ModelMetadata,
    variables: Dict[str, Any],
) -> Path:
    """Atomically write one model version dir (write to temp, rename —
    the watcher must never see a half-written version). ``variables``
    is the nested tree to store (``{"params": {...}}``; leaves numpy
    arrays or torch tensors)."""
    base = Path(base_path)
    base.mkdir(parents=True, exist_ok=True)
    final = base / str(version)
    if final.exists():
        raise FileExistsError(f"version dir {final} already exists")
    tmp = Path(tempfile.mkdtemp(dir=base, prefix=f".tmp-{version}-"))
    try:
        (tmp / SIGNATURE_FILE).write_text(metadata.dumps())
        with open(tmp / PARAMS_FILE, "wb") as f:
            flax_msgpack.dump(variables, f)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def read_metadata(version_dir: str) -> ModelMetadata:
    return ModelMetadata.loads(
        (Path(version_dir) / SIGNATURE_FILE).read_text())


def read_variables(version_dir: str) -> Dict[str, Any]:
    """The stored variables tree, its arrays numpy views of the
    memory-mapped file (no copy is made here; the mapping lives as long
    as the arrays do)."""
    with open(Path(version_dir) / PARAMS_FILE, "rb") as f:
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    stored = flax_msgpack.loads(data)
    if not isinstance(stored, dict) or "params" not in stored:
        raise ValueError(f"export {version_dir} has no 'params' "
                         f"collection")
    return stored


def unbox(tree: Any) -> Any:
    """``tree`` without Flax's partitioning boxes: a ``{"value": x}``
    node whose ``x`` is not a dict (``nn.Partitioned``'s state dict;
    its axis names are not serialized) becomes ``x``."""
    if not isinstance(tree, Mapping):
        return tree
    if set(tree) == {"value"} and not isinstance(tree["value"], Mapping):
        return tree["value"]
    return {k: unbox(v) for k, v in tree.items()}
