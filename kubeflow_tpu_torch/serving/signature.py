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

"""Model signatures — the typed request/response contract.

The port's own copy of ``kubeflow_tpu/serving/signature.py``: the same
classes and the same JSON, so a ``signature.json`` written by either
package reads in the other. A signature names its inputs/outputs with
dtype + shape (batch dim = -1) and a method (predict | classify |
generate).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

DTYPES = {"float32", "bfloat16", "int32", "int64", "uint8", "bool"}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    dtype: str
    shape: Tuple[int, ...]  # -1 for the batch dimension

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")

    def to_json(self) -> Dict[str, Any]:
        return {"dtype": self.dtype, "shape": list(self.shape)}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "TensorSpec":
        return TensorSpec(obj["dtype"], tuple(obj["shape"]))


@dataclasses.dataclass(frozen=True)
class Signature:
    method: str  # "predict" | "classify" | "generate"
    inputs: Dict[str, TensorSpec]
    outputs: Dict[str, TensorSpec]

    def __post_init__(self):
        if self.method not in ("predict", "classify", "generate"):
            raise ValueError(f"unsupported method {self.method!r}")
        if not self.inputs:
            raise ValueError("signature needs at least one input")

    def to_json(self) -> Dict[str, Any]:
        return {
            "method": self.method,
            "inputs": {k: v.to_json() for k, v in self.inputs.items()},
            "outputs": {k: v.to_json() for k, v in self.outputs.items()},
        }

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "Signature":
        return Signature(
            method=obj["method"],
            inputs={k: TensorSpec.from_json(v) for k, v in obj["inputs"].items()},
            outputs={k: TensorSpec.from_json(v) for k, v in obj["outputs"].items()},
        )


@dataclasses.dataclass(frozen=True)
class ModelMetadata:
    """The signature.json file at the root of a model version dir."""

    model_name: str
    registry_name: str  # models registry key
    signatures: Dict[str, Signature]
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    classes: Optional[List[str]] = None  # label vocabulary for classify
    # For generate-method models: max_new_tokens, temperature, top_k,
    # top_p, eos_id, seed. Fixed at export time so serving shapes and
    # compiled programs are static (no per-request recompiles).
    generate_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Shard manifest for multi-chip exports (serving/sharding.py):
    # {"format": 1, "num_shards": N, "mesh": {"tensor": t, "fsdp": f},
    #  "shards": [filenames...], "plan": {flat_key: {"dim", "axis"}}}.
    # None = the classic monolithic params.msgpack layout; readers
    # that predate the field (or a num_shards == 1 manifest) keep
    # loading the monolithic file unchanged.
    sharding: Optional[Dict[str, Any]] = None

    DEFAULT_SIGNATURE = "serving_default"

    def to_json(self) -> Dict[str, Any]:
        out = {
            "model_name": self.model_name,
            "registry_name": self.registry_name,
            "signatures": {k: s.to_json() for k, s in self.signatures.items()},
            "model_kwargs": self.model_kwargs,
            "classes": self.classes,
            "generate_config": self.generate_config,
        }
        if self.sharding is not None:
            # Written only when present, so monolithic signature.json
            # files are byte-identical to the pre-sharding layout
            # (old readers never see an unknown key).
            out["sharding"] = self.sharding
        return out

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "ModelMetadata":
        return ModelMetadata(
            model_name=obj["model_name"],
            registry_name=obj["registry_name"],
            signatures={k: Signature.from_json(s)
                        for k, s in obj["signatures"].items()},
            model_kwargs=obj.get("model_kwargs", {}),
            classes=obj.get("classes"),
            generate_config=obj.get("generate_config", {}),
            sharding=obj.get("sharding"),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    @staticmethod
    def loads(text: str) -> "ModelMetadata":
        return ModelMetadata.from_json(json.loads(text))
