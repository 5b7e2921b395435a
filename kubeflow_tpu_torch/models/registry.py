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

"""Model registry: name → (constructor, canonical input spec).

The port's own copy of ``kubeflow_tpu/models/registry.py``, with the
same names, so an export's ``registry_name`` resolves in both packages.
``make`` returns a ``torch.nn.Module`` built on the meta device; its
weights travel separately as a ``params`` dict (models/convert.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    family: str  # "vision" | "language"
    make: Callable[..., Any]  # returns a torch.nn.Module
    input_spec: Tuple[Tuple[int, ...], str]  # (shape sans batch, dtype)
    num_classes_or_vocab: int
    # Benchmark sgd lr override for models whose training dynamics
    # reject the family default (the reference's no-norm classic CNNs
    # diverge at the BN-era 0.1); recorded next to the model, so new
    # registrations carry the fact with them.
    bench_lr: Optional[float] = None
    # Causal decoder with a generate/decode path (KV cache).
    decoder: bool = False


_MODELS: Dict[str, ModelEntry] = {}


def register_model(entry: ModelEntry) -> None:
    if entry.name in _MODELS:
        raise ValueError(f"model {entry.name!r} already registered")
    _MODELS[entry.name] = entry


def _ensure_loaded() -> None:
    import importlib

    for mod in ("kubeflow_tpu_torch.models.llama",
                "kubeflow_tpu_torch.models.resnet"):
        importlib.import_module(mod)


def get_model(name: str) -> ModelEntry:
    _ensure_loaded()
    try:
        return _MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_MODELS)} (not "
            f"ported yet: BERT and ViT, ROADMAP A12; the MoE configs, A13; "
            f"the rest of vision, A11)") from None
