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

"""kubeflow_tpu_torch stands alone, and runs on the GPU unless told not to.

- Every module imports with ``jax``, ``flax``, ``msgpack`` and
  ``kubeflow_tpu`` blocked, and no source line of the package or of its
  GPU scripts (``chip_smoke.py``, ``scripts/profile_torch_llama.py``,
  ``scripts/bn_phase_times.py``, ``scripts/decode_invariance.py``,
  ``scripts/manager_phase.py``, ``scripts/train_phase.py``,
  ``scripts/registry_phase.py``, ``scripts/measure_phase.py``,
  ``scripts/smoke_breakdown.py``, ``scripts/gang_phase.py``,
  ``scripts/tensor_gang.py``, ``scripts/axes_gang.py``,
  ``scripts/expert_gang.py``) names
  them: the GPU machine has no ``msgpack``, so the export reader is the
  port's own.
- Without CUDA, an entry point called without ``device="cpu"`` raises.
- On a CPU tensor the flash wrapper takes the plain version and counts
  no launch.
"""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import kubeflow_tpu_torch
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.serving.model import LoadedModel
from kubeflow_tpu_torch.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)
from kubeflow_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(kubeflow_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="kubeflow_tpu_torch."))


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "scripts", "profile_torch_llama.py")
    yield os.path.join(ROOT, "scripts", "bn_phase_times.py")
    yield os.path.join(ROOT, "scripts", "decode_invariance.py")
    yield os.path.join(ROOT, "scripts", "manager_phase.py")
    yield os.path.join(ROOT, "scripts", "train_phase.py")
    yield os.path.join(ROOT, "scripts", "registry_phase.py")
    yield os.path.join(ROOT, "scripts", "measure_phase.py")
    yield os.path.join(ROOT, "scripts", "smoke_breakdown.py")
    yield os.path.join(ROOT, "scripts", "gang_phase.py")
    yield os.path.join(ROOT, "scripts", "tensor_gang.py")
    yield os.path.join(ROOT, "scripts", "axes_gang.py")
    yield os.path.join(ROOT, "scripts", "expert_gang.py")


def test_every_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert "kubeflow_tpu_torch.ops.flash_attention" in mods
    assert "kubeflow_tpu_torch.inference.engine.engine" in mods
    assert "kubeflow_tpu_torch.serving.export" in mods
    # The serving plane, the lazily-importing modules included (the
    # tornado server, the grpc listener, the scrape handlers).
    for name in ("serving.manager", "serving.server", "serving.grpc_server",
                 "serving.wire", "serving._native", "serving.remote",
                 "serving.faults", "serving.version_policy",
                 "serving.overload", "serving.tenancy", "obs.exposition",
                 "scaling.policy", "scaling.endpoints",
                 # The rest of the registry and the pod launcher.
                 "models.bert", "models.vit", "models.inception",
                 "models.classic_cnn", "models.layers", "ops.moe",
                 "training.launcher",
                 # The measuring entry points and what they need.
                 "utils.platform", "inference.benchmark",
                 "serving.benchmark", "serving.export_cli",
                 "serving.sharding"):
        assert f"kubeflow_tpu_torch.{name}" in mods, name
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'msgpack',\n"
            "             'kubeflow_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k.split('.')[0] in ('jax', 'flax') and v "
            "is not None for k, v in sys.modules.items())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|msgpack)\b|from\s+(jax|flax|msgpack)\b)"
    r"|\bkubeflow_tpu\.",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_line_names_jax_flax_or_the_reference(path):
    with open(path) as f:
        hits = _FORBIDDEN.findall(f.read())
    assert not hits, f"{path}: {hits}"


def test_no_source_names_the_done_parallelism_item():
    """The batch axes of ROADMAP A14 are ported: no raise or note of the
    package or of its GPU scripts still names A14; what is not ported of
    parallelism names A18."""
    named = [path for path in _sources()
             if re.search(r"\bA14\b", open(path, encoding="utf-8").read())]
    assert named == []


def test_without_cuda_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model("llama-test").make(dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.init_params(model, seed=0)
    params = convert.init_params(model, seed=0, device="cpu")
    meta = ModelMetadata(
        model_name="m", registry_name="llama-test",
        model_kwargs={"dtype": "float32"},
        signatures={"serving_default": Signature(
            method="predict",
            inputs={"input_ids": TensorSpec("int32", (-1, 4))},
            outputs={})})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LoadedModel(meta, 1, params)
    assert LoadedModel(meta, 1, params, device="cpu").device.type == "cpu"


def test_device_resolution_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_tensor_takes_plain_version_and_counts_no_launch(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(fa._build, "load", no_build)
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 70, 4, 16), dtype=np.float32)) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref)
    assert fa.flash_attention.launches == 0


def test_chip_smoke_refuses_without_cuda():
    # The sandbox has no GPU: the script must fail, and print no result.
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
