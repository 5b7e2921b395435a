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

"""The pod env's device: ``kubeflow_tpu_torch/utils/platform.py``.

``JAX_PLATFORMS=cpu`` (the operator's simulated mode, which the
reference's launcher honours with a gloo gang) puts the port's launcher
and CLIs on the CPU: ``launch()`` with no command runs the stock bench
there, and a two-process gang joins gloo with no device argument.
Without the env and without CUDA, the card's entry points still raise.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from kubeflow_tpu_torch.training import benchmark, launcher
from kubeflow_tpu_torch.utils.platform import default_device, device_from_env

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env,want", [
    ({}, "cuda"),
    ({"JAX_PLATFORMS": ""}, "cuda"),
    ({"JAX_PLATFORMS": "cpu"}, "cpu"),
    ({"JAX_PLATFORMS": " CPU \n"}, "cpu"),
    ({"JAX_PLATFORMS": "tpu"}, "cuda"),
    ({"JAX_PLATFORMS": "cuda"}, "cuda"),
    ({"JAX_PLATFORMS": "cpu,tpu"}, "cuda"),
    ({"OTHER": "cpu"}, "cuda"),
])
def test_device_from_env(env, want):
    assert device_from_env(env) == want


def test_an_explicit_device_wins_over_the_env():
    assert default_device("cuda", {"JAX_PLATFORMS": "cpu"}) == "cuda"
    assert default_device("cpu", {}) == "cpu"
    assert default_device(None, {"JAX_PLATFORMS": "cpu"}) == "cpu"
    assert default_device(None, {}) == "cuda"


@pytest.fixture
def small_stock_bench(monkeypatch):
    """The stock bench (``tpu-cnn``'s defaults: resnet50, b128, 20 steps)
    cut to resnet-test at 32², b2, 1 + 1 steps, so it runs here; every
    call's config and device are kept."""
    calls = []
    real = benchmark.run_benchmark

    def small(config, device=None):
        calls.append((config.model, device))
        config = benchmark.BenchConfig(
            model="resnet-test", batch_size=2, steps=1, warmup_steps=1,
            image_size=32)
        return real(config, device=device)

    monkeypatch.setattr(benchmark, "run_benchmark", small)
    return calls


@pytest.mark.parametrize("gang", [False, True],
                         ids=["no gang env", "a one-process gang"])
def test_launch_without_a_command_runs_the_stock_bench_on_the_cpu(
        small_stock_bench, capsys, gang):
    env = {"JAX_PLATFORMS": "cpu"}
    if gang:
        env.update({launcher.ENV_COORD: "127.0.0.1:1",
                    launcher.ENV_NPROC: "1", launcher.ENV_PID: "0"})
    assert launcher.launch([], env=env) == 0
    assert small_stock_bench == [("resnet50", "cpu")]
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["device"] == "cpu"
    assert result["images_per_sec"] > 0


def test_without_the_env_and_without_cuda_launch_raises(monkeypatch,
                                                        small_stock_bench):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.launch([], env={})
    assert small_stock_bench == [("resnet50", "cuda")]
    # A gang on the card refuses before its rendezvous.
    gang = {launcher.ENV_COORD: "127.0.0.1:1", launcher.ENV_NPROC: "2",
            launcher.ENV_PID: "0"}
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        launcher.initialize_distributed(gang)


GANG_PROCESS = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from kubeflow_tpu_torch.training import launcher

    assert launcher.initialize_distributed()  # no device argument
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    print(json.dumps({"rank": dist.get_rank(),
                      "backend": dist.get_backend(), "sum": float(x)}))
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_two_process_gang_in_the_simulated_env_joins_gloo():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
                   **{launcher.ENV_COORD: f"127.0.0.1:{port}",
                      launcher.ENV_NPROC: "2", launcher.ENV_PID: str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", GANG_PROCESS], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err[-2000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert sorted(r["rank"] for r in results) == [0, 1]
    for r in results:
        assert r["backend"] == "gloo" and r["sum"] == 3.0
