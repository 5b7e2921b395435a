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

"""kubeflow_tpu_torch.training.launcher against the reference's.

Twins of tests/test_launcher.py and tests/test_env_contract.py: the
operator's own pod env (reconciled on the reference's fake apiserver
from its manifests) fed to the port's launcher gives the reference
launcher's ``distributed_config`` and ``slice_config``. Then a
two-process gloo gang formed by ``initialize_distributed`` from that
contract: SIGTERM reaches process 1 only, and both processes drain at
the same step and exit ``DRAIN_EXIT_CODE``; given a checkpoint
directory, both refuse it (the gang's sharded save is ROADMAP A14).
"""

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from kubeflow_tpu.training import launcher as jax_launcher
from kubeflow_tpu_torch.training import launcher

from test_env_contract import make_contract_job, reconciled_pod_envs

REPO = Path(__file__).resolve().parents[1]
GANG_TIMEOUT = 120


def test_distributed_config_absent_and_parsed():
    assert launcher.distributed_config(env={}) is None
    env = {launcher.ENV_COORD: "job-tpu-worker-0.job:8476",
           launcher.ENV_NPROC: "4", launcher.ENV_PID: "2"}
    assert launcher.distributed_config(env=env) == {
        "coordinator_address": "job-tpu-worker-0.job:8476",
        "num_processes": 4, "process_id": 2}


def test_env_names_are_the_reference_launchers():
    for name in ("ENV_COORD", "ENV_NPROC", "ENV_PID", "ENV_REPLICA_TYPE",
                 "ENV_REPLICA_INDEX", "ENV_SLEEP", "DRAIN_EXIT_CODE"):
        assert getattr(launcher, name) == getattr(jax_launcher, name), name


def test_initialize_single_process_noop():
    assert launcher.initialize_distributed(env={}) is False
    assert launcher.initialize_distributed(env={
        launcher.ENV_COORD: "x:1", launcher.ENV_NPROC: "1",
        launcher.ENV_PID: "0"}) is False


@pytest.mark.parametrize("workers,num_slices,coordinator", [
    (3, 1, False), (2, 2, False), (2, 1, True)])
def test_operator_env_gives_the_reference_configs(workers, num_slices,
                                                  coordinator):
    envs = reconciled_pod_envs(make_contract_job(
        workers=workers, num_slices=num_slices, coordinator=coordinator))
    assert envs
    for pod, env in envs.items():
        assert launcher.distributed_config(env=env) == (
            jax_launcher.distributed_config(env=env)), pod
        assert launcher.slice_config(env=env) == (
            jax_launcher.slice_config(env=env)), pod


def test_run_and_stream_logs_and_exit_code(caplog):
    with caplog.at_level(logging.INFO):
        rc = launcher.run_and_stream(
            [sys.executable, "-c", "print('hello-from-child'); print('l2')"])
    assert rc == 0
    messages = [r.message for r in caplog.records]
    assert "hello-from-child" in messages and "l2" in messages
    assert launcher.run_and_stream(
        [sys.executable, "-c", "import sys; sys.exit(3)"]) == 3


def test_launch_runs_user_command():
    assert launcher.launch([sys.executable, "-c", "pass"], env={}) == 0


# One process of the gang: joins from the launcher's env, then fits a
# trivial state whose step sleeps; process 1 signals itself at step 3.
GANG_PROCESS = textwrap.dedent("""
    import dataclasses, json, os, signal, sys, time
    from kubeflow_tpu_torch.training import launcher
    from kubeflow_tpu_torch.training.checkpoint import CheckpointConfig
    from kubeflow_tpu_torch.training.loop import (
        DrainInterrupt, LoopConfig, fit)

    assert launcher.initialize_distributed(device="cpu")
    import torch.distributed as dist
    rank = dist.get_rank()

    @dataclasses.dataclass
    class State:
        step: int = 0

    def step_fn(state, batch):
        time.sleep(0.05)
        state.step += 1
        if rank == 1 and state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, {"loss": 0.0}

    def batches():
        while True:
            yield None

    ckpt = sys.argv[1] if len(sys.argv) > 1 else None
    try:
        fit(State(), step_fn, batches(),
            LoopConfig(total_steps=50, log_every=100, drain_sync_steps=2,
                       checkpoint=ckpt and CheckpointConfig(directory=ckpt)))
    except NotImplementedError as refused:
        print(json.dumps({"rank": rank, "refused": str(refused)}))
        dist.destroy_process_group()
        sys.exit(0)
    except DrainInterrupt as drain:
        print(json.dumps({"rank": rank, "drained": drain.step}))
        dist.destroy_process_group()
        sys.exit(launcher.DRAIN_EXIT_CODE)
    print(json.dumps({"rank": rank, "drained": None}))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_gang(*args, want_rc):
    """Both processes of a two-worker gang from the operator's env, each
    with ``args``; their last stdout lines, parsed, in rank order."""
    envs = reconciled_pod_envs(make_contract_job(workers=2))
    port = _free_port()
    procs = []
    for pod in sorted(envs):
        env = dict(os.environ, **envs[pod])
        # The operator's address, on this host's loopback.
        env[launcher.ENV_COORD] = f"127.0.0.1:{port}"
        env["PYTHONPATH"] = str(REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", GANG_PROCESS, *args], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=GANG_TIMEOUT)
            assert proc.returncode == want_rc, err[-2000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
    assert sorted(r["rank"] for r in results) == [0, 1]
    return sorted(results, key=lambda r: r["rank"])


def test_two_process_gang_drains_together_at_one_step():
    results = _run_gang(want_rc=launcher.DRAIN_EXIT_CODE)
    # Process 1 saw SIGTERM after step 3; the agreement at step 4 (every
    # 2 steps) drains both there.
    assert [r["drained"] for r in results] == [4, 4]


def test_two_process_gang_refuses_to_checkpoint(tmp_path):
    """The checkpointer writes as one host: a gang whose processes step
    their own states must not write them to one step directory, so both
    processes refuse before a step, naming ROADMAP A14, and nothing is
    written."""
    ckpt = tmp_path / "ckpt"
    results = _run_gang(str(ckpt), want_rc=0)
    for r in results:
        assert "A14" in r["refused"], r
    assert not ckpt.exists()
