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

"""Pod entrypoint: distributed bootstrap + user-program supervision.

Port of ``kubeflow_tpu/training/launcher.py``. The operator injects the
gang's bootstrap env (the reference's contract, unchanged):

  KFT_COORDINATOR_ADDRESS  host:port of process 0
  KFT_NUM_PROCESSES        gang size
  KFT_PROCESS_ID           this process's index
  KFT_REPLICA_TYPE/_INDEX  replica identity (chief detection)

and, for a multi-slice job, ``MEGASCALE_NUM_SLICES`` /
``MEGASCALE_SLICE_ID`` / ``MEGASCALE_COORDINATOR_ADDRESS``.

:func:`initialize_distributed` maps it onto
``torch.distributed.init_process_group``: a TCP rendezvous at the
coordinator address, world size ``KFT_NUM_PROCESSES``, rank
``KFT_PROCESS_ID``; nccl on the card (each process on card ``rank mod
count``), gloo on the CPU. The device is the caller's, else the pod
env's (``utils/platform.py``: ``JAX_PLATFORMS=cpu``, the operator's
simulated mode, means the CPU). It does nothing for one process, and
nothing if the group is already up. :func:`launch` runs the user command as a
supervised child (the child joins the gang itself: the env travels to
it, and the port's trainer CLIs call :func:`initialize_distributed`),
or with no command joins here and runs the port's benchmark CLI in
process.

Imports nothing heavier than ``torch``, and that only when a gang forms.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
from datetime import timedelta
from typing import List, Optional, Sequence

from kubeflow_tpu_torch.utils.platform import device_from_env

logger = logging.getLogger(__name__)

ENV_COORD = "KFT_COORDINATOR_ADDRESS"
ENV_NPROC = "KFT_NUM_PROCESSES"
ENV_PID = "KFT_PROCESS_ID"
ENV_REPLICA_TYPE = "KFT_REPLICA_TYPE"
ENV_REPLICA_INDEX = "KFT_REPLICA_INDEX"
ENV_SLEEP = "KFT_SLEEP_ON_SUCCESS"
ENV_MEGASCALE_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_MEGASCALE_COORD = "MEGASCALE_COORDINATOR_ADDRESS"

# Exit code for a preemption drain: the pod was told to terminate,
# finished its in-flight step, wrote a checkpoint, and exited. Apart
# from success (0) and a crash (1, 134, 139, ...), so the operator
# restarts the slice without charging its restart budget.
DRAIN_EXIT_CODE = 77

#: How long a process waits for its gang at the rendezvous.
RENDEZVOUS_TIMEOUT = timedelta(minutes=10)


def distributed_config(env=os.environ) -> Optional[dict]:
    """The operator-injected gang description, or None (single host).
    A multi-slice job is one flat gang here (``num_processes`` counts
    every worker of every slice; ``process_id`` is the slice-major
    global index); :func:`slice_config` carries the slice structure."""
    if ENV_COORD not in env:
        return None
    return {
        "coordinator_address": env[ENV_COORD],
        "num_processes": int(env.get(ENV_NPROC, "1")),
        "process_id": int(env.get(ENV_PID, "0")),
    }


def slice_count_from_env(env=os.environ) -> int:
    """Number of slices this job spans, per the megascale env (1 when
    unset)."""
    raw = env.get(ENV_MEGASCALE_SLICES, "").strip()
    if not raw:
        return 1
    count = int(raw)
    if count < 1:
        raise ValueError(f"{ENV_MEGASCALE_SLICES}={raw!r} must be >= 1")
    return count


def slice_config(env=os.environ) -> Optional[dict]:
    """The operator-injected multi-slice description, or None for a
    single-slice job (which carries no MEGASCALE_* vars)."""
    num_slices = slice_count_from_env(env)
    if num_slices <= 1:
        return None
    return {
        "num_slices": num_slices,
        "slice_id": int(env.get(ENV_MEGASCALE_SLICE_ID, "0")),
        "coordinator_address": env.get(ENV_MEGASCALE_COORD),
    }


def initialize_distributed(env=os.environ, device=None) -> bool:
    """``torch.distributed.init_process_group`` from the env; True if
    this process is in a gang of more than one. ``device``: ``"cpu"``
    forms a gloo group; ``"cuda"`` an nccl group, with this process on
    card ``process_id mod device_count``; ``None`` takes the env's
    (``platform.device_from_env``: the CPU under ``JAX_PLATFORMS=cpu``,
    else the card).
    Idempotent: an initialized group is left as it is (the launcher's
    fallthrough joins, then runs a CLI that calls this again)."""
    config = distributed_config(env)
    if config is None:
        logger.info("single-process run (no %s)", ENV_COORD)
        return False
    if config["num_processes"] <= 1:
        logger.info("single-process run (%s=1)", ENV_NPROC)
        return False
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        logger.info("torch.distributed already initialized; skipping")
        return True
    slices = slice_config(env)
    if slices:
        logger.info("multi-slice gang: slice %d of %d (megascale "
                    "coordinator %s)", slices["slice_id"],
                    slices["num_slices"], slices["coordinator_address"])
    if device is None:
        device = device_from_env(env)
    cpu = torch.device(device).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; a gang on the card needs it. Pass "
                "device='cpu', or set JAX_PLATFORMS=cpu in the env, for a "
                "gloo gang on the CPU.")
        torch.cuda.set_device(config["process_id"]
                              % torch.cuda.device_count())
    logger.info("init_process_group(%s, tcp://%s, world_size=%d, rank=%d)",
                backend, config["coordinator_address"],
                config["num_processes"], config["process_id"])
    dist.init_process_group(
        backend, init_method=f"tcp://{config['coordinator_address']}",
        world_size=config["num_processes"], rank=config["process_id"],
        timeout=RENDEZVOUS_TIMEOUT)
    return True


def run_and_stream(command: Sequence[str]) -> int:
    """Run the user program, streaming its output into our logs."""
    logger.info("running: %s", " ".join(command))
    process = subprocess.Popen(
        list(command), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, errors="replace")
    assert process.stdout is not None
    for line in process.stdout:
        logger.info("%s", line.rstrip("\n"))
    process.wait()
    logger.info("command exited with %d", process.returncode)
    return process.returncode


def launch(argv: Optional[List[str]] = None, env=os.environ) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s|%(asctime)s|%(pathname)s|%(lineno)d| "
               "%(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
    )
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv:
        # The child owns the gang join (the env travels to it): a join
        # here too would take the child's rank at the rendezvous.
        rc = run_and_stream(argv)
    else:
        # No user program: the stock benchmark, in process, on the
        # gang joined here (the CLI's own join is then a no-op), on the
        # device the pod env names.
        device = device_from_env(env)
        initialize_distributed(env, device=device)
        from kubeflow_tpu_torch.training.benchmark import main as bench_main

        rc = bench_main(["--device", device])
    if rc == 0 and env.get(ENV_SLEEP, "").lower() in ("1", "true", "yes"):
        # The reference launcher's sleep-forever on success, for
        # operators that would restart a completed pod; off by default.
        logger.info("success; sleeping forever (%s set)", ENV_SLEEP)
        while True:
            time.sleep(3600)
    return rc


if __name__ == "__main__":
    raise SystemExit(launch())
