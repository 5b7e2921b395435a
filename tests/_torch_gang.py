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

"""A gloo gang of CPU processes for the port's mesh tests.

:func:`run_gang` starts ``world`` processes of ``tests/_torch_gang_worker.py``
that join one gloo group on localhost and run a job over a pickled list
of cases; each writes its results to ``rank<r>.pkl``. A test file runs
its gang once (a module-scoped fixture) and holds each case against the
reference in the pytest process, on its virtual CPU devices.
"""

import os
import pickle
import signal
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_gang_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(job: str, cases, workdir, *, world: int = 2,
             timeout: float = 240.0):
    """Results of ``job`` over ``cases`` from each rank of a ``world``
    gloo gang, in rank order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    cases_path = workdir / "cases.pkl"
    cases_path.write_bytes(pickle.dumps(cases))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.pop("MEGASCALE_NUM_SLICES", None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), job, str(cases_path), str(workdir),
         str(rank), str(world), str(port)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(world)]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]
