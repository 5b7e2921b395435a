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

"""Build the hand-written CUDA kernels in ``csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into
``_build/lib<name>-<hash>.so`` inside the package (the directory is
git-ignored), with a plain C interface bound through ``ctypes``: no
PyTorch headers, so a build takes seconds rather than the minutes of
``torch.utils.cpp_extension``. The hash is of the source, so an edited
kernel is rebuilt and a stale library is never loaded.

``build_all()`` starts one ``nvcc`` per source at once and waits for
all of them; ``load(name)`` builds one source if needed and returns the
``ctypes.CDLL``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built on the machine with the GPU")
    return path


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start ``nvcc`` for one source; None if its library is built."""
    src, lib = _target(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> str:
    """Wait for one build, publish its library atomically, and keep
    the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) beside it. Returns that report."""
    proc, tmp, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib)
    with open(lib + ".log", "w") as f:
        f.write(out)
    return out


def build_all() -> Dict[str, str]:
    """Build every ``csrc/*.cu`` in parallel, one ``nvcc`` each.
    Returns ``{name: compiler report}`` (empty for a source already
    built)."""
    started = {name: _start(name) for name in sources()}
    reports = {}
    for name, s in started.items():
        reports[name] = "" if s is None else _finish(name, s)
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            _libs[name] = ctypes.CDLL(_target(name)[1])
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a nonzero ``cudaError_t``: a launch
    refused for its shared memory or thread count never runs, and a
    later ``synchronize()`` would not report it."""
    if err != 0:
        lib.kft_cuda_error_string.restype = ctypes.c_char_p
        lib.kft_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.kft_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
