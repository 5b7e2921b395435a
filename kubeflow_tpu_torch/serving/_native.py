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

"""ctypes bindings for ``native/libkft_runtime.so`` (the micro-batching
queue and the version-dir scanner) with a pure-Python fallback, used
when the shared library has not been built. The port's copy of the
reference's bindings: the library is found at the same
``<repo>/native/`` path, three levels above this file."""

from __future__ import annotations

import collections
import ctypes
import os
import threading
import time
from pathlib import Path
from typing import List, Optional

# Env override first so sanitizer builds (native/Makefile asan/tsan
# targets) actually get loaded over the bundled library.
_LIB_PATHS = [
    Path(os.environ.get("KFT_RUNTIME_LIB", "")),
    Path(__file__).resolve().parent.parent.parent / "native" / "libkft_runtime.so",
]


def _load() -> Optional[ctypes.CDLL]:
    for path in _LIB_PATHS:
        if path and path.is_file():
            lib = ctypes.CDLL(str(path))
            lib.kft_queue_create.restype = ctypes.c_void_p
            lib.kft_queue_create.argtypes = [ctypes.c_int]
            lib.kft_queue_destroy.argtypes = [ctypes.c_void_p]
            lib.kft_queue_push.restype = ctypes.c_int
            lib.kft_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.kft_queue_close.argtypes = [ctypes.c_void_p]
            lib.kft_queue_size.restype = ctypes.c_int
            lib.kft_queue_size.argtypes = [ctypes.c_void_p]
            lib.kft_queue_pop_batch.restype = ctypes.c_int
            lib.kft_queue_pop_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.kft_scan_latest_version.restype = ctypes.c_int64
            lib.kft_scan_latest_version.argtypes = [ctypes.c_char_p]
            lib.kft_now_us.restype = ctypes.c_int64
            return lib
    return None


_LIB = _load()


def native_available() -> bool:
    return _LIB is not None


class RequestQueue:
    """MPMC id queue with micro-batch pop (native-backed)."""

    def __init__(self, capacity: int = 4096):
        self._capacity = capacity
        if _LIB is not None:
            self._handle = _LIB.kft_queue_create(capacity)
        else:
            self._handle = None
            self._items: collections.deque = collections.deque()
            self._lock = threading.Lock()
            self._cond = threading.Condition(self._lock)
            self._closed = False

    def push(self, request_id: int) -> bool:
        """True if enqueued; False if the queue is full (shed load)."""
        if self._handle is not None:
            rc = _LIB.kft_queue_push(self._handle, request_id)
            if rc == -2:
                raise RuntimeError("queue closed")
            return rc == 0
        with self._cond:
            if self._closed:
                raise RuntimeError("queue closed")
            if len(self._items) >= self._capacity:
                return False
            self._items.append(request_id)
            self._cond.notify()
            return True

    def pop_batch(self, max_n: int, timeout_s: float = 0.1,
                  window_s: float = 0.002) -> Optional[List[int]]:
        """A micro-batch of ids; [] on timeout; None if closed+drained."""
        if self._handle is not None:
            buf = (ctypes.c_uint64 * max_n)()
            n = _LIB.kft_queue_pop_batch(
                self._handle, buf, max_n,
                int(timeout_s * 1e6), int(window_s * 1e6))
            if n == -2:
                return None
            return [buf[i] for i in range(n)]
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not self._items:
                if self._closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None if self._closed else []
                self._cond.wait(remaining)
            if window_s > 0 and len(self._items) < max_n:
                window_deadline = time.monotonic() + window_s
                while len(self._items) < max_n and not self._closed:
                    remaining = window_deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            n = min(max_n, len(self._items))
            return [self._items.popleft() for _ in range(n)]

    def size(self) -> int:
        if self._handle is not None:
            return _LIB.kft_queue_size(self._handle)
        with self._lock:
            return len(self._items)

    def close(self) -> None:
        if self._handle is not None:
            _LIB.kft_queue_close(self._handle)
        else:
            with self._cond:
                self._closed = True
                self._cond.notify_all()

    def __del__(self):  # pragma: no cover
        if getattr(self, "_handle", None) is not None and _LIB is not None:
            _LIB.kft_queue_destroy(self._handle)
            self._handle = None


def scan_latest_version(base_path: str) -> int:
    """Highest numeric version subdir of base_path, or -1."""
    if _LIB is not None:
        return _LIB.kft_scan_latest_version(str(base_path).encode())
    best = -1
    try:
        for entry in os.listdir(base_path):
            if entry.isdigit() and os.path.isdir(os.path.join(base_path, entry)):
                best = max(best, int(entry))
    except OSError:
        return -1
    return best
