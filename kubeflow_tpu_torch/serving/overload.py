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

"""Overload-control primitives the decode engine sheds and expires with.

The port's own copy of the parts of ``kubeflow_tpu/serving/overload.py``
that the engine uses: the two errors a request can fail with before or
while it is served, and the EWMA latency estimate the admission gate
prices a request's time to first token with. Deadlines are plain
``time.monotonic()`` timestamps.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = [
    "DeadlineExceededError",
    "LatencyEstimator",
    "OverloadedError",
]


class DeadlineExceededError(RuntimeError):
    """The request's deadline lapsed before (or while) serving it.

    Maps to HTTP 504 / gRPC DEADLINE_EXCEEDED. Subclasses RuntimeError
    so layers without a specific handler still treat it as a
    server-side, non-4xx condition.
    """


class OverloadedError(RuntimeError):
    """The request was shed (queue full, or admission control judged
    the queue wait longer than the remaining budget).

    Maps to HTTP 503 + ``Retry-After`` / gRPC RESOURCE_EXHAUSTED.
    ``retry_after_s`` is the server's estimate of when capacity frees
    up — the client hint that converts a retry storm into a trickle.
    """

    def __init__(self, message: str, *, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(0.001, float(retry_after_s))


class LatencyEstimator:
    """Thread-safe EWMA of batch dispatch latency, the admission
    controller's crystal ball.

    ``seed()`` installs a prior measured at model-load warmup, so
    admission control works from the very first request instead of
    letting an initial burst through unjudged. ``observe()`` then
    tracks the live traffic mix (alpha=0.2 ≈ the last ~10 batches
    dominate, so a shift from classify-heavy to generate-heavy traffic
    re-centers the estimate within a second of dispatches).
    """

    def __init__(self, alpha: float = 0.2, prior_s: float = 0.05):
        self._alpha = alpha
        self._prior_s = prior_s
        self._value: Optional[float] = None
        self._seeded = False
        self._lock = threading.Lock()

    def seed(self, batch_seconds: float) -> None:
        """Install a warmup-measured prior; live observations override."""
        with self._lock:
            if self._value is None:
                self._value = float(batch_seconds)
                self._seeded = True

    def observe(self, batch_seconds: float) -> None:
        with self._lock:
            if self._value is None or self._seeded:
                self._value = float(batch_seconds)
                self._seeded = False
            else:
                self._value += self._alpha * (batch_seconds - self._value)

    def estimate_s(self) -> float:
        with self._lock:
            return self._prior_s if self._value is None else self._value
