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

"""Overload-control primitives for the serving request path.

The port's copy of the reference's ``serving/overload.py``, whole:

- **Deadlines**: a request carries its *remaining* budget hop to hop
  (``X-Deadline-Ms`` on HTTP, ``grpc-timeout`` on gRPC); every layer
  subtracts the time it spent, and expired work is dropped at the
  earliest layer that notices, never executed.
- **Admission control**: reject at enqueue when the estimated queue
  wait (batch-latency EWMA × queued batches) already exceeds the
  remaining budget: a fast 503 beats a slow guaranteed 504.
- **Circuit breaker, hedging and retry budget**: the client-side
  machinery (:class:`CircuitBreaker`, :class:`HedgeThrottle`,
  :class:`RetryPolicy`, :class:`QuantileWindow`), so the port serves
  and calls with the reference's semantics."""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

__all__ = [
    "DEADLINE_HEADER",
    "CircuitBreaker",
    "DeadlineExceededError",
    "HedgeThrottle",
    "LatencyEstimator",
    "OverloadedError",
    "QuantileWindow",
    "QuotaExceededError",
    "RetryPolicy",
    "clamp_wait_s",
    "deadline_after",
    "parse_deadline_ms",
    "remaining_s",
    "request_deadline",
    "retry_after_header",
]

#: HTTP request/response header carrying the REMAINING deadline budget
#: in milliseconds (the gRPC surfaces use the native ``grpc-timeout``).
#: Each hop forwards the budget minus its own elapsed time, so the
#: value is always relative — no clock synchronization between hops.
DEADLINE_HEADER = "X-Deadline-Ms"


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


class QuotaExceededError(OverloadedError):
    """ONE tenant's token bucket ran dry (serving/tenancy.py) — the
    server has capacity, this tenant spent its share.

    Maps to HTTP 429 + ``Retry-After`` (distinct from the 503 global
    shed: a 503 says "the server is full, anyone retrying makes it
    worse"; a 429 says "YOU are over quota — everyone else is fine").
    Subclasses :class:`OverloadedError` so layers without a dedicated
    handler still degrade to the safe shed semantics
    (RESOURCE_EXHAUSTED + backoff) instead of a 500.
    """

    def __init__(self, message: str, *, tenant: str,
                 retry_after_s: float = 1.0):
        super().__init__(message, retry_after_s=retry_after_s)
        self.tenant = tenant


# -- deadline arithmetic -----------------------------------------------------
#
# A deadline is a plain ``time.monotonic()`` timestamp (absolute within
# this process, never wall-clock — NTP steps must not expire requests).


def deadline_after(budget_s: float) -> float:
    """Absolute monotonic deadline ``budget_s`` from now."""
    return time.monotonic() + budget_s


def remaining_s(deadline: Optional[float]) -> Optional[float]:
    """Seconds until ``deadline`` (negative = expired); None passes
    through (no deadline)."""
    if deadline is None:
        return None
    return deadline - time.monotonic()


def parse_deadline_ms(value) -> Optional[float]:
    """Parse a deadline budget in milliseconds (header or JSON field)
    into SECONDS. None/empty → None. Malformed values raise ValueError
    (a client that sends a deadline it can't spell should get a 400,
    not an accidental unbounded request)."""
    if value is None or value == "":
        return None
    budget_ms = float(value)  # ValueError propagates
    return budget_ms / 1000.0


def clamp_wait_s(deadline: Optional[float], ceiling_s: float) -> float:
    """Future-wait budget for one blocking wait: the server ceiling
    when the request has no deadline, else the remaining budget capped
    at the ceiling and floored just above zero (a non-positive wait
    would mean 'forever' to some APIs)."""
    if deadline is None:
        return ceiling_s
    return max(0.001, min(ceiling_s, deadline - time.monotonic()))


def retry_after_header(retry_after_s: float) -> str:
    """RFC 7231 Retry-After is integer delta-seconds; round up so the
    client never comes back before the estimate."""
    return str(max(1, int(-(-retry_after_s // 1))))


def request_deadline(headers, body) -> Optional[float]:
    """Absolute monotonic deadline for one HTTP request: the
    ``X-Deadline-Ms`` header (preferred — proxies rewrite it hop to
    hop with the remaining budget) or the JSON body's ``deadline_ms``
    field. None = unbounded (legacy clients). Malformed values raise
    ValueError (callers map it to 400)."""
    budget_s = parse_deadline_ms(headers.get(DEADLINE_HEADER))
    if budget_s is None and isinstance(body, dict):
        budget_s = parse_deadline_ms(body.get("deadline_ms"))
    if budget_s is None:
        return None
    return deadline_after(budget_s)


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


class QuantileWindow:
    """Thread-safe bounded sample window with quantile reads — the
    rolling-latency primitive behind brownout detection (per-replica
    p50 vs the pool, scaling/endpoints.py) and budget-aware hedging
    (the p95 hedge delay, http_proxy.py). A deque, not a sketch: the
    windows are small (≤ a few hundred samples) and exact quantiles
    keep the k-MAD outlier math honest."""

    def __init__(self, maxlen: int = 64):
        if maxlen < 1:
            raise ValueError("maxlen must be >= 1")
        from collections import deque

        self._samples = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._samples.append(float(value))

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._samples)

    def quantile(self, q: float, *, last: Optional[int] = None
                 ) -> Optional[float]:
        """Exact quantile of the window (or of the most recent
        ``last`` samples — the recovery check reads only samples taken
        since the soft-eject). None when empty."""
        with self._lock:
            samples = list(self._samples)
        if last is not None:
            samples = samples[-last:]
        if not samples:
            return None
        samples.sort()
        idx = min(len(samples) - 1,
                  max(0, int(round(q * (len(samples) - 1)))))
        return samples[idx]


class HedgeThrottle:
    """Caps hedged requests at ``rate`` per offered request: every
    real request deposits ``rate`` credits (bounded burst), every
    fired hedge spends one — so over any window, hedges/requests ≤
    rate, whatever the latency distribution does. Without the cap, a
    fleet-wide slowdown makes EVERY request look hedge-worthy and the
    hedger doubles offered load exactly when capacity is scarcest
    (the retry-storm failure mode, re-invented)."""

    def __init__(self, rate: float, *, burst: float = 2.0):
        if not 0.0 <= rate <= 1.0:
            raise ValueError("hedge rate must be in [0, 1]")
        self.rate = rate
        self._burst = max(1.0, burst)
        self._credits = 0.0
        self._lock = threading.Lock()

    def note_request(self) -> None:
        """One offered (non-hedge) request arrived."""
        with self._lock:
            self._credits = min(self._burst, self._credits + self.rate)

    def try_acquire(self) -> bool:
        """May a hedge fire now? Consumes one credit on True."""
        with self._lock:
            if self._credits >= 1.0:
                self._credits -= 1.0
                return True
            return False


class CircuitBreaker:
    """Consecutive-failure circuit breaker: closed → open → half-open.

    Closed: calls flow; ``failure_threshold`` consecutive transport
    failures trip it open. Open: ``allow()`` returns False (the caller
    fast-fails in microseconds — no socket, no timeout) until
    ``reset_timeout_s`` elapses. Then half-open: exactly ONE probe call
    is admitted; its success closes the circuit, its failure re-opens
    it for another full timeout. Only transport-level failures
    (connect refused/timed out) should be recorded — an application
    error proves the backend is alive.

    All three transitions are driven lazily from ``allow()`` /
    ``record_*`` under one lock; there is no timer thread.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 5.0, *, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """True = place the call (and report back via record_*);
        False = fast-fail now with Retry-After ≈ retry_after_s()."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now - self._opened_at < self.reset_timeout_s:
                    return False
                self._state = self.HALF_OPEN
                self._probe_in_flight = False
            # Half-open: admit one probe at a time; if a probe was
            # abandoned (caller died without recording), re-admit after
            # another reset timeout rather than sticking half-open
            # forever.
            if self._probe_in_flight:
                if now - self._opened_at < 2 * self.reset_timeout_s:
                    return False
                self._opened_at = now - self.reset_timeout_s
            self._probe_in_flight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN:
                # The probe failed: re-open for a fresh timeout.
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probe_in_flight = False
            elif (self._state == self.CLOSED
                  and self._failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()

    def retry_after_s(self) -> float:
        """Seconds until the next probe would be admitted (the
        Retry-After hint for fast-failed callers)."""
        with self._lock:
            if self._state == self.CLOSED:
                return 0.0
            elapsed = self._clock() - self._opened_at
            return max(0.001, self.reset_timeout_s - elapsed)


class RetryPolicy:
    """Client retry budget: capped attempts, exponential backoff with
    full jitter, ``Retry-After`` honored as a floor, retriable status
    codes only. The sleep/deadline loop lives with the caller (sync
    urllib here, potentially async elsewhere); this object only
    answers "may I retry?" and "how long do I wait?"."""

    def __init__(self, max_attempts: int = 3, base_backoff_s: float = 0.1,
                 max_backoff_s: float = 2.0, multiplier: float = 2.0,
                 retriable_codes=(429, 502, 503), *,
                 rng: Optional[random.Random] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.multiplier = multiplier
        self.retriable_codes = frozenset(retriable_codes)
        self._rng = rng or random.Random()

    def retriable(self, code: Optional[int]) -> bool:
        """Transport failures arrive as code None (connection refused /
        reset — always worth one more try within budget); application
        codes must be on the retriable list. 504 is deliberately NOT
        retriable: the deadline that produced it has already lapsed."""
        return code is None or code in self.retriable_codes

    def backoff_s(self, attempt: int,
                  retry_after_s: Optional[float] = None) -> float:
        """Sleep before retry number ``attempt`` (0-based: the wait
        after the first failure is attempt 0). Full jitter on the
        exponential term — synchronized retries from a fleet of
        clients re-create the very overload spike they are backing
        off from — floored at the server's Retry-After hint."""
        ceiling = min(self.base_backoff_s * self.multiplier ** attempt,
                      self.max_backoff_s)
        sleep = self._rng.uniform(0.0, ceiling)
        if retry_after_s is not None:
            sleep = max(sleep, retry_after_s)
        return sleep
