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

"""Request tracing: propagated context + an in-process span ring buffer.

The port's own copy of the parts of ``kubeflow_tpu/obs/tracing.py``
that the decode engine records through: :class:`TraceContext` (the
W3C trace/span ids and the request id a request carries),
:func:`span_args` (the linkage args every context-tagged span
carries) and :data:`TRACER`, a bounded recorder of Chrome trace-event
spans. Span names and args are the reference's (``engine_prefill``,
``engine_slice``, ``engine_request``, ``engine_compile``), so one
timeline reads the same whichever package recorded it. Header parsing,
tail sampling, span export and the Chrome-trace dump stay in the
reference until the server is ported.
"""

from __future__ import annotations

import os
import random
import threading
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "TRACER",
    "TraceContext",
    "Tracer",
    "new_context",
    "span_args",
]

# Id generation is on the per-request path: uuid.uuid4() costs an
# os.urandom syscall per call. Trace ids need collision resistance, not
# cryptographic strength: a Mersenne twister seeded once from urandom.
# getrandbits is a single C call, so it's GIL-atomic across threads.
_rng = random.Random(int.from_bytes(os.urandom(16), "big"))


def _hex128() -> str:
    return f"{_rng.getrandbits(128):032x}"


def _hex64() -> str:
    return f"{_rng.getrandbits(64):016x}"


class TraceContext:
    """Immutable-ish propagation context: W3C trace/span ids plus the
    human-greppable request id (the access-log join key).
    ``parent_span_id`` is the CALLER's span id (parsed off the inbound
    ``traceparent``) — the edge that lets the collector rebuild the
    cross-process tree; ``leg`` names which leg of a multi-leg request
    this context rides (empty for single-leg requests)."""

    __slots__ = ("trace_id", "span_id", "request_id",
                 "parent_span_id", "leg")

    def __init__(self, trace_id: str, span_id: str, request_id: str,
                 parent_span_id: Optional[str] = None, leg: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id
        self.request_id = request_id
        self.parent_span_id = parent_span_id
        self.leg = leg

    def __repr__(self) -> str:
        return (f"TraceContext(request_id={self.request_id!r}, "
                f"trace_id={self.trace_id!r})")


def new_context(request_id: Optional[str] = None) -> TraceContext:
    trace_id = _hex128()
    return TraceContext(trace_id, _hex64(),
                        request_id or trace_id[:16])


def span_args(ctx: Optional[TraceContext],
              **extra: Any) -> Dict[str, Any]:
    """The span-linkage args every context-tagged span carries:
    request/trace ids for the grep workflow, ``parent_id`` (= the
    context's own span id) for tree assembly, and the leg tag when the
    request is multi-leg. ``extra`` keys ride along verbatim; a None
    context yields just them (the span is then a documented root)."""
    args: Dict[str, Any] = dict(extra)
    if ctx is not None:
        args.setdefault("request_id", ctx.request_id)
        args["trace_id"] = ctx.trace_id
        args["parent_id"] = ctx.span_id
        if ctx.leg:
            args.setdefault("leg", ctx.leg)
    return args


class Tracer:
    """Bounded in-process span recorder.

    ``record()`` appends one finished span (a plain dict, Chrome
    trace-event "X" shape) to a deque with maxlen — O(1), oldest spans
    evicted. ``enabled=False`` makes record() a no-op (one attribute
    read).
    """

    def __init__(self, capacity: int = 4096):
        self.enabled = True
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(capacity))

    def record(self, name: str, cat: str, start_s: float, dur_s: float,
               args: Optional[Dict[str, Any]] = None,
               tid: Optional[int] = None) -> None:
        """Record one completed span. ``start_s`` is a
        ``time.monotonic()`` timestamp; durations in seconds."""
        if not self.enabled:
            return
        event = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": start_s * 1e6,               # µs, Chrome contract
            "dur": dur_s * 1e6 if dur_s > 0.0 else 0.0,
            "pid": self._pid,
            "tid": (tid if tid is not None
                    else threading.get_ident() & 0x7FFFFFFF),
        }
        if args:
            event["args"] = args
        with self._lock:
            self._spans.append(event)

    def snapshot(self) -> List[Dict[str, Any]]:
        """All live spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


TRACER = Tracer()
