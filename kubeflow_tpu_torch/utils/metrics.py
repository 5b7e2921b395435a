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


"""Metrics emission: statsd (UDP) and structured JSONL.

The port's copy of ``kubeflow_tpu/utils/metrics.py``: a dependency-free
statsd client and a JSONL writer for training metrics, the durable
artifact a job keeps next to its checkpoints. Scrapeable metrics live
in :mod:`kubeflow_tpu_torch.obs.metrics`; the training loop publishes
its step time and throughput there too.
"""

from __future__ import annotations

import json
import socket
import time
from pathlib import Path
from typing import IO, Any, Dict, Optional


class StatsdClient:
    """Minimal statsd UDP client (gauge/counter/timing). Fire-and-
    forget: network errors are swallowed, so metrics never take down
    the process that emits them."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "kft"):
        self._addr = (host, port)
        self._prefix = prefix
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _send(self, payload: str) -> None:
        try:
            self._sock.sendto(payload.encode(), self._addr)
        except OSError:
            pass

    def gauge(self, name: str, value: float) -> None:
        self._send(f"{self._prefix}.{name}:{value}|g")

    def incr(self, name: str, value: int = 1) -> None:
        self._send(f"{self._prefix}.{name}:{value}|c")

    def timing(self, name: str, ms: float) -> None:
        self._send(f"{self._prefix}.{name}:{ms}|ms")

    def close(self) -> None:
        self._sock.close()


class MetricsLogger:
    """Structured training metrics: JSONL file + optional statsd."""

    def __init__(self, path: Optional[str] = None,
                 statsd: Optional[StatsdClient] = None):
        self._file: Optional[IO[str]] = None
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            self._file = open(path, "a", buffering=1)
        self._statsd = statsd

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": step, "ts": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if self._file:
            self._file.write(json.dumps(record) + "\n")
        if self._statsd:
            for k, v in record.items():
                if k not in ("step", "ts") and isinstance(v, float):
                    self._statsd.gauge(f"train.{k}", v)

    def close(self) -> None:
        if self._file:
            self._file.close()
