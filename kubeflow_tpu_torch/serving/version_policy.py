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

"""Model-server version policy: which ``<base>/<N>/`` dirs to serve.

The port's copy of the reference's ``serving/version_policy.py``
(``latest`` | ``all`` | ``specific:<v>[,<v>...]``), stdlib only, so
the server's flag parser and the manager share one grammar."""

from __future__ import annotations

from typing import Tuple


def parse_version_policy(policy: str) -> Tuple[str, Tuple[int, ...]]:
    """``latest`` | ``all`` | ``specific:<v>[,<v>...]`` → (kind, pins)."""
    if policy == "latest":
        return "latest", ()
    if policy == "all":
        return "all", ()
    if policy.startswith("specific:"):
        raw = policy[len("specific:"):]
        try:
            pins = tuple(sorted({int(v) for v in raw.split(",")
                                 if v.strip()}))
        except ValueError:
            raise ValueError(
                f"version_policy {policy!r}: versions must be integers")
        if not pins:
            raise ValueError(
                "version_policy 'specific:' needs at least one version")
        return "specific", pins
    raise ValueError(
        f"unknown version_policy {policy!r}; expected latest | all | "
        f"specific:<v>[,<v>...]")
