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

"""Replica roles of the serving fleet.

The part of the reference's scaling/endpoints.py that the model
server speaks: the role vocabulary for prefill/decode pool splitting
and its degrade rule. The endpoint registry, pool and health prober
(the proxy's half) are not ported.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ROLES", "ROLE_ANY", "ROLE_DECODE", "ROLE_PREFILL",
           "normalize_role"]

#: Replica roles: ``prefill`` replicas serve the compute-bound prompt
#: pass, ``decode`` replicas adopt the handed-off KV cache and stream
#: tokens, ``any`` does both. An unrecognized role string DEGRADES to
#: ``any``: a mid-rollout replica reading a newer writer's value must
#: keep serving, never crash.
ROLE_PREFILL, ROLE_DECODE, ROLE_ANY = "prefill", "decode", "any"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_ANY)


def normalize_role(role: Optional[str]) -> str:
    """Unknown/absent roles degrade to ``any`` (never raise: the
    value may come from a newer writer mid-rollout)."""
    return role if role in ROLES else ROLE_ANY
