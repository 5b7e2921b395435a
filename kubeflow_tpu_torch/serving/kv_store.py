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

"""Tier 2 of the tiered KV memory: the fleet pull-through KV store.

The port's copy of ``kubeflow_tpu/serving/kv_store.py`` (stdlib and
numpy), on the port's ``serving/wire.py``. Tier 1
(``inference/engine/kv_tier.py``) keeps one replica's evicted prefix
pages in its host RAM; here a replica that misses locally asks the
prefix key's rendezvous owner (the proxy names it in the
``X-KFT-KV-Owner`` header) for the prefix blocks over the ``:kv/fetch``
endpoint, imports them into its host tier, and lets the ordinary
admission path splice them device-ward. The blocks' leaves travel in
the reference's order (``paged_kv.kv_leaf_order``), so either package
may own or ask.

The design rule: a fleet fetch is an optimisation, never load-bearing.
Every failure (owner down, deadline, malformed payload, version skew, a
clean miss) degrades to zero blocks imported and the request prefills
locally. Nothing here raises past :func:`prefetch_into`. The fetch
deadline (``kv_fetch_deadline_ms``, also capped by the request's own
remaining budget) bounds the added latency; the ``kv_fetch_ms`` bucket
of the engine_request span shows the spend.

The bytes: the owner exports what its pages hold (msgpack carries them
byte-exact), the importer derives the chain hashes from the tokens (a
peer's keys are never trusted), and the splice is the host tier's.
"""

from __future__ import annotations

import base64
import json
import logging
import time
import urllib.request
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "DEFAULT_FETCH_DEADLINE_MS",
    "KV_OWNER_HEADER",
    "fetch_blocks",
    "kv_fetch_path",
    "prefetch_into",
    "prompt_of",
]

#: The proxy names the prefix key's rendezvous owner here when the
#: chosen endpoint isn't it; the server treats the value as the base
#: URL to ``:kv/fetch`` from. Absent header = no fetch (the request
#: either landed on the owner or carries no usable prefix key).
KV_OWNER_HEADER = "X-KFT-KV-Owner"

#: Default fetch budget when ``kv_fetch_deadline_ms`` is not in the
#: export's generate_config. Small on purpose: past this, paying the
#: local prefill is usually faster than waiting on a slow peer, and
#: the whole tier must never become a tail-latency source. 0 in the
#: config disables fleet fetching for the model entirely.
DEFAULT_FETCH_DEADLINE_MS = 250


def kv_fetch_path(model: str, version: Optional[int] = None) -> str:
    """URL path of the owner's fetch endpoint. The asker pins its OWN
    resident version: mid-rollout, an owner serving a different
    version answers a clean 400/miss instead of shipping bytes the
    asker's cache layout can't adopt."""
    if version is not None:
        return f"/v1/models/{model}/versions/{int(version)}:kv/fetch"
    return f"/v1/models/{model}:kv/fetch"


def prompt_of(instances: Any) -> Optional[List[int]]:
    """The FIRST request row's token ids — the same row the balancer's
    ``normalize_prefix_key`` buckets by, so the fetch asks for exactly
    the prefix the routing decision was made on. None on malformed
    input (the caller skips the fetch; never an error)."""
    try:
        ids = [int(t) for t in list(instances[0])]
        return ids or None
    except (TypeError, ValueError, IndexError, KeyError):
        return None


def fetch_blocks(owner_url: str, model: str, version: int,
                 page_size: int, tokens: Sequence[int],
                 timeout_s: float
                 ) -> List[Tuple[Tuple[int, ...], List[np.ndarray]]]:
    """One ``:kv/fetch`` round trip to the rendezvous owner. Returns
    the decoded block chain (possibly empty — a clean miss). Raises
    on transport failure, non-200, or a malformed/mismatched payload;
    :func:`prefetch_into` maps every raise to fall-back-to-prefill."""
    from kubeflow_tpu_torch.serving import wire

    url = owner_url.rstrip("/") + kv_fetch_path(model, version)
    req = urllib.request.Request(
        url, data=json.dumps(
            {"tokens": [int(t) for t in tokens]}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        payload = json.loads(resp.read())
    blob = payload.get("blocks")
    if not blob:
        return []
    return wire.decode_kv_blocks(
        base64.b64decode(blob), model=model, version=version,
        page_size=page_size)


def prefetch_into(engine, model: str, version: int, owner_url: str,
                  tokens: Sequence[int], *,
                  deadline_ms: int = DEFAULT_FETCH_DEADLINE_MS,
                  deadline: Optional[float] = None) -> float:
    """Pull the prompt's prefix blocks from ``owner_url`` into
    ``engine``'s host tier before the engine pays prefill. Returns
    the seconds spent (the caller threads it into the request's
    ``kv_fetch`` attribution bucket); 0.0 when the fetch didn't
    engage. NEVER raises — every failure is a silent fall-back to
    local prefill (see the module doc).

    The fetch is skipped outright when it cannot pay off: no host
    tier to land blocks in, a prompt too short to span a full block,
    a local prefix match that already covers every full block, or a
    request budget (``deadline``, absolute monotonic) already tighter
    than any useful fetch."""
    if engine is None or getattr(engine, "host_tier", None) is None:
        return 0.0
    try:
        ids = [int(t) for t in tokens]
    except (TypeError, ValueError):
        return 0.0
    page = int(engine.config.page_size)
    # Same coverage cap as the prefix cache's match walk: the final
    # prompt token is always computed by the bind's tail prefill, so
    # only blocks fully inside [0, len-1) can ever be consumed.
    want_blocks = max(0, (len(ids) - 1) // page)
    if want_blocks == 0:
        return 0.0
    if engine.probe_prefix(np.asarray(ids, np.int32)) \
            >= want_blocks * page:
        return 0.0  # already local (HBM or host) — nothing to pull
    timeout_s = max(0, int(deadline_ms)) / 1000.0
    if deadline is not None:
        timeout_s = min(timeout_s, deadline - time.monotonic())
    if timeout_s <= 0:
        return 0.0
    t0 = time.monotonic()
    try:
        blocks = fetch_blocks(owner_url, model, int(version), page,
                              ids, timeout_s)
    except Exception as e:  # noqa: BLE001 — ANY failure = prefill
        engine.note_kv_fetch("error")
        logger.debug("kv fetch from %s failed (falling back to "
                     "prefill): %s", owner_url, e)
        return time.monotonic() - t0
    if not blocks:
        engine.note_kv_fetch("miss")
        return time.monotonic() - t0
    try:
        imported = engine.import_prefix_blocks(blocks)
    except Exception as e:  # noqa: BLE001 — ANY failure = prefill
        engine.note_kv_fetch("error")
        logger.debug("kv import of %d fetched blocks failed: %s",
                     len(blocks), e)
        return time.monotonic() - t0
    engine.note_kv_fetch("hit" if imported else "miss",
                         blocks=imported)
    return time.monotonic() - t0
