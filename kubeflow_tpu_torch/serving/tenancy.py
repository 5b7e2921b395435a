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

"""Tenant identity, capped tenant metrics and the weighted-fair queue.

The port's own copy of what the decode engine uses of
``kubeflow_tpu/serving/tenancy.py``: :data:`DEFAULT_TENANT`, the
cardinality-capped per-tenant metric families (``note_*``,
``observe_ttft``, :func:`tenant_label`, :func:`cap_depths`) and
:class:`FairQueue`, the engine's admission queue. Quotas, API keys and
the policy file come with the server.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

from kubeflow_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "DEFAULT_TENANT",
    "FairQueue",
    "OTHER_TENANT_LABEL",
    "TENANT_CARDINALITY_CAP",
    "TenantLabelCapper",
    "cap_depths",
    "note_expired",
    "note_shed",
    "note_tokens",
    "observe_ttft",
    "tenant_label",
]

logger = logging.getLogger(__name__)

#: Requests without tenant identity land here (single-tenant
#: deployments never send the header and behave exactly as before).
DEFAULT_TENANT = "default"

#: Metric-label overflow bucket and the hard top-K cap: at most
#: TENANT_CARDINALITY_CAP tenants get their own series per process;
#: later arrivals share ``other``. 10k sprayed tenant ids leave
#: ≤ cap+1 label values in /metrics and the collector store.
OTHER_TENANT_LABEL = "other"
TENANT_CARDINALITY_CAP = 16


# -- cardinality-capped tenant metrics ---------------------------------------


class TenantLabelCapper:
    """Hard cap on tenant metric-label cardinality: the first
    ``cap`` distinct tenants keep their own label value, every later
    tenant shares :data:`OTHER_TENANT_LABEL`. First-seen-wins is
    deliberate — a stable mapping means one tenant's series never
    silently changes identity mid-scrape, and an API-key-spraying
    client can at worst claim the overflow bucket."""

    def __init__(self, cap: int = TENANT_CARDINALITY_CAP):
        if cap < 1:
            raise ValueError("cap must be >= 1")
        self.cap = cap
        self._known: Dict[str, str] = {}
        self._lock = threading.Lock()

    def label(self, tenant: str) -> str:
        tenant = tenant or DEFAULT_TENANT
        with self._lock:
            got = self._known.get(tenant)
            if got is not None:
                return got
            label = (tenant if len(self._known) < self.cap
                     else OTHER_TENANT_LABEL)
            self._known[tenant] = label
            return label



#: Process-wide capper shared by every tenant-labeled family below —
#: the cap is per PROCESS, so the fleet-wide series count is bounded
#: by replicas × (cap + 1) per family whatever clients send.
CAPPER = TenantLabelCapper()

_T_SHED = obs_metrics.Counter(
    "kft_tenant_shed_total",
    "Requests turned away per tenant, by reason (quota = the "
    "tenant's own bucket ran dry → 429; overload = global admission "
    "control → 503)", ("tenant", "reason"))
_T_EXPIRED = obs_metrics.Counter(
    "kft_tenant_expired_total",
    "Requests whose deadline lapsed before dispatch, per tenant",
    ("tenant",))
_T_TTFT = obs_metrics.Histogram(
    "kft_tenant_ttft_seconds",
    "Submit to first streamed token per tenant (engine path)",
    ("tenant",))
_T_TOKENS = obs_metrics.Counter(
    "kft_tenant_decode_tokens_total",
    "Decode tokens actually delivered per tenant (billing-grade "
    "usage)", ("tenant",))


def tenant_label(tenant: str) -> str:
    """The capped metric-label value for ``tenant``."""
    return CAPPER.label(tenant)


def cap_depths(depths: Dict[str, int],
               limit: int = TENANT_CARDINALITY_CAP) -> Dict[str, int]:
    """Bound a per-tenant depth map for REPORTING surfaces (healthz /
    batch_stats / engine stats): the top-``limit`` tenants by depth
    keep their own row, the rest aggregate into
    :data:`OTHER_TENANT_LABEL` — the same adversary argument as the
    metric cap (a tenant-spraying client queueing one request per
    fresh id must not balloon every healthz scrape). Internal
    consumers (the queue-full attribution) read the uncapped map."""
    if len(depths) <= limit:
        return dict(depths)
    items = sorted(depths.items(), key=lambda kv: -kv[1])
    out = dict(items[:limit])
    out[OTHER_TENANT_LABEL] = (out.get(OTHER_TENANT_LABEL, 0)
                               + sum(v for _, v in items[limit:]))
    return out


def note_shed(tenant: str, reason: str = "overload") -> None:
    _T_SHED.labels(tenant_label(tenant), reason).inc()


def note_expired(tenant: str) -> None:
    _T_EXPIRED.labels(tenant_label(tenant)).inc()


def note_tokens(tenant: str, n: int = 1) -> None:
    _T_TOKENS.labels(tenant_label(tenant)).inc(n)


def observe_ttft(tenant: str, seconds: float) -> None:
    _T_TTFT.labels(tenant_label(tenant)).observe(max(0.0, seconds))


# -- weighted-fair queueing --------------------------------------------------


def _default_tenant_of(item: Any) -> str:
    return getattr(item, "tenant", "") or DEFAULT_TENANT


class FairQueue:
    """Per-tenant sub-queues drained by start-time fair queueing.

    Each active tenant carries a virtual time; :meth:`popleft` serves
    the sub-queue with the smallest vtime and charges it ``1/weight``
    — over any backlogged interval tenant i receives service
    proportional to its weight, and no tenant's burst can park work in
    front of another tenant's head (DRR-equivalent fairness with an
    O(tenants) pop, exact FIFO within each sub-queue). A tenant whose
    head cannot be admitted yet (the engine's reservation rule) is
    simply *skipped this pass* without being charged, so it keeps
    first claim on the next admission attempt — FIFO holds the line
    within the tenant, never across tenants, and the engine's no-deadlock
    argument survives per sub-queue.

    With exactly one tenant the drain order is byte-identical to a
    plain deque (the single-tenant bitwise guard). All operations are
    internally locked — the engine appends from request threads while
    its own thread drains.
    """

    def __init__(self, tenant_of: Optional[Callable[[Any], str]] = None,
                 weight_of: Optional[Callable[[str], float]] = None):
        self._tenant_of = tenant_of or _default_tenant_of
        self.weight_of = weight_of
        self._lock = threading.Lock()
        self._queues: "OrderedDict[str, Deque[Any]]" = OrderedDict()
        self._vtimes: Dict[str, float] = {}
        self._seq: Dict[str, int] = {}
        self._vnow = 0.0
        self._nseq = 0
        self._len = 0

    def _weight(self, tenant: str) -> float:
        if self.weight_of is None:
            return 1.0
        try:
            w = float(self.weight_of(tenant))
        except Exception:  # noqa: BLE001 — a policy bug must not
            # wedge the drain loop; degrade to unweighted fairness.
            logger.exception("tenant weight lookup failed for %r",
                             tenant)
            return 1.0
        return w if w > 0 else 1.0

    # -- mutation --------------------------------------------------------

    def append(self, item: Any) -> None:
        tenant = self._tenant_of(item)
        with self._lock:
            q = self._queues.get(tenant)
            if q is None:
                q = deque()
                self._queues[tenant] = q
                # A newly-backlogged tenant starts at the CURRENT
                # virtual time: it competes fairly from now on, with
                # no credit accrued while idle (start-time FQ).
                self._vtimes[tenant] = self._vnow
                self._seq[tenant] = self._nseq
                self._nseq += 1
            q.append(item)
            self._len += 1

    def extend(self, items) -> None:
        for item in items:
            self.append(item)

    def _ordered_tenants(self) -> List[str]:
        return sorted(self._queues,
                      key=lambda t: (self._vtimes[t], self._seq[t]))

    def _charge_and_pop(self, tenant: str) -> Any:
        q = self._queues[tenant]
        item = q.popleft()
        self._len -= 1
        # max(): a reservation-blocked head keeps its (old) start tag
        # while other tenants advance _vnow; serving it at last must
        # not REWIND global virtual time, or a tenant activating next
        # would inherit the stale tag and its whole burst would drain
        # ahead of continuously-backlogged tenants (SFQ-with-skips
        # needs monotone vnow).
        self._vnow = max(self._vnow, self._vtimes[tenant])
        self._vtimes[tenant] = self._vnow + 1.0 / self._weight(tenant)
        if not q:
            del self._queues[tenant]
            del self._vtimes[tenant]
            del self._seq[tenant]
        return item

    def popleft(self) -> Any:
        with self._lock:
            if not self._len:
                raise IndexError("pop from an empty FairQueue")
            return self._charge_and_pop(self._ordered_tenants()[0])

    def heads(self) -> List[Any]:
        """Each backlogged tenant's head, in fair-queueing order —
        the engine's admission loop tries them in turn and admits the
        first whose page reservation fits (``pop_head``); skipped
        heads are not charged and keep their priority."""
        with self._lock:
            return [self._queues[t][0]
                    for t in self._ordered_tenants()]

    def pop_head(self, item: Any) -> None:
        """Pop ``item`` — which must be its tenant's head — and
        charge the tenant's virtual time (this IS the scheduling
        decision)."""
        tenant = self._tenant_of(item)
        with self._lock:
            q = self._queues.get(tenant)
            if q is None or q[0] is not item:
                raise ValueError("pop_head item is not a current head")
            self._charge_and_pop(tenant)

    def remove_if(self, pred: Callable[[Any], bool]) -> List[Any]:
        """Remove (and return, in queue order) every item matching
        ``pred``, preserving each survivor's sub-queue order. The
        engine's expiry/cancel sweeps ride this instead of swapping
        the whole deque — per-tenant fairness state survives the
        sweep."""
        removed: List[Any] = []
        with self._lock:
            for tenant in list(self._queues):
                q = self._queues[tenant]
                keep: Deque[Any] = deque()
                for item in q:
                    (removed if pred(item) else keep).append(item)
                if len(keep) != len(q):
                    self._len -= len(q) - len(keep)
                    if keep:
                        self._queues[tenant] = keep
                    else:
                        del self._queues[tenant]
                        del self._vtimes[tenant]
                        del self._seq[tenant]
        return removed

    def clear(self) -> None:
        with self._lock:
            self._queues.clear()
            self._vtimes.clear()
            self._seq.clear()
            self._len = 0

    # -- queries ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return self._len

    def __bool__(self) -> bool:
        return len(self) > 0

    def __iter__(self) -> Iterator[Any]:
        """Snapshot iteration (tenants in activation order, FIFO
        within each) — the shutdown fail-all and tests."""
        with self._lock:
            items = [item for q in self._queues.values() for item in q]
        return iter(items)

    def __getitem__(self, index: int) -> Any:
        if index != 0:
            raise IndexError("FairQueue only exposes the fair head")
        with self._lock:
            if not self._len:
                raise IndexError("FairQueue is empty")
            return self._queues[self._ordered_tenants()[0]][0]

    def tenant_depths(self) -> Dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items()}
