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

"""Multi-tenant isolation for the serving stack.

The port's copy of the reference's ``serving/tenancy.py``, whole:

- **Identity**: the ``X-KFT-Tenant`` header / ``x-kft-tenant`` gRPC
  metadata key names the tenant (an ``X-KFT-Api-Key`` maps to one via
  the policy file); absent means the ``default`` tenant.
- **Quotas**: per-tenant token buckets (requests/s and
  decode-tokens/s) from a hot-reloadable JSON policy file with
  last-good-on-malformed semantics. Over-quota is a structured 429,
  never a global shed.
- **Weighted-fair queueing**: :class:`FairQueue` drains per-tenant
  sub-queues by start-time fair queueing weighted by quota share, in
  the manager's batcher (:class:`TenantRequestQueue`) and the decode
  engine's admission queue; with one tenant the order is FIFO.
- **Observability**: ``kft_tenant_*`` families labeled through a hard
  cardinality cap (:class:`TenantLabelCapper`)."""

from __future__ import annotations

import hashlib
import json
import logging
import re
import threading
import time
from collections import OrderedDict, deque
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    Iterator,
    List,
    Optional,
)

from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.scaling import policy
from kubeflow_tpu_torch.serving.overload import QuotaExceededError

__all__ = [
    "API_KEY_HEADER",
    "DEFAULT_TENANT",
    "FairQueue",
    "OTHER_TENANT_LABEL",
    "TENANT_CARDINALITY_CAP",
    "TENANT_HEADER",
    "TenantLabelCapper",
    "TenantPolicy",
    "TenantPolicySource",
    "TenantQuota",
    "TenantRegistry",
    "TenantRequestQueue",
    "TokenBucket",
    "normalize_tenant",
    "note_expired",
    "note_request",
    "note_shed",
    "note_tokens",
    "observe_queue_wait",
    "observe_ttft",
    "tenant_from_headers",
    "tenant_from_metadata",
    "tenant_label",
]

logger = logging.getLogger(__name__)

#: The tenant-identity header contract: the client (or its gateway)
#: names its tenant here; the proxy forwards it VERBATIM on every
#: upstream hop (REST header + gRPC metadata) so the model server —
#: the layer that owns the queues — is the enforcement point.
TENANT_HEADER = "X-KFT-Tenant"

#: API-key alternative: the policy file's ``api_keys`` table maps keys
#: to tenants; an unmapped key becomes an anonymous per-key tenant
#: (``key-<digest8>``) so unknown keys are rate-limited individually
#: under the default quota instead of pooling into ``default``.
API_KEY_HEADER = "X-KFT-Api-Key"

#: Requests without tenant identity land here (single-tenant
#: deployments never send the header and behave exactly as before).
DEFAULT_TENANT = "default"

#: Metric-label overflow bucket and the hard top-K cap: at most
#: TENANT_CARDINALITY_CAP tenants get their own series per process;
#: later arrivals share ``other``. 10k sprayed tenant ids leave
#: ≤ cap+1 label values in /metrics and the collector store.
OTHER_TENANT_LABEL = "other"
TENANT_CARDINALITY_CAP = 16

_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")
_TENANT_STRIP_RE = re.compile(r"[^A-Za-z0-9._-]")


def normalize_tenant(value: Optional[str]) -> str:
    """Canonical tenant id for a raw header value: trimmed,
    ``[A-Za-z0-9._-]``, ≤ 64 chars. A malformed id is SANITIZED
    deterministically rather than rejected or folded into
    ``default`` — mapping garbage to ``default`` would let a client
    escape its own quota by mangling its header, and a 400 would turn
    a cosmetic typo into an outage."""
    if not value:
        return DEFAULT_TENANT
    value = str(value).strip()
    if _TENANT_RE.match(value):
        return value
    cleaned = _TENANT_STRIP_RE.sub("", value)[:64].lstrip("._-")
    if cleaned:
        return cleaned
    # Nothing representable survived: a stable per-value bucket keeps
    # binary garbage out of label values without un-scoping its quota.
    digest = hashlib.sha1(value.encode("utf-8", "replace")).hexdigest()
    return f"tenant-{digest[:8]}"


def _tenant_for_key(key: str, registry: Optional["TenantRegistry"]
                    ) -> str:
    if registry is not None:
        mapped = registry.tenant_for_key(key)
        if mapped is not None:
            return mapped
    digest = hashlib.sha1(key.encode("utf-8", "replace")).hexdigest()
    return f"key-{digest[:8]}"


def tenant_from_headers(headers: Any,
                        registry: Optional["TenantRegistry"] = None
                        ) -> str:
    """Resolve the tenant for one HTTP request: explicit
    ``X-KFT-Tenant`` wins, else an ``X-KFT-Api-Key`` maps through the
    policy (unknown keys get a stable anonymous per-key tenant), else
    ``default``."""
    explicit = headers.get(TENANT_HEADER)
    if explicit:
        return normalize_tenant(explicit)
    key = headers.get(API_KEY_HEADER)
    if key:
        return _tenant_for_key(str(key), registry)
    return DEFAULT_TENANT


def is_quota_detail(details: Optional[str]) -> bool:
    """True when a gRPC RESOURCE_EXHAUSTED status's details carry a
    tenant-quota shed. gRPC has no 429, so the server folds both shed
    flavors into RESOURCE_EXHAUSTED (serving/grpc_server.py
    ``_abort_for``) and the *message shape* — minted only by
    :meth:`TenantRegistry.admit_request` — is the discriminator the
    pooled proxy uses to restore the structured 429 on its binary
    upstream hop. Both ends live in this repo and
    tests/test_tenancy.py pins the round trip."""
    return bool(details) and details.startswith("tenant ") and (
        "over request quota" in details
        or "over decode-token quota" in details)


def tenant_from_metadata(metadata: Any,
                         registry: Optional["TenantRegistry"] = None
                         ) -> str:
    """The gRPC half of the identity contract: invocation metadata
    keys are lowercase on the wire (``x-kft-tenant`` /
    ``x-kft-api-key``)."""
    explicit = None
    key = None
    for k, v in metadata or ():
        lk = str(k).lower()
        if lk == TENANT_HEADER.lower() and explicit is None:
            explicit = v
        elif lk == API_KEY_HEADER.lower() and key is None:
            key = v
    if explicit:
        return normalize_tenant(explicit)
    if key:
        return _tenant_for_key(str(key), registry)
    return DEFAULT_TENANT


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

    def known(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._known)


#: Process-wide capper shared by every tenant-labeled family below —
#: the cap is per PROCESS, so the fleet-wide series count is bounded
#: by replicas × (cap + 1) per family whatever clients send.
CAPPER = TenantLabelCapper()

_T_REQUESTS = obs_metrics.Counter(
    "kft_tenant_requests_total",
    "Requests submitted per tenant (billing-grade offered load; "
    "label capped at top-K + 'other')", ("tenant",))
_T_SHED = obs_metrics.Counter(
    "kft_tenant_shed_total",
    "Requests turned away per tenant, by reason (quota = the "
    "tenant's own bucket ran dry → 429; overload = global admission "
    "control → 503)", ("tenant", "reason"))
_T_EXPIRED = obs_metrics.Counter(
    "kft_tenant_expired_total",
    "Requests whose deadline lapsed before dispatch, per tenant",
    ("tenant",))
_T_QUEUE_WAIT = obs_metrics.Histogram(
    "kft_tenant_queue_wait_seconds",
    "Queue wait of dispatched requests, per tenant (the "
    "noisy-neighbor number: a compliant tenant's wait must not grow "
    "with a neighbor's burst)", ("tenant",))
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


def note_request(tenant: str) -> None:
    _T_REQUESTS.labels(tenant_label(tenant)).inc()


def note_shed(tenant: str, reason: str = "overload") -> None:
    _T_SHED.labels(tenant_label(tenant), reason).inc()


def note_expired(tenant: str) -> None:
    _T_EXPIRED.labels(tenant_label(tenant)).inc()


def note_tokens(tenant: str, n: int = 1) -> None:
    _T_TOKENS.labels(tenant_label(tenant)).inc(n)


def observe_queue_wait(tenant: str, seconds: float) -> None:
    _T_QUEUE_WAIT.labels(tenant_label(tenant)).observe(
        max(0.0, seconds))


def observe_ttft(tenant: str, seconds: float) -> None:
    _T_TTFT.labels(tenant_label(tenant)).observe(max(0.0, seconds))


# -- token buckets + policy --------------------------------------------------


class TokenBucket:
    """Thread-safe lazy-refill token bucket. ``rate`` is tokens/s,
    ``burst`` the bucket depth; ``rate=None`` means unlimited (every
    take succeeds). Monotonic clock only — NTP steps must not refill
    (or drain) a quota."""

    def __init__(self, rate: Optional[float], burst: float, *,
                 clock=time.monotonic):
        if rate is not None and rate <= 0:
            raise ValueError("rate must be > 0 (None = unlimited)")
        if burst <= 0:
            raise ValueError("burst must be > 0")
        self.rate = rate
        self.burst = float(burst)
        self._level = float(burst)
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._level = policy.token_bucket_refill(
            self._level, self._last, now,
            rate=self.rate, burst=self.burst)
        self._last = now

    def try_take(self, cost: float = 1.0) -> bool:
        if self.rate is None:
            return True
        with self._lock:
            now = self._clock()
            self._refill(now)
            if self._level >= cost:
                self._level -= cost
                return True
            return False

    def retry_after_s(self, cost: float = 1.0) -> float:
        """Seconds until ``cost`` tokens will have refilled — the
        429's Retry-After hint. A cost deeper than the bucket reports
        the full-bucket refill (the request can never succeed at this
        size; the hint still bounds the client's backoff)."""
        if self.rate is None:
            return 0.0
        with self._lock:
            now = self._clock()
            self._refill(now)
            return policy.token_bucket_retry_after_s(
                self._level, rate=self.rate, burst=self.burst,
                cost=cost)

    def level(self) -> float:
        if self.rate is None:
            return float("inf")
        with self._lock:
            self._refill(self._clock())
            return self._level


class TenantQuota:
    """One tenant's policy row. ``None`` rates mean unlimited; bursts
    default to one second of the rate (min 1)."""

    __slots__ = ("requests_per_s", "request_burst",
                 "decode_tokens_per_s", "token_burst", "weight")

    _FIELDS = ("requests_per_s", "request_burst",
               "decode_tokens_per_s", "token_burst", "weight")

    def __init__(self, requests_per_s: Optional[float] = None,
                 request_burst: Optional[float] = None,
                 decode_tokens_per_s: Optional[float] = None,
                 token_burst: Optional[float] = None,
                 weight: Optional[float] = None):
        self.requests_per_s = (None if requests_per_s is None
                               else float(requests_per_s))
        self.request_burst = float(
            request_burst if request_burst is not None
            else max(1.0, self.requests_per_s or 1.0))
        self.decode_tokens_per_s = (None if decode_tokens_per_s is None
                                    else float(decode_tokens_per_s))
        self.token_burst = float(
            token_burst if token_burst is not None
            else max(1.0, self.decode_tokens_per_s or 1.0))
        self.weight = None if weight is None else float(weight)
        if self.requests_per_s is not None and self.requests_per_s <= 0:
            raise ValueError("requests_per_s must be > 0 or null")
        if (self.decode_tokens_per_s is not None
                and self.decode_tokens_per_s <= 0):
            raise ValueError("decode_tokens_per_s must be > 0 or null")
        if self.weight is not None and self.weight <= 0:
            raise ValueError("weight must be > 0")

    @classmethod
    def from_json(cls, obj: Any, *, where: str) -> "TenantQuota":
        if not isinstance(obj, dict):
            raise ValueError(f"{where}: quota must be an object, got "
                             f"{type(obj).__name__}")
        unknown = set(obj) - set(cls._FIELDS)
        if unknown:
            # Loud, like the fault plan's rule parser: a typo'd knob
            # must not silently leave a tenant unlimited.
            raise ValueError(f"{where}: unknown quota key(s) "
                             f"{sorted(unknown)}; valid: "
                             f"{list(cls._FIELDS)}")
        return cls(**obj)

    def fair_weight(self) -> float:
        """The WFQ weight: explicit ``weight`` wins, else the
        requests/s rate IS the quota share, else 1.0."""
        if self.weight is not None:
            return self.weight
        if self.requests_per_s is not None:
            return self.requests_per_s
        return 1.0

    def to_json(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._FIELDS
                if getattr(self, k) is not None}


class TenantPolicy:
    """The parsed policy file::

        {"default": {quota...},
         "tenants": {"<tenant>": {quota...}},
         "api_keys": {"<key>": "<tenant>"}}

    ``default`` applies to every tenant without its own row (including
    the literal ``default`` tenant and anonymous per-key tenants).
    Omitted entirely, the default quota is unlimited — tenancy then
    only provides identity, fairness and accounting."""

    def __init__(self, default: Optional[TenantQuota] = None,
                 tenants: Optional[Dict[str, TenantQuota]] = None,
                 api_keys: Optional[Dict[str, str]] = None):
        self.default = default or TenantQuota()
        self.tenants = dict(tenants or {})
        self.api_keys = {str(k): normalize_tenant(v)
                         for k, v in (api_keys or {}).items()}

    @classmethod
    def from_json(cls, raw: str) -> "TenantPolicy":
        doc = json.loads(raw)
        if not isinstance(doc, dict):
            raise ValueError("tenant policy must be a JSON object")
        unknown = set(doc) - {"default", "tenants", "api_keys"}
        if unknown:
            raise ValueError(f"tenant policy has unknown key(s) "
                             f"{sorted(unknown)}; valid: "
                             f"['default', 'tenants', 'api_keys']")
        default = (TenantQuota.from_json(doc["default"],
                                         where="default")
                   if "default" in doc else None)
        tenants: Dict[str, TenantQuota] = {}
        raw_tenants = doc.get("tenants", {})
        if not isinstance(raw_tenants, dict):
            raise ValueError("'tenants' must be an object")
        for name, quota in raw_tenants.items():
            tenants[normalize_tenant(name)] = TenantQuota.from_json(
                quota, where=f"tenants[{name!r}]")
        api_keys = doc.get("api_keys", {})
        if not isinstance(api_keys, dict) or not all(
                isinstance(v, str) for v in api_keys.values()):
            raise ValueError("'api_keys' must map key → tenant name")
        return cls(default, tenants, api_keys)

    def quota(self, tenant: str) -> TenantQuota:
        return self.tenants.get(tenant, self.default)


class TenantPolicySource:
    """Hot-reloading policy file with last-good-on-malformed
    semantics (the ``--fault_plan`` contract): a half-written rewrite
    mid-flight must not silently drop every quota, and a deleted file
    keeps the last good policy rather than failing traffic.

    ``policy()`` sits in the submit AND scheduling hot paths (quota
    check per request, weight lookup per queue pop), so the steady
    state is one ``stat()`` — the file is re-READ only when its
    (mtime, size) signature moves. A rewrite racing the read is
    caught on the next call: the signature is taken BEFORE the read,
    so a mid-read change leaves it stale and forces a fresh read."""

    def __init__(self, path: str,
                 initial: Optional[TenantPolicy] = None):
        self.path = path
        self._last_sig: Optional[tuple] = None
        self._last_raw: Optional[str] = None
        self._policy: TenantPolicy = initial or TenantPolicy()

    def policy(self) -> TenantPolicy:
        import os

        try:
            st = os.stat(self.path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            return self._policy
        if sig == self._last_sig:
            return self._policy
        try:
            with open(self.path) as f:
                raw = f.read()
        except OSError:
            return self._policy
        self._last_sig = sig
        if raw == self._last_raw:
            return self._policy
        try:
            policy = TenantPolicy.from_json(raw)
        except (ValueError, KeyError, TypeError) as e:
            logger.warning("tenant policy %s malformed (%s); keeping "
                           "the last good policy", self.path, e)
            self._last_raw = raw  # don't re-parse the same bad bytes
            return self._policy
        self._last_raw = raw
        self._policy = policy
        logger.info("tenant policy %s loaded: %d tenant(s), %d api "
                    "key(s)", self.path, len(policy.tenants),
                    len(policy.api_keys))
        return policy


class _TenantState:
    __slots__ = ("requests", "tokens", "quota", "shed_quota")

    def __init__(self, quota: TenantQuota):
        self.quota = quota
        self.requests = TokenBucket(quota.requests_per_s,
                                    quota.request_burst)
        self.tokens = TokenBucket(quota.decode_tokens_per_s,
                                  quota.token_burst)
        self.shed_quota = 0


#: Runtime-state cap for the registry: at most this many tenants hold
#: live bucket state per process. The metric cap bounds /metrics; this
#: bounds MEMORY and the healthz payload against the same adversary
#: (an API-key sprayer minting a fresh anonymous tenant per request).
MAX_TRACKED_TENANTS = 1024


class TenantRegistry:
    """Per-tenant runtime state over a (possibly hot-reloading)
    policy: token buckets, quota-shed counters, WFQ weights and the
    api-key table. One registry serves every model in the process —
    quotas are a tenant property, not a model property.

    State is bounded at :data:`MAX_TRACKED_TENANTS`: past the cap,
    the oldest tenant NOT named in the policy is evicted (named
    tenants never lose state). An evicted tenant returning gets a
    fresh full-burst bucket — to launder its own burst through that,
    a client would first have to churn ~1k other tenants through the
    registry, at one fresh-burst request each; the default quota
    still bounds every one of them."""

    def __init__(self, policy: Any = None):
        # ``policy`` is a TenantPolicySource, a TenantPolicy, or None
        # (identity + fairness only; unlimited buckets).
        if policy is None:
            policy = TenantPolicy()
        self._source = policy if hasattr(policy, "policy") else None
        self._static = policy if self._source is None else None
        self._states: Dict[str, _TenantState] = {}
        self._evicted = 0
        self._lock = threading.Lock()

    def policy(self) -> TenantPolicy:
        return (self._source.policy() if self._source is not None
                else self._static)

    def tenant_for_key(self, key: str) -> Optional[str]:
        return self.policy().api_keys.get(key)

    def _state(self, tenant: str) -> _TenantState:
        policy = self.policy()
        quota = policy.quota(tenant)
        with self._lock:
            state = self._states.get(tenant)
            if state is None:
                if len(self._states) >= MAX_TRACKED_TENANTS:
                    # Evict the oldest anonymous tenant (insertion
                    # order); policy-named tenants keep their state.
                    for old in self._states:
                        if old not in policy.tenants:
                            del self._states[old]
                            self._evicted += 1
                            break
                state = _TenantState(quota)
                self._states[tenant] = state
            elif state.quota is not quota:
                # Hot reload changed this tenant's row: re-arm the
                # buckets at the new rate (full burst — a reload is an
                # operator action, not a client's refill exploit).
                state.quota = quota
                state.requests = TokenBucket(quota.requests_per_s,
                                             quota.request_burst)
                state.tokens = TokenBucket(quota.decode_tokens_per_s,
                                           quota.token_burst)
            return state

    def weight(self, tenant: str) -> float:
        return self.policy().quota(tenant).fair_weight()

    def admit_request(self, tenant: str, *,
                      decode_tokens: int = 0) -> None:
        """Charge one request (and its requested decode budget)
        against the tenant's buckets; raises
        :class:`~.overload.QuotaExceededError` when either runs dry.
        The request bucket is checked first and NOT refunded on a
        token-bucket miss — an over-budget generate still cost the
        server a parse + this decision."""
        state = self._state(tenant)
        if not state.requests.try_take(1.0):
            retry = state.requests.retry_after_s(1.0)
            self._count_quota_shed(state, tenant)
            raise QuotaExceededError(
                f"tenant {tenant!r} over request quota "
                f"({state.quota.requests_per_s:g}/s)",
                tenant=tenant, retry_after_s=retry)
        if decode_tokens > 0 and not state.tokens.try_take(
                float(decode_tokens)):
            retry = state.tokens.retry_after_s(float(decode_tokens))
            self._count_quota_shed(state, tenant)
            raise QuotaExceededError(
                f"tenant {tenant!r} over decode-token quota "
                f"({state.quota.decode_tokens_per_s:g} tok/s; "
                f"requested {decode_tokens})",
                tenant=tenant, retry_after_s=retry)

    def _count_quota_shed(self, state: _TenantState,
                          tenant: str) -> None:
        with self._lock:
            state.shed_quota += 1
        note_shed(tenant, "quota")

    def stats(self, limit: int = 32) -> Dict[str, Any]:
        """Bounded per-tenant snapshot for healthz / the dashboard:
        policy-named tenants always make the cut, anonymous ones by
        descending quota-shed up to ``limit`` rows total — a sprayed
        registry must not balloon the healthz payload. ``tracked`` /
        ``evicted`` carry the full-population accounting."""
        named = set(self.policy().tenants)
        with self._lock:
            states = list(self._states.items())
            evicted = self._evicted
        states.sort(key=lambda kv: (kv[0] not in named,
                                    -kv[1].shed_quota))
        rows = {}
        for tenant, state in states[:max(limit, len(named))]:
            rows[tenant] = {
                "shed_quota": state.shed_quota,
                "weight": state.quota.fair_weight(),
                "quota": state.quota.to_json(),
            }
        return {"tenants": rows, "tracked": len(states),
                "evicted": evicted}


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

    def remove(self, item: Any) -> None:
        tenant = self._tenant_of(item)
        with self._lock:
            q = self._queues.get(tenant)
            if q is None:
                raise ValueError("item not queued")
            q.remove(item)  # ValueError propagates (identity eq)
            self._len -= 1
            if not q:
                del self._queues[tenant]
                del self._vtimes[tenant]
                del self._seq[tenant]

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

    def depth(self, tenant: str) -> int:
        with self._lock:
            q = self._queues.get(tenant)
            return len(q) if q is not None else 0


class TenantRequestQueue:
    """Drop-in replacement for the native ``RequestQueue`` when
    tenancy is enabled: the same push/pop_batch/size/close contract
    (including the micro-batch window semantics), but ids drain from
    per-tenant sub-queues through a :class:`FairQueue` instead of one
    global FIFO — the batcher's pop order is what turns quota share
    into actual service share under contention."""

    def __init__(self, capacity: int = 4096,
                 weight_of: Optional[Callable[[str], float]] = None):
        self._capacity = capacity
        self._fq = FairQueue(tenant_of=lambda it: it[1],
                             weight_of=weight_of)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def push(self, request_id: int,
             tenant: str = DEFAULT_TENANT) -> bool:
        with self._cond:
            if self._closed:
                raise RuntimeError("queue closed")
            if len(self._fq) >= self._capacity:
                return False
            self._fq.append((request_id, tenant or DEFAULT_TENANT))
            self._cond.notify()
            return True

    def pop_batch(self, max_n: int, timeout_s: float = 0.1,
                  window_s: float = 0.002) -> Optional[List[int]]:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not self._fq:
                if self._closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None if self._closed else []
                self._cond.wait(remaining)
            if window_s > 0 and len(self._fq) < max_n:
                window_deadline = time.monotonic() + window_s
                while len(self._fq) < max_n and not self._closed:
                    remaining = window_deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            n = min(max_n, len(self._fq))
            return [self._fq.popleft()[0] for _ in range(n)]

    def size(self) -> int:
        with self._lock:
            return len(self._fq)

    def tenant_depths(self) -> Dict[str, int]:
        return self._fq.tenant_depths()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
