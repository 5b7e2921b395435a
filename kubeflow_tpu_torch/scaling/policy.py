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

"""Pure scaling and admission decisions, shared by the server side.

The port's copy of the reference's ``scaling/policy.py``: the
manager's admission gate (:func:`admission_should_shed`) and the
tenancy helpers (token-bucket refill, weighted shares, the capped
label set) are the same arithmetic in both packages, so a port
replica sheds and bills exactly as a JAX replica does."""

from __future__ import annotations

import hashlib
import math
from typing import Any, Optional, Sequence, Tuple

__all__ = [
    "admission_should_shed",
    "brownout_should_convict",
    "brownout_should_readmit_latency",
    "brownout_should_readmit_stall",
    "brownout_threshold_s",
    "fit_arrival_forecast",
    "forecast_desired_replicas",
    "median",
    "pick_least_saturated",
    "pick_prefix_affinity",
    "pick_resident_affinity",
    "pick_role_aware",
    "pick_round_robin",
    "rendezvous_weight",
    "saturation_score",
    "token_bucket_refill",
    "token_bucket_retry_after_s",
]


# -- saturation scoring ------------------------------------------------

def saturation_score(saturation: Any, inflight: int) -> float:
    """Estimated queue wait in milliseconds if one more request were
    routed to a replica: the healthz-reported per-model estimate
    (``queue_depth × est_batch_latency_ms``, summed — one accelerator
    serializes all models) plus the caller's own in-flight count
    priced at one batch latency each. Lower = emptier.
    ``saturation`` is the healthz saturation mapping (model →
    {queue_depth, est_batch_latency_ms, ...})."""
    probe_ms = 0.0
    latency_ms = 1.0
    for stats in saturation.values():
        batch_ms = float(stats.get("est_batch_latency_ms", 0.0))
        latency_ms = max(latency_ms, batch_ms)
        probe_ms += float(stats.get("queue_depth", 0.0)) * batch_ms
    return probe_ms + inflight * latency_ms


# -- balancer picks ----------------------------------------------------
#
# Each pick takes the rotating ``offset`` its caller's pick counter
# provides (the round-robin tiebreak that keeps a pure ``min()`` from
# sending every tied pick to the same replica). Candidates must expose
# ``saturation_score()``; the affinity picks additionally read
# ``saturation`` / ``address`` / ``serves_phase``.

def pick_round_robin(candidates: Sequence[Any], offset: int) -> Any:
    if not candidates:
        return None
    return candidates[offset % len(candidates)]


def pick_least_saturated(candidates: Sequence[Any],
                         offset: int = 0) -> Any:
    """Join-shortest-queue over ``saturation_score()`` with a rotating
    tiebreak (ties resolve to a different member per call when the
    caller advances ``offset``)."""
    if not candidates:
        return None
    return min(
        (candidates[(offset + i) % len(candidates)]
         for i in range(len(candidates))),
        key=lambda ep: ep.saturation_score())


def pick_resident_affinity(candidates: Sequence[Any],
                           model: Optional[str],
                           overload_ms: float,
                           offset: int = 0,
                           fallback_offset: int = 0) -> Any:
    """Resident-model affinity: least-saturated among replicas where
    ``model`` is already loaded (saturation keys = resident set) and
    not overloaded past ``overload_ms``; least-saturated over the
    whole pool otherwise — affinity buys cache hits, never
    unavailability."""
    if not candidates:
        return None
    if model:
        resident = [ep for ep in candidates
                    if model in ep.saturation
                    and ep.saturation_score() < overload_ms]
        if resident:
            return pick_least_saturated(resident, offset)
    return pick_least_saturated(candidates, fallback_offset)


def rendezvous_weight(prefix_key: str, address: str) -> int:
    """Highest-random-weight hash of (prefix key, replica address) —
    stateless placement, stable under membership churn (only keys
    owned by a departed replica move)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(prefix_key.encode("utf-8"))
    h.update(b"\x00")
    h.update(address.encode("utf-8"))
    return int.from_bytes(h.digest(), "little")


def pick_prefix_affinity(candidates: Sequence[Any],
                         prefix_key: Optional[str],
                         overload_ms: float,
                         fallback_offset: int = 0) -> Any:
    """Rendezvous-place ``prefix_key`` onto the pool so repeat-prefix
    traffic lands where its KV pages are cached; fall back to
    least-saturation when keyless or when the home replica is
    overloaded past ``overload_ms``."""
    if not candidates:
        return None
    if prefix_key:
        home = max(candidates,
                   key=lambda ep: rendezvous_weight(prefix_key,
                                                    ep.address))
        if home.saturation_score() < overload_ms:
            return home
    return pick_least_saturated(candidates, fallback_offset)


def pick_role_aware(candidates: Sequence[Any],
                    phase: Optional[str],
                    prefix_key: Optional[str],
                    overload_ms: float,
                    fallback_offset: int = 0) -> Any:
    """Role-split routing: phase-matching members first (prefix
    affinity inside the healthy matching set), whole-pool fallback
    when the matching pool is empty or saturated — specialization
    never beats availability."""
    if not candidates:
        return None
    if phase:
        matching = [ep for ep in candidates if ep.serves_phase(phase)]
        healthy = [ep for ep in matching
                   if ep.saturation_score() < overload_ms]
        if healthy:
            return pick_prefix_affinity(healthy, prefix_key,
                                        overload_ms, fallback_offset)
        if matching:
            rest = [ep for ep in candidates
                    if ep.saturation_score() < overload_ms]
            pool = rest or matching
            return pick_least_saturated(pool, fallback_offset)
    return pick_least_saturated(candidates, fallback_offset)


# -- brownout outlier detection ---------------------------------------

def median(values: Sequence[float]) -> float:
    values = sorted(values)
    n = len(values)
    mid = n // 2
    return (values[mid] if n % 2
            else (values[mid - 1] + values[mid]) / 2.0)


def brownout_threshold_s(p50s: Sequence[float], *, k: float,
                         mad_floor_s: float,
                         min_ratio: float) -> Optional[float]:
    """The pool-relative outlier bar over routable members' latency
    medians: median(p50) + k × MAD (MAD floored — a
    microsecond-uniform pool must not convict nanosecond noise), and
    never below ``min_ratio`` × the pool median (a replica twice as
    slow as an already-slow pool is load skew, not a brownout). None
    below two reporting members — one replica cannot outlie itself."""
    if len(p50s) < 2:
        return None
    med = median(p50s)
    mad = median([abs(p - med) for p in p50s])
    return max(med + k * max(mad, mad_floor_s), med * min_ratio)


def brownout_should_convict(p50: Optional[float],
                            threshold: Optional[float],
                            recent_stalls: int, *,
                            stall_strikes: int
                            ) -> Tuple[bool, bool]:
    """One replica's conviction verdict: ``(slow, convict)``. Slow =
    its p50 clears the pool threshold; stalled = enough recent stream
    stalls. Either convicts (the caller still applies the pool-floor
    veto — graceful degradation is pool state, not replica state)."""
    slow = (threshold is not None and p50 is not None
            and p50 > threshold)
    stalled = recent_stalls >= stall_strikes
    return slow, slow or stalled


def brownout_should_readmit_stall(soft_ejected_at: Optional[float],
                                  recent_stalls: int, now: float, *,
                                  stall_quiet_s: float) -> bool:
    """Stall-only convictions readmit on stall SILENCE: a full quiet
    window since eject with zero fresh strikes (latency samples can't
    prove a wedged stream healed)."""
    if recent_stalls > 0:
        return False
    return (soft_ejected_at is not None
            and now - soft_ejected_at >= stall_quiet_s)


def brownout_should_readmit_latency(recent_p50: Optional[float],
                                    bar: Optional[float], *,
                                    recover_ratio: float) -> bool:
    """Latency convictions readmit when the post-eject shadow-sample
    median is back inside ``recover_ratio`` × the bar (the live pool
    threshold, or the bar frozen at conviction when the pool is too
    small to re-derive one)."""
    return (recent_p50 is not None and bar is not None
            and recent_p50 <= bar * recover_ratio)


# -- quota (token bucket) ---------------------------------------------

def token_bucket_refill(level: float, last: float, now: float, *,
                        rate: Optional[float],
                        burst: float) -> float:
    """Lazy-refill arithmetic: the level after ``now - last`` seconds
    of refill at ``rate`` tokens/s, capped at ``burst``. ``rate=None``
    (unlimited) leaves the level untouched. Clock steps backwards
    refill nothing (monotonic-only contract)."""
    if rate is None:
        return level
    return min(burst, level + max(0.0, now - last) * rate)


def token_bucket_retry_after_s(level: float, *, rate: Optional[float],
                               burst: float,
                               cost: float = 1.0) -> float:
    """Seconds until ``cost`` tokens will have refilled — the 429's
    Retry-After hint. A cost deeper than the bucket reports the
    full-bucket refill (the request can never succeed at this size;
    the hint still bounds the client's backoff)."""
    if rate is None:
        return 0.0
    missing = min(cost, burst) - level
    return max(0.001, missing / rate)


# -- deadline admission -----------------------------------------------

def admission_should_shed(est_wait_s: float, remaining_s: float,
                          safety: float) -> bool:
    """Shed-on-admission verdict: queue this request only if the
    estimated wait fits inside ``safety`` × its remaining deadline
    budget — a request that would expire in queue costs queue slots
    and compute and returns nothing."""
    return est_wait_s > remaining_s * safety


# -- arrival forecasting (predictive autoscaling) ---------------------

def fit_arrival_forecast(samples: Sequence[Tuple[float, float]],
                         horizon_s: float, *,
                         now: Optional[float] = None) -> float:
    """Short-horizon arrival-rate forecast: ordinary least squares
    over ``(t, rate)`` samples, evaluated ``horizon_s`` past the
    newest sample (or past ``now``). Clamped at ≥ 0 (a cooling fleet
    forecasts idle, never negative traffic). Fewer than two samples
    degrade to the last observation — a forecast must never be MORE
    confident than its data.

    Least squares over a sliding window is deliberately the simplest
    model that can lead a ramp: it extrapolates trend, reacts within
    one window, and its failure mode (overshooting a spike's peak) is
    exactly what the autoscaler's max/double clamps already bound."""
    if not samples:
        return 0.0
    if len(samples) == 1:
        return max(0.0, float(samples[0][1]))
    t_ref = samples[-1][0] if now is None else now
    ts = [t - t_ref for t, _ in samples]
    rs = [r for _, r in samples]
    n = float(len(samples))
    mean_t = sum(ts) / n
    mean_r = sum(rs) / n
    var_t = sum((t - mean_t) ** 2 for t in ts)
    if var_t <= 0.0:
        return max(0.0, mean_r)
    slope = sum((t - mean_t) * (r - mean_r)
                for t, r in zip(ts, rs)) / var_t
    return max(0.0, mean_r + slope * (horizon_s - mean_t))


def forecast_desired_replicas(forecast_rate: float,
                              replica_capacity_rps: float) -> int:
    """Replicas the forecast demands: ceil(rate / per-replica
    capacity). Zero capacity means the operator gave the forecaster
    no unit — predict nothing rather than divide by zero."""
    if replica_capacity_rps <= 0.0 or forecast_rate <= 0.0:
        return 0
    return int(math.ceil(forecast_rate / replica_capacity_rps))
