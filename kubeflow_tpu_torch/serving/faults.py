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

"""Serving data-plane fault injection (chaos seam of the model server).

The port's copy of the reference's ``serving/faults.py``, stdlib only.
A JSON fault plan (``--fault_plan``, hot-reloaded on every request)
arms rules matched by route, model and phase (unary, stream, handoff,
resume); actions add latency, reset the connection, or kill or stall
a token stream after N events. Construction refuses unless
``KFT_ENABLE_FAULTS=1`` is set, so a plan leaking into a production
manifest fails the process at startup."""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import random
import threading
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "ENABLE_ENV",
    "FaultDisabledError",
    "FaultPlan",
    "FaultPlanSource",
    "FaultRule",
    "StreamFaultInjector",
    "corrupt_b64_blob",
    "faults_enabled",
    "inject_request_fault",
    "match_request",
    "stream_injector",
]

#: The opt-in switch. Anything else (unset, "0", "true") refuses.
ENABLE_ENV = "KFT_ENABLE_FAULTS"

#: Serving phases a rule may pin: ``unary`` (plain request/response),
#: ``stream`` (SSE token streaming), ``handoff`` (role-split KV blob
#: hop), ``resume`` (mid-stream decode resume replay).
PHASES = ("unary", "stream", "handoff", "resume")


def faults_enabled() -> bool:
    return os.environ.get(ENABLE_ENV) == "1"


class FaultDisabledError(RuntimeError):
    """A fault plan was supplied without ``KFT_ENABLE_FAULTS=1``."""

    def __init__(self) -> None:
        super().__init__(
            f"fault injection refused: set {ENABLE_ENV}=1 to arm it "
            f"(never in production manifests)")


@dataclasses.dataclass
class FaultRule:
    """One match → action rule. Mutable counters live on the instance
    and are guarded by the owning plan's lock."""

    # -- match ----------------------------------------------------------
    route: Optional[str] = None  # substring of the request path/verb
    model: Optional[str] = None
    phase: Optional[str] = None  # unary | stream | handoff | resume
    after_n: int = 0  # first N matching requests pass clean
    every: int = 1  # then fire on every k-th match
    probability: float = 1.0
    max_fires: Optional[int] = None
    # -- actions --------------------------------------------------------
    latency_ms: float = 0.0
    stall_ms: float = 0.0
    error_code: Optional[int] = None
    reset: bool = False
    kill_after_events: Optional[int] = None
    event_latency_ms: float = 0.0
    stall_after_events: Optional[int] = None
    corrupt_blob: bool = False
    # -- state ----------------------------------------------------------
    seen: int = 0
    fired: int = 0

    def __post_init__(self) -> None:
        if self.phase is not None and self.phase not in PHASES:
            raise ValueError(
                f"fault rule phase {self.phase!r} not in {PHASES}")
        if self.every < 1:
            raise ValueError("fault rule 'every' must be >= 1")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError("fault rule probability outside [0, 1]")

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "FaultRule":
        match = dict(doc.get("match") or {})
        action = dict(doc.get("action") or {})
        unknown_match = set(match) - {"route", "model", "phase",
                                      "after_n", "every", "probability",
                                      "max_fires"}
        unknown_action = set(action) - {
            "latency_ms", "stall_ms", "error_code", "reset",
            "kill_after_events", "event_latency_ms",
            "stall_after_events", "corrupt_blob"}
        if unknown_match or unknown_action:
            # A typo'd knob silently matching nothing would make a
            # chaos run vacuously green — reject loudly.
            raise ValueError(
                f"fault rule has unknown keys: match={sorted(unknown_match)} "
                f"action={sorted(unknown_action)}")
        return cls(
            route=match.get("route"), model=match.get("model"),
            phase=match.get("phase"),
            after_n=int(match.get("after_n", 0)),
            every=int(match.get("every", 1)),
            probability=float(match.get("probability", 1.0)),
            max_fires=(None if match.get("max_fires") is None
                       else int(match["max_fires"])),
            latency_ms=float(action.get("latency_ms", 0.0)),
            stall_ms=float(action.get("stall_ms", 0.0)),
            error_code=(None if action.get("error_code") is None
                        else int(action["error_code"])),
            reset=bool(action.get("reset", False)),
            kill_after_events=(
                None if action.get("kill_after_events") is None
                else int(action["kill_after_events"])),
            event_latency_ms=float(action.get("event_latency_ms", 0.0)),
            stall_after_events=(
                None if action.get("stall_after_events") is None
                else int(action["stall_after_events"])),
            corrupt_blob=bool(action.get("corrupt_blob", False)),
        )

    def matches(self, route: str, model: Optional[str],
                phase: Optional[str]) -> bool:
        if self.route is not None and self.route not in (route or ""):
            return False
        if self.model is not None and self.model != model:
            return False
        if self.phase is not None and self.phase != phase:
            return False
        return True


class FaultPlan:
    """An armed set of fault rules. Construction REFUSES without the
    ``KFT_ENABLE_FAULTS=1`` opt-in — the guard lives at the lowest
    layer so no wiring path can route around it."""

    def __init__(self, rules: List[FaultRule], *, seed: int = 0):
        if not faults_enabled():
            raise FaultDisabledError()
        self.rules = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "FaultPlan":
        rules = doc.get("rules")
        if not isinstance(rules, list):
            raise ValueError("fault plan needs a 'rules' list")
        return cls([FaultRule.from_dict(r) for r in rules],
                   seed=int(doc.get("seed", 0)))

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        return cls.from_dict(json.loads(raw))

    def decide(self, *, route: str, model: Optional[str] = None,
               phase: Optional[str] = None) -> Optional[FaultRule]:
        """The rule that fires for this request (first match wins), or
        None. Counting happens here — one decide() call per request."""
        with self._lock:
            for rule in self.rules:
                if not rule.matches(route, model, phase):
                    continue
                rule.seen += 1
                if rule.seen <= rule.after_n:
                    continue
                if (rule.seen - rule.after_n - 1) % rule.every != 0:
                    continue
                if (rule.max_fires is not None
                        and rule.fired >= rule.max_fires):
                    continue
                if (rule.probability < 1.0
                        and self._rng.random() >= rule.probability):
                    continue
                rule.fired += 1
                return rule
        return None

    def stats(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"route": r.route, "model": r.model,
                     "phase": r.phase, "seen": r.seen,
                     "fired": r.fired} for r in self.rules]


class FaultPlanSource:
    """Hot-reloading ``--fault_plan`` file source (content comparison,
    like the endpoints file): a malformed or missing file keeps the
    LAST GOOD plan — a half-written rewrite mid-chaos-run must not
    silently disarm the faults and turn the run vacuously green."""

    def __init__(self, path: str):
        if not faults_enabled():
            raise FaultDisabledError()
        self.path = path
        self._last_raw: Optional[str] = None
        self._plan: Optional[FaultPlan] = None

    def plan(self) -> Optional[FaultPlan]:
        try:
            with open(self.path) as f:
                raw = f.read()
        except OSError:
            return self._plan
        if raw == self._last_raw:
            return self._plan
        try:
            plan = FaultPlan.from_json(raw)
        except (ValueError, KeyError, TypeError) as e:
            logger.warning("fault plan %s malformed (%s); keeping the "
                           "last good plan", self.path, e)
            return self._plan
        self._last_raw, self._plan = raw, plan
        logger.info("fault plan %s loaded: %d rule(s)", self.path,
                    len(plan.rules))
        return plan


def match_request(settings: Dict[str, Any], *, route: str,
                  model: Optional[str] = None,
                  phase: Optional[str] = None) -> Optional[FaultRule]:
    """The middleware entry: look up the app's (hot-reloaded) plan and
    return the firing rule, or None when faults are unarmed. Never
    raises — a broken plan must not take the data plane down."""
    source = settings.get("fault_source")
    plan = settings.get("fault_plan")
    try:
        if source is not None:
            plan = source.plan()
        if plan is None:
            return None
        return plan.decide(route=route, model=model, phase=phase)
    except Exception:  # noqa: BLE001 — injection must never 500 traffic
        logger.exception("fault plan lookup failed; serving clean")
        return None


async def inject_request_fault(handler: Any, rule: FaultRule) -> bool:
    """Apply the pre-response half of ``rule`` on a tornado handler.
    Returns True when the response is already finished (or the
    connection is gone) and the handler must stop."""
    import asyncio

    if rule.latency_ms > 0:
        await asyncio.sleep(rule.latency_ms / 1000.0)
    if rule.stall_ms > 0 and rule.stall_after_events is None:
        # Accept-then-hang: the classic gray failure — the TCP accept
        # succeeded, /healthz still answers, and this request gets
        # nothing until the connection resets out from under it.
        # (With ``stall_after_events`` set, ``stall_ms`` instead
        # prices the MID-stream wedge the StreamFaultInjector runs.)
        await asyncio.sleep(rule.stall_ms / 1000.0)
        _close_connection(handler)
        return True
    if rule.reset:
        _close_connection(handler)
        return True
    if rule.error_code is not None:
        handler.set_status(rule.error_code)
        handler.set_header("Content-Type", "application/json")
        handler.finish(json.dumps(
            {"error": "injected fault", "code": "FAULT_INJECTED"}))
        return True
    return False


def _close_connection(handler: Any) -> None:
    try:
        handler.request.connection.stream.close()
    except Exception:  # noqa: BLE001 — already gone
        pass


class StreamFaultInjector:
    """The mid-stream half of a rule, consulted once per SSE event by
    the streaming handler: injects the slow-drip ``event_latency_ms``
    and signals the kill point after ``kill_after_events`` flushed
    events."""

    def __init__(self, rule: Optional[FaultRule]):
        self.rule = rule
        self.events = 0

    async def before_event(self) -> bool:
        """Await the injected per-event latency; True = kill the
        stream NOW (the caller closes the connection raw)."""
        import asyncio

        if self.rule is None:
            return False
        if (self.rule.kill_after_events is not None
                and self.events >= self.rule.kill_after_events):
            return True
        self.events += 1
        if self.rule.event_latency_ms > 0:
            await asyncio.sleep(self.rule.event_latency_ms / 1000.0)
        if (self.rule.stall_after_events is not None
                and self.events > self.rule.stall_after_events
                and self.rule.stall_ms > 0):
            # Mid-stream wedge: the first N events flowed; now the
            # stream goes silent (bounded by the rule's own stall).
            await asyncio.sleep(self.rule.stall_ms / 1000.0)
        return False


def stream_injector(settings: Dict[str, Any], *, route: str,
                    model: Optional[str] = None) -> StreamFaultInjector:
    """Per-stream injector (phase ``stream``); inert when unarmed."""
    return StreamFaultInjector(
        match_request(settings, route=route, model=model,
                      phase="stream"))


def corrupt_b64_blob(blob_b64: str) -> str:
    """Flip one byte in the middle of a base64 payload (handoff /
    resume blobs): the receiver must answer a structured 400 and the
    sender must fall back, never mis-adopt garbage pages."""
    raw = bytearray(base64.b64decode(blob_b64))
    if not raw:
        return blob_b64
    raw[len(raw) // 2] ^= 0xFF
    return base64.b64encode(bytes(raw)).decode("ascii")
