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

"""ModelManager: version watching, hot reload, micro-batched execution.

The port's copy of the reference's ``serving/manager.py``
(``ServedModel``, ``ModelManager``), serving versions that the port's
``load_version`` puts on the GPU (``device=None``, the default) or on
the CPU when asked (``device="cpu"``).

A background thread polls the base path (the native scanner of
``native/kft_runtime.cc`` for POSIX paths, :mod:`remote`'s fsspec
scanner and download cache for object stores) and swaps in new
versions atomically; a request queue micro-batches predict, classify
and static generate calls, so the card runs full batch buckets instead
of one execution per request. Concurrent generates coalesce into one
KV-cache decode (mixed-length prompts left-pad to a bucket; per-request
keys keep each request's tokens equal to its B=1 run). With
``continuous_batching`` a generate rides the slot engine instead
(``LoadedModel.ensure_engine``): unary, streamed, role-split
(``prefill_handoff`` / ``submit_handoff``) and resumed mid-stream
(``submit_resume``, in the engine's split form, so the resumed tokens
are the uninterrupted stream's bitwise on the card).

Overload control (:mod:`overload`): queue entries carry the request's
deadline; admission sheds at enqueue when the estimated queue wait
(batch-latency EWMA × queued batches) exceeds the remaining budget,
and the batcher evicts already-expired entries before each dispatch,
so abandoned requests never reach the card.

On a gang (``ModelManager(gang=)``, a
:class:`~kubeflow_tpu_torch.inference.engine.gang.GangLink` over the
group's ranks) rank 0's manager is the whole server: it alone polls
versions and takes requests, and its admission, tenancy, overload
shedding and micro-batcher run as on one card. A version whose shard
manifest spans the gang is announced on the line before rank 0 loads
it (``load_version`` builds its serving mesh; each rank reads its own
shard), and its device work then rides that version's channel; its
swap or unload is its ``close``. Every other rank runs
:meth:`ModelManager.follow`, which loads the same versions onto the
same mesh and runs each channel's work until rank 0's manager stops."""

from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np

from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.obs.tracing import TRACER
from kubeflow_tpu_torch.scaling import policy as scaling_policy
from kubeflow_tpu_torch.serving import _native, remote, tenancy
from kubeflow_tpu_torch.serving.export import read_metadata
from kubeflow_tpu_torch.serving.model import LoadedModel, load_version
from kubeflow_tpu_torch.serving.overload import (
    DeadlineExceededError,
    LatencyEstimator,
    OverloadedError,
    QuotaExceededError,
)
from kubeflow_tpu_torch.serving.version_policy import parse_version_policy
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["LOAD_ON_DEMAND_WAIT_S", "ModelManager", "ServedModel",
           "parse_version_policy"]

logger = logging.getLogger(__name__)

#: How long a request thread waits on a concurrent on-demand load of
#: the same version before giving up (load = read + device put + bucket
#: warmup; seconds on the CPU, tens of seconds for a large model).
LOAD_ON_DEMAND_WAIT_S = 300.0

#: Admission safety factor: admit only when the estimated queue wait
#: fits inside this fraction of the remaining budget. Admitting to
#: exactly the boundary turns every scheduling hiccup into a batch of
#: requests that are dispatched AND miss their deadline — all cost, no
#: goodput; the headroom absorbs the jitter instead.
ADMISSION_SAFETY = 0.8

# Prometheus families for the batcher's overload/throughput signals —
# the same numbers batch_stats() reports, now scrapeable at /metrics
# (serving/server.py), in the port's own registry. One family per
# signal, labeled by model; the
# per-model children are bound once in ServedModel.__init__ so the
# request path pays a float-add, not a dict lookup.
_M_SHED = obs_metrics.Counter(
    "kft_serving_shed_total",
    "Requests shed at admission (queue full or estimated wait over "
    "the remaining deadline budget)", ("model",))
_M_EXPIRED = obs_metrics.Counter(
    "kft_serving_expired_total",
    "Requests whose deadline lapsed before dispatch (never executed)",
    ("model",))
_M_BATCHES = obs_metrics.Counter(
    "kft_serving_batches_total",
    "Model executions issued by the micro-batcher", ("model",))
_M_ROWS = obs_metrics.Counter(
    "kft_serving_batch_rows_total",
    "Request rows carried by micro-batcher executions", ("model",))
_M_QUEUE_DEPTH = obs_metrics.Gauge(
    "kft_serving_queue_depth",
    "Requests enqueued and not yet popped by the batcher", ("model",))
_M_EST_LATENCY = obs_metrics.Gauge(
    "kft_serving_est_batch_latency_seconds",
    "Rolling batch-dispatch latency estimate (admission control's "
    "queue-wait crystal ball)", ("model",))
_M_QUEUE_WAIT = obs_metrics.Histogram(
    "kft_serving_queue_wait_seconds",
    "Time a dispatched request spent queued (enqueue to batcher pop)",
    ("model",), exemplars=True)
_M_DISPATCH = obs_metrics.Histogram(
    "kft_serving_dispatch_seconds",
    "Wall time of one batched model execution group", ("model",),
    exemplars=True)


def _combine_streams(streams, future: Future) -> None:
    """Resolve ``future`` with {"tokens": [n, T]} once every engine
    stream finishes (first error wins and cancels the rest). Runs on
    the engine thread via each stream's notify hook — no waiter
    thread per request."""
    import threading as _threading

    lock = _threading.Lock()
    state = {"left": len(streams)}
    counted = [False] * len(streams)

    def finalize() -> None:
        try:
            rows = [s.result(timeout=1.0) for s in streams]
        except BaseException as e:  # noqa: BLE001 — fan out
            for s in streams:
                s.cancel()
            if not future.done():
                future.set_exception(e)
            return
        if not future.done():
            future.set_result({"tokens": np.stack(rows)})

    def make_cb(i: int, stream):
        def cb() -> None:
            if not stream.done:
                return
            with lock:
                if counted[i]:
                    return
                counted[i] = True
                state["left"] -= 1
                last = state["left"] == 0
            if last:
                finalize()
        return cb

    for i, stream in enumerate(streams):
        cb = make_cb(i, stream)
        stream.set_notify(cb)
        cb()  # already-finished stream (raced the set_notify)


def version_dir(base_path: str, version: int) -> str:
    """A version's local dir: an object store's is pulled into the local
    cache first (they cannot be mmapped or listed), then loaded through
    the ordinary local path."""
    if remote.is_remote(base_path):
        return remote.materialize(base_path, version)
    return f"{base_path}/{version}"


def _spans_gang(path: str, gang: Any) -> bool:
    """Whether the version at ``path`` loads onto the gang: its shard
    manifest has one shard a rank."""
    sharding = read_metadata(path).sharding or {}
    return int(sharding.get("num_shards", 1)) == gang.size > 1


def _local_versions(base_path: str) -> List[int]:
    """All numeric version dirs under a POSIX base path, ascending."""
    import os

    try:
        with os.scandir(base_path) as it:
            return sorted({int(e.name) for e in it
                           if e.name.isdigit() and e.is_dir()})
    except OSError:
        return []


class ServedModel:
    """One named model: its base path, loaded versions, batcher."""

    def __init__(self, name: str, base_path: str, *, max_batch: int = 64,
                 batch_window_s: float = 0.002,
                 version_policy: str = "latest",
                 queue_capacity: int = 4096,
                 continuous_batching: bool = False,
                 tenancy_registry: Optional[
                     tenancy.TenantRegistry] = None,
                 device: DeviceLike = None, gang: Any = None):
        self.name = name
        #: The gang's control line (rank 0's), or None on one card.
        self.gang = gang
        #: Where versions load: ``None`` → cuda (raises without a
        #: GPU), ``"cpu"`` only on request.
        self.device = resolve_device(device)
        self.base_path = base_path
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.queue_capacity = queue_capacity
        # Continuous batching: generate requests ride the
        # slot-based decode engine (inference/engine/) instead of the
        # admit-at-dispatch coalescer — rows join/retire mid-decode
        # and tokens stream incrementally. predict/classify traffic
        # keeps the micro-batcher either way.
        self.continuous_batching = continuous_batching
        # Multi-tenant isolation (serving/tenancy.py): with
        # a registry, submits are charged against per-tenant token
        # buckets (over-quota = structured 429, never a global shed)
        # and the request queue becomes per-tenant sub-queues drained
        # weighted-fair by quota share. None = the classic
        # single-FIFO path, bitwise unchanged.
        self._tenancy = tenancy_registry
        self.version_policy, self._pinned = parse_version_policy(
            version_policy)
        self._versions: Dict[int, LoadedModel] = {}
        self._latest: Optional[int] = None
        self._loading: Dict[int, threading.Event] = {}
        self._lock = threading.Lock()
        # queue_capacity bounds the worst-case queue WAIT, not just
        # memory: a deadline-free client's request can sit behind at
        # most capacity/max_batch dispatches. Size it so that wait is
        # tolerable (capacity × batch latency / max_batch).
        if tenancy_registry is not None:
            self._queue: Any = tenancy.TenantRequestQueue(
                queue_capacity, weight_of=tenancy_registry.weight)
        else:
            self._queue = _native.RequestQueue(queue_capacity)
        # _pending is touched by every request thread and the batcher;
        # GIL-atomicity of single dict ops is not a contract worth
        # betting on (submit's push-fail cleanup + a concurrent pop of
        # a neighboring id interleave arbitrarily), so all access goes
        # through _pending_lock. _worker_lock serializes batcher
        # start/stop (two concurrent first requests must not spawn two
        # batch loops).
        self._pending_lock = threading.Lock()
        self._worker_lock = threading.Lock()
        self._pending: Dict[int, Any] = {}
        self._ids = itertools.count(1)
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        # Batch-fill accounting (PERF/benchmark instrumentation): how
        # many model executions the batcher issued and how many request
        # rows they carried.
        self._stat_batches = 0
        self._stat_rows = 0
        # Overload accounting: shed (rejected at enqueue — queue full
        # or admission control) and expired (deadline lapsed while
        # queued, evicted before dispatch). Incremented from request
        # threads AND the batcher, so writes go through _pending_lock
        # (int += is read-modify-write, not GIL-atomic).
        self._stat_shed = 0
        self._stat_expired = 0
        # Rolling batch-dispatch latency: the admission controller's
        # queue-wait estimate. Seeded from warmup timing at model load
        # (see _seed_latency) so the very first burst is judged too.
        self._latency = LatencyEstimator()
        # Bound metric children (kft_serving_* families above). Two
        # ServedModels with one name (tests) share children — last
        # set_function wins, which is the live instance.
        self._m_shed = _M_SHED.labels(name)
        self._m_expired = _M_EXPIRED.labels(name)
        self._m_batches = _M_BATCHES.labels(name)
        self._m_rows = _M_ROWS.labels(name)
        self._m_queue_wait = _M_QUEUE_WAIT.labels(name)
        self._m_dispatch = _M_DISPATCH.labels(name)
        self._g_depth = _M_QUEUE_DEPTH.labels(name)
        self._g_depth.set_function(self._queue.size)
        self._g_est = _M_EST_LATENCY.labels(name)
        self._g_est.set_function(self._latency.estimate_s)

    # -- version lifecycle ------------------------------------------------

    def _available_versions(self) -> List[int]:
        """All version dirs under base_path, ascending. The common
        latest-policy poll keeps riding the native C++ scanner (it
        returns only the max; that's all "latest" needs)."""
        if remote.is_remote(self.base_path):
            return remote.scan_versions(self.base_path)
        if self.version_policy == "latest":
            latest = _native.scan_latest_version(self.base_path)
            return [latest] if latest >= 0 else []
        return _local_versions(self.base_path)

    def _version_dir(self, version: int) -> str:
        return version_dir(self.base_path, version)

    def _load(self, version: int) -> LoadedModel:
        logger.info("model %s: loading version %d from %s",
                    self.name, version, self.base_path)
        path = self._version_dir(version)
        if self.gang is not None and _spans_gang(path, self.gang):
            # Announced first: every rank loads it (a collective), under
            # the line's lock so no other model's work interleaves.
            with self.gang.lock:
                self.gang.send(("load", self.name, self.base_path, version,
                                self.max_batch))
                loaded = load_version(
                    path, max_batch=self.max_batch, device=self.device,
                    gang=self.gang.channel((self.name, version)))
            loaded.warmup()
        else:
            # warmup=True: every batch bucket runs once during load
            # (health stays 503), so no request pays a first-run cost.
            loaded = load_version(path, max_batch=self.max_batch,
                                  warmup=True, device=self.device)
        # Warmup timed one post-compile full-bucket execution: install
        # it as the admission controller's latency prior, so the first
        # overload burst after a cold start is shed correctly instead
        # of admitted unjudged.
        if loaded.warmup_batch_seconds is not None:
            self._latency.seed(loaded.warmup_batch_seconds)
        if (self.continuous_batching
                and loaded.signature().method == "generate"):
            # Build + warm the decode engine during load (still 503):
            # on the GPU the first use of a prefill bucket or a slice
            # length captures its CUDA graph, the same first-run cliff
            # the bucket warmup exists for.
            self._warm_engine(loaded.ensure_engine(
                self.name, queue_capacity=self.queue_capacity))
        return loaded

    def _warm_engine(self, engine) -> None:
        """Run the engine's prefill buckets and slice programs once,
        with one throwaway request per prompt bucket (fixed key: a
        warmup must not perturb deterministic exports' rng streams).
        On the GPU each first use captures that ``engine_compile``
        key's CUDA graph (``inference/engine/graphs.py``): the classic
        prefill of every warm bucket and the decode slice of every
        length 1..``slice_tokens``, so the first real request at those
        buckets captures nothing."""
        cfg = engine.config
        buckets = sorted({int(v) for v in (cfg.prompt_buckets or ())}
                         | {cfg.max_prompt_len})
        key = np.asarray(prng.PRNGKey(0))
        # One request per prompt bucket runs its prefill (and the
        # full-K slice, reached from every bucket). Prefix-cache
        # engines run the bucket loop TWICE: the second pass hits the
        # blocks the first registered, running the page-gather and
        # the tail-prefill programs the warm path runs (residual tail
        # widths run first under traffic, like tail slices always
        # have).
        tokens = min(cfg.max_new_tokens, cfg.slice_tokens + 1)
        for cold_pass in ((True, False) if engine.prefix is not None
                          else (True,)):
            for width in buckets:
                prompt = np.zeros((min(width, cfg.max_prompt_len),),
                                  np.int32)
                engine.submit(prompt, rng=key,
                              max_new_tokens=tokens).result(timeout=600)
                if cold_pass and engine.prefix is not None:
                    # Keep the first pass fully COLD: a smaller
                    # bucket's registered zero blocks would otherwise
                    # match a larger bucket's prompt and skip its
                    # full-width prefill — the exact cliff this
                    # warmup exists to prevent.
                    engine.clear_prefix_cache()
        # Tail slices: a request retiring mid-slice shrinks K, and
        # each distinct K is its own program (its own graph on the
        # GPU) — warm K=1..slice-1 too (sequential solo requests with
        # budget b run one (b-1)-step slice), or the first short
        # request pays its capture mid-traffic.
        prompt = np.zeros((min(buckets[0], cfg.max_prompt_len),),
                          np.int32)
        for budget in range(2, min(cfg.slice_tokens + 1,
                                   cfg.max_new_tokens + 1)):
            engine.submit(prompt, rng=key,
                          max_new_tokens=budget).result(timeout=600)
        # Warmup prompts are zeros, not traffic — drop them from the
        # prefix index so the pool starts traffic with a full free
        # list and real prompts can't "hit" warmup garbage.
        engine.clear_prefix_cache()

    def poll_versions(self) -> bool:
        """Scan base_path; (re)load whatever the version policy admits.
        Returns True if any load happened."""
        available = self._available_versions()
        if self.version_policy == "specific":
            target = [v for v in self._pinned if v in available]
            absent = sorted(set(self._pinned) - set(available))
            if absent:
                logger.warning(
                    "model %s: pinned version(s) %s not present under "
                    "%s yet", self.name, absent, self.base_path)
        elif self.version_policy == "all":
            target = available
        else:
            target = available[-1:]
        if not target:
            return False
        with self._lock:
            to_load = [v for v in target if v not in self._versions]
            previous = self._latest
        if not to_load and max(target) == previous:
            return False
        loaded_any = False
        failed = set()
        for v in sorted(to_load):
            # Through the single-flight path: a concurrent pinned
            # request may be loading the same version right now —
            # never run the load (device put + bucket warmup) twice. One corrupt/mid-upload version dir must not wedge
            # the rest of the target set (or block _latest forever):
            # isolate per-version failures and retry on the next poll.
            try:
                self._ensure_loaded(v)
                loaded_any = True
            except Exception:  # noqa: BLE001 — logged, next poll retries
                logger.exception("model %s: version %d failed to load",
                                 self.name, v)
                failed.add(v)
        target = [v for v in target if v not in failed]
        if not target:
            return loaded_any
        default = max(target)
        with self._lock:
            self._latest = default
            # Eviction by policy: "latest" keeps the new default plus
            # the previous one (in-flight requests may still reference
            # it); "specific" keeps exactly the pinned-and-present set;
            # "all" keeps everything. On-demand extras (get() below)
            # live until the next reload event prunes them.
            if self.version_policy == "latest":
                keep = set(target) | ({previous} if previous is not None
                                      else set())
            elif self.version_policy == "specific":
                keep = set(target)
            else:
                keep = set(self._versions)
            evicted = [self._versions.pop(v)
                       for v in list(self._versions) if v not in keep]
            resident = sorted(self._versions)
        # Close OUTSIDE the lock: engine.stop() joins the decode
        # thread (up to 10s mid-compile), and holding _lock for that
        # long blocks get_resident() — i.e. all admission — for the
        # whole model during a routine version rollout.
        for loaded in evicted:
            close = getattr(loaded, "close", None)
            if close is not None:
                close()
        if remote.is_remote(self.base_path):
            remote.prune_cache(self.base_path, resident)
        return loaded_any

    def get_resident(self, version: Optional[int] = None
                     ) -> Optional[LoadedModel]:
        """The loaded model if (and only if) it is already resident —
        a lock-guarded dict lookup, never a load. The HTTP handlers'
        hot path: under overload, routing every request through a
        pool-thread get() turns the executor into a second queue in
        front of the real one; the fast path keeps admission control
        the first thing a request meets. None → fall back to get()
        on a pool thread (load-on-demand may take minutes)."""
        with self._lock:
            v = self._latest if version is None else version
            if v is None:
                return None
            return self._versions.get(v)

    def get(self, version: Optional[int] = None) -> LoadedModel:
        with self._lock:
            if self._latest is None:
                raise KeyError(f"model {self.name!r} has no loaded version")
            v = self._latest if version is None else version
            if v in self._versions:
                return self._versions[v]
        if version is None:  # default version must already be resident
            raise KeyError(
                f"model {self.name!r} version {v} not loaded; "
                f"available: {self.versions}")
        return self._load_on_demand(version)

    def _ensure_loaded(self, version: int) -> LoadedModel:
        """Single-flight load: exactly one thread (request or poll)
        runs the load for a given version; others wait on its
        completion event."""
        with self._lock:
            if version in self._versions:
                return self._versions[version]
            event = self._loading.get(version)
            owner = event is None
            if owner:
                event = threading.Event()
                self._loading[version] = event
        if not owner:
            event.wait(LOAD_ON_DEMAND_WAIT_S)
            with self._lock:
                if version in self._versions:
                    return self._versions[version]
            raise KeyError(
                f"model {self.name!r} version {version} failed to load")
        try:
            loaded = self._load(version)
            with self._lock:
                self._versions[version] = loaded
            return loaded
        finally:
            with self._lock:
                self._loading.pop(version, None)
            event.set()

    def _load_on_demand(self, version: int) -> LoadedModel:
        """A pinned-version request for a version not resident: load it
        from the base path if the policy admits it (TF-Serving served
        only resident versions, so a pinned rollback target was
        reachable only while it happened to still be in memory)."""
        if self.version_policy == "specific" and version not in self._pinned:
            raise KeyError(
                f"model {self.name!r} version {version} excluded by "
                f"version_policy specific:{','.join(map(str, self._pinned))}")
        with self._lock:
            if version in self._versions:
                return self._versions[version]
        if remote.is_remote(self.base_path):
            present = version in remote.scan_versions(self.base_path)
        else:
            import os

            present = os.path.isdir(f"{self.base_path}/{version}")
        if not present:
            raise KeyError(
                f"model {self.name!r} version {version} not found "
                f"under {self.base_path}")
        return self._ensure_loaded(version)

    @property
    def versions(self) -> List[int]:
        with self._lock:
            return sorted(self._versions)

    # -- batched execution -------------------------------------------------

    def start_batcher(self) -> None:
        with self._worker_lock:
            if self._worker is None and not self._closed:
                self._worker = threading.Thread(
                    target=self._batch_loop, name=f"batcher-{self.name}",
                    daemon=True)
                self._worker.start()

    def stop(self) -> None:
        with self._worker_lock:
            self._closed = True
            worker, self._worker = self._worker, None
        # Unbind the registry-lifetime gauge callbacks: they hold this
        # instance (and its loaded device buffers) otherwise. The
        # owner check means a stopped instance never clobbers a newer
        # same-named model's live binding.
        self._g_depth.clear_function(self._queue)
        self._g_est.clear_function(self._latency)
        self._queue.close()
        if worker is not None:
            worker.join(timeout=5)
        # Fail anything the batcher never drained (popping under the
        # lock transfers resolution ownership to this thread).
        with self._pending_lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
        for req in leftovers:
            req[4].set_exception(RuntimeError("server shutting down"))
        with self._lock:
            resident = list(self._versions.values())
        for loaded in resident:
            # Duck-typed: tests stub LoadedModel with bare objects.
            close = getattr(loaded, "close", None)
            if close is not None:
                close()  # decode-engine threads + page pools

    def queue_depth(self) -> int:
        """Requests enqueued but not yet popped by the batcher."""
        return self._queue.size()

    def estimated_wait_s(self) -> float:
        """Expected queue wait for a request admitted NOW: the rolling
        batch-latency estimate × batches ahead of it (everything
        queued, at max_batch per dispatch, plus its own batch)."""
        depth = self._queue.size()
        return self._latency.estimate_s() * (depth / self.max_batch + 1.0)

    def _span_args(self, obs_ctx, outcome: str, **extra):
        # span_args carries the request/trace ids plus parent_id (the
        # transport root span's id) so the fleet collector can hang
        # the manager trio under the right hop of the waterfall.
        from kubeflow_tpu_torch.obs.tracing import span_args

        return span_args(obs_ctx, model=self.name, outcome=outcome,
                         **extra)

    def _decode_cost(self, signature_name, method, version) -> int:
        """Requested decode budget for the tenant token bucket: the
        export's max_new_tokens for generate-method submissions, 0
        otherwise (predict/classify cost rides the request bucket
        alone). Best-effort — a still-loading version or a stub
        charges 0 rather than failing the request over billing."""
        loaded = self.get_resident(version)
        if loaded is None:
            return 0
        try:
            sig = loaded.signature(signature_name)
            if (method or sig.method) != "generate":
                return 0
            cfg = getattr(loaded.metadata, "generate_config",
                          None) or {}
            return int(cfg.get("max_new_tokens", 0))
        except Exception:  # noqa: BLE001 — cost estimate only; the
            # submit path itself re-validates everything.
            return 0

    def _engine_for(self, loaded):
        """``ensure_engine`` plus the tenancy hookup: the engine's
        fair admission queue drains by the registry's quota-share
        weights (idempotent per call; no registry = unweighted)."""
        engine = loaded.ensure_engine(
            self.name, queue_capacity=self.queue_capacity)
        if self._tenancy is not None:
            engine.set_tenant_weights(self._tenancy.weight)
        return engine

    def submit(self, inputs: Dict[str, np.ndarray],
               signature_name: Optional[str],
               method: Optional[str],
               version: Optional[int], *,
               deadline: Optional[float] = None,
               obs_ctx=None,
               tenant: str = "",
               on_streams=None,
               kv_fetch_s: float = 0.0) -> Future:
        """Enqueue one request for micro-batching; resolves to the
        output dict for exactly this request's rows.

        ``deadline`` is an absolute ``time.monotonic()`` timestamp.
        Admission control runs here: a request whose remaining budget
        is already smaller than the estimated queue wait is shed NOW
        (future carries OverloadedError with a Retry-After hint)
        rather than queued to expire; an already-expired request gets
        DeadlineExceededError without touching the queue.

        ``obs_ctx`` is the request's :class:`TraceContext` (from the
        transport's headers/metadata): its ids tag the per-request
        spans so a request_id greps from proxy access log to the model
        execution that served it.

        ``tenant`` names the request's quota buckets and
        weighted-fair sub-queue; with a tenancy registry, an
        over-quota tenant's future carries
        :class:`~.overload.QuotaExceededError` (→ 429 + Retry-After)
        BEFORE any global admission state is touched — a tenant
        spending its own budget is never a fleet-wide shed."""
        self.start_batcher()
        tenant = tenant or tenancy.DEFAULT_TENANT
        tenancy.note_request(tenant)  # billing-grade offered load
        if self._tenancy is not None:
            try:
                self._tenancy.admit_request(
                    tenant, decode_tokens=self._decode_cost(
                        signature_name, method, version))
            except QuotaExceededError as e:
                quota_future: Future = Future()
                if TRACER.enabled:
                    TRACER.record(
                        "request", "serving", time.monotonic(), 0.0,
                        self._span_args(obs_ctx, "quota_shed",
                                        tenant=tenant))
                quota_future.set_exception(e)
                return quota_future
        if self.continuous_batching:
            # Generate rides the slot engine when the target version
            # is already resident (a version still loading keeps the
            # classic queue path — the batcher thread owns the slow
            # load). predict/classify always ride the micro-batcher.
            loaded = self.get_resident(version)
            if loaded is not None:
                sig = loaded.signature(signature_name)
                if (method or sig.method) == "generate" \
                        and sig.method == "generate":
                    return self._submit_engine(
                        loaded, inputs, signature_name,
                        deadline=deadline, obs_ctx=obs_ctx,
                        tenant=tenant, on_streams=on_streams,
                        kv_fetch_s=kv_fetch_s)
        future: Future = Future()
        t_enqueue = time.monotonic()
        if deadline is not None:
            remaining = deadline - t_enqueue
            if remaining <= 0:
                with self._pending_lock:
                    self._stat_expired += 1
                self._m_expired.inc()
                tenancy.note_expired(tenant)
                if TRACER.enabled:
                    TRACER.record("request", "serving", t_enqueue, 0.0,
                                  self._span_args(obs_ctx, "expired"))
                future.set_exception(DeadlineExceededError(
                    "deadline expired before enqueue"))
                return future
            est_wait = self.estimated_wait_s()
            if scaling_policy.admission_should_shed(
                    est_wait, remaining, ADMISSION_SAFETY):
                with self._pending_lock:
                    self._stat_shed += 1
                self._m_shed.inc()
                tenancy.note_shed(tenant, "overload")
                if TRACER.enabled:
                    TRACER.record("request", "serving", t_enqueue, 0.0,
                                  self._span_args(obs_ctx, "shed"))
                future.set_exception(OverloadedError(
                    f"server overloaded: estimated queue wait "
                    f"{est_wait * 1e3:.0f}ms exceeds remaining deadline "
                    f"budget {remaining * 1e3:.0f}ms",
                    retry_after_s=est_wait))
                return future
        request_id = next(self._ids)
        with self._pending_lock:
            self._pending[request_id] = (inputs, signature_name, method,
                                         version, future, deadline,
                                         (obs_ctx, t_enqueue), tenant)
        try:
            if self._tenancy is not None:
                # The tenant-aware queue: per-tenant sub-queues, the
                # batcher's pop_batch drains them weighted-fair.
                pushed = self._queue.push(request_id, tenant)
            else:
                pushed = self._queue.push(request_id)
            error: Optional[Exception] = None
        except RuntimeError:  # queue closed mid-flight (shutdown race)
            pushed = False
            error = RuntimeError("server shutting down")
        if not pushed:
            if error is None:  # built lazily — never on the hot path
                error = OverloadedError(
                    "server overloaded: request queue full",
                    retry_after_s=self.estimated_wait_s())
            # Ownership protocol: whoever pops the _pending entry (this
            # thread, the batcher, or stop()'s drain) is the only one
            # allowed to resolve the future — no set_exception races.
            with self._pending_lock:
                owned = self._pending.pop(request_id, None) is not None
                if owned and isinstance(error, OverloadedError):
                    self._stat_shed += 1
            if owned:
                if isinstance(error, OverloadedError):
                    self._m_shed.inc()
                    tenancy.note_shed(tenant, "overload")
                    if TRACER.enabled:
                        TRACER.record(
                            "request", "serving", t_enqueue,
                            time.monotonic() - t_enqueue,
                            self._span_args(obs_ctx, "shed"))
                future.set_exception(error)
        return future

    def submit_stream(self, inputs: Dict[str, np.ndarray],
                      signature_name: Optional[str],
                      version: Optional[int], *,
                      deadline: Optional[float] = None,
                      obs_ctx=None,
                      tenant: str = "",
                      max_new_tokens: Optional[int] = None,
                      kv_fetch_s: float = 0.0):
        """Streaming generate: submit every request row to the decode
        engine and return ``(loaded, [GenerateStream per row])`` — the
        transports (SSE on REST, gRPC server streaming) drain the
        streams incrementally. ``max_new_tokens`` optionally lowers
        this request's token budget below the export's (the slot
        retires early — the per-request knob static batching can't
        offer). Raises OverloadedError / DeadlineExceededError
        synchronously when the engine sheds."""
        if not self.continuous_batching:
            raise ValueError(
                f"model {self.name!r} is not served with continuous "
                f"batching; token streaming requires it "
                f"(--continuous_batching)")
        tenant = tenant or tenancy.DEFAULT_TENANT
        tenancy.note_request(tenant)
        if self._tenancy is not None:
            cost = (int(max_new_tokens) if max_new_tokens
                    else self._decode_cost(signature_name, "generate",
                                           version))
            # Raises QuotaExceededError synchronously, like the
            # engine's own shed path — the transports map it to 429.
            self._tenancy.admit_request(tenant, decode_tokens=cost)
        loaded = self.get(version)
        sig = loaded.signature(signature_name)
        if sig.method != "generate":
            raise ValueError(
                f"streaming requires a generate signature; "
                f"{signature_name or 'serving_default'!r} is "
                f"{sig.method!r}")
        x, n = loaded._prepare(sig, inputs, variable_length=True)
        if n == 0:
            raise ValueError("empty batch")
        engine = self._engine_for(loaded)
        rngs = loaded.request_rngs(n)
        streams = []
        try:
            for i in range(n):
                streams.append(engine.submit(
                    x[i], rng=rngs[i], deadline=deadline,
                    obs_ctx=obs_ctx, tenant=tenant,
                    max_new_tokens=max_new_tokens,
                    kv_fetch_s=kv_fetch_s if i == 0 else 0.0))
        except BaseException:
            for s in streams:  # free the slots already taken
                s.cancel()
            raise
        return loaded, streams

    def prefill_handoff(self, inputs: Dict[str, np.ndarray],
                        signature_name: Optional[str],
                        version: Optional[int], *,
                        deadline: Optional[float] = None,
                        tenant: str = "",
                        max_new_tokens: Optional[int] = None,
                        obs_ctx=None):
        """Prefill-only execution (role-split routing's first hop):
        run each request row's prompt prefill and return ``(loaded,
        [PrefillHandoff per row])`` WITHOUT taking a decode slot —
        the caller ships the handoffs to a decode-role replica whose
        engine adopts the pages (:meth:`submit_handoff`). Engine
        (continuous-batching) models only: the page-adopt seam IS the
        handoff mechanism."""
        if not self.continuous_batching:
            raise ValueError(
                f"model {self.name!r} is not served with continuous "
                f"batching; KV handoff rides the decode engine's "
                f"page-adopt seam (--continuous_batching)")
        loaded = self.get(version)
        sig = loaded.signature(signature_name)
        if sig.method != "generate":
            raise ValueError(
                f"prefill handoff requires a generate signature; "
                f"got {sig.method!r}")
        tenant = tenant or tenancy.DEFAULT_TENANT
        tenancy.note_request(tenant)
        if self._tenancy is not None:
            # The split path's quota point is hop 1: the prefill is
            # where a request ENTERS the fleet; hop 2 adopts work
            # already paid for (charging both hops would double-bill
            # every split request).
            cost = (int(max_new_tokens) if max_new_tokens
                    else self._decode_cost(signature_name, "generate",
                                           version))
            self._tenancy.admit_request(tenant, decode_tokens=cost)
        x, n = loaded._prepare(sig, inputs, variable_length=True)
        if n == 0:
            raise ValueError("empty batch")
        if deadline is not None and deadline <= time.monotonic():
            raise DeadlineExceededError(
                "deadline expired before prefill")
        engine = self._engine_for(loaded)
        rngs = loaded.request_rngs(n)
        return loaded, [
            engine.run_prefill(x[i], rng=rngs[i],
                               max_new_tokens=max_new_tokens,
                               obs_ctx=obs_ctx)
            for i in range(n)]

    def submit_handoff(self, handoffs, version: Optional[int], *,
                       deadline: Optional[float] = None,
                       obs_ctx=None, tenant: str = ""):
        """Resume decodes whose prefills ran elsewhere: adopt each
        handoff's pages into this replica's engine. Returns
        ``(loaded, [GenerateStream per handoff])`` — the same handle
        shape as :meth:`submit_stream`, so both the unary combiner
        and the SSE/gRPC streaming transports drain it unchanged."""
        if not self.continuous_batching:
            raise ValueError(
                f"model {self.name!r} is not served with continuous "
                f"batching; KV handoff rides the decode engine's "
                f"page-adopt seam (--continuous_batching)")
        loaded = self.get(version)
        engine = self._engine_for(loaded)
        # No quota charge here: the split path billed this request at
        # its prefill hop; the tenant still names the fair sub-queue.
        tenant = tenant or tenancy.DEFAULT_TENANT
        streams = []
        try:
            for h in handoffs:
                streams.append(engine.submit(
                    handoff=h, deadline=deadline, obs_ctx=obs_ctx,
                    tenant=tenant))
        except BaseException:
            for s in streams:  # free the slots already taken
                s.cancel()
            raise
        return loaded, streams

    def submit_resume(self, resumes, version: Optional[int], *,
                      deadline: Optional[float] = None,
                      obs_ctx=None, tenant: str = ""):
        """Mid-stream decode resume: continue streams whose decode died
        on ANOTHER replica. ``resumes`` is a list of ``(resume_token,
        emitted)`` pairs — the token dict is the dead replica's
        serialized resume context (wire.py ``decode_resume_token``:
        prompt ids + the full step-key schedule + budget) and
        ``emitted`` the tokens the proxy already relayed to the client
        since that token was minted. Each row re-enters the engine as
        a continuation in the engine's split form: context = prompt +
        emitted, schedule = keys[len(emitted):], ``prompt_len`` = the
        token's ``prompt_len`` where it carries one (a stream that was
        itself resumed: its "prompt" holds its first life's tokens)
        else the prompt's length. The original prompt prefills as at
        its first admission and every emitted token is replayed on
        the decode route, so the continuation is the uninterrupted
        stream's bitwise on the card too. A row whose emitted tokens
        already carry EOS (or whose budget is spent) finishes
        synthetically with the reference's latched-EOS padding — the
        engine is never burned on a completed stream. Returns
        ``(loaded, [GenerateStream per row])``, the submit_stream
        handle shape."""
        if not self.continuous_batching:
            raise ValueError(
                f"model {self.name!r} is not served with continuous "
                f"batching; decode resume rides the engine "
                f"(--continuous_batching)")
        from kubeflow_tpu_torch.inference.engine.engine import (
            GenerateStream,
        )

        loaded = self.get(version)
        engine = self._engine_for(loaded)
        # A resume continues an already-billed stream; no fresh quota
        # charge (the tenant still names its fair sub-queue).
        tenant = tenant or tenancy.DEFAULT_TENANT
        eos = engine.config.eos_id
        streams = []
        try:
            for token, emitted in resumes:
                prompt = np.asarray(token["prompt_tokens"],
                                    np.int32).reshape(-1)
                keys = np.asarray(token["step_keys"],
                                  np.uint32).reshape(-1, 2)
                budget = int(token["max_new_tokens"])
                if len(keys) != budget:
                    raise ValueError(
                        f"resume token carries {len(keys)} step keys "
                        f"for a {budget}-token budget")
                emitted = [int(t) for t in emitted]
                n = len(emitted)
                if n > budget:
                    raise ValueError(
                        f"{n} emitted tokens exceed the {budget}-token "
                        f"budget")
                if n >= budget or (eos is not None and eos in emitted):
                    # Terminal before the resume: the remainder is the
                    # latched-EOS padding of the reference shape.
                    remaining = budget - n
                    pad = ([] if eos is None
                           else [eos] * remaining)
                    s = GenerateStream(remaining, obs_ctx=obs_ctx)
                    s._finish(np.asarray(pad, np.int32))
                    streams.append(s)
                    continue
                context = np.concatenate(
                    [prompt, np.asarray(emitted, np.int32)])
                streams.append(engine.submit(
                    context, step_keys=keys[n:], deadline=deadline,
                    obs_ctx=obs_ctx, tenant=tenant,
                    prompt_len=int(token.get("prompt_len",
                                             len(prompt)))))
        except BaseException:
            for s in streams:  # free the slots already taken
                s.cancel()
            raise
        return loaded, streams

    def export_kv_blocks(self, tokens, version: Optional[int] = None):
        """Owner-side half of the fleet KV tier: walk the
        resident engine's prefix chain for ``tokens`` and return
        ``(loaded, [(block_tokens, layers)])``. An empty chain is a
        clean miss the asker pays prefill for — so a version that is
        not resident, a model without an engine yet (nothing could be
        cached), or zero coverage all answer ``(loaded-or-None, [])``
        rather than erroring. Engine (continuous-batching) models
        only: the prefix chain IS the engine's radix index."""
        if not self.continuous_batching:
            raise ValueError(
                f"model {self.name!r} is not served with continuous "
                f"batching; the fleet KV tier rides the decode "
                f"engine's prefix cache (--continuous_batching)")
        loaded = self.get_resident(version)
        if loaded is None:
            return None, []
        engine = loaded.engine
        if engine is None:
            return loaded, []
        return loaded, engine.export_prefix_blocks(
            np.asarray(tokens, np.int32))

    def kv_prefetch(self, tokens, owner_url: str,
                    version: Optional[int] = None,
                    deadline: Optional[float] = None) -> float:
        """Asker-side half of the fleet KV tier: before a
        generate pays prefill, pull the prompt's prefix blocks from
        the rendezvous owner the proxy named (``X-KFT-KV-Owner``)
        into this replica's host tier. Returns the seconds spent —
        the transport threads it into the request's ``kv_fetch``
        attribution bucket — and NEVER raises: a fleet fetch is an
        optimisation, so every failure (and every model this doesn't
        apply to) is a silent 0.0 and the request prefills locally.
        ``kv_fetch_deadline_ms`` in the export's generate_config
        bounds the fetch (0 disables it for the model)."""
        from kubeflow_tpu_torch.serving import kv_store

        if not self.continuous_batching or not owner_url \
                or tokens is None:
            return 0.0
        try:
            loaded = self.get_resident(version)
            if loaded is None:
                return 0.0
            sig = loaded.signature(None)
            if sig.method != "generate":
                return 0.0
            cfg = getattr(loaded.metadata, "generate_config",
                          None) or {}
            deadline_ms = int(cfg.get(
                "kv_fetch_deadline_ms",
                kv_store.DEFAULT_FETCH_DEADLINE_MS))
            if deadline_ms <= 0:
                return 0.0
            # _engine_for (not loaded.engine): the submit that
            # follows this fetch constructs the engine anyway, so
            # building it a moment early costs nothing and lets the
            # very first request on a cold replica still import.
            engine = self._engine_for(loaded)
            return kv_store.prefetch_into(
                engine, self.name, int(loaded.version), owner_url,
                tokens, deadline_ms=deadline_ms, deadline=deadline)
        except Exception:  # noqa: BLE001 — never user-visible
            logger.debug("kv prefetch skipped", exc_info=True)
            return 0.0

    def _submit_engine(self, loaded, inputs: Dict[str, np.ndarray],
                       signature_name: Optional[str], *,
                       deadline: Optional[float],
                       obs_ctx, tenant: str = "",
                       on_streams=None,
                       kv_fetch_s: float = 0.0) -> Future:
        """Non-streaming generate over the engine: the classic
        future-of-{"tokens": [n, T]} contract, built by combining the
        per-row streams (so REST/gRPC unary clients transparently gain
        slot-level batching). ``on_streams`` hands the live
        engine streams back to the transport so a client that hangs up
        — or a hedged request whose twin already won — can CANCEL the
        decode instead of burning slots into a dead socket."""
        future: Future = Future()
        sig = loaded.signature(signature_name)
        try:
            x, n = loaded._prepare(sig, inputs, variable_length=True)
            if n == 0:
                raise ValueError("empty batch")
            engine = self._engine_for(loaded)
            rngs = loaded.request_rngs(n)
            streams = []
            try:
                for i in range(n):
                    # The fleet KV fetch ran once for the whole
                    # request; attribute it to row 0 only so the
                    # waterfall's bucket sum stays the wall time.
                    streams.append(engine.submit(
                        x[i], rng=rngs[i], deadline=deadline,
                        obs_ctx=obs_ctx, tenant=tenant,
                        kv_fetch_s=kv_fetch_s if i == 0 else 0.0))
            except BaseException:
                for s in streams:
                    s.cancel()
                raise
        except (DeadlineExceededError, OverloadedError) as e:
            with self._pending_lock:
                if isinstance(e, OverloadedError):
                    self._stat_shed += 1
                else:
                    self._stat_expired += 1
            (self._m_shed if isinstance(e, OverloadedError)
             else self._m_expired).inc()
            if isinstance(e, DeadlineExceededError):
                tenancy.note_expired(tenant or tenancy.DEFAULT_TENANT)
            future.set_exception(e)
            return future
        except Exception as e:  # noqa: BLE001 — validation errors
            future.set_exception(e)
            return future
        if on_streams is not None:
            try:
                on_streams(streams)
            except Exception:  # noqa: BLE001 — a transport hook bug
                logger.exception("on_streams hook failed")
        _combine_streams(streams, future)
        return future

    def _batch_loop(self) -> None:
        while True:
            ids = self._queue.pop_batch(self.max_batch, timeout_s=0.05,
                                        window_s=self.batch_window_s)
            if ids is None:
                return
            if not ids:
                continue
            with self._pending_lock:
                # Entries may be gone if stop() cleared _pending while
                # this thread outlived the join timeout.
                requests = [r for r in
                            (self._pending.pop(i, None) for i in ids)
                            if r is not None]
            if not requests:
                continue
            t_pop = time.monotonic()
            # Deadline eviction: entries whose deadline lapsed while
            # queued are failed HERE, before grouping — an abandoned
            # request must never burn a model execution. This is the
            # hard guarantee the overload bench asserts via
            # batch_stats (expired + dispatched rows == admitted).
            # The cutoff includes half an estimated execution: a
            # request dispatched with less remaining budget than the
            # dispatch itself takes completes just after its caller
            # hung up — all cost, no goodput.
            cutoff = t_pop + 0.5 * self._latency.estimate_s()
            live: List[Any] = []
            expired: List[Any] = []
            for req in requests:  # single pass: tuples hold ndarrays,
                # so membership tests (==) are not an option here
                (expired if req[5] is not None and req[5] <= cutoff
                 else live).append(req)
            if expired:
                requests = live
                with self._pending_lock:
                    self._stat_expired += len(expired)
                self._m_expired.inc(len(expired))
                for req in expired:
                    tenancy.note_expired(req[7])
                    if TRACER.enabled:
                        ctx, t_enq = req[6]
                        TRACER.record(
                            "queue_wait", "serving", t_enq,
                            t_pop - t_enq,
                            self._span_args(ctx, "expired"))
                    req[4].set_exception(DeadlineExceededError(
                        "deadline expired while queued; request was "
                        "never dispatched"))
                if not requests:
                    continue
            # Group by (signature, method, version): only same-signature
            # requests can share a model execution.
            groups: Dict[Any, List[Any]] = {}
            for req in requests:
                key = (req[1], req[2], req[3])
                groups.setdefault(key, []).append(req)
            for (sig_name, method, version), group in groups.items():
                self._run_group(sig_name, method, version, group, t_pop)

    def batch_stats(self, reset: bool = False) -> Dict[str, float]:
        """Batcher fill statistics since start (or last reset): number
        of model executions, total rows, mean rows per execution, plus
        the overload counters (shed at admission, expired in queue)
        and the rolling batch-latency estimate. Reset is only safe
        while traffic is quiescent (benchmark phases)."""
        with self._pending_lock:
            batches, rows = self._stat_batches, self._stat_rows
            shed, expired = self._stat_shed, self._stat_expired
            if reset:
                self._stat_batches = 0
                self._stat_rows = 0
                self._stat_shed = 0
                self._stat_expired = 0
        stats = {"batches": batches, "rows": rows,
                 "mean_fill": round(rows / batches, 3) if batches else 0.0,
                 "shed": shed, "expired": expired,
                 "queue_depth": self._queue.size(),
                 "est_batch_latency_ms": round(
                     self._latency.estimate_s() * 1e3, 3)}
        if self.continuous_batching:
            # Slot-engine saturation signals ride the same healthz
            # payload (slot occupancy is the autoscaler-facing number
            # for decode-bound fleets).
            default = self.get_resident()
            engine = default.engine if default is not None else None
            if engine is not None:
                stats["engine"] = engine.stats()
        if self._tenancy is not None:
            # Per-tenant attribution: queue depths from
            # the fair queue + the registry's quota/shed snapshot —
            # healthz carries it to the dashboard and the bench.
            stats["tenants"] = {
                "queue_depths": tenancy.cap_depths(
                    self._queue.tenant_depths()),
                "registry": self._tenancy.stats(),
            }
        return stats

    def _run_group(self, sig_name, method, version, group,
                   t_pop: Optional[float] = None) -> None:
        futures = [g[4] for g in group]
        t0 = time.monotonic()
        t_pop = t0 if t_pop is None else t_pop
        try:
            model = self.get(version)
            sig = model.signature(sig_name)
            input_name = next(iter(sig.inputs))
            arrays = [np.asarray(g[0][input_name]) for g in group]
            counts = [a.shape[0] for a in arrays]
            t_exec = time.monotonic()
            if (method or getattr(sig, "method", None)) == "generate":
                out = self._run_generate_group(model, sig_name, method,
                                               input_name, arrays, counts)
                rows = sum(counts)
            else:
                batch = (np.concatenate(arrays) if len(arrays) > 1
                         else arrays[0])
                rows = int(batch.shape[0])
                self._count_executions(rows)
                out = model.run({input_name: batch}, sig_name, method)
            t_end = time.monotonic()
            # Feed the admission controller: per-EXECUTION latency
            # (a group whose rows exceed max_batch ran several model
            # executions inside model.run — dividing keeps the
            # queue-wait arithmetic in estimated_wait_s consistent).
            self._latency.observe((t_end - t0)
                                  / max(1, -(-rows // self.max_batch)))
            # Exemplar: any one trace that rode this dispatch (the
            # bucket links to a batch; the batch span links the rest).
            self._m_dispatch.observe(
                t_end - t_exec,
                trace_id=next((g[6][0].trace_id for g in group
                               if g[6][0] is not None), None))
            self._record_group_spans(group, t_pop, t_exec, t_end, rows)
            offset = 0
            for future, count in zip(futures, counts):
                sliced = {k: v[offset:offset + count] for k, v in out.items()}
                offset += count
                if not future.done():  # caller may have abandoned it
                    future.set_result(sliced)
        except BaseException as e:  # noqa: BLE001 — fan the error out
            if TRACER.enabled:
                for g in group:
                    ctx, t_enq = g[6]
                    TRACER.record("request", "serving", t_enq,
                                  time.monotonic() - t_enq,
                                  self._span_args(ctx, "error"))
            for future in futures:
                if not future.done():
                    future.set_exception(e)

    def _record_group_spans(self, group, t_pop: float, t_exec: float,
                            t_end: float, rows: int) -> None:
        """The per-request span trio (queue_wait → batch_assembly →
        execute) + the ONE coalesced batch_execute span they all link
        to via ``args.batch``. Queue-wait histogram samples ride along
        (same timestamps, always on — histograms are cheap), each
        stamping its request's trace id as the bucket exemplar."""
        for g in group:
            ctx = g[6][0]
            self._m_queue_wait.observe(
                max(0.0, t_pop - g[6][1]),
                trace_id=ctx.trace_id if ctx is not None else None)
            # Tenant-labeled twin (capped label): the noisy-neighbor
            # dashboard number — a compliant tenant's queue wait must
            # not follow a neighbor's burst.
            tenancy.observe_queue_wait(g[7], t_pop - g[6][1])
        if not TRACER.enabled:
            return
        batch = TRACER.next_batch_id()
        TRACER.record("batch_execute", "serving", t_exec, t_end - t_exec,
                      {"model": self.name, "batch": batch, "rows": rows,
                       "requests": len(group)})
        for g in group:
            ctx, t_enq = g[6]
            args = self._span_args(ctx, "ok", batch=batch)
            TRACER.record("queue_wait", "serving", t_enq,
                          t_pop - t_enq, args)
            TRACER.record("batch_assembly", "serving", t_pop,
                          t_exec - t_pop, args)
            TRACER.record("execute", "serving", t_exec,
                          t_end - t_exec, args)

    def _run_generate_group(self, model, sig_name, method, input_name,
                            arrays, counts):
        """Coalesce concurrent generate requests into as few decode
        executions as their prompt-length buckets allow: decode is
        bound by the memory system (each step streams the whole weight
        set), so rows are near-free — the same lever the predict
        batcher exploits, applied to the KV-cache path. Mixed-length
        prompts LEFT-pad to the widest request of their bucket (the
        model pads on to the bucket); each request keeps its own
        per-row rng keys, so its rows match a sequential B=1 run
        whatever batch the coalescer placed them in.

        One execution a bucket, where the reference pads the whole
        group to its widest request: a prompt padded past its own
        bucket sits at other cache slots and key tiles than in its run
        alone, and the card's kernels round such a row apart from that
        run (a 77-token prompt, 128 alone, beside 512-token prompts)."""
        # Keys are minted per REQUEST, in arrival order (row index
        # resets at each request boundary): deterministic exports
        # replay per request, not per batch position.
        rngs = [model.request_rngs(c) for c in counts]
        (_, spec), = model.signature(sig_name).inputs.items()
        buckets = [model._length_bucket(a.shape[1], spec.shape[1])
                   for a in arrays]
        outs: List[Optional[Dict[str, np.ndarray]]] = [None] * len(arrays)
        for bucket in sorted(set(buckets)):
            idx = [i for i, b in enumerate(buckets) if b == bucket]
            max_len = max(arrays[i].shape[1] for i in idx)
            lengths = np.concatenate(
                [np.full((counts[i],), arrays[i].shape[1], np.int32)
                 for i in idx])
            batch = np.concatenate(
                [np.pad(arrays[i], ((0, 0), (max_len - arrays[i].shape[1],
                                             0))) for i in idx])
            self._count_executions(int(batch.shape[0]))
            out = model.run({input_name: batch}, sig_name, method,
                            prompt_lengths=lengths,
                            row_rngs=np.concatenate([rngs[i] for i in idx]))
            offset = 0
            for i in idx:
                outs[i] = {k: v[offset:offset + counts[i]]
                           for k, v in out.items()}
                offset += counts[i]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def _count_executions(self, rows: int) -> None:
        """batch_stats accounting: pop_batch caps REQUEST count at
        max_batch, but multi-row requests can push the group's row
        total past it, and model.run() then splits into
        ceil(rows/max_batch) separate model executions — count those,
        not 1, or mean_fill could report an impossible > max_batch
        and the coalescing contract (< N dispatches) would overstate.
        Under _pending_lock like the shed/expired counters: batch_stats
        readers and reset share these fields across threads."""
        with self._pending_lock:
            self._stat_batches += -(-rows // self.max_batch)
            self._stat_rows += rows
        self._m_batches.inc(-(-rows // self.max_batch))
        self._m_rows.inc(rows)


class ModelManager:
    """All served models + the version-poll thread. ``gang``: the
    control line of a gang of ranks (rank 0's manager serves; the
    others :meth:`follow`)."""

    def __init__(self, poll_interval_s: float = 5.0,
                 tenancy_registry: Optional[
                     tenancy.TenantRegistry] = None,
                 device: DeviceLike = None, gang: Any = None):
        self.gang = gang
        self._models: Dict[str, ServedModel] = {}
        self._poll_interval_s = poll_interval_s
        #: One registry per PROCESS, shared by every model: quotas
        #: are a tenant property, not a model property.
        self.tenancy = tenancy_registry
        #: The device every model of this manager loads onto: ``None``
        #: → cuda (raises without a GPU), ``"cpu"`` on request.
        self.device = resolve_device(device)
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None

    def add_model(self, name: str, base_path: str, *,
                  max_batch: int = 64,
                  version_policy: str = "latest",
                  queue_capacity: int = 4096,
                  continuous_batching: bool = False,
                  initial_poll: bool = True) -> ServedModel:
        """Register a model. With ``initial_poll=False`` the (slow)
        first version load is deferred to the poll thread so a server
        can open its port immediately and report 503-until-loaded."""
        model = ServedModel(name, base_path, max_batch=max_batch,
                            version_policy=version_policy,
                            queue_capacity=queue_capacity,
                            continuous_batching=continuous_batching,
                            tenancy_registry=self.tenancy,
                            device=self.device, gang=self.gang)
        if initial_poll and not model.poll_versions():
            logger.warning("model %s: no versions found yet under %s",
                           name, base_path)
        self._models[name] = model
        return model

    def ready(self) -> bool:
        """True when every registered model has ≥1 loaded version."""
        return bool(self._models) and all(
            m.versions for m in self._models.values())

    def get_model(self, name: str) -> ServedModel:
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(
                f"unknown model {name!r}; serving: {sorted(self._models)}"
            ) from None

    @property
    def models(self) -> Dict[str, ServedModel]:
        return dict(self._models)

    def start(self) -> None:
        if self._poller is None:
            self._poller = threading.Thread(
                target=self._poll_loop, name="version-poller", daemon=True)
            self._poller.start()

    def stop(self) -> None:
        """Stop polling and every model; on a gang, then end the other
        ranks' :meth:`follow` (each version's close went first)."""
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5)
            self._poller = None
        for model in self._models.values():
            model.stop()
        if self.gang is not None and self.gang.leader:
            with self.gang.lock:
                self.gang.send(("stop",))

    def follow(self) -> Dict[str, Any]:
        """A gang rank other than rank 0: load each version rank 0's
        manager announces onto the same mesh (``load_version``, this
        rank reading its own shard) and run each version's work
        (:meth:`LoadedModel.follow_step`) until rank 0's manager stops.
        Returns the ``(name, version)`` keys it ``loaded`` and the ones
        rank 0 ``closed`` (a swap's old version, an unload, the stop)."""
        gang = self.gang
        if gang is None or gang.leader:
            raise RuntimeError("follow() runs on a gang's ranks other than "
                               "rank 0")
        held: Dict[Any, LoadedModel] = {}
        loaded: List[Any] = []
        closed: List[Any] = []
        while True:
            channel, message = gang.recv()
            if channel is not None:
                if held[channel].follow_step(message) is not None:
                    del held[channel]
                    closed.append(channel)
            elif message[0] == "load":
                _, name, base_path, version, max_batch = message
                logger.info("gang follower: loading %s version %d", name,
                            version)
                try:
                    held[(name, version)] = load_version(
                        version_dir(base_path, version), max_batch=max_batch,
                        device=self.device,
                        gang=gang.channel((name, version)))
                except Exception:  # noqa: BLE001 — rank 0's failed too;
                    # its next poll announces the version again.
                    logger.exception("gang follower: %s version %d failed "
                                     "to load", name, version)
                    continue
                loaded.append((name, version))
            elif message[0] == "stop":
                for key, model in held.items():
                    model.close()
                    closed.append(key)
                return {"loaded": loaded, "closed": closed}
            else:
                raise ValueError(f"unknown gang message {message[0]!r}")

    def _poll_loop(self) -> None:
        # Poll immediately on start (covers deferred initial loads),
        # then on the configured interval.
        while True:
            for model in self._models.values():
                try:
                    model.poll_versions()
                except Exception:  # noqa: BLE001
                    logger.exception("version poll failed for %s", model.name)
            if self._stop.wait(self._poll_interval_s):
                return
