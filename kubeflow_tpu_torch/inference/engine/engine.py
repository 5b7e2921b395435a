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

"""The continuous-batching decode engine: the plain lane, the
prefix-cache lane, chunked prefill, speculative decoding, KV handoff,
mid-stream resume and the host KV tier.

Port of ``kubeflow_tpu/inference/engine/engine.py``. One persistent
decode loop over N slots: decode runs in K-token slices; BETWEEN slices
finished rows retire (EOS, token budget, deadline, cancel) and queued
requests admit — a B=1 prefill into a free slot plus a page adoption.
Tokens stream back per slot as they are sampled.

Decode is weight-streaming bound, so a decode step costs about the same
whether 1 or N slots are live: every slot kept full multiplies tokens/s.

Output contract: every slot's stream equals the same request run alone
through :func:`inference.generate.generate` at B=1 with the same key,
bitwise — the per-row decode reuses the same step math, per-row step
keys and left-pad masking, and every op of a decode step gives a row
the bits it has alone (models/llama.py: the decode kernels, whose
reductions do not depend on the row count; a row-wise top-p cumsum).

With ``EngineConfig.prefix_cache`` admissions switch to the pad-0
(right-padded) layout, prompt pages are indexed by a radix of
token-block hashes (``prefix_cache.py``), and a matched prefix is
shared copy-on-write instead of re-prefilled: only the unmatched tail
runs, as a continuation prefill at the tail's bucket width.

With ``EngineConfig.prefill_chunk`` (prefix-cache mode only) a prompt
whose unmatched tail is longer than one chunk binds its slot at once and
prefills one page-aligned chunk per engine lap, between decode slices,
so a long admission does not stall the slots that are decoding.

With a draft model and ``speculate_tokens = k``, each round runs k + 1
one-token steps of the draft over its own dense cache (one row a slot),
then ONE verifier forward over every slot's ``[t0, d1..dk]`` block
(``decode_positions`` with l = k + 1: on the card the same decode
kernels as a vanilla step, at M = slots·(k + 1)), samples the k + 1
targets from the verifier's logits with the slot's own step keys, and
emits the agreeing prefix plus one; speculated K/V past it rolls back
through ``truncate_slot``. The targets are the vanilla slice's tokens,
whatever the draft proposed, so a spec stream equals a vanilla one.

KV handoff (role-split serving): :meth:`DecodeEngine.run_prefill` runs
a prompt's prefill without decoding and returns a
:class:`PrefillHandoff` (its cache on the host, the whole step-key
schedule); ``submit(handoff=)`` on this or any engine of the same export
adopts the carried pages at admission instead of prefilling, so the
adopted stream carries the bytes a local prefill would have made. The
classic lane prefills left-padded at the bucket width on the engine
thread; the prefix lane runs a slot-bound prefill-only request that
hits and registers the prefix index, and the adopter indexes the carried
pages in its own.

Mid-stream resume: ``submit(context, step_keys=keys[k:])`` continues a
stream whose replica died after k tokens. With ``prompt_len`` (the split
form) the original prompt is prefilled exactly as its first admission
did, and the k emitted tokens' K/V is written by ``decode_positions``
forwards over them (:func:`_replay_slice`, the verify's route): every op
then runs on the route the uninterrupted stream ran it on, and the card
gives the same bits. Without it the whole context is prefilled, as the
reference does, and the emitted tokens' K/V comes from the prefill
route, which on the card rounds apart from the decode route.

Tiered KV memory (``host_cache_bytes``, prefix lane only): evicted
full prefix blocks spill to host RAM (``kv_tier.py``), a match continues
past the HBM chain into host blocks, which are spliced back into the
admission's gathered cache, and :meth:`DecodeEngine.export_prefix_blocks`
/ :meth:`DecodeEngine.import_prefix_blocks` move blocks between
replicas (``serving/kv_store.py``), their leaves in the reference's
order (``paged_kv.kv_leaf_order``).

Deadlines are checked at submit (shed), at admission (expired in queue)
and at every slice boundary (mid-decode eviction frees the slot's
pages). Observability: the reference's metric families, span names
(``engine_prefill``, ``engine_slice``, ``engine_request``,
``engine_compile``, ``spec_verify``) and ``stats()`` keys.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import logging
import threading
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, Iterator, List, Optional,
                    Sequence)

import numpy as np
import torch

from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine.graphs import GraphCache
from kubeflow_tpu_torch.inference.engine.kv_tier import (
    HostKVTier,
    splice_host_blocks,
)
from kubeflow_tpu_torch.inference.engine.paged_kv import (
    PagedKVCache,
    _gather_logical,
    _scatter_token_range,
    kv_leaf_order,
)
from kubeflow_tpu_torch.inference.engine.prefix_cache import (
    _ROOT,
    PrefixCache,
    PrefixMatch,
    _block_key,
)
from kubeflow_tpu_torch.inference.engine.slots import Slot, SlotScheduler
from kubeflow_tpu_torch.inference.generate import (
    _device_keys,
    _prefill,
    _sample_logits,
    init_cache,
    prompt_bucket,
)
from kubeflow_tpu_torch.models.llama import LayerCache, apply
from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.obs.tracing import TRACER, span_args
from kubeflow_tpu_torch.serving import tenancy
from kubeflow_tpu_torch.serving.overload import (
    DeadlineExceededError,
    LatencyEstimator,
    OverloadedError,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

__all__ = ["DecodeEngine", "EngineConfig", "GenerateStream",
           "PrefillHandoff", "TokenEvent"]

#: Admission safety factor (same rationale as the micro-batcher's):
#: shed unless the estimated time-to-first-token fits inside this
#: fraction of the remaining budget.
ADMISSION_SAFETY = 0.8

# Engine observability families (bound per engine name; the gauges use
# render-time callbacks with owner-checked clears).
_M_SLOTS = obs_metrics.Gauge(
    "kft_engine_active_slots",
    "Decode slots currently bound to a request", ("model",))
_M_QUEUE = obs_metrics.Gauge(
    "kft_engine_queue_depth",
    "Requests admitted by submit() but not yet bound to a slot",
    ("model",))
_M_FREE_PAGES = obs_metrics.Gauge(
    "kft_engine_free_pages",
    "KV-cache pages neither allocated nor reserved", ("model",))
_M_TOKENS = obs_metrics.Counter(
    "kft_engine_tokens_total",
    "Tokens sampled and delivered to streams", ("model",))
_M_ADMITTED = obs_metrics.Counter(
    "kft_engine_admitted_total",
    "Requests prefillled into a slot", ("model",))
_M_RETIRED = obs_metrics.Counter(
    "kft_engine_retired_total",
    "Slots retired, by reason", ("model", "reason"))
_M_SHED = obs_metrics.Counter(
    "kft_engine_shed_total",
    "Requests shed at submit (estimated TTFT over the remaining "
    "deadline budget)", ("model",))
_M_TTFT = obs_metrics.Histogram(
    "kft_serving_ttft_seconds",
    "Submit to first streamed token (queue wait + prefill)",
    ("model",), exemplars=True)
_M_INTER = obs_metrics.Histogram(
    "kft_serving_inter_token_seconds",
    "Per-token decode pacing (slice wall time / slice tokens)",
    ("model",))
# Prefix-cache families: hit/miss/evict counters plus the
# saved-prefill-tokens histogram the TTFT win is made of. Evicted and
# cached-pages ride render-time callbacks off the live cache (one
# source of truth, owner-checked clears at stop()).
_M_PREFIX_HITS = obs_metrics.Counter(
    "kft_engine_prefix_hits_total",
    "Admissions that matched a cached prompt prefix", ("model",))
_M_PREFIX_MISSES = obs_metrics.Counter(
    "kft_engine_prefix_misses_total",
    "Admissions with no cached prefix match", ("model",))
_M_PREFIX_EVICTED = obs_metrics.Counter(
    "kft_engine_prefix_evicted_pages_total",
    "Cached prefix pages evicted under page pressure (LRU over "
    "zero-ref pages)", ("model",))
_M_PREFIX_SAVED = obs_metrics.Histogram(
    "kft_engine_prefix_saved_tokens",
    "Prefill tokens skipped per prefix-cache hit",
    ("model",),
    buckets=(1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0))
_M_PREFIX_PAGES = obs_metrics.Gauge(
    "kft_engine_prefix_cached_pages",
    "Resident pages indexed by the prefix cache", ("model",))
_M_PAGE_OCC = obs_metrics.Gauge(
    "kft_engine_page_occupancy",
    "Fraction of the KV page pool allocated or reserved "
    "(cached-idle pages count as headroom)", ("model",))
# Speculative-decode families: the acceptance economics
# the draft lane is judged by. drafted = k per live slot per round;
# accepted = drafted tokens actually emitted (each one a verifier
# forward NOT paid); the rate gauge is lifetime accepted/drafted via
# a render-time callback off the engine's counters.
_M_SPEC_DRAFTED = obs_metrics.Counter(
    "kft_engine_spec_drafted_tokens_total",
    "Draft-model tokens proposed to the verifier", ("model",))
_M_SPEC_ACCEPTED = obs_metrics.Counter(
    "kft_engine_spec_accepted_tokens_total",
    "Drafted tokens accepted and emitted (verifier forwards saved)",
    ("model",))
_M_SPEC_REJECTED = obs_metrics.Counter(
    "kft_engine_spec_rejected_tokens_total",
    "Drafted tokens discarded at verification", ("model",))
_M_SPEC_RATE = obs_metrics.Gauge(
    "kft_engine_spec_acceptance_rate",
    "Lifetime drafted-token acceptance rate", ("model",))
# Tiered KV memory families: the host tier's block flow
# (spill in, re-adopt out, LRU eviction) plus the fleet pull-through
# counters. All ride render-time callbacks off the live tier — one
# source of truth, owner-checked clears at stop(), same discipline as
# the prefix-cache families above.
_M_HOST_SPILLED = obs_metrics.Counter(
    "kft_engine_kv_host_spilled_blocks_total",
    "Prefix KV blocks evicted from HBM into the host-RAM tier",
    ("model",))
_M_HOST_READOPTED = obs_metrics.Counter(
    "kft_engine_kv_host_readopted_blocks_total",
    "Host-tier KV blocks spliced back HBM-ward on a prefix match",
    ("model",))
_M_HOST_EVICTED = obs_metrics.Counter(
    "kft_engine_kv_host_evicted_blocks_total",
    "Host-tier KV blocks dropped by the byte-budget LRU", ("model",))
_M_HOST_BYTES = obs_metrics.Gauge(
    "kft_engine_kv_host_resident_bytes",
    "Bytes of KV blocks resident in the host-RAM tier", ("model",))
_M_HOST_BLOCKS = obs_metrics.Gauge(
    "kft_engine_kv_host_resident_blocks",
    "KV blocks resident in the host-RAM tier", ("model",))
_M_KV_FETCH = obs_metrics.Counter(
    "kft_engine_kv_fetch_total",
    "Fleet KV pull-through fetches, by outcome (a 'miss' or 'error' "
    "outcome always falls back to local prefill — never an error)",
    ("model", "outcome"))
_M_KV_FETCH_BLOCKS = obs_metrics.Counter(
    "kft_engine_kv_fetched_blocks_total",
    "KV blocks imported from fleet peers into the host tier",
    ("model",))


@dataclasses.dataclass
class TokenEvent:
    """One streamed event: a sampled token, or the terminal marker
    (``final=True``; ``error`` set when the request failed
    mid-stream)."""

    token: Optional[int]
    index: int
    final: bool = False
    error: Optional[BaseException] = None


class GenerateStream:
    """The caller's handle on one request: an incremental token-event
    queue plus the collected result. Engine thread emits; any number
    of consumer threads may drain (SSE handler, gRPC stream, a plain
    ``result()`` waiter)."""

    def __init__(self, max_new_tokens: int, obs_ctx: Any = None):
        self.max_new_tokens = max_new_tokens
        self.obs_ctx = obs_ctx
        self._cv = threading.Condition()
        self._queue: Deque[TokenEvent] = deque()
        self._tokens: List[int] = []
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._final = False
        self._notify: Optional[Callable[[], None]] = None
        self.cancelled = False
        #: Mid-stream resume seam: what a PEER engine needs to reproduce
        #: this request's remaining tokens if this replica dies
        #: mid-decode — {"prompt" (the full context ids), "step_keys"
        #: (the whole sampling schedule), "max_new_tokens"}. None when
        #: unresumable (a left-layout handoff carries no prompt ids).
        self.resume_ctx: Optional[dict] = None

    # -- engine side -----------------------------------------------------

    def _emit(self, event: TokenEvent) -> None:
        with self._cv:
            if self._final:
                return
            self._queue.append(event)
            if not event.final and event.token is not None:
                self._tokens.append(event.token)
            if event.final:
                self._final = True
                self._error = event.error
                if event.error is None and self._result is None:
                    self._result = np.asarray(self._tokens, np.int32)
            self._cv.notify_all()
        cb = self._notify
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — a consumer bug must
                logger.exception("stream notify callback failed")

    def _finish(self, tokens: np.ndarray) -> None:
        with self._cv:
            self._result = np.asarray(tokens, np.int32)
        self._emit(TokenEvent(token=None, index=len(self._tokens),
                              final=True))

    def _fail(self, error: BaseException) -> None:
        self._emit(TokenEvent(token=None, index=len(self._tokens),
                              final=True, error=error))

    # -- consumer side ---------------------------------------------------

    def set_notify(self, cb: Optional[Callable[[], None]]) -> None:
        """Called (from the ENGINE thread) after each emit — the hook
        async transports use to schedule a drain on their own loop."""
        self._notify = cb

    def next_event(self, timeout: float) -> Optional[TokenEvent]:
        """Pop the next event, waiting up to ``timeout``; None on
        timeout. The terminal event stays poppable exactly once."""
        with self._cv:
            if not self._cv.wait_for(lambda: bool(self._queue),
                                     timeout=timeout):
                return None
            return self._queue.popleft()

    def drain(self) -> List[TokenEvent]:
        """Pop everything queued right now (non-blocking)."""
        with self._cv:
            out = list(self._queue)
            self._queue.clear()
            return out

    def events(self, timeout_per_event: float = 60.0
               ) -> Iterator[TokenEvent]:
        """Iterate events up to AND including the terminal one.
        Raises TimeoutError if the engine stalls past the per-event
        timeout (bounded waits — serving discipline)."""
        while True:
            ev = self.next_event(timeout_per_event)
            if ev is None:
                raise TimeoutError(
                    f"no token event within {timeout_per_event}s")
            yield ev
            if ev.final:
                return

    @property
    def done(self) -> bool:
        with self._cv:
            return self._final

    @property
    def tokens_so_far(self) -> List[int]:
        with self._cv:
            return list(self._tokens)

    def result(self, timeout: float = 120.0) -> np.ndarray:
        """Block for the full token array (padded to the request's
        ``max_new_tokens`` with the EOS id on early retirement — the
        same latched shape the monolithic generate returns)."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._final,
                                     timeout=timeout):
                raise TimeoutError(
                    f"generation did not finish within {timeout}s")
            if self._error is not None:
                raise self._error
            return np.array(self._result)

    def cancel(self) -> None:
        """Client hung up: the engine retires the slot at the next
        slice boundary and frees its pages."""
        self.cancelled = True


@dataclasses.dataclass
class PrefillHandoff:
    """The page-adopt seam's transferable half: everything a decode
    engine needs to continue a request whose prefill ran elsewhere (a
    prefill-role replica, ``serving/wire.py`` carrying it, or another
    engine in this process). ``step_keys`` travels whole because
    ``prng.split(key, n)`` depends on n: re-deriving it with another
    budget would fork the sampled sequence."""

    cache: List[LayerCache]  # B=1 prefill cache on the host
    first_token: int
    done: bool
    prompt_len: int  # true prompt token count
    prompt_width: int  # prefill bucket width (pad + prompt)
    max_new_tokens: int
    step_keys: np.ndarray  # [max_new_tokens, 2] uint32
    #: Cache layout the prefill ran in: ``left`` (classic, the prompt
    #: left-padded at ``[width - len, width)``) or ``right`` (the prefix
    #: lane's pad-0 layout, ``prompt_width == prompt_len``). An engine
    #: adopts only its own layout.
    layout: str = "left"
    #: The prompt ids (``right`` layout): the adopting engine indexes the
    #: carried pages in its prefix cache.
    prompt_tokens: Optional[np.ndarray] = None


@dataclasses.dataclass(eq=False)  # identity equality: the queued-
# cancel sweep removes by instance, and the generated field-wise eq
# compares numpy prompts
class _Request:
    prompt: np.ndarray  # [L] int32
    step_keys: np.ndarray  # [max_new_tokens, 2] uint32 sampling keys
    max_new_tokens: int
    deadline: Optional[float]
    stream: GenerateStream
    submitted_at: float
    request_id: str = ""
    #: Tenant identity: names this request's weighted-fair sub-queue
    #: and tags its TTFT/usage metrics. Empty = the default tenant.
    tenant: str = ""
    #: Adopt, don't prefill: the request arrives with its prefilled
    #: cache (KV handoff); admission copies the pages in and decode
    #: starts at the first slice.
    handoff: Optional[PrefillHandoff] = None
    #: Prefill-only: the prefix lane's ``run_prefill``. The request
    #: binds a slot, prefills (chunked when configured), registers its
    #: pages in the prefix index, then retires with a
    #: :class:`PrefillHandoff` in ``prefill_box`` instead of decoding.
    prefill_only: bool = False
    prefill_box: Optional[dict] = None
    #: A split resume's emitted tokens (``submit(prompt_len=)``):
    #: ``prompt`` is then the original prompt alone, and admission
    #: replays these on the decode route after the prompt's prefill.
    replay: Optional[np.ndarray] = None
    #: Fleet KV fetch wall: seconds the serving layer spent pulling
    #: this request's prefix blocks from the rendezvous owner before
    #: submit. Attributed as its own ``kv_fetch_ms`` bucket in the
    #: engine_request span, so a tier fetch is never mistaken for
    #: queue wait or decode time.
    kv_fetch_s: float = 0.0
    #: A gang's id of the request (its order of announcement).
    gang_id: int = -1


@dataclasses.dataclass
class EngineConfig:
    """Static decode configuration (mirrors generate_config) + the
    engine's capacity knobs: every field of the reference's."""

    max_new_tokens: int
    max_prompt_len: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    #: decode slots (the persistent batch width).
    num_slots: int = 4
    #: KV-cache page granularity (cache slots per page).
    page_size: int = 16
    #: decode steps per slice — the admit/retire cadence AND the
    #: streaming granularity (tokens reach the host per slice).
    slice_tokens: int = 4
    #: prompt length buckets (None = powers of two); each bucket is
    #: one prefill shape.
    prompt_buckets: Optional[Sequence[int]] = None
    #: physical page-pool size (None = every slot can go full length).
    num_pages: Optional[int] = None
    #: admission-queue depth bound: deadline-free submits past it shed
    #: with OverloadedError (the queue_capacity invariant — without
    #: it a flood of deadline-free requests grows pending without
    #: limit while the deadline gate never fires).
    queue_capacity: int = 4096
    #: cross-request prefix KV cache: admissions switch to
    #: the pad-0 (right-padded) prompt layout so prompt token i always
    #: lands at cache position i, prompt pages are content-indexed by
    #: a radix of token-block hashes, and a matching prefix is shared
    #: copy-on-write instead of re-prefilled. Output stays bitwise
    #: equal to cold prefill (greedy + sampled): on the card a prefill's
    #: rows do not depend on its block width.
    prefix_cache: bool = False
    #: speculative decoding: draft tokens per verify round
    #: (0 = vanilla decode). Takes effect only when the engine is
    #: built with a draft model; output stays bitwise vanilla either
    #: way.
    speculate_tokens: int = 0
    #: chunked prefill: page-aligned prompt tokens fed per
    #: engine lap for prompts whose unmatched tail exceeds one chunk
    #: (0 = one-shot prefill). Prefix-cache mode only — chunks
    #: accumulate in the pad-0 layout.
    prefill_chunk: int = 0
    #: tiered KV memory: byte budget for the host-RAM
    #: prefix tier (0 = off). With a budget, LRU eviction of zero-ref
    #: retained pages becomes evict-to-host, matches continue past
    #: the HBM chain into host blocks (spliced back bitwise), and the
    #: fleet pull-through endpoint (:kvfetch) can import blocks from
    #: peer replicas. Prefix-cache mode only.
    host_cache_bytes: int = 0

    @staticmethod
    def from_generate_config(cfg: dict, max_prompt_len: int,
                             queue_capacity: Optional[int] = None
                             ) -> "EngineConfig":
        """Build from an export's ``generate_config`` (the ``engine_*``
        keys are the serving-side capacity knobs, docs/streaming.md)."""
        return EngineConfig(
            max_new_tokens=int(cfg.get("max_new_tokens", 32)),
            max_prompt_len=max_prompt_len,
            temperature=float(cfg.get("temperature", 0.0)),
            eos_id=cfg.get("eos_id"),
            top_k=cfg.get("top_k"),
            top_p=cfg.get("top_p"),
            seed=int(cfg.get("seed", 0)),
            num_slots=int(cfg.get("engine_slots", 4)),
            page_size=int(cfg.get("engine_page_size", 16)),
            slice_tokens=int(cfg.get("engine_slice_tokens", 4)),
            prompt_buckets=cfg.get("prompt_buckets"),
            num_pages=cfg.get("engine_num_pages"),
            queue_capacity=(4096 if queue_capacity is None
                            else int(queue_capacity)),
            prefix_cache=bool(cfg.get("engine_prefix_cache", False)),
            speculate_tokens=int(cfg.get("engine_draft_tokens", 0)),
            prefill_chunk=int(cfg.get("engine_prefill_chunk", 0)),
            host_cache_bytes=int(
                cfg.get("engine_host_cache_bytes", 0)),
        )


def _sample_step(logits: torch.Tensor, step_rng: Optional[torch.Tensor],
                 done: torch.Tensor, *, temperature: float,
                 eos_id: Optional[int], top_k: Optional[int],
                 top_p: Optional[float]):
    """One step's sample → EOS latch, as generate's
    ``_make_decode_step``: ``(tokens [N], done [N])``."""
    tok = _sample_logits(logits, step_rng, temperature, top_k, top_p)
    if eos_id is not None:
        tok = torch.where(done, torch.full_like(tok, eos_id), tok)
        done = done | (tok == eos_id)
    return tok, done


def _decode_steps(model, params, cache: List[LayerCache],
                  tokens: torch.Tensor, write_pos: torch.Tensor,
                  pad_lens: torch.Tensor, done: torch.Tensor,
                  step_rngs: Optional[torch.Tensor], num_steps: int,
                  **sample_kw):
    """``num_steps`` per-row decode steps over ``cache`` (updated in
    place): sample → EOS-latch → advance, each row writing at its own
    position (``decode_positions``) instead of the shared scalar index,
    which is what lets rows sit at different sequence positions.
    ``step_rngs`` is ``[K, N, 2]`` (None when greedy). Returns
    ``(tokens [N, K] int32, last tokens [N], done [N])``."""
    tok, wpos, dn = tokens, write_pos, done
    out = []
    for k in range(num_steps):
        positions = (wpos - pad_lens)[:, None]
        logits = apply(model, params, tok[:, None], positions,
                       pad_lengths=pad_lens, decode_positions=wpos,
                       cache=cache)[:, 0]
        tok, dn = _sample_step(logits, None if step_rngs is None
                               else step_rngs[k], dn, **sample_kw)
        out.append(tok)
        wpos = wpos + 1
    return torch.stack(out, dim=1), tok, dn


def _decode_slice(model, params, physical: List[LayerCache],
                  tables: torch.Tensor, write_pos: torch.Tensor,
                  pad_lens: torch.Tensor, tokens: torch.Tensor,
                  done: torch.Tensor, step_rngs: Optional[torch.Tensor],
                  *, num_steps: int, **sample_kw):
    """One K-token slice over the slot batch: gather the logical cache
    from pages ONCE, run the per-row decode step K times over it
    (:func:`_decode_steps`), scatter the K newly written token positions
    back."""
    logical = _gather_logical(physical, tables)
    out = _decode_steps(model, params, logical, tokens, write_pos,
                        pad_lens, done, step_rngs, num_steps, **sample_kw)
    _scatter_token_range(physical, logical, tables, write_pos,
                         num_steps=num_steps)
    return out


def _draft_slice(draft_model, draft_params, draft_cache: List[LayerCache],
                 tokens: torch.Tensor, write_pos: torch.Tensor,
                 pad_lens: torch.Tensor, done: torch.Tensor,
                 step_rngs: Optional[torch.Tensor], *, num_steps: int,
                 **sample_kw):
    """``num_steps`` (k + 1) single-token draft steps over the
    persistent DENSE draft cache (one row per slot, updated in place),
    sampled with the SAME step keys the verifier will use: with similar
    logits the draw lands on the same token, which is what acceptance is
    made of. Rejected rows need no rollback: validity is the slot's
    write_pos frontier, and the next round overwrites stale K/V before
    any query attends to it. The k+1-th step exists ONLY to write the
    k-th draft's K/V: on a full accept the next round starts past it,
    and without the write it would hold zeros for good (acceptance
    collapses while the output stays right). Its proposal is dropped by
    the caller. Returns the proposals ``[N, num_steps]``."""
    return _decode_steps(draft_model, draft_params, draft_cache, tokens,
                         write_pos, pad_lens, done, step_rngs, num_steps,
                         **sample_kw)[0]


def _draft_proposals(draft_model, draft_params,
                     draft_cache: List[LayerCache], tokens: torch.Tensor,
                     write_pos: torch.Tensor, pad_lens: torch.Tensor,
                     done: torch.Tensor, step_rngs: Optional[torch.Tensor],
                     *, num_steps: int, **sample_kw) -> torch.Tensor:
    """A round's k = ``num_steps`` − 1 proposals ``[N, k]``
    (:func:`_draft_slice`, its last step's proposal dropped)."""
    return _draft_slice(draft_model, draft_params, draft_cache, tokens,
                        write_pos, pad_lens, done, step_rngs,
                        num_steps=num_steps,
                        **sample_kw)[:, :num_steps - 1]


def _verify_slice(model, params, physical: List[LayerCache],
                  tables: torch.Tensor, write_pos: torch.Tensor,
                  pad_lens: torch.Tensor, tokens: torch.Tensor,
                  drafts: torch.Tensor, done: torch.Tensor,
                  step_rngs: Optional[torch.Tensor], **sample_kw):
    """ONE batched verifier forward over each slot's speculative block
    ``[t0, d1..dk]`` (k + 1 positions), then the sample → EOS-latch
    chain replayed over the k + 1 logit columns with the slot's own step
    keys: target j is the token the vanilla slice would have sampled at
    that step, whatever the drafts proposed, because the model runs a
    ``decode_positions`` forward of any width as a decode step (one
    query at a time, every linear on the decode GEMM), so column j has
    the bits of the one-token step at ``write_pos + j``. Acceptance is
    the longest agreeing draft prefix. The block's K/V is written
    through the page tables at ``[write_pos, write_pos + k + 1)``; the
    host truncates back to the accepted length
    (``PagedKVCache.truncate_slot``). Returns ``(targets [N, k+1],
    accepts [N])``."""
    logical = _gather_logical(physical, tables)
    block = torch.cat([tokens[:, None], drafts], dim=1)
    width = block.shape[1]
    positions = (write_pos - pad_lens)[:, None] + torch.arange(
        width, device=block.device)[None, :]
    logits = apply(model, params, block, positions, pad_lengths=pad_lens,
                   decode_positions=write_pos, cache=logical)
    dn = done
    targets = []
    for j in range(width):
        tok, dn = _sample_step(logits[:, j].contiguous(), None
                               if step_rngs is None else step_rngs[j], dn,
                               **sample_kw)
        targets.append(tok)
    targets = torch.stack(targets, dim=1)
    agree = (drafts == targets[:, :-1]).to(torch.int32)
    accepts = torch.cumprod(agree, dim=1).sum(dim=1)
    _scatter_token_range(physical, logical, tables, write_pos,
                         num_steps=width)
    return targets, accepts


#: Columns a resume's replay forward takes at most: up to 32 rows the
#: decode GEMM reads W once and a row's bits do not depend on the row
#: count (tests/test_torch_gpu.py), so a longer replay runs in forwards
#: of this width.
REPLAY_COLUMNS = 32


def _replay_slice(model, params, physical: List[LayerCache],
                  tables: torch.Tensor, write_pos: torch.Tensor,
                  pad_lens: torch.Tensor, tokens: torch.Tensor,
                  first_rng: Optional[torch.Tensor], **sample_kw):
    """A split resume's emitted tokens ``tokens [1, n]`` into the slot's
    pages at ``write_pos … write_pos + n − 1``, then its first new token.
    The tokens go through ``decode_positions`` forwards of at most
    :data:`REPLAY_COLUMNS` columns over the slot's gathered row, the
    verify's route: column j has the bits of the one-token decode step
    at ``write_pos + j``, which is where the uninterrupted stream made
    that token's K/V and its next logits. The first new token is sampled
    from the last column with ``first_rng``, the first key of the
    remaining schedule. Returns ``(first [1], done [1])``."""
    logical = _gather_logical(physical, tables)
    n = tokens.shape[1]
    for c0 in range(0, n, REPLAY_COLUMNS):
        block = tokens[:, c0:c0 + REPLAY_COLUMNS]
        width = block.shape[1]
        start = write_pos + c0
        positions = (start - pad_lens)[:, None] + torch.arange(
            width, device=block.device)[None, :]
        logits = apply(model, params, block, positions,
                       pad_lengths=pad_lens, decode_positions=start,
                       cache=logical, logits_at=torch.full(
                           (1,), width - 1, device=block.device))
    first, done = _sample_step(
        logits[:, 0], first_rng,
        torch.zeros((1,), dtype=torch.bool, device=tokens.device),
        **sample_kw)
    _scatter_token_range(physical, logical, tables, write_pos, num_steps=n)
    return first, done


def _insert_cache_row(batched: List[LayerCache], single: List[LayerCache],
                      row: int) -> None:
    """Land a B=1 prefill cache in row ``row`` of a B=N cache, in place:
    the draft cache's admission write. K/V only: the batched cache's
    scalar ``index`` stays as it is, because the decode path addresses
    positions explicitly (``decode_positions``)."""
    for dst, src in zip(batched, single):
        dst.k[row] = src.k[0].to(dst.k.dtype)
        dst.v[row] = src.v[0].to(dst.v.dtype)


def _prefill_ctx(model, params, token_block: torch.Tensor,
                 cache: List[LayerCache], start: int, last_col: int,
                 first_rng: Optional[torch.Tensor], *, temperature: float,
                 eos_id: Optional[int], top_k: Optional[int],
                 top_p: Optional[float]):
    """Pad-0 (right-padded) prompt pass for prefix-cache mode, cold AND
    continuation: ``token_block`` [1, W] holds prompt tokens ``[start,
    start + real)`` right-padded to a bucket width, and ``cache``
    carries the already-resident prefix at positions ``[0, start)``
    with its ``index`` at ``start`` (a zero cache for a cold prefill).
    The model's scalar append path writes the block at ``[start, start
    + W)`` in place and attends causally from ``start``, so the
    right-pad garbage never reaches a real token's attention, and its
    K/V lands only where the decode overwrites or masks. Next-token
    logits are read at the last real column ``last_col``. Returns
    ``(cache, first [1], done [1])``."""
    b, width = token_block.shape
    positions = start + torch.arange(
        width, device=token_block.device)[None].expand(b, width)
    for layer in cache:
        layer.index = start
    logits = apply(model, params, token_block, positions, cache=cache,
                   logits_at=torch.full((b,), last_col,
                                        device=token_block.device))
    first = _sample_logits(logits[:, 0], first_rng, temperature, top_k,
                           top_p)
    done = (first == eos_id if eos_id is not None
            else torch.zeros((b,), dtype=torch.bool, device=first.device))
    return cache, first, done


class DecodeEngine:
    """Slot-based continuous-batching decode over one model.

    ``submit()`` is thread-safe and returns a :class:`GenerateStream`;
    all device work happens on the single engine thread (started
    lazily), which enters ``torch.inference_mode`` and the engine's CUDA
    device itself: both are per thread. ``model`` must be built with a
    ``cache_size >= max_prompt_len + max_new_tokens``; ``params`` must
    live on ``device`` (``None`` → cuda; ``"cpu"`` on request).

    The plain lane: left-padded B=1 prefills, paged KV, K-token slices;
    with ``prefix_cache``, the prefix lane (pad-0 prefills, shared
    prefix pages, a copy-on-write fork of a partly matched page), with
    ``prefill_chunk`` its prompts prefilled a chunk per lap, and with
    ``host_cache_bytes`` its evicted blocks kept in host RAM; with
    ``draft_model``/``draft_params`` and ``speculate_tokens > 0``,
    speculative rounds in place of plain slices (the draft lives on the
    engine's device too). In every lane: :meth:`run_prefill` and
    ``submit(handoff=)`` (KV handoff), ``submit(step_keys=)`` (resume).
    Work that reads engine-thread state or runs the model for a caller
    (``run_prefill``'s classic lane, :meth:`export_prefix_blocks`) is
    posted to the engine thread (:meth:`_run_on_engine`).

    On a CUDA device the engine runs its fixed programs as CUDA graphs
    (``graphs.py``): a plain decode slice, a speculative round's draft
    and verify, and the classic lane's admission prefill at a prompt
    bucket, one graph per ``engine_compile`` key, captured on the key's
    first use and replayed after. A failed capture or replay raises.
    ``capture_graphs=False`` builds an engine that runs every op eagerly
    (the comparison the GPU checks hold the captured engine to); a CPU
    engine always does. Prefix-lane and chunked prefills, a draft's
    prefill and a resume's replay run eagerly in either.

    On a gang (``gang``, a channel of the serving mesh's control line,
    :mod:`~kubeflow_tpu_torch.inference.engine.gang`, over a sharded
    model's ranks) rank 0's engine is the driver: it alone takes
    ``submit`` and the calls that touch the pool, and at each lap, before
    any device work, it broadcasts the requests it queued since the last
    lap (prompt, step keys, budget, tenant, a handoff, a resume's
    replay, a prefill-only flag), the ones it dropped (deadline, cancel),
    the pool operations callers posted (a handoff's classic prefill, a
    fleet export or import of prefix blocks, a clear of the index), the
    tenants' fair-queue weights the lap admits by, and a digest of its
    pool (free, reserved and retained pages, live slots, queued
    requests, indexed pages, the host tier's bytes). Every other rank
    applies them and runs the same lap (:meth:`follow_lap`), raising if
    its own digest differs, so a gang that drifts apart fails loudly
    instead of pairing its collectives wrongly. Every host decision
    (admission, prefix match, eviction, spill, chunk schedule, a
    speculative round's accept length) is then a function of the same
    inputs and of the all-gathered logits, sampled with the same keys,
    so the ranks agree on every token. Each rank's pool, prefix index
    and host tier hold its own KV heads (its tensor piece; the heads
    split evenly, so the byte budgets decide alike); a speculative draft
    is whole on every rank and runs no collective. A handoff's cache and
    an exported block carry every KV head in the reference's layout
    (the ranks' pieces gathered in head order), so a blob passes between
    a gang and a one-card engine of the same export either way; each
    rank adopts its own heads of one. A gang's engine runs eagerly
    (CUDA-graph capture with collectives inside is ROADMAP A18's next
    item).
    """

    def __init__(self, model: Any, params: Dict[str, torch.Tensor],
                 config: EngineConfig, *, name: str = "engine",
                 device: DeviceLike = None, draft_model: Any = None,
                 draft_params: Any = None, capture_graphs: bool = True,
                 gang: Any = None):
        if model.cache_size < config.max_prompt_len + \
                config.max_new_tokens:
            raise ValueError(
                f"cache_size {model.cache_size} < max_prompt_len "
                f"{config.max_prompt_len} + max_new_tokens "
                f"{config.max_new_tokens}")
        if config.speculate_tokens < 0:
            raise ValueError(
                f"speculate_tokens {config.speculate_tokens} < 0")
        self._spec_on = (draft_model is not None
                         and config.speculate_tokens > 0)
        if config.speculate_tokens > 0 and draft_model is None:
            # The knob survived export but the draft weights didn't
            # load (serving/model.py degrades here): vanilla decode,
            # never a failed engine — the output is the same either way,
            # only the verifier-forward count differs.
            logger.warning(
                "engine %s: engine_draft_tokens=%d but no draft "
                "model — speculative decoding disabled, decoding "
                "vanilla", name, config.speculate_tokens)
        if self._spec_on:
            if draft_model.cache_size != model.cache_size:
                raise ValueError(
                    f"draft cache_size {draft_model.cache_size} != "
                    f"verifier cache_size {model.cache_size} — the "
                    f"draft writes at the verifier's slot positions")
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft vocab_size {draft_model.vocab_size} != "
                    f"verifier vocab_size {model.vocab_size}")
        if config.prefill_chunk:
            if not config.prefix_cache:
                raise ValueError(
                    "engine_prefill_chunk requires engine_prefix_cache"
                    " — chunks accumulate in the pad-0 layout and "
                    "land in the prefix index")
            if config.prefill_chunk % config.page_size:
                raise ValueError(
                    f"engine_prefill_chunk {config.prefill_chunk} "
                    f"must be a multiple of engine_page_size "
                    f"{config.page_size} (page-aligned slices)")
        if config.host_cache_bytes < 0:
            raise ValueError(
                f"engine_host_cache_bytes {config.host_cache_bytes} "
                f"< 0 (0 disables the host tier)")
        if gang is not None:
            # Eager: no CUDA graph holds a gloo collective.
            capture_graphs = False
        #: A gang's control line (None alone), the requests rank 0
        #: queued and dropped since its last lap, the pool operations
        #: posted for its next lap, and every request's stream by gang
        #: id.
        self._gang = gang
        self._gang_new: List[_Request] = []
        self._gang_drops: List[int] = []
        self._gang_ops: List[tuple] = []
        self._gang_next = 0
        self.gang_streams: Dict[int, GenerateStream] = {}
        #: Laps run on the gang (a follower holds each to rank 0's pool
        #: digest first).
        self.gang_laps = 0
        #: Rank 0's live tenant-weight lookup on a gang: each lap admits
        #: by a snapshot of it that the lap carries to every rank.
        self._weight_of: Optional[Callable[[str], float]] = None
        #: ``(mesh, ranks, position)`` of the tensor line whose ranks
        #: each hold a 1/ranks slice of the KV heads; None where the pool
        #: holds every head.
        self._head_line = None
        if getattr(model, "kv_split", False) and getattr(model, "tensor",
                                                         1) > 1:
            self._head_line = (model.mesh, model.tensor,
                               model.mesh.coords()["tensor"])
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The engine thread sets this device as its own current one.
            self.device = torch.device("cuda", torch.cuda.current_device())
        for what, tree in (("params", params), ("draft params",
                                                 draft_params if
                                                 self._spec_on else {})):
            off = [k for k, v in tree.items() if v.device != self.device]
            if off:
                raise ValueError(
                    f"{what} {off[:3]} are not on the engine's device "
                    f"{self.device}")
        # A module of its own: apply() swaps weights into the module it
        # is given, so the engine thread and a caller's thread must not
        # share one (a meta-device template copies for free).
        self._model = copy.deepcopy(model)
        self._params = params
        self.config = config
        self.name = name
        with torch.inference_mode():
            self.kv = PagedKVCache(
                init_cache(model, params, 1), num_slots=config.num_slots,
                page_size=config.page_size, cache_size=model.cache_size,
                num_pages=config.num_pages)
        self.scheduler = SlotScheduler(config.num_slots,
                                       self.kv.allocator)
        #: Cross-request prefix cache (prefix_cache.py) or None. Built
        #: here so the allocator's retained-page custody is wired
        #: before the first admission.
        self.prefix: Optional[PrefixCache] = None
        if config.prefix_cache:
            self.prefix = PrefixCache(config.page_size, self.kv.allocator)
        #: Host-RAM KV tier or None. Wired here so the prefix cache's
        #: reclaim spills from the first eviction.
        self.host_tier: Optional[HostKVTier] = None
        if config.host_cache_bytes > 0:
            if self.prefix is None:
                # No index to tier: degrade, never a failed engine.
                logger.warning(
                    "engine %s: engine_host_cache_bytes=%d but "
                    "engine_prefix_cache is off — host KV tier "
                    "disabled", name, config.host_cache_bytes)
            else:
                self.host_tier = HostKVTier(config.host_cache_bytes)
                self.prefix.set_host_tier(self.host_tier)
                self.prefix.set_spill(self._spill_entry)
        # Per-page host leaf shapes ([page_size, heads, dim] a KV leaf,
        # kv_leaf_order; every head, a gang's too): the gate every
        # fleet-fetched block must pass before it can be spliced.
        self._kv_leaf_shapes = [
            self._all_heads_shape(getattr(self.kv.physical[i], n).shape[1:])
            for i, n in kv_leaf_order(len(self.kv.physical))]
        # Fleet pull-through accounting (GIL-consistent ints; the
        # serving layer counts through note_kv_fetch).
        self._kv_fetch_hits = 0
        self._kv_fetch_misses = 0
        self._kv_fetch_errors = 0
        self._kv_fetched_blocks_total = 0
        self._cv = threading.Condition()
        # Closures posted by _run_on_engine, run at the top of each lap.
        self._control: Deque[Callable[[], None]] = deque()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._rng_counter = 0
        # TTFT/pacing estimators feed the submit-side admission gate.
        self._prefill_est = LatencyEstimator(prior_s=0.05)
        self._token_est = LatencyEstimator(prior_s=0.01)
        # First-seen (program, shape) keys: the reference's compile
        # events; the count is the engine_compile spans. On the card a
        # decode slice, a speculative round's draft and verify, and a
        # classic admission's prefill at a prompt bucket are captured
        # there as CUDA graphs (graphs.py) and replayed after.
        self._compile_seen: set = set()
        self._graphs: Optional[GraphCache] = (
            GraphCache(self.device)
            if capture_graphs and self.device.type == "cuda" else None)
        # The captured admission prefill's B=1 cache (one for every
        # prompt bucket: an admission adopts it before the next).
        self._prefill_cache: Optional[List[LayerCache]] = None
        self._slices = 0
        self._sample_kw = dict(
            temperature=config.temperature, eos_id=config.eos_id,
            top_k=config.top_k, top_p=config.top_p)
        # Draft lane: a persistent dense draft cache (one row per slot)
        # and split draft / verify dispatches, so the attribution can
        # tell draft wall from verify wall (the spec_verify span, the
        # draft_ms / verify_ms request args). The draft module is the
        # engine thread's own copy, as the verifier's is.
        self._draft_model = None
        self._draft_params = None
        self._draft_cache: Optional[List[LayerCache]] = None
        self._spec_rounds = 0
        self._spec_drafted_total = 0
        self._spec_accepted_total = 0
        if self._spec_on:
            self._draft_model = copy.deepcopy(draft_model)
            self._draft_params = draft_params
            with torch.inference_mode():
                self._draft_cache = init_cache(draft_model, draft_params,
                                               config.num_slots)
        # Metric children (owner-checked gauge callbacks).
        self._m_tokens = _M_TOKENS.labels(name)
        self._m_admitted = _M_ADMITTED.labels(name)
        self._m_shed = _M_SHED.labels(name)
        self._m_ttft = _M_TTFT.labels(name)
        self._m_inter = _M_INTER.labels(name)
        self._g_slots = _M_SLOTS.labels(name)
        self._g_slots.set_function(self.scheduler.occupancy)
        self._g_queue = _M_QUEUE.labels(name)
        self._g_queue.set_function(self.scheduler.queue_depth)
        self._g_pages = _M_FREE_PAGES.labels(name)
        self._g_pages.set_function(self.kv.allocator.available)
        self._g_occupancy = _M_PAGE_OCC.labels(name)
        self._g_occupancy.set_function(self.page_occupancy)
        if self._spec_on:
            self._m_spec_drafted = _M_SPEC_DRAFTED.labels(name)
            self._m_spec_accepted = _M_SPEC_ACCEPTED.labels(name)
            self._m_spec_rejected = _M_SPEC_REJECTED.labels(name)
            self._g_spec_rate = _M_SPEC_RATE.labels(name)
            self._g_spec_rate.set_function(self.spec_acceptance_rate)
        if self.prefix is not None:
            self._m_prefix_hits = _M_PREFIX_HITS.labels(name)
            self._m_prefix_misses = _M_PREFIX_MISSES.labels(name)
            self._m_prefix_saved = _M_PREFIX_SAVED.labels(name)
            self._m_prefix_evicted = _M_PREFIX_EVICTED.labels(name)
            self._m_prefix_evicted.set_function(
                self._prefix_evicted_total)
            self._g_prefix_pages = _M_PREFIX_PAGES.labels(name)
            self._g_prefix_pages.set_function(
                self.prefix.resident_pages)
        if self.host_tier is not None:
            self._m_host_spilled = _M_HOST_SPILLED.labels(name)
            self._m_host_spilled.set_function(self._host_spilled)
            self._m_host_readopted = _M_HOST_READOPTED.labels(name)
            self._m_host_readopted.set_function(self._host_readopted)
            self._m_host_evicted = _M_HOST_EVICTED.labels(name)
            self._m_host_evicted.set_function(self._host_evicted)
            self._g_host_bytes = _M_HOST_BYTES.labels(name)
            self._g_host_bytes.set_function(
                self.host_tier.resident_bytes)
            self._g_host_blocks = _M_HOST_BLOCKS.labels(name)
            self._g_host_blocks.set_function(
                self.host_tier.resident_blocks)
            self._m_kv_fetch_hit = _M_KV_FETCH.labels(name, "hit")
            self._m_kv_fetch_miss = _M_KV_FETCH.labels(name, "miss")
            self._m_kv_fetch_error = _M_KV_FETCH.labels(name, "error")
            self._m_kv_fetched_blocks = _M_KV_FETCH_BLOCKS.labels(name)

    # -- submit side -----------------------------------------------------

    def set_tenant_weights(self,
                           weight_of: Optional[Callable[[str], float]]
                           ) -> None:
        """Install the tenant-quota weight lookup the fair admission
        queue drains by (idempotent; safe while traffic flows: the
        queue reads it per scheduling decision; on a gang each lap reads
        it once, and every rank admits by that snapshot)."""
        if self._gang is not None:
            self._weight_of = weight_of
            return
        self.scheduler.pending.weight_of = weight_of

    # -- a gang's KV heads ------------------------------------------------

    def _all_heads_shape(self, shape) -> tuple:
        """A pool leaf's ``[..., heads, dim]`` shape with every KV head
        (a gang rank's pool holds its slice of them)."""
        shape = tuple(shape)
        if self._head_line is None:
            return shape
        return shape[:-2] + (shape[-2] * self._head_line[1], shape[-1])

    def _all_heads(self, tensors: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """Host copies of ``tensors`` (this rank's KV heads on ``dim``)
        with every head, the tensor line's slices joined in head order
        (a collective: every rank of the line calls it); the tensors
        themselves, copied to the host, where the pool holds every
        head."""
        if self._head_line is None:
            return [t.to("cpu", copy=True) for t in tensors]
        from kubeflow_tpu_torch.parallel.collectives import all_gather_dim

        stacked = torch.stack([torch.as_tensor(t).to(self.device)
                               for t in tensors])
        joined = all_gather_dim(stacked, self._head_line[0], dim + 1,
                                "tensor")
        return list(joined.to("cpu").unbind(0))

    def _own_heads(self, tensor: Any, dim: int) -> Any:
        """This rank's slice of a tensor carrying every KV head on
        ``dim`` (a handoff's cache leaf, an imported block's leaf)."""
        if self._head_line is None:
            return tensor
        _, ranks, position = self._head_line
        tensor = torch.as_tensor(tensor)
        width = tensor.shape[dim] // ranks
        return tensor.narrow(dim, position * width, width).contiguous()

    def _handoff_cache(self, cache: List[LayerCache]) -> List[LayerCache]:
        """A B=1 cache as a handoff carries it: on the host, every head."""
        n = len(cache)
        leaves = self._all_heads([c.k for c in cache] +
                                 [c.v for c in cache], 2)
        return [LayerCache(leaves[i], leaves[n + i], c.index)
                for i, c in enumerate(cache)]

    def _next_key(self) -> np.ndarray:
        base = prng.PRNGKey(self.config.seed)
        with self._cv:
            self._rng_counter += 1
            counter = self._rng_counter
        return prng.fold_in(base, counter)

    def estimated_ttft_s(self) -> float:
        """Submit-time TTFT estimate: queue-ahead prefills plus the
        slice currently occupying the executor. Deliberately simple —
        it gates deadline shedding, not scheduling."""
        queued = self.scheduler.queue_depth()
        prefill = self._prefill_est.estimate_s()
        slice_s = self._token_est.estimate_s() * \
            self.config.slice_tokens
        return (queued + 1) * prefill + slice_s * (
            1.0 + queued / max(1, self.config.num_slots))

    def page_occupancy(self) -> float:
        """Fraction of the pool allocated to live slots or spoken for
        by reservations — the page-pressure number /healthz and the
        autoscaler read."""
        alloc = self.kv.allocator
        total = alloc.num_pages - 1
        return (total - alloc.available()) / total if total else 1.0

    def spec_acceptance_rate(self) -> float:
        """Lifetime drafted-token acceptance rate (0.0 before the
        first speculative round)."""
        if not self._spec_drafted_total:
            return 0.0
        return self._spec_accepted_total / self._spec_drafted_total

    def _prefix_evicted_total(self) -> float:
        return float(self.prefix.evicted_pages) if self.prefix \
            else 0.0

    def _host_spilled(self) -> float:
        return float(self.host_tier.spilled_blocks) \
            if self.host_tier else 0.0

    def _host_readopted(self) -> float:
        return float(self.host_tier.readopted_blocks) \
            if self.host_tier else 0.0

    def _host_evicted(self) -> float:
        return float(self.host_tier.evicted_blocks) \
            if self.host_tier else 0.0

    def _spill_entry(self, entry) -> None:
        """Evict-to-host hook (``PrefixCache.set_spill``): snapshot a
        full block's page to host memory under its chain key. Runs
        inside reclaim on the engine thread, before the page returns to
        the free list, so the copy reads valid K/V. Never raises: a
        failed spill degrades to a plain drop (the next match
        re-prefills)."""
        try:
            self.host_tier.put(entry.key, entry.tokens,
                               self.kv.read_page_layers(entry.page))
        except Exception:  # noqa: BLE001 — degrade to plain drop
            logger.exception("engine %s: host-tier spill failed; page "
                             "dropped cold", self.name)

    def note_kv_fetch(self, outcome: str, *, blocks: int = 0) -> None:
        """Record one fleet pull-through attempt from the serving layer
        (``hit`` / ``miss`` / ``error``). Thread-safe (GIL ints and
        metric children)."""
        if self.host_tier is None:
            return
        if outcome == "hit":
            self._kv_fetch_hits += 1
            self._m_kv_fetch_hit.inc()
            if blocks:
                self._kv_fetched_blocks_total += blocks
                self._m_kv_fetched_blocks.inc(blocks)
        elif outcome == "miss":
            self._kv_fetch_misses += 1
            self._m_kv_fetch_miss.inc()
        else:
            self._kv_fetch_errors += 1
            self._m_kv_fetch_error.inc()

    @contextlib.contextmanager
    def _device_scope(self):
        """What the engine thread holds for its whole life:
        ``inference_mode`` and the engine's CUDA device (both per
        thread)."""
        with contextlib.ExitStack() as stack:
            if self.device.type == "cuda":
                stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.inference_mode())
            yield

    def _run_on_engine(self, fn: Callable[[], Any],
                       timeout_s: float = 5.0) -> Any:
        """Run ``fn`` on the engine thread between laps and return its
        result (bounded wait). The engine thread is the single mutator
        of the prefix index, the pool's page custody and the engine's
        module (``apply`` swaps weights into it). Inline, in the engine
        thread's device scope, when the engine thread is not running:
        nothing else owns that state then."""
        with self._cv:
            thread = self._thread
        if thread is None or not thread.is_alive():
            with self._device_scope():
                return fn()
        done = threading.Event()
        box: dict = {}

        def wrapped() -> None:
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — carried back
                box["error"] = e
            finally:
                done.set()

        with self._cv:
            self._control.append(wrapped)
            self._cv.notify_all()
        if not done.wait(timeout_s):
            raise TimeoutError(f"engine {self.name} control op timed out "
                               f"after {timeout_s:.1f}s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _gang_call(self, op: tuple, timeout_s: float) -> Any:
        """Rank 0 of a gang: post the pool operation ``op`` for the
        engine's next lap, which announces it to every rank and runs it
        (:meth:`_apply_op`) before the lap's admissions, and return rank
        0's result (bounded wait)."""
        done = threading.Event()
        box: dict = {}
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is stopped")
            self._gang_ops.append((op, box, done))
            self._cv.notify_all()
        self._ensure_thread()
        if not done.wait(timeout_s):
            raise TimeoutError(f"engine {self.name} gang op {op[0]!r} "
                               f"timed out after {timeout_s:.1f}s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _apply_op(self, op: tuple) -> Any:
        """One pool operation of a gang's lap, on every rank (engine
        thread or a follower's lap): a clear of the prefix index, a
        fleet import or export of prefix blocks, or a classic-lane
        handoff prefill."""
        kind = op[0]
        if kind == "clear":
            return self.prefix.clear() if self.prefix is not None else 0
        if kind == "import":
            return self._import_blocks(op[1])
        if kind == "export":
            return self._export_blocks(op[1])
        if kind == "prefill":
            return self._handoff_prefill(*op[1:])
        raise ValueError(f"unknown gang op {kind!r}")

    def _export_blocks(self, tokens: np.ndarray) -> List[tuple]:
        """Every resident full block of ``tokens``, chain order, as
        ``(block_tokens, layers)`` with every KV head (engine thread)."""
        return [(block, self._all_heads(
            self.kv.read_page_layers(entry.page) if is_hbm
            else list(entry.layers), 1))
            for block, entry, is_hbm in self.prefix.chain_blocks(tokens)]

    def export_prefix_blocks(self, prompt: np.ndarray, *,
                             timeout_s: float = 5.0) -> List[tuple]:
        """Owner side of the fleet pull-through: every resident FULL
        block of ``prompt`` (HBM or host tier), chain order, as
        ``(block_tokens, layers)`` pairs for ``wire.encode_kv_blocks``
        (layers in ``kv_leaf_order``). The walk and the page snapshots
        run on the engine thread; any failure or timeout returns [] and
        the fetcher prefills."""
        if self.prefix is None:
            return []
        tokens = np.asarray(prompt, np.int32).reshape(-1)
        try:
            if self._gang is not None:
                return self._gang_call(("export", tokens), timeout_s)
            return self._run_on_engine(lambda: self._export_blocks(tokens),
                                       timeout_s=timeout_s)
        except Exception:  # noqa: BLE001 — best-effort export
            logger.warning("engine %s: prefix-block export failed; peer "
                           "will prefill cold", self.name, exc_info=True)
            return []

    def import_prefix_blocks(self, blocks: Sequence[tuple]) -> int:
        """Fleet-fetch landing: index carried ``(tokens, layers)``
        blocks in the HOST tier under chain keys recomputed from the
        carried tokens (never the peer's hashes), after a shape gate
        against this engine's pool. Import stops at the first malformed
        block: a chain is only as good as its prefix. Thread-safe (the
        host tier locks; on a gang it rides rank 0's next lap, every rank
        keeping its own heads). Returns the blocks inserted."""
        if self.host_tier is None:
            return 0
        if self._gang is not None:
            return self._gang_call(("import", list(blocks)), 60.0)
        return self._import_blocks(blocks)

    def _import_blocks(self, blocks: Sequence[tuple]) -> int:
        p = self.config.page_size
        parent = _ROOT
        imported = 0
        for tokens, layers in blocks:
            block = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
            if len(block) != p:
                break
            if [tuple(a.shape) for a in layers] != self._kv_leaf_shapes:
                break
            key = _block_key(parent, block)
            if self.host_tier.put(key, block,
                                  [self._own_heads(a, 1) for a in layers],
                                  imported=True):
                imported += 1
            parent = key
        return imported

    def probe_prefix(self, prompt: np.ndarray) -> int:
        """Cheap, lock-free estimate of how many prompt tokens this
        engine could serve from its prefix cache. Dict reads off the
        engine thread — a torn read costs one suboptimal routing
        decision, never correctness (the authoritative match runs at
        admission). 0 when prefix caching is off."""
        if self.prefix is None:
            return 0
        try:
            return self.prefix.match(
                np.asarray(prompt, np.int32).reshape(-1)).matched
        except Exception:  # noqa: BLE001 — benign-race probe
            return 0

    def clear_prefix_cache(self) -> int:
        """Drop every cached prefix (idle pages return to the free
        list immediately; pinned ones when their slot retires).
        QUIESCED callers only — warmup teardown and tests: the index
        is engine-thread state, and this must not race a live
        admission. On a gang it rides rank 0's next lap."""
        if self.prefix is None:
            return 0
        if self._gang is not None:
            return self._gang_call(("clear",), 60.0)
        return self.prefix.clear()

    def run_prefill(self, prompt: np.ndarray, *,
                    rng: Optional[np.ndarray] = None,
                    max_new_tokens: Optional[int] = None,
                    obs_ctx: Any = None,
                    timeout_s: float = 300.0) -> PrefillHandoff:
        """Run the B=1 prefill WITHOUT decoding: the prefill-role half
        of KV handoff. The returned handoff feeds ``submit(handoff=)``
        on this or any engine serving the same export. Both lanes run
        on the engine thread, and the call blocks up to ``timeout_s``:
        the classic lane's left-padded prefill at the bucket width is
        posted there (:meth:`_run_on_engine`); the prefix lane queues a
        slot-bound prefill-only request, chunked when ``prefill_chunk``
        is set, which hits and registers the prefix index. On a gang
        either lane rides rank 0's laps, and the handoff's cache carries
        every KV head."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 1 <= prompt.shape[0] <= self.config.max_prompt_len:
            raise ValueError(
                f"prompt length {prompt.shape[0]} outside "
                f"[1, {self.config.max_prompt_len}]")
        budget = (self.config.max_new_tokens if max_new_tokens is None
                  else int(max_new_tokens))
        if not 1 <= budget <= self.config.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {budget} outside "
                f"[1, {self.config.max_new_tokens}]")
        key = self._next_key() if rng is None else np.asarray(rng)
        step_keys = prng.split(np.asarray(key, np.uint32), budget)
        length = int(prompt.shape[0])
        t0 = time.monotonic()

        def note_span() -> None:
            # The prefill-role hop's work joins the request's trace.
            if TRACER.enabled and obs_ctx is not None:
                TRACER.record(
                    "engine_prefill", "engine", t0, time.monotonic() - t0,
                    span_args(obs_ctx, model=self.name, prompt_len=length,
                              handoff=True))

        if self.prefix is not None:
            if self.kv.pages_for(length) > self.kv.allocator.num_pages - 1:
                raise ValueError(
                    f"prompt needs {self.kv.pages_for(length)} pages but "
                    f"the pool has only {self.kv.allocator.num_pages - 1}")
            stream = GenerateStream(budget, obs_ctx=obs_ctx)
            box: dict = {"handoff": None}
            req = _Request(prompt=prompt, step_keys=step_keys,
                           max_new_tokens=budget, deadline=None,
                           stream=stream, submitted_at=t0,
                           tenant=tenancy.DEFAULT_TENANT,
                           prefill_only=True, prefill_box=box)
            with self._cv:
                if self._closed:
                    raise RuntimeError("engine is stopped")
                self._enqueue(req)
                self._cv.notify_all()
            self._ensure_thread()
            stream.result(timeout=timeout_s)  # raises on engine error
            if box["handoff"] is None:
                raise RuntimeError(
                    "prefill-only request finished without a handoff")
            note_span()
            return box["handoff"]
        width = self._bucket(length)
        pad = width - length
        padded = np.zeros((1, width), np.int32)
        padded[0, pad:] = prompt
        op = ("prefill", padded, pad, step_keys, length, budget)
        if self._gang is not None:
            handoff = self._gang_call(op, timeout_s)
        else:
            # On the engine thread: apply() swaps weights into the
            # engine's module, which a caller's thread must not touch.
            self._ensure_thread()
            handoff = self._run_on_engine(lambda: self._apply_op(op),
                                          timeout_s=timeout_s)
        self._note_compile("prefill", f"tokens[1,{width}]", t0,
                           time.monotonic() - t0, link=span_args(obs_ctx))
        note_span()
        return handoff

    def _handoff_prefill(self, padded: np.ndarray, pad: int,
                         step_keys: np.ndarray, length: int,
                         budget: int) -> PrefillHandoff:
        """The classic lane's prefill-role prefill (engine thread)."""
        cache, first, done = self._classic_prefill(
            padded, pad, step_keys[0:1], length)
        return PrefillHandoff(
            cache=self._handoff_cache(cache), first_token=int(first[0]),
            done=bool(done[0]), prompt_len=length,
            prompt_width=padded.shape[1], max_new_tokens=budget,
            step_keys=step_keys)

    def submit(self, prompt: Optional[np.ndarray] = None, *,
               rng: Optional[np.ndarray] = None,
               max_new_tokens: Optional[int] = None,
               deadline: Optional[float] = None,
               obs_ctx: Any = None,
               request_id: str = "",
               tenant: str = "",
               handoff: Optional[PrefillHandoff] = None,
               step_keys: Optional[np.ndarray] = None,
               prompt_len: Optional[int] = None,
               kv_fetch_s: float = 0.0
               ) -> GenerateStream:
        """Queue one request; tokens stream on the returned handle.

        ``max_new_tokens`` may be LESS than the engine's configured
        budget (a short request retires early and frees its slot);
        ``rng`` is the request's sampling key ([2] uint32 — the same
        key reproduces the same tokens at B=1 through generate()).

        With ``handoff`` (KV handoff) the prompt's prefill already ran
        elsewhere: admission adopts the carried cache pages instead of
        prefilling, and the prompt, key schedule and budget come from
        the handoff (a different caller budget is rejected: it would
        fork the schedule).

        With ``step_keys`` (mid-stream resume) the caller gives the
        remaining sampling schedule ([budget, 2] uint32) instead of a
        key: ``prompt`` is the whole context (the original prompt and
        the tokens already emitted elsewhere), the budget is the
        schedule's length, and the context may exceed
        ``max_prompt_len``: its bound is ``cache_size - budget``.
        ``prompt_len`` splits the context: ``prompt[:prompt_len]`` is
        the original prompt (at most ``max_prompt_len``), prefilled as
        its first admission did, and the rest are the emitted tokens,
        written on the decode route (:func:`_replay_slice`). Only the
        split form gives the uninterrupted stream's tokens bitwise on
        the card; without it the whole context is prefilled, as the
        reference does, and the emitted tokens' K/V comes from the
        prefill route, one rounding apart.

        Raises :class:`OverloadedError` /
        :class:`DeadlineExceededError` synchronously when admission
        control sheds the request. ``kv_fetch_s`` is the fleet KV
        fetch the serving layer ran for this request, recorded in its
        ``engine_request`` span."""
        if handoff is not None and step_keys is not None:
            raise ValueError("handoff and step_keys are mutually "
                             "exclusive (the handoff carries its own "
                             "key schedule)")
        if prompt_len is not None and handoff is not None:
            raise ValueError("prompt_len and handoff are mutually "
                             "exclusive (a handoff carries its prefill)")
        if prompt_len is not None and step_keys is None:
            raise ValueError("prompt_len splits a resume context: it "
                             "needs step_keys")
        if handoff is not None:
            prompt, budget = self._check_handoff(handoff, max_new_tokens)
        elif step_keys is not None:
            # Mid-stream resume: the context is the original prompt and
            # the tokens already emitted elsewhere, and the remaining
            # schedule is the budget.
            if rng is not None:
                raise ValueError("step_keys and rng are mutually "
                                 "exclusive (the schedule is explicit)")
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            step_keys = np.ascontiguousarray(
                np.asarray(step_keys, np.uint32).reshape(-1, 2))
            budget = len(step_keys)
            if (max_new_tokens is not None
                    and int(max_new_tokens) != budget):
                raise ValueError(
                    f"max_new_tokens {max_new_tokens} != the "
                    f"{budget}-key resume schedule")
            limit = self._model.cache_size - budget
            if not 1 <= prompt.shape[0] <= limit:
                raise ValueError(
                    f"resume context length {prompt.shape[0]} outside "
                    f"[1, {limit}] (cache_size {self._model.cache_size}"
                    f" - {budget} remaining tokens)")
            if prompt_len is not None:
                prompt_len = int(prompt_len)
                if not 1 <= prompt_len <= prompt.shape[0]:
                    raise ValueError(
                        f"prompt_len {prompt_len} outside [1, "
                        f"{prompt.shape[0]}] (the resume context)")
                if prompt_len > self.config.max_prompt_len:
                    raise ValueError(
                        f"prompt part of {prompt_len} tokens outside "
                        f"[1, {self.config.max_prompt_len}] "
                        f"(max_prompt_len)")
                end = self._prompt_width(prompt_len) + (
                    prompt.shape[0] - prompt_len) + budget
                if end > self._model.cache_size:
                    raise ValueError(
                        f"resume context of {prompt.shape[0]} tokens "
                        f"(prompt bucket {self._prompt_width(prompt_len)}"
                        f") and {budget} remaining tokens outside the "
                        f"cache_size {self._model.cache_size}")
        else:
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            if not 1 <= prompt.shape[0] <= self.config.max_prompt_len:
                raise ValueError(
                    f"prompt length {prompt.shape[0]} outside "
                    f"[1, {self.config.max_prompt_len}]")
            budget = (self.config.max_new_tokens
                      if max_new_tokens is None else int(max_new_tokens))
        if not 1 <= budget <= self.config.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {budget} outside "
                f"[1, {self.config.max_new_tokens}]")
        if self._closed:
            raise RuntimeError("engine is stopped")
        # A worst-case reservation that can NEVER fit the pool would
        # sit at the FIFO head forever (admission holds the line for
        # the head) — fail it at submit, not by hanging the queue.
        if handoff is not None and self.prefix is None:
            width = handoff.prompt_width
        elif prompt_len is not None:
            width = self._prompt_width(prompt_len) + (
                prompt.shape[0] - prompt_len)
        else:
            width = self._prompt_width(int(prompt.shape[0]))
        need = self.kv.pages_for(width + budget)
        usable = self.kv.allocator.num_pages - 1
        if need > usable:
            raise ValueError(
                f"request needs {need} pages worst-case "
                f"(prompt bucket {width} + "
                f"{budget} new tokens at page_size "
                f"{self.kv.page_size}) but the pool has only "
                f"{usable} — raise engine_num_pages or lower the "
                f"request budget")
        tenant = tenant or tenancy.DEFAULT_TENANT
        if self.scheduler.queue_depth() >= self.config.queue_capacity:
            # Attributable shed: name the submitting tenant's own depth
            # and the top queue holder, so the 503 points at the noisy
            # neighbor, not just at "full".
            depths = self.scheduler.tenant_depths()
            top = max(depths.items(), key=lambda kv: kv[1],
                      default=(tenant, 0))
            self._m_shed.inc()
            tenancy.note_shed(tenant, "overload")
            raise OverloadedError(
                f"engine queue full "
                f"({self.config.queue_capacity} pending; tenant "
                f"{tenant!r} holds {depths.get(tenant, 0)}, top "
                f"holder {top[0]!r} with {top[1]})",
                retry_after_s=self.estimated_ttft_s())
        now = time.monotonic()
        if deadline is not None:
            remaining = deadline - now
            if remaining <= 0:
                raise DeadlineExceededError(
                    "deadline expired before submit")
            est = self.estimated_ttft_s()
            if handoff is not None:
                # An adopting admission skips its own prefill, the
                # expensive term: pricing it would shed adoptable
                # requests the proxy then prefills again elsewhere.
                est = max(0.0, est - self._prefill_est.estimate_s())
            if est > remaining * ADMISSION_SAFETY:
                self._m_shed.inc()
                tenancy.note_shed(tenant, "overload")
                raise OverloadedError(
                    f"engine overloaded: estimated time-to-first-"
                    f"token {est * 1e3:.0f}ms exceeds remaining "
                    f"budget {remaining * 1e3:.0f}ms",
                    retry_after_s=est)
        if handoff is not None:
            step_keys = np.asarray(handoff.step_keys, np.uint32)
        elif step_keys is None:
            key = self._next_key() if rng is None else np.asarray(rng)
            step_keys = prng.split(np.asarray(key, np.uint32), budget)
        stream = GenerateStream(budget, obs_ctx=obs_ctx)
        if handoff is None or handoff.prompt_tokens is not None:
            # The peer-resume context; a left-layout handoff's
            # placeholder prompt (zeros) is not the context. A split
            # resume keeps its split point, so a second death resumes
            # split too (the server writes it into the token).
            stream.resume_ctx = {"prompt": prompt, "step_keys": step_keys,
                                 "max_new_tokens": budget}
            if prompt_len is not None:
                stream.resume_ctx["prompt_len"] = prompt_len
        replay = None
        if prompt_len is not None and prompt_len < prompt.shape[0]:
            prompt, replay = prompt[:prompt_len], prompt[prompt_len:]
        req = _Request(prompt=prompt, step_keys=step_keys,
                       max_new_tokens=budget, deadline=deadline,
                       stream=stream, submitted_at=now,
                       request_id=request_id, tenant=tenant,
                       handoff=handoff, replay=replay,
                       kv_fetch_s=max(0.0, float(kv_fetch_s)))
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is stopped")
            self._enqueue(req)
            self._cv.notify_all()
        self._ensure_thread()
        return stream

    def _enqueue(self, req: _Request) -> None:
        """Queue ``req`` (under ``_cv``): on a gang at rank 0's next lap,
        once announced."""
        if self._gang is None:
            self.scheduler.pending.append(req)
            return
        req.gang_id = self._gang_next
        self._gang_next += 1
        self._gang_new.append(req)
        self.gang_streams[req.gang_id] = req.stream

    def _check_handoff(self, handoff: PrefillHandoff,
                       max_new_tokens: Optional[int]):
        """The reference's checks of a handoff at submit (layout, width,
        length, budget against the step-key schedule), and its cache's
        geometry against this engine's pool. Returns ``(prompt,
        budget)``: the carried prompt ids, or zeros of the prompt's
        length where a left-layout handoff carries none."""
        if (max_new_tokens is not None
                and int(max_new_tokens) != handoff.max_new_tokens):
            raise ValueError(
                f"max_new_tokens {max_new_tokens} != handoff's "
                f"{handoff.max_new_tokens} — the step-key schedule was "
                f"derived at prefill time")
        layout = getattr(handoff, "layout", "left") or "left"
        expected = "right" if self.prefix is not None else "left"
        if layout != expected:
            # A left-padded cache in the pad-0 layout (or the reverse)
            # would put the prompt at the wrong cache positions.
            raise ValueError(
                f"handoff layout {layout!r} incompatible with this "
                f"engine's {expected!r} layout (prefix caching "
                f"{'on' if expected == 'right' else 'off'})")
        max_bucket = self._bucket(self.config.max_prompt_len)
        if not 1 <= handoff.prompt_width <= max_bucket:
            raise ValueError(f"handoff prompt_width {handoff.prompt_width}"
                             f" outside [1, {max_bucket}]")
        if not 1 <= handoff.prompt_len <= handoff.prompt_width:
            raise ValueError(
                f"handoff prompt_len {handoff.prompt_len} outside "
                f"[1, width {handoff.prompt_width}]")
        budget = int(handoff.max_new_tokens)
        if len(np.asarray(handoff.step_keys)) != budget:
            raise ValueError(
                f"handoff carries {len(handoff.step_keys)} step keys "
                f"for a {budget}-token budget")
        want = [(1, self.kv.cache_size) + self._all_heads_shape(
            c.k.shape[2:]) for c in self.kv.physical]
        got = [tuple(c.k.shape) for c in handoff.cache]
        if got != want or any(tuple(c.v.shape) != tuple(c.k.shape)
                              for c in handoff.cache):
            raise ValueError(
                f"handoff cache of {len(got)} layers {got[:1]} does not "
                f"fit this engine's {len(want)} layers {want[:1]}")
        if handoff.prompt_tokens is None:
            return np.zeros((handoff.prompt_len,), np.int32), budget
        prompt = np.asarray(handoff.prompt_tokens, np.int32).reshape(-1)
        if prompt.shape[0] != handoff.prompt_len:
            raise ValueError(
                f"handoff carries {prompt.shape[0]} prompt tokens but "
                f"claims prompt_len {handoff.prompt_len}")
        return prompt, budget

    def _carried_cache(self, handoff: PrefillHandoff) -> List[LayerCache]:
        """A handoff's host cache on the engine's device (a gang rank's
        own KV heads of it)."""
        return [LayerCache(self._own_heads(c.k, 2).to(self.device),
                           self._own_heads(c.v, 2).to(self.device),
                           c.index) for c in handoff.cache]

    def _ensure_thread(self) -> None:
        with self._cv:
            if self._thread is None and not self._closed:
                self._thread = threading.Thread(
                    target=self._loop, name=f"engine-{self.name}",
                    daemon=True)
                self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._closed = True
            thread, self._thread = self._thread, None
            self._cv.notify_all()
        still_running = False
        if thread is not None:
            thread.join(timeout=10)
            still_running = thread.is_alive()
        err = RuntimeError("engine shutting down")
        if still_running:
            # The engine thread is mid-slice and still owns the slot/
            # allocator state — racing _retire against it corrupts the
            # free list. Fail the streams (their locks are per-stream,
            # safe from any thread) and leave the device-side
            # bookkeeping to die with the object.
            logger.warning(
                "engine %s thread still busy at stop(); failing "
                "streams without touching slot state", self.name)
            for slot in self.scheduler.active_slots():
                slot.request.stream._fail(err)
        else:
            for slot in self.scheduler.active_slots():
                self._retire(slot, "shutdown", error=err)
            # The graphs and their pool go with the engine thread.
            self._graphs = None
            self._prefill_cache = None
        for req in list(self.scheduler.pending) + self._gang_new:
            req.stream._fail(err)
        self.scheduler.pending.clear()
        self._gang_new = []
        for _, box, done in self._gang_ops:
            box["error"] = err
            done.set()
        self._gang_ops = []
        if self.prefix is not None:
            if not still_running:
                # Drain the cache so the pool releases cleanly (a
                # stopped engine holds zero resident pages). A busy
                # thread still owns the allocator — leave custody to
                # die with the object.
                self.prefix.clear()
            # Callback clears are pure registry ops — run them even
            # when the thread is busy, or the gauges pin the dead
            # engine (params + page pool).
            self._m_prefix_evicted.clear_function(self)
            self._g_prefix_pages.clear_function(self.prefix)
        if self.host_tier is not None:
            if not still_running:
                self.host_tier.clear()
            self._m_host_spilled.clear_function(self)
            self._m_host_readopted.clear_function(self)
            self._m_host_evicted.clear_function(self)
            self._g_host_bytes.clear_function(self.host_tier)
            self._g_host_blocks.clear_function(self.host_tier)
        self._g_slots.clear_function(self.scheduler)
        self._g_queue.clear_function(self.scheduler)
        self._g_pages.clear_function(self.kv.allocator)
        self._g_occupancy.clear_function(self)
        if self._spec_on:
            self._g_spec_rate.clear_function(self)

    def captured_keys(self) -> set:
        """The ``engine_compile`` keys this engine runs as CUDA graphs,
        one graph each (empty when uncaptured). Not a ``stats()`` key:
        those are the reference's."""
        return set(self._graphs.programs) if self._graphs is not None \
            else set()

    def stats(self) -> dict:
        alloc = self.kv.allocator
        out = {
            "slots": self.config.num_slots,
            "active_slots": self.scheduler.occupancy(),
            "queue_depth": self.scheduler.queue_depth(),
            "admitted": self.scheduler.admitted,
            "retired": dict(self.scheduler.retired_by),
            "free_pages": alloc.free_pages,
            "reserved_pages": alloc.reserved_pages,
            "retained_pages": alloc.retained_pages,
            "total_pages": alloc.num_pages - 1,
            "page_size": self.kv.page_size,
            "page_occupancy": round(self.page_occupancy(), 4),
            "est_ttft_ms": round(self.estimated_ttft_s() * 1e3, 3),
            # Decode slices run, and distinct (program, shape) keys
            # seen (a growing count at steady state is shape churn).
            "slices": self._slices,
            "compiled_programs": len(self._compile_seen),
            # Per-tenant queue depths, capped: top-K + 'other'.
            "tenant_queue_depths": tenancy.cap_depths(
                self.scheduler.tenant_depths()),
        }
        if self.prefix is not None:
            out["prefix_cache"] = self.prefix.stats()
        if self._spec_on:
            # The acceptance economics: verify_forwards is what
            # "verifier forwards per emitted token" divides by.
            out["spec"] = {
                "k": self.config.speculate_tokens,
                "rounds": self._spec_rounds,
                "verify_forwards": self._spec_rounds,
                "drafted_tokens": self._spec_drafted_total,
                "accepted_tokens": self._spec_accepted_total,
                "acceptance_rate": round(
                    self.spec_acceptance_rate(), 4),
            }
        if self.config.prefill_chunk:
            out["prefill_chunk"] = self.config.prefill_chunk
        if self._gang is not None:
            # A gang's engine runs eagerly (no CUDA graphs).
            out["gang"] = {"ranks": self._gang.size,
                           "capture_graphs": self._graphs is not None}
        if self.host_tier is not None:
            out["kv_tier"] = {
                "host": self.host_tier.stats(),
                "fetch_hits": self._kv_fetch_hits,
                "fetch_misses": self._kv_fetch_misses,
                "fetch_errors": self._kv_fetch_errors,
                "fetched_blocks": self._kv_fetched_blocks_total,
            }
        return out

    # -- engine thread ---------------------------------------------------

    def _drain_control(self) -> None:
        """Run every posted control closure (engine thread). The
        closures carry their own error boxes (:meth:`_run_on_engine`);
        the except keeps a broken one from failing in-flight slots."""
        while True:
            with self._cv:
                if not self._control:
                    return
                fn = self._control.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 — already boxed
                logger.exception("engine control op failed")

    def _loop(self) -> None:
        # inference_mode and the current CUDA device are per thread:
        # this thread does every device op of the engine.
        with self._device_scope():
            self._run_loop()

    def _run_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                if (not self.scheduler.pending
                        and not self.scheduler.active_slots()
                        and not self._control and not self._gang_new
                        and not self._gang_ops):
                    self._cv.wait(timeout=0.05)
                    continue
            try:
                self._drain_control()
                if self._gang is not None:
                    worked = self._lead_lap()
                else:
                    self._expire()
                    worked = self._lap()
                if not worked:
                    # Queued-but-unadmittable head with nothing
                    # decoding: bounded nap instead of a hot spin
                    # (only expiry/cancel can change the picture, and
                    # _expire reruns each lap).
                    with self._cv:
                        if not self._closed:
                            self._cv.wait(timeout=0.05)
            except Exception as e:  # noqa: BLE001 — fail the streams,
                # keep the engine alive for later requests.
                logger.exception("engine slice failed")
                for slot in self.scheduler.active_slots():
                    self._retire(slot, "error", error=e)

    def _lap(self) -> bool:
        """Admit, advance prefills and run a slice where a slot decodes:
        one lap's device work. False when it could not move (a queued
        head that does not fit, nothing decoding or prefilling)."""
        self._admit()
        self._advance_prefills()
        if self.scheduler.decoding_slots():
            self._run_slice()
            return True
        # Prefill-only laps: work advanced, no nap.
        return bool(self.scheduler.prefilling_slots())

    def pool_digest(self) -> tuple:
        """What every rank of a gang must agree on before a lap: free,
        reserved and retained pages, live slots, queued requests,
        indexed pages and the host tier's bytes."""
        alloc = self.kv.allocator
        return (alloc.free_pages, alloc.reserved_pages,
                alloc.retained_pages, self.scheduler.occupancy(),
                self.scheduler.queue_depth(),
                self.prefix.resident_pages() if self.prefix else 0,
                self.host_tier.resident_bytes() if self.host_tier else 0)

    def _lap_weights(self, new: Sequence[_Request]
                     ) -> Optional[Dict[str, float]]:
        """Rank 0: the fair queue's weight of each queued tenant for
        this lap (None unweighted), installed here as on every rank."""
        if self._weight_of is None:
            return None
        weights = {}
        for tenant in {r.tenant for r in list(self.scheduler.pending)
                       + list(new)}:
            try:
                weights[tenant] = float(self._weight_of(tenant))
            except Exception:  # noqa: BLE001 — as FairQueue degrades
                logger.exception("tenant weight lookup failed for %r",
                                 tenant)
                weights[tenant] = 1.0
        self._set_lap_weights(weights)
        return weights

    def _set_lap_weights(self, weights: Optional[Dict[str, float]]) -> None:
        self.scheduler.pending.weight_of = (
            None if weights is None
            else lambda tenant: weights.get(tenant, 1.0))

    def _lead_lap(self) -> bool:
        """Rank 0's lap on a gang: expire, then broadcast what changed
        since the last lap (new requests, drops, posted pool operations,
        the lap's tenant weights, the pool's digest), then run the
        operations and the lap, all under the line's lock (a
        ``LoadedModel.run`` of rank 0 takes it too, so the ranks see one
        order of work)."""
        with self._gang.lock:
            self._expire()
            with self._cv:
                new, self._gang_new = self._gang_new, []
                drops, self._gang_drops = self._gang_drops, []
                ops, self._gang_ops = self._gang_ops, []
            digest = self.pool_digest()
            weights = self._lap_weights(new)
            self._gang.send(("lap", [
                (r.gang_id, r.prompt, r.step_keys, r.max_new_tokens,
                 r.tenant, r.request_id, r.handoff, r.replay,
                 r.prefill_only) for r in new], drops,
                [op for op, _, _ in ops], weights, digest))
            self.gang_laps += 1
            for op, box, done in ops:
                try:
                    box["result"] = self._apply_op(op)
                except Exception as e:  # noqa: BLE001 — carried back
                    box["error"] = e
                finally:
                    done.set()
            with self._cv:
                for req in new:
                    self.scheduler.pending.append(req)
            return self._lap()

    def follow_lap(self, new: Sequence[tuple], drops: Sequence[int],
                   ops: Sequence[tuple] = (),
                   weights: Optional[Dict[str, float]] = None,
                   digest: Optional[tuple] = None) -> None:
        """A follower rank's lap on a gang: rank 0's drops applied, its
        digest checked against this rank's (a mismatch raises), its pool
        operations run, its queued requests appended in its order, then
        the same lap by the same tenant weights (on the caller's thread,
        in the engine's device scope)."""
        with self._device_scope():
            now = time.monotonic()
            gone = set(drops)
            if gone:
                for req in self.scheduler.pending.remove_if(
                        lambda r: r.gang_id in gone):
                    req.stream._fail(RuntimeError("dropped by rank 0"))
                for slot in self.scheduler.active_slots():
                    if slot.request.gang_id in gone:
                        self._retire(slot, "cancelled", error=RuntimeError(
                            "dropped by rank 0"))
            mine = self.pool_digest()
            if digest is not None and tuple(digest) != mine:
                raise RuntimeError(
                    f"engine {self.name}: this rank's pool {mine} differs "
                    f"from rank 0's {tuple(digest)} (free, reserved and "
                    f"retained pages, live slots, queued, indexed pages, "
                    f"host-tier bytes): the gang drifted apart")
            self.gang_laps += 1
            for op in ops:
                try:
                    self._apply_op(op)
                except Exception:  # noqa: BLE001 — rank 0's raised too
                    logger.exception("gang op %r failed", op[0])
            for (gid, prompt, keys, budget, tenant, request_id, handoff,
                 replay, prefill_only) in new:
                stream = GenerateStream(budget)
                self.gang_streams[gid] = stream
                self.scheduler.pending.append(_Request(
                    prompt=prompt, step_keys=keys, max_new_tokens=budget,
                    deadline=None, stream=stream, submitted_at=now,
                    request_id=request_id, tenant=tenant, gang_id=gid,
                    handoff=handoff, replay=replay,
                    prefill_only=prefill_only,
                    prefill_box={"handoff": None} if prefill_only
                    else None))
            self._set_lap_weights(weights)
            try:
                self._lap()
            except Exception as e:  # noqa: BLE001 — as rank 0's loop does
                logger.exception("engine slice failed")
                for slot in self.scheduler.active_slots():
                    self._retire(slot, "error", error=e)

    def _note_compile(self, program: str, shapes: str,
                      start_s: float, dur_s: float,
                      link: Optional[dict] = None) -> None:
        """Record the engine_compile span for a first-seen program/
        shape key. ``link`` (a span_args dict) attributes a
        request-triggered first run to THAT request's trace; slice
        first runs (no single owner) stay documented roots."""
        key = (program, shapes)
        if key in self._compile_seen:
            return
        self._compile_seen.add(key)
        if TRACER.enabled:
            args = {"model": self.name, "program": program,
                    "shapes": shapes}
            for k in ("request_id", "trace_id", "parent_id", "leg"):
                if link and k in link:
                    args[k] = link[k]
            TRACER.record("engine_compile", "engine", start_s, dur_s,
                          args)

    def _bucket(self, n: int) -> int:
        return prompt_bucket(n, self.config.max_prompt_len,
                             self.config.prompt_buckets)

    def _prompt_width(self, length: int) -> int:
        """Cache positions a ``length``-token prompt takes: exact in the
        pad-0 prefix layout, the shared prompt-bucket policy (a
        left-padded prompt) otherwise — except a resume context longer
        than ``max_prompt_len`` (legal: its bound is the cache), which
        takes its exact width, as ``prompt_bucket`` clamps to
        ``max_prompt_len`` and a clamped width would cut the
        context."""
        if self.prefix is not None or length > self.config.max_prompt_len:
            return length
        return self._bucket(length)

    def _budget_pages(self, req: _Request) -> int:
        if req.handoff is not None and self.prefix is None:
            width = req.handoff.prompt_width
        else:
            width = self._prompt_width(len(req.prompt))
        if req.replay is not None:
            width += len(req.replay)
        # Prefill-only requests never decode: the prompt's pages are the
        # whole budget.
        new_tokens = 0 if req.prefill_only else req.max_new_tokens
        return self.kv.pages_for(width + new_tokens)

    def _tail_width(self, length: int, start: int) -> int:
        """Block width for the continuation prefill of prompt tokens
        ``[start, length)``: the shared prompt-bucket policy, except
        never past the model's cache end — the scalar append writes
        ``[start, start + width)`` by slicing, so an overhanging block
        must never reach it. An overshooting bucket falls back to the
        exact tail length. A hit's tail block (``start > 0``) is at
        least 2 wide: the model runs a one-token cache forward as a
        decode step, whose kernels sum in another order than the
        prefill's, and the cold run prefills that position in a wider
        block. The pad column's K/V lands at ``length``, which the
        first decode step overwrites, and it fits: a prompt leaves
        room for at least one new token before the cache end. A resume
        context's tail longer than ``max_prompt_len`` takes its exact
        width (``prompt_bucket`` clamps, which would cut it)."""
        if length - start > self.config.max_prompt_len:
            return length - start
        width = self._bucket(length - start)
        if start + width > self._model.cache_size:
            width = length - start
        if start > 0:
            width = max(width, 2)
        return width

    def _device_keys(self, keys: np.ndarray) -> Optional[torch.Tensor]:
        """Step keys on the engine's device; None when greedy (no key
        is read)."""
        if self.config.temperature <= 0.0:
            return None
        return _device_keys(keys, self.device)

    def _expire(self) -> None:
        # Under _cv: expired_pending() rebuilds the pending sub-queues,
        # and submit() appends under _cv.
        with self._cv:
            expired = self.scheduler.expired_pending()
            dead = self.scheduler.pending.remove_if(
                lambda r: r.stream.cancelled)
        late = self.scheduler.expired_slots()
        gone = [s for s in self.scheduler.active_slots()
                if s not in late and s.request.stream.cancelled]
        if self._gang is not None:
            # Rank 0's drops, announced before its lap's device work.
            self._gang_drops += [r.gang_id for r in expired + dead] + [
                s.request.gang_id for s in late + gone]
        for req in expired:
            req.stream._fail(DeadlineExceededError(
                "deadline expired while queued for a slot"))
            _M_RETIRED.labels(self.name, "expired_queued").inc()
            tenancy.note_expired(req.tenant or tenancy.DEFAULT_TENANT)
        for req in dead:
            # Client hung up while still queued: never burn a prefill
            # or a slot on it.
            req.stream._fail(RuntimeError(
                "stream cancelled by the client"))
            _M_RETIRED.labels(self.name, "cancelled_queued").inc()
        for slot in late:
            self._retire(slot, "deadline", error=DeadlineExceededError(
                f"deadline expired mid-decode after "
                f"{slot.emitted} token(s)"))
        for slot in gone:
            self._retire(slot, "cancelled", error=RuntimeError(
                "stream cancelled by the client"))

    def _admit(self) -> None:
        while True:
            if self.prefix is not None:
                if not self._admit_one_prefix():
                    return
                continue
            req = self.scheduler.next_admittable(self._budget_pages)
            if req is None:
                return
            self._prefill_and_bind(req)

    def _admit_one_prefix(self) -> bool:
        """One admission attempt in prefix-cache mode: in fair-
        queueing order, match each tenant head's prompt, pin the
        matched resident pages, and reserve only the private
        remainder; the first head whose reservation fits admits. A
        failed reservation UNPINS before moving on — a head never
        deadlocks the queue against its own pins (every page it waits
        for is then either free, evictable, or held by a live slot
        that will retire), and it holds the line for ITS tenant only
        while other tenants' heads still admit."""
        sched = self.scheduler
        if not sched.pending or not sched.has_free_slot():
            return False
        for i, head in enumerate(sched.pending.heads()):
            total = self._budget_pages(head)
            match = self.prefix.match(head.prompt)
            if head.handoff is not None:
                # A handoff arrives with its whole prefill: full-block
                # sharing still saves pages, but a boundary fork or a
                # host block has nothing to add that the carried cache
                # does not hold, and a placeholder prompt (no tokens in
                # the blob) must not match zeros.
                entries = (match.entries
                           if head.handoff.prompt_tokens is not None
                           else [])
                match = PrefixMatch(
                    entries=entries, fork=None, fork_len=0,
                    matched=len(entries) * self.kv.page_size)
            match = self.prefix.pin(match)
            if not self.kv.allocator.reserve(total - len(match.entries)):
                self.prefix.unpin(match)
                if i == 0 and sched.head_blocked(head):
                    # Starvation guard (see SlotScheduler): the same
                    # fair-first head has been skipped enough — hold
                    # the whole line so freed pages accumulate for it.
                    return False
                continue  # this tenant's line holds; try the next
            if i == 0:
                sched.head_unblocked()
            sched.pending.pop_head(head)
            if head.prefill_only or self._chunkable(head, match):
                # A long tail feeds one chunk per engine lap; a
                # prefill-only request always binds a slot (with
                # chunking off its whole tail is one chunk) so its
                # pages register in the prefix index.
                self._bind_chunked_prefill(head, match)
            else:
                self._prefill_and_bind_prefix(head, match)
            return True
        return False

    def _chunkable(self, req: _Request, match: PrefixMatch) -> bool:
        return (self.config.prefill_chunk > 0
                and req.handoff is None
                and len(req.prompt) - match.matched
                > self.config.prefill_chunk)

    def _program(self, key: Optional[tuple], body: Callable[..., Any],
                 inputs: Dict[str, Any]) -> Any:
        """``body(**inputs)`` for host arrays (or device tensors)
        ``inputs``: on a captured engine ``key``'s CUDA graph (the key's
        first use runs the body and captures it; later uses replay it);
        otherwise, or with no key, the body run on the inputs moved to
        the device."""
        if self._graphs is not None and key is not None:
            return self._graphs.run(key, body, inputs)
        return body(**{name: None if value is None
                       else torch.as_tensor(value).to(self.device)
                       for name, value in inputs.items()})

    def _classic_prefill(self, prompt: np.ndarray, pad: int,
                         first_keys: np.ndarray, length: int):
        """The classic lane's B=1 prefill of the left-padded ``prompt
        [1, W]`` (``pad`` pad tokens, ``length`` real ones) and its first
        sample with ``first_keys [1, 2]``: ``(cache, first [1], done
        [1])``, the cache the engine's one B=1 prefill cache (an
        admission adopts it, a handoff copies it, before the next).
        Captured per prompt bucket, the pad a device input; a resume
        context past ``max_prompt_len`` takes its exact width and runs
        eagerly (a graph a length would multiply without bound)."""
        if self._prefill_cache is None:
            self._prefill_cache = init_cache(self._model, self._params, 1)
        key = (("prefill", f"tokens[1,{prompt.shape[1]}]")
               if length <= self.config.max_prompt_len else None)
        cache, first, done = self._program(
            key, self._prefill_body,
            dict(prompt_ids=prompt, first_rng=self._host_keys(first_keys),
                 pad_lengths=np.asarray([pad], np.int32)))
        # The cache index is host state, which a replay does not set: it
        # holds the width of the last bucket whose body ran eagerly.
        for layer in cache:
            layer.index = prompt.shape[1]
        return cache, first, done

    def _prefill_body(self, prompt_ids: torch.Tensor,
                      first_rng: Optional[torch.Tensor],
                      pad_lengths: torch.Tensor):
        """The admission prefill: the B=1 prefill cache zeroed, then
        generate's prompt pass and first sample into it."""
        cache = self._prefill_cache
        for layer in cache:
            layer.k.zero_()
            layer.v.zero_()
            layer.index = 0
        (cache, first, _, done), _ = _prefill(
            self._model, self._params, prompt_ids, first_rng, cache,
            pad_lengths, **self._sample_kw)
        return cache, first, done

    def _host_keys(self, keys: np.ndarray) -> Optional[np.ndarray]:
        """Step keys as a program's host input (int64, as the device
        takes them); None when greedy (no key is read)."""
        if self.config.temperature <= 0.0:
            return None
        return np.asarray(keys, np.uint32).astype(np.int64)

    def _prefill_and_bind(self, req: _Request) -> None:
        t0 = time.monotonic()
        length = len(req.prompt)
        try:
            if req.handoff is not None:
                # KV handoff: the prefill ran elsewhere; adopt its cache
                # pages instead of recomputing them.
                width = req.handoff.prompt_width
                pad = width - req.handoff.prompt_len
                prefill_cache = self._carried_cache(req.handoff)
                first = int(req.handoff.first_token)
                done = bool(req.handoff.done)
            else:
                width = self._prompt_width(length)
                pad = width - length
                prompt = np.zeros((1, width), np.int32)
                prompt[0, pad:] = req.prompt
                # The prefill writes a zero cache in place, and adopt
                # copies it into the slot's pages.
                prefill_cache, first, done = self._classic_prefill(
                    prompt, pad, req.step_keys[0:1], length)
                first = int(first[0])
                done = bool(done[0])
        except Exception as e:  # noqa: BLE001 — CUDA OOM and the like
            # The request was popped WITH a reservation
            # (next_admittable); letting this propagate to _loop's
            # handler would leak that reservation forever, leave the
            # stream with no terminal event, and retire every
            # innocent in-flight slot with this error.
            logger.exception("prefill failed; shedding the request")
            self.kv.allocator.unreserve(self._budget_pages(req))
            _M_RETIRED.labels(self.name, "error").inc()
            req.stream._fail(e)
            return
        budget_pages = self._budget_pages(req)
        slot = self.scheduler.bind(
            req, prompt_width=width, pad_len=pad, first_token=first,
            done=done, budget_pages=budget_pages,
            deadline=req.deadline)
        slot.allocated_pages = self.kv.adopt(
            slot.index, prefill_cache, width, budget_pages)
        if req.replay is not None and not self._replay(slot, req):
            return
        first = slot.last_token
        t1 = time.monotonic()
        slot.queue_s = max(0.0, t0 - req.submitted_at)
        slot.prefill_s = t1 - t0
        if req.handoff is None:
            self._note_compile("prefill", f"tokens[1,{width}]", t0,
                               t1 - t0, link=self._span_args(req))
            # Only real prefills feed the estimator: an adoption's time
            # would read a decode-role replica's prefills as nearly free.
            self._prefill_est.observe(t1 - t0)
        self._m_admitted.inc()
        ctx = req.stream.obs_ctx
        self._m_ttft.observe(t1 - req.submitted_at,
                             trace_id=ctx.trace_id if ctx else None)
        tenancy.observe_ttft(req.tenant or tenancy.DEFAULT_TENANT,
                             t1 - req.submitted_at)
        if TRACER.enabled:
            TRACER.record("engine_prefill", "engine", t0, t1 - t0,
                          self._span_args(req, slot=slot.index,
                                          prompt_len=length,
                                          adopted=req.handoff is not None))
        self._emit_token(slot, first)
        if slot.done or slot.remaining == 0:
            self._retire(slot, "eos" if slot.done else "budget")
        else:
            self._draft_prefill(slot, req)

    def _prefill_and_bind_prefix(self, req: _Request,
                                 match: PrefixMatch) -> None:
        """Prefix-mode admission: the caller (``_admit_one_prefix``)
        already pinned ``match``'s pages and reserved the private
        remainder. Shared full blocks enter the slot's page table
        as-is; a partially matched boundary page is forked
        copy-on-write (its common head rows ride the gathered B=1
        cache into a PRIVATE page, because the tail prefill and the
        decode will write past them); only the unmatched tail is
        prefilled. The same tokens at the same positions with the same
        step-key schedule as a cold prefill, and the same bits: the
        tail block is narrower than the cold prefill's, but on the card
        every prefill op gives a row bits that do not depend on the
        block's width (the projections run on the prefill GEMM, whose
        reduction order depends on K alone; scripts/decode_invariance.py
        checks each op at every tail width)."""
        t0 = time.monotonic()
        length = len(req.prompt)
        budget_pages = self._budget_pages(req)
        shared = match.shared_pages
        m = match.matched
        fork_pinned = match.fork is not None
        width = self._tail_width(length, m)
        try:
            if req.handoff is not None:
                cache = self._carried_cache(req.handoff)
                first = int(req.handoff.first_token)
                done = bool(req.handoff.done)
            else:
                if m > 0:
                    cache = self._gather_match(match)
                    if fork_pinned:
                        # The fork copy is queued (device work runs in
                        # this thread's stream order); the donor page
                        # is not this slot's to keep.
                        self.prefix.unpin_fork(match)
                        fork_pinned = False
                else:
                    cache = init_cache(self._model, self._params, 1)
                block = np.zeros((1, width), np.int32)
                block[0, :length - m] = req.prompt[m:]
                cache, first, done = _prefill_ctx(
                    self._model, self._params,
                    torch.from_numpy(block).to(self.device), cache, m,
                    length - m - 1, self._device_keys(req.step_keys[0:1]),
                    **self._sample_kw)
                first = int(first[0])
                done = bool(done[0])
        except Exception as e:  # noqa: BLE001 — CUDA OOM and the like
            # Same contract as the plain path: the popped request
            # holds a reservation AND pins — leak neither, fail only
            # its own stream.
            logger.exception("prefix prefill failed; shedding the "
                             "request")
            self.kv.allocator.unreserve(budget_pages - len(shared))
            self.prefix.unpin(match, include_fork=fork_pinned)
            _M_RETIRED.labels(self.name, "error").inc()
            req.stream._fail(e)
            return
        slot = self.scheduler.bind(
            req, prompt_width=length, pad_len=0, first_token=first,
            done=done, budget_pages=budget_pages, deadline=req.deadline)
        slot.allocated_pages = self.kv.adopt(
            slot.index, cache, length, budget_pages, shared_pages=shared)
        # Index this prompt's resident pages (new private blocks, plus
        # the boundary partial). A handoff's registration lands the
        # warm transfer: pages this replica never prefilled become
        # matchable.
        if req.handoff is None or req.handoff.prompt_tokens is not None:
            self.prefix.register(
                req.prompt,
                self.kv.tables[slot.index, :slot.allocated_pages].tolist())
        if req.replay is not None and not self._replay(slot, req):
            return
        first = slot.last_token
        t1 = time.monotonic()
        slot.queue_s = max(0.0, t0 - req.submitted_at)
        slot.prefill_s = t1 - t0
        if req.handoff is None:
            self._note_compile("prefill_ctx", f"tokens[1,{width}]", t0,
                               t1 - t0, link=self._span_args(req))
            if m > 0:
                self.prefix.hits += 1
                self.prefix.saved_tokens_total += m
                self._m_prefix_hits.inc()
                self._m_prefix_saved.observe(float(m))
            else:
                self.prefix.misses += 1
                self._m_prefix_misses.inc()
                # Only full (cold) prefills feed the estimator — a tail
                # prefill's cost scales with the UNMATCHED length and
                # would read a warm cache as a fast prefill for cold
                # requests.
                self._prefill_est.observe(t1 - t0)
        self._m_admitted.inc()
        ctx = req.stream.obs_ctx
        self._m_ttft.observe(t1 - req.submitted_at,
                             trace_id=ctx.trace_id if ctx else None)
        tenancy.observe_ttft(req.tenant or tenancy.DEFAULT_TENANT,
                             t1 - req.submitted_at)
        if TRACER.enabled:
            TRACER.record("engine_prefill", "engine", t0, t1 - t0,
                          self._span_args(req, slot=slot.index,
                                          prompt_len=length,
                                          prefix_matched=m,
                                          adopted=req.handoff is not None))
        self._emit_token(slot, first)
        if slot.done or slot.remaining == 0:
            self._retire(slot, "eos" if slot.done else "budget")
        else:
            self._draft_prefill(slot, req)

    def _bind_chunked_prefill(self, req: _Request,
                              match: PrefixMatch) -> None:
        """Admit a prompt WITHOUT running its prefill yet: the slot
        binds in the PREFILLING state holding the reservation and the
        pinned prefix match; :meth:`_advance_prefills` feeds one
        page-aligned chunk per engine lap. As in the one-shot path, the
        matched prefix (plus a boundary fork) is gathered into the
        accumulating B=1 cache up front: the fork's donor page is
        unpinned once the copy is queued, and ``match`` is narrowed so a
        mid-prefill retire can unpin the entries without freeing the
        fork twice."""
        t0 = time.monotonic()
        m = match.matched
        budget_pages = self._budget_pages(req)
        fork_pinned = match.fork is not None
        try:
            if m > 0:
                cache = self._gather_match(match)
                if fork_pinned:
                    self.prefix.unpin_fork(match)
                    fork_pinned = False
                    match = dataclasses.replace(match, fork=None,
                                                fork_len=0)
            else:
                cache = init_cache(self._model, self._params, 1)
        except Exception as e:  # noqa: BLE001 — CUDA OOM and the like
            logger.exception("chunked-prefill admission failed; "
                             "shedding the request")
            self.kv.allocator.unreserve(
                budget_pages - len(match.entries))
            self.prefix.unpin(match, include_fork=fork_pinned)
            _M_RETIRED.labels(self.name, "error").inc()
            req.stream._fail(e)
            return
        slot = self.scheduler.bind_prefilling(
            req, prefill_pos=m, prefill_cache=cache,
            prefill_match=match, budget_pages=budget_pages,
            deadline=req.deadline)
        slot.queue_s = max(0.0, t0 - req.submitted_at)

    def _gather_match(self, match: PrefixMatch) -> List[LayerCache]:
        """A matched prefix as the accumulating B=1 cache: the shared
        pages, then host-tier blocks continuing the chain (their table
        rows gather as null-page rows and the host copies are spliced
        over them: byte-equal to having kept the pages), then a
        boundary fork's page."""
        host_blocks = list(match.host_entries)
        page_row = list(match.shared_pages) + [0] * len(host_blocks)
        if match.fork is not None:
            page_row.append(match.fork.page)
        cache = self.kv.gather_prefix_cache(page_row, match.matched)
        if host_blocks:
            splice_host_blocks(cache, [hb.layers for hb in host_blocks],
                               len(match.shared_pages), self.kv.page_size)
            self.host_tier.note_readopted(len(host_blocks))
        return cache

    def _advance_prefills(self) -> None:
        """Feed ONE chunk to every prefilling slot — one per engine
        lap, so a long prompt's prefill interleaves with decode slices
        instead of stalling them (the chunk is the prefill's slice
        budget). Chunks run at a fixed [1, chunk] width; the final tail
        takes the one-shot path's tail width. On the card a chunk's rows
        have the bits they have in the one-shot block (the prefill's
        kernels sum in an order its width does not change), so a chunked
        stream equals a one-shot one."""
        chunk = self.config.prefill_chunk
        for slot in self.scheduler.prefilling_slots():
            req = slot.request
            length = len(req.prompt)
            pos = slot.prefill_pos
            remaining = length - pos
            # chunk 0 only for a prefill-only admission with chunking
            # off: its whole tail is one chunk.
            step = chunk if chunk else remaining
            final = remaining <= step
            t0 = time.monotonic()
            try:
                if final:
                    width = self._tail_width(length, pos)
                    block = np.zeros((1, width), np.int32)
                    block[0, :remaining] = req.prompt[pos:]
                    last_col = remaining - 1
                else:
                    # At least 2 wide, as a hit's tail is (_tail_width):
                    # a one-token cache forward is a decode step. A pad
                    # column's K/V lands at the next prompt position,
                    # which the next chunk overwrites.
                    width = max(chunk, 2)
                    block = np.zeros((1, width), np.int32)
                    block[0, :chunk] = req.prompt[pos:pos + chunk]
                    last_col = chunk - 1
                cache, first, done = _prefill_ctx(
                    self._model, self._params,
                    torch.from_numpy(block).to(self.device),
                    slot.prefill_cache, pos, last_col,
                    self._device_keys(req.step_keys[0:1]),
                    **self._sample_kw)
                # The chunk's end is this lap's yield point.
                first = int(first[0])
                done = bool(done[0])
            except Exception as e:  # noqa: BLE001 — fail only this
                # slot; its prefilling retire path unwinds the pins
                # and the reservation.
                logger.exception("chunk prefill failed")
                self._retire(slot, "error", error=e)
                continue
            dur = time.monotonic() - t0
            slot.prefill_cache = cache
            slot.prefill_pos = pos + (remaining if final else step)
            slot.prefill_s += dur
            self._note_compile("prefill_ctx", f"tokens[1,{width}]", t0,
                               dur, link=self._span_args(req))
            if final:
                self._finish_chunked_prefill(slot, first=first, done=done)

    def _finish_chunked_prefill(self, slot: Slot, *, first: int,
                                done: bool) -> None:
        """Last chunk landed: adopt the accumulated cache into pages,
        register the prompt in the prefix index, and either join the
        decode batch (:meth:`SlotScheduler.finish_prefill`) or, for a
        prefill-only request, package the handoff and retire."""
        req = slot.request
        match = slot.prefill_match
        m = match.matched
        length = len(req.prompt)
        try:
            allocated = self.kv.adopt(
                slot.index, slot.prefill_cache, length,
                slot.budget_pages, shared_pages=match.shared_pages)
        except Exception as e:  # noqa: BLE001 — the prefilling
            # retire branch unpins the match and unreserves.
            logger.exception("chunked-prefill adopt failed")
            self._retire(slot, "error", error=e)
            return
        # From here the slot owns its pages like any bound slot: the
        # pins became table refs, and release_slot unwinds them.
        SlotScheduler.finish_prefill(slot, prompt_width=length,
                                     first_token=first, done=done)
        slot.allocated_pages = allocated
        self.prefix.register(
            req.prompt, self.kv.tables[slot.index, :allocated].tolist())
        t1 = time.monotonic()
        if m > 0:
            self.prefix.hits += 1
            self.prefix.saved_tokens_total += m
            self._m_prefix_hits.inc()
            self._m_prefix_saved.observe(float(m))
        else:
            self.prefix.misses += 1
            self._m_prefix_misses.inc()
            # Not fed to the prefill estimator: a chunked prefill's wall
            # spans several laps with decode slices between them.
        self._m_admitted.inc()
        if req.prefill_only:
            self._finish_prefill_handoff(slot, first=first, done=done)
            return
        if req.replay is not None and not self._replay(slot, req):
            return
        first = slot.last_token
        ctx = req.stream.obs_ctx
        self._m_ttft.observe(t1 - req.submitted_at,
                             trace_id=ctx.trace_id if ctx else None)
        tenancy.observe_ttft(req.tenant or tenancy.DEFAULT_TENANT,
                             t1 - req.submitted_at)
        if TRACER.enabled:
            TRACER.record(
                "engine_prefill", "engine", t1 - slot.prefill_s,
                slot.prefill_s,
                self._span_args(req, slot=slot.index, prompt_len=length,
                                prefix_matched=m, chunked=True))
        self._emit_token(slot, first)
        if slot.done or slot.remaining == 0:
            self._retire(slot, "eos" if slot.done else "budget")
        else:
            self._draft_prefill(slot, req)

    def _finish_prefill_handoff(self, slot: Slot, *, first: int,
                                done: bool) -> None:
        """Prefill-only completion: gather the slot's (adopted and
        registered) pages back into a contiguous B=1 cache for the
        :class:`PrefillHandoff`, hand it to the waiting ``run_prefill``
        caller, and retire the slot. Positions past the prompt in the
        tail page gather as whatever the page holds there: dead cells
        the adopting decode overwrites or masks."""
        req = slot.request
        length = len(req.prompt)
        page_row = self.kv.tables[slot.index, :slot.allocated_pages].tolist()
        cache = self.kv.gather_prefix_cache(page_row, length)
        req.prefill_box["handoff"] = PrefillHandoff(
            cache=self._handoff_cache(cache), first_token=first, done=done,
            prompt_len=length, prompt_width=length,
            max_new_tokens=req.max_new_tokens,
            step_keys=np.asarray(req.step_keys), layout="right",
            prompt_tokens=np.asarray(req.prompt, np.int32).copy())
        self._retire(slot, "prefill_handoff")

    def _replay(self, slot: Slot, req: _Request) -> bool:
        """A split resume, once its prompt's pages are adopted: write
        the emitted tokens' K/V on the decode route and sample the next
        token with the first key of the remaining schedule
        (:func:`_replay_slice`). The slot then stands where the
        uninterrupted stream stood after those tokens. The prompt
        prefill's own sample is discarded: that token is the first
        emitted one. False when the replay failed and the slot retired
        with the error."""
        n = len(req.replay)
        width = slot.write_pos
        dev = self.device
        try:
            slot.allocated_pages = self.kv.extend_slot(
                slot.index, slot.allocated_pages, width + n,
                slot.budget_pages)
            first, done = _replay_slice(
                self._model, self._params, self.kv.physical,
                torch.from_numpy(self.kv.tables[slot.index:slot.index + 1]
                                 .astype(np.int64)).to(dev),
                torch.tensor([width], dtype=torch.int32, device=dev),
                torch.tensor([slot.pad_len], dtype=torch.int32,
                             device=dev),
                torch.from_numpy(req.replay[None]).to(dev),
                self._device_keys(req.step_keys[0:1]), **self._sample_kw)
            first, done = int(first[0]), bool(done[0])
        except Exception as e:  # noqa: BLE001 — fail only this slot
            logger.exception("resume replay failed")
            self._retire(slot, "error", error=e)
            return False
        slot.write_pos = slot.prompt_width = width + n
        slot.last_token = first
        slot.done = done
        return True

    def _draft_prefill(self, slot: Slot, req: _Request) -> None:
        """Fill the slot's draft-cache row with the DRAFT model's prompt
        K/V, in the layout the verifier's slot uses, so the first draft
        step continues from ``write_pos``. The draft pays its whole
        prompt every admission (no draft-side prefix cache: the draft
        is small beside one saved verifier forward). A left-layout
        handoff carries no prompt ids: the row stays stale, the drafts
        are junk and acceptance falls, but the stream is the same
        (targets never depend on drafts)."""
        if not self._spec_on:
            return
        if req.handoff is not None and req.handoff.prompt_tokens is None:
            return
        # A split resume's draft row takes the whole context in one
        # prefill: the draft moves acceptance only, never tokens.
        context = (req.prompt if req.replay is None
                   else np.concatenate([req.prompt, req.replay]))
        length = len(context)
        t0 = time.monotonic()
        if self.prefix is not None:
            width = self._tail_width(length, 0)
            block = np.zeros((1, width), np.int32)
            block[0, :length] = context
            cache, _, _ = _prefill_ctx(
                self._draft_model, self._draft_params,
                torch.from_numpy(block).to(self.device),
                init_cache(self._draft_model, self._draft_params, 1), 0,
                length - 1, self._device_keys(req.step_keys[0:1]),
                **self._sample_kw)
        else:
            width = slot.prompt_width
            pad = slot.pad_len
            padded = np.zeros((1, width), np.int32)
            padded[0, pad:] = context
            (cache, _, _, _), _ = _prefill(
                self._draft_model, self._draft_params,
                torch.from_numpy(padded).to(self.device),
                self._device_keys(req.step_keys[0:1]),
                init_cache(self._draft_model, self._draft_params, 1),
                torch.tensor([pad], dtype=torch.int32, device=self.device),
                **self._sample_kw)
        _insert_cache_row(self._draft_cache, cache, slot.index)
        dur = time.monotonic() - t0
        slot.draft_s += dur
        self._note_compile("draft_prefill", f"tokens[1,{width}]", t0, dur,
                           link=self._span_args(req))

    def _emit_token(self, slot: Slot, token: int) -> None:
        slot.emitted += 1
        slot.request.stream._emit(
            TokenEvent(token=token, index=slot.emitted - 1))
        self._m_tokens.inc()
        # Billing-grade per-tenant usage: tokens actually DELIVERED
        # (capped label — spraying tenants can't grow /metrics).
        tenancy.note_tokens(slot.request.tenant
                            or tenancy.DEFAULT_TENANT)
        if self.config.eos_id is not None and \
                token == self.config.eos_id:
            slot.done = True

    def _run_slice(self) -> None:
        if self._spec_on:
            self._run_spec_slice()
        else:
            self._run_plain_slice()

    def _run_plain_slice(self) -> None:
        active = self.scheduler.decoding_slots()
        num_steps = min(self.config.slice_tokens,
                        max(s.remaining for s in active))
        n = self.config.num_slots
        for s in active:
            s.allocated_pages = self.kv.extend_slot(
                s.index, s.allocated_pages, s.write_pos + num_steps,
                s.budget_pages)
        tokens = np.zeros((n,), np.int32)
        wpos = np.zeros((n,), np.int32)
        pads = np.zeros((n,), np.int32)
        done = np.ones((n,), bool)  # inactive rows ride latched
        rngs = np.zeros((num_steps, n, 2), np.uint32)
        for s in active:
            tokens[s.index] = s.last_token
            wpos[s.index] = s.write_pos
            pads[s.index] = s.pad_len
            done[s.index] = s.done
            rngs[:, s.index] = SlotScheduler.slice_keys(s, num_steps)
        dev = self.device
        t0 = time.monotonic()
        out, last_tok, _ = self._program(
            ("decode_slice", f"steps={num_steps} slots={n}"),
            functools.partial(_decode_slice, self._model, self._params,
                              self.kv.physical, num_steps=num_steps,
                              **self._sample_kw),
            dict(tables=self.kv.device_tables(), write_pos=wpos,
                 pad_lens=pads, tokens=tokens, done=done,
                 step_rngs=self._host_keys(rngs)))
        # The executor yield point (decode-slicing contract): the copy
        # to the host waits for THIS slice, so admissions interleave
        # instead of queueing behind back-to-back slices.
        out = out.cpu().numpy()
        last_tok = last_tok.cpu().numpy()
        t_slice = time.monotonic() - t0
        self._token_est.observe(t_slice / num_steps)
        per_token = t_slice / num_steps
        self._slices += 1
        self._note_compile("decode_slice",
                           f"steps={num_steps} slots={n}", t0, t_slice)
        if TRACER.enabled:
            # Per-slice structured profile record: occupancy collapses
            # and page pressure show up HERE. Documented root span (no
            # single request owns a slice; requests join it via their
            # own decode_ms).
            alloc = self.kv.allocator
            TRACER.record(
                "engine_slice", "engine", t0, t_slice, {
                    "model": self.name,
                    "slice": self._slices,
                    "slots": len(active),
                    "steps": num_steps,
                    "tokens": sum(min(num_steps, s.remaining)
                                  for s in active),
                    "free_pages": alloc.available(),
                    "retained_pages": alloc.retained_pages,
                    "occupancy": round(self.page_occupancy(), 4),
                    "admitted": self.scheduler.admitted,
                    "retired": self.scheduler.retired,
                    "queue_depth": self.scheduler.queue_depth(),
                    "prefix_hits": (self.prefix.hits
                                    if self.prefix is not None else 0),
                })
        for s in active:
            # Every live slot waited this whole slice — that IS its
            # decode share (per-request attribution, engine_request).
            s.decode_s += t_slice
        for s in active:
            take = min(num_steps, s.remaining)
            for k in range(take):
                if s.done:
                    break  # post-EOS steps are latched padding
                s.steps_done += 1
                self._emit_token(s, int(out[s.index, k]))
                self._m_inter.observe(per_token)
            s.write_pos += num_steps
            s.last_token = int(last_tok[s.index])
            if s.done:
                self._retire(s, "eos")
            elif s.remaining == 0:
                self._retire(s, "budget")

    def _run_spec_slice(self) -> None:
        """One speculative round over the decode batch: k + 1 draft
        steps (the dense draft cache) and ONE batched verifier forward
        over every slot's ``[t0, d1..dk]``, then accept the agreeing
        prefix. Emits ``min(accepts + 1, remaining)`` tokens a slot for
        one verifier weight read. The targets come from the verifier's
        own logits under the slot's own step keys, so the stream is the
        vanilla slice's whatever the drafts were. Speculated K/V past the
        accepted length rolls back through ``truncate_slot``
        (reservation-safe), keeping the write_pos / steps_done alignment
        the vanilla path keeps."""
        active = self.scheduler.decoding_slots()
        k = self.config.speculate_tokens
        steps = k + 1
        n = self.config.num_slots
        for s in active:
            s.allocated_pages = self.kv.extend_slot(
                s.index, s.allocated_pages, s.write_pos + steps,
                s.budget_pages)
        tokens = np.zeros((n,), np.int32)
        wpos = np.zeros((n,), np.int32)
        pads = np.zeros((n,), np.int32)
        done = np.ones((n,), bool)  # inactive rows ride latched
        rngs = np.zeros((steps, n, 2), np.uint32)
        for s in active:
            tokens[s.index] = s.last_token
            wpos[s.index] = s.write_pos
            pads[s.index] = s.pad_len
            done[s.index] = s.done
            rngs[:, s.index] = SlotScheduler.slice_keys(s, steps)
        dev = self.device
        inputs = dict(tokens=tokens, write_pos=wpos, pad_lens=pads,
                      done=done, step_rngs=self._host_keys(rngs))
        t0 = time.monotonic()
        # The draft proposes with keys [0, k): key j is the key target
        # j + 1 is sampled with. All k + 1 keys go in; the last step only
        # writes K/V (see _draft_slice) and its proposal is dropped.
        drafts = self._program(
            ("spec_draft", f"steps={k} slots={n}"),
            functools.partial(_draft_proposals, self._draft_model,
                              self._draft_params, self._draft_cache,
                              num_steps=steps, **self._sample_kw),
            inputs)
        # Wait for the drafts, so draft wall and verify wall are
        # attributed apart (the spec_verify span).
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        t1 = time.monotonic()
        targets, accepts = self._program(
            ("spec_verify", f"width={steps} slots={n}"),
            functools.partial(_verify_slice, self._model, self._params,
                              self.kv.physical, **self._sample_kw),
            dict(inputs, tables=self.kv.device_tables(), drafts=drafts))
        targets = targets.cpu().numpy()
        accepts = accepts.cpu().numpy()
        t2 = time.monotonic()
        t_draft, t_verify = t1 - t0, t2 - t1
        t_round = t2 - t0
        self._slices += 1
        self._spec_rounds += 1
        self._note_compile("spec_draft", f"steps={k} slots={n}", t0,
                           t_draft)
        self._note_compile("spec_verify", f"width={steps} slots={n}", t1,
                           t_verify)
        round_drafted = round_accepted = round_emitted = 0
        for s in active:
            a = int(accepts[s.index])
            take = min(a + 1, s.remaining)
            used = take - 1  # drafted tokens that saved a forward
            round_drafted += k
            round_accepted += used
            s.spec_drafted += k
            s.spec_accepted += used
            s.draft_s += t_draft
            s.verify_s += t_verify
            s.decode_s += t_round
            per_token = t_round / take
            for j in range(take):
                if s.done:
                    break  # post-EOS targets are latched padding
                s.steps_done += 1
                self._emit_token(s, int(targets[s.index, j]))
                self._m_inter.observe(per_token)
                round_emitted += 1
            s.write_pos += take
            s.allocated_pages = self.kv.truncate_slot(
                s.index, s.allocated_pages, s.write_pos)
            s.last_token = int(targets[s.index, take - 1])
            if s.done:
                self._retire(s, "eos")
            elif s.remaining == 0:
                self._retire(s, "budget")
        self._spec_drafted_total += round_drafted
        self._spec_accepted_total += round_accepted
        self._m_spec_drafted.inc(round_drafted)
        self._m_spec_accepted.inc(round_accepted)
        self._m_spec_rejected.inc(round_drafted - round_accepted)
        self._token_est.observe(
            t_round / max(1.0, round_emitted / max(1, len(active))))
        if TRACER.enabled:
            alloc = self.kv.allocator
            TRACER.record(
                "engine_slice", "engine", t0, t_round, {
                    "model": self.name,
                    "slice": self._slices,
                    "slots": len(active),
                    "steps": steps,
                    "tokens": round_emitted,
                    "spec": True,
                    "drafted": round_drafted,
                    "accepted": round_accepted,
                    "draft_ms": round(t_draft * 1e3, 3),
                    "verify_ms": round(t_verify * 1e3, 3),
                    "free_pages": alloc.available(),
                    "retained_pages": alloc.retained_pages,
                    "occupancy": round(self.page_occupancy(), 4),
                    "admitted": self.scheduler.admitted,
                    "retired": self.scheduler.retired,
                    "queue_depth": self.scheduler.queue_depth(),
                    "prefix_hits": (self.prefix.hits
                                    if self.prefix is not None else 0),
                })
            # The spec_verify leg: the verifier-forward share of the
            # round, the half the attribution report splits out.
            TRACER.record(
                "spec_verify", "engine", t1, t_verify, {
                    "model": self.name,
                    "slice": self._slices,
                    "slots": len(active),
                    "width": steps,
                })

    def _retire(self, slot: Slot, reason: str,
                error: Optional[BaseException] = None) -> None:
        req = slot.request
        if slot.prefilling:
            # Mid-chunked-prefill death (deadline / cancel / error /
            # shutdown): no pages were adopted — the slot holds only
            # its reservation and the pinned prefix match (its fork
            # already unpinned and narrowed out at bind).
            match = slot.prefill_match
            shared = len(match.entries) if match is not None else 0
            if match is not None and self.prefix is not None:
                self.prefix.unpin(match, include_fork=False)
            self.kv.allocator.unreserve(slot.budget_pages - shared)
            slot.clear_prefill_state()
        else:
            self.kv.release_slot(
                slot.index, slot.allocated_pages,
                slot.budget_pages - slot.allocated_pages)
        self.scheduler.retire(slot, reason)
        _M_RETIRED.labels(self.name, reason).inc()
        if TRACER.enabled:
            extra = {}
            if slot.spec_drafted or slot.draft_s or slot.verify_s:
                # Draft vs verify split of the decode share, plus the
                # request's own acceptance economics.
                extra = dict(
                    draft_ms=round(slot.draft_s * 1e3, 3),
                    verify_ms=round(slot.verify_s * 1e3, 3),
                    spec_drafted=slot.spec_drafted,
                    spec_accepted=slot.spec_accepted)
            if req.kv_fetch_s:
                extra["kv_fetch_ms"] = round(req.kv_fetch_s * 1e3, 3)
            TRACER.record(
                "engine_request", "engine", req.submitted_at,
                time.monotonic() - req.submitted_at,
                self._span_args(
                    req, slot=slot.index, reason=reason,
                    tokens=slot.emitted,
                    # The per-request attribution triple (queue wait →
                    # a slot, prefill, decode-slice share).
                    queue_ms=round(slot.queue_s * 1e3, 3),
                    prefill_ms=round(slot.prefill_s * 1e3, 3),
                    decode_ms=round(slot.decode_s * 1e3, 3),
                    **extra))
        if error is not None:
            req.stream._fail(error)
            return
        tokens = req.stream.tokens_so_far
        if len(tokens) < req.max_new_tokens and \
                self.config.eos_id is not None:
            # Early EOS: pad to the request budget with the latched
            # EOS id — byte-for-byte the monolithic generate() shape.
            tokens = tokens + [self.config.eos_id] * (
                req.max_new_tokens - len(tokens))
        req.stream._finish(np.asarray(tokens, np.int32))

    def _span_args(self, req: _Request, **extra) -> dict:
        # span_args adds trace linkage (trace id + parent_id = the
        # transport hop's span id + leg); the capped tenant label lets
        # waterfalls filter by tenant.
        args = span_args(req.stream.obs_ctx, model=self.name, **extra)
        if req.request_id:
            args["request_id"] = req.request_id
        if req.tenant and req.tenant != tenancy.DEFAULT_TENANT:
            args.setdefault("tenant", tenancy.tenant_label(req.tenant))
        return args
