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

"""Slot bookkeeping for the continuous-batching engine.

The port's own copy of ``kubeflow_tpu/inference/engine/slots.py``.

Pure host-side state machine (no framework): N decode slots, a
weighted-fair admission queue (per-tenant sub-queues), and
reservation-aware admit/retire transitions. The engine thread is the
only mutator; :class:`SlotScheduler` exists separately from the
engine so the scheduling policy is unit-testable without compiling a
model.

Slot lifecycle::

    FREE --admit(prefill+adopt)--> ACTIVE --retire--> FREE
                                     |  (eos / token budget /
                                     |   deadline / cancel / error)

A slot's cache positions: ``[0, pad_len)`` left-pad garbage (masked),
``[pad_len, prompt_width)`` the prompt, ``[prompt_width, write_pos)``
decoded tokens; ``write_pos`` is where the NEXT token's K/V lands.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

from kubeflow_tpu_torch.serving.tenancy import FairQueue


@dataclasses.dataclass
class Slot:
    """One decode slot's host state."""

    index: int
    active: bool = False
    request: Any = None  # the engine's _Request
    write_pos: int = 0  # cache index the next token is written at
    pad_len: int = 0  # left-pad slots before the prompt
    prompt_width: int = 0  # prompt bucket width (pads + prompt)
    last_token: int = 0  # feeds the next decode step
    steps_done: int = 0  # step-rng indices consumed (incl. prefill's)
    emitted: int = 0  # tokens handed to the stream
    done: bool = False  # EOS latched
    allocated_pages: int = 0
    budget_pages: int = 0  # reservation ceiling (pages)
    deadline: Optional[float] = None
    # Latency attribution: where this request's wall time
    # went — queue wait before the slot, its prefill, and its share
    # of decode-slice wall (a slot waits the FULL slice whatever its
    # neighbors do). The engine_request span reports them as
    # queue_ms / prefill_ms / decode_ms.
    queue_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # Speculative-decode attribution: draft vs verify
    # share of this slot's decode wall, and its drafted/accepted
    # token counts — the engine_request span reports draft_ms /
    # verify_ms / spec acceptance alongside the queue/prefill/decode triple.
    draft_s: float = 0.0
    verify_s: float = 0.0
    spec_drafted: int = 0
    spec_accepted: int = 0
    # Chunked-prefill state: an admitted long prompt
    # occupies its slot while its prefill advances one page-aligned
    # chunk per engine lap, interleaved with decode slices. While
    # ``prefilling`` the slot is excluded from decode batches;
    # ``prefill_pos`` is the next prompt index to feed,
    # ``prefill_cache`` the accumulating B=1 contiguous cache, and
    # ``prefill_match`` the pinned prefix-cache match that must be
    # unpinned if the slot dies before adoption.
    prefilling: bool = False
    prefill_pos: int = 0
    prefill_cache: Any = None
    prefill_match: Any = None

    def clear_prefill_state(self) -> None:
        self.prefilling = False
        self.prefill_pos = 0
        self.prefill_cache = None
        self.prefill_match = None

    @property
    def max_new_tokens(self) -> int:
        return self.request.max_new_tokens

    @property
    def remaining(self) -> int:
        """Decode steps still owed (the prefill produced token 0)."""
        return max(0, self.max_new_tokens - self.steps_done)


class SlotScheduler:
    """Owns the N slots + the weighted-fair admission queue.

    Admission is strictly FIFO *within a tenant* (no head-of-line
    jumping inside a sub-queue: a large request that can't reserve
    pages yet blocks ITS tenant's later arrivals, which keeps tail
    fairness — the alternative starves big prompts forever) and
    weighted-fair *across* tenants (``pending`` is a
    :class:`~kubeflow_tpu_torch.serving.tenancy.FairQueue`: one tenant's
    burst cannot park work in front of another tenant's head; with a
    single tenant the drain order is bitwise the old global FIFO's).
    The page-pool reservation check lives here; the actual
    prefill/adopt device work stays in the engine.
    """

    #: Consecutive failed reservations of the SAME fair-first head
    #: after which admission holds the WHOLE line (no other tenant's
    #: head admits) so freed pages can accumulate for it. Skipping a
    #: blocked head avoids cross-tenant head-of-line blocking, but
    #: unbounded skipping would let a stream of small requests from
    #: OTHER tenants starve a large reservation forever — the exact
    #: liveness property the old global FIFO bought by always holding.
    #: This bounds the starvation window instead: ~threshold admission
    #: attempts (one per engine lap), then the classic hold applies
    #: until the head fits, expires, or cancels.
    STARVATION_HOLD_ATTEMPTS = 32

    def __init__(self, num_slots: int, allocator, *,
                 weight_of: Optional[Callable[[str], float]] = None):
        self.slots: List[Slot] = [Slot(i) for i in range(num_slots)]
        self._free: Deque[int] = deque(range(num_slots))
        self._allocator = allocator
        self.pending: FairQueue = FairQueue(weight_of=weight_of)
        self._blocked_head: Any = None
        self._blocked_count = 0
        # Monotonic counters for stats()/metrics.
        self.admitted = 0
        self.retired = 0
        self.retired_by: dict = {}

    # -- queries ---------------------------------------------------------

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.active]

    def decoding_slots(self) -> List[Slot]:
        """Active slots in the decode batch (a chunk-prefilling slot
        occupies a slot but has no first token yet)."""
        return [s for s in self.slots if s.active and not s.prefilling]

    def prefilling_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.active and s.prefilling]

    def occupancy(self) -> int:
        return len(self.slots) - len(self._free)

    def queue_depth(self) -> int:
        return len(self.pending)

    def tenant_depths(self) -> Dict[str, int]:
        """Queued requests per tenant — the attribution a queue-full
        shed carries so a 503 names the tenant that caused it."""
        return self.pending.tenant_depths()

    def has_free_slot(self) -> bool:
        return bool(self._free)

    def has_capacity_for(self, budget_pages: int) -> bool:
        return bool(self._free) and self._allocator.available() >= \
            budget_pages

    # -- transitions (engine thread only) --------------------------------

    def head_blocked(self, head: Any) -> bool:
        """Record one failed reservation for the FAIR-FIRST head.
        Returns True once the same head has failed
        ``STARVATION_HOLD_ATTEMPTS`` consecutive attempts — the
        caller must then hold the whole line (admit nobody) so freed
        pages accumulate for it instead of leaking to smaller
        requests from other tenants forever."""
        if self._blocked_head is head:
            self._blocked_count += 1
        else:
            self._blocked_head = head
            self._blocked_count = 1
        return self._blocked_count >= self.STARVATION_HOLD_ATTEMPTS

    def head_unblocked(self) -> None:
        self._blocked_head = None
        self._blocked_count = 0

    def holding_for_head(self) -> bool:
        """True while the starvation guard holds the line for a
        blocked fair-first head (introspection for stats/fuzz)."""
        return (self._blocked_head is not None
                and self._blocked_count
                >= self.STARVATION_HOLD_ATTEMPTS)

    def next_admittable(self, budget_pages_of) -> Optional[Any]:
        """Pop the first admittable tenant head in fair-queueing
        order iff a slot AND its reservation fit;
        ``budget_pages_of(request)`` prices the worst case. A head
        whose reservation doesn't fit holds the line for ITS tenant
        only (and is not charged fair-share, so it keeps first claim
        on freed pages); other tenants' heads still admit — no
        cross-tenant head-of-line blocking, BOUNDED by the
        starvation guard: once the same fair-first head has been
        skipped ``STARVATION_HOLD_ATTEMPTS`` times, the whole line
        holds (classic FIFO behavior) until it fits or leaves the
        queue. None = nothing admittable right now."""
        if not self.pending or not self._free:
            return None
        for i, head in enumerate(self.pending.heads()):
            if self._allocator.reserve(budget_pages_of(head)):
                if i == 0:
                    self.head_unblocked()
                self.pending.pop_head(head)
                return head
            if i == 0 and self.head_blocked(head):
                return None  # hold the line for the starving head
        return None

    def bind(self, request: Any, *, prompt_width: int, pad_len: int,
             first_token: int, done: bool, budget_pages: int,
             deadline: Optional[float]) -> Slot:
        """Attach an admitted (already prefilled) request to a free
        slot. The caller has already reserved ``budget_pages``."""
        slot = self.slots[self._free.popleft()]
        assert not slot.active, f"slot {slot.index} double-bound"
        slot.active = True
        slot.request = request
        slot.write_pos = prompt_width
        slot.pad_len = pad_len
        slot.prompt_width = prompt_width
        slot.last_token = int(first_token)
        slot.steps_done = 1  # the prefill consumed step key 0
        slot.emitted = 0
        slot.done = bool(done)
        slot.allocated_pages = 0
        slot.budget_pages = budget_pages
        slot.deadline = deadline
        slot.queue_s = 0.0  # slots are reused: attribution resets
        slot.prefill_s = 0.0
        slot.decode_s = 0.0
        slot.draft_s = 0.0
        slot.verify_s = 0.0
        slot.spec_drafted = 0
        slot.spec_accepted = 0
        slot.clear_prefill_state()
        self.admitted += 1
        return slot

    def bind_prefilling(self, request: Any, *, prefill_pos: int,
                        prefill_cache: Any, prefill_match: Any,
                        budget_pages: int,
                        deadline: Optional[float]) -> Slot:
        """Attach an admitted request whose prompt will prefill in
        page-aligned chunks ACROSS engine laps: the slot
        is occupied (it holds the reservation and, via
        ``prefill_match``, the pinned prefix pages) but joins no
        decode batch until :meth:`finish_prefill`. The caller has
        already reserved ``budget_pages`` minus the pinned shared
        pages."""
        slot = self.slots[self._free.popleft()]
        assert not slot.active, f"slot {slot.index} double-bound"
        slot.active = True
        slot.request = request
        slot.write_pos = 0
        slot.pad_len = 0
        slot.prompt_width = 0
        slot.last_token = 0
        slot.steps_done = 0
        slot.emitted = 0
        slot.done = False
        slot.allocated_pages = 0
        slot.budget_pages = budget_pages
        slot.deadline = deadline
        slot.queue_s = 0.0
        slot.prefill_s = 0.0
        slot.decode_s = 0.0
        slot.draft_s = 0.0
        slot.verify_s = 0.0
        slot.spec_drafted = 0
        slot.spec_accepted = 0
        slot.prefilling = True
        slot.prefill_pos = prefill_pos
        slot.prefill_cache = prefill_cache
        slot.prefill_match = prefill_match
        self.admitted += 1
        return slot

    @staticmethod
    def finish_prefill(slot: Slot, *, prompt_width: int,
                       first_token: int, done: bool) -> None:
        """Chunked prefill completed: the slot joins the decode batch
        with the same state :meth:`bind` would have set (pad-0
        layout; the prefill consumed step key 0)."""
        assert slot.prefilling, f"slot {slot.index} not prefilling"
        slot.write_pos = prompt_width
        slot.prompt_width = prompt_width
        slot.last_token = int(first_token)
        slot.steps_done = 1
        slot.done = bool(done)
        slot.clear_prefill_state()

    def retire(self, slot: Slot, reason: str) -> None:
        """Return the slot to the free pool. Page release is the
        engine's job (it owns the PagedKVCache); this only flips the
        host state so the pages/reservation numbers the engine reads
        off the slot are still intact when it releases them."""
        assert slot.active, f"slot {slot.index} retired twice"
        slot.active = False
        slot.request = None
        self._free.append(slot.index)
        self.retired += 1
        self.retired_by[reason] = self.retired_by.get(reason, 0) + 1

    # -- expiry ----------------------------------------------------------

    def expired_slots(self, now: Optional[float] = None) -> List[Slot]:
        now = time.monotonic() if now is None else now
        return [s for s in self.active_slots()
                if s.deadline is not None and s.deadline <= now]

    def expired_pending(self, now: Optional[float] = None) -> List[Any]:
        """Drop (and return) queued requests whose deadline lapsed
        before a slot ever freed up — they must never burn a prefill.
        ``FairQueue.remove_if`` rebuilds each sub-queue atomically
        under its own lock (fairness state survives the sweep), so a
        concurrently appended request can never be dropped — the
        locked-swap contract, now per sub-queue."""
        now = time.monotonic() if now is None else now
        return self.pending.remove_if(
            lambda req: req.deadline is not None
            and req.deadline <= now)

    # -- step-key helper -------------------------------------------------

    @staticmethod
    def slice_keys(slot: Slot, num_steps: int) -> np.ndarray:
        """The slot's per-step sampling keys for the next
        ``num_steps`` decode steps ([K, 2]); indices past the
        request's schedule clamp to the last key (those steps are
        overshoot — computed, discarded)."""
        keys = slot.request.step_keys
        idx = np.minimum(
            np.arange(slot.steps_done, slot.steps_done + num_steps),
            len(keys) - 1)
        return keys[idx]
