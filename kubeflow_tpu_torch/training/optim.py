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


"""The optimizers of the LM trainers, with optax's semantics.

The port's copy of the part of optax the reference's LM trainers use:
``adamw``, ``sgd`` (without momentum), ``chain``, ``clip_by_global_norm``,
``global_norm``, ``apply_updates`` and the schedules behind
``warmup_cosine_decay_schedule``. ``torch.optim`` is not used: its
defaults and update differ from optax's (``AdamW``'s weight decay is
1e-2 and is applied to the params before the Adam step; optax's is
1e-4, added to the Adam direction and scaled by the scheduled rate with
it), and so does ``clip_grad_norm_`` (it divides by ``norm + 1e-6``).
What the reference computes, this computes, op for op:

- ``scale_by_adam``: ``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² +
  b2·nu``, a count from 0 incremented before the bias corrections
  ``1 - b^count`` (in fp32), ``u = mu_hat / (sqrt(nu_hat + eps_root) +
  eps)``; moments in the param's dtype;
- ``add_decayed_weights``: ``u + wd·p`` over every param (no mask);
- the learning rate: ``-lr·u``; a schedule is read at its own count,
  which also starts at 0, so the first update uses ``schedule(0)``;
- ``clip_by_global_norm``: ``t / ‖g‖ · max_norm`` where ``‖g‖ >=
  max_norm``, else ``t``.

A tree is a dict of tensors keyed by the port's parameter names. A
state mirrors optax's: a ``chain`` is a tuple of its members' states,
``ScaleByAdamState(count, mu, nu)`` and the rest are named tuples with
optax's field names, so a state flattens to optax's tree paths
(``opt_state/0/mu/...``; models/convert.py). Counts are host ints, so a
step never waits on the device for them, and schedules are evaluated
on the host in float32, as XLA evaluates them.

Unlike optax, ``update`` works in place where it can: the moments are
updated in place, and the ``updates`` dict it is given (the gradients,
which the caller hands over) has its tensors replaced or overwritten.
That keeps a step's optimizer memory at the moments plus one leaf's
temporaries, where a functional update would hold a second copy of
every moment.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], np.float32]
ScalarOrSchedule = Union[float, Schedule]

_INT32_MAX = 2 ** 31 - 1


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params) ->
    (updates, state)``, as optax's."""

    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Optional[Params]], Tuple[Params, Any]]


class EmptyState(NamedTuple):
    """A transformation with no state (optax's ``EmptyState``)."""


class ScaleByAdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


class ScaleByScheduleState(NamedTuple):
    count: int


def _increment(count: int) -> int:
    """optax's ``safe_increment`` on an int32 count."""
    return min(count + 1, _INT32_MAX)


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (a tensor op then
    applies exactly that value)."""
    return float(np.float32(x))


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


_NORM: contextvars.ContextVar = contextvars.ContextVar("global_norm",
                                                       default=None)


@contextlib.contextmanager
def norm_over(fn: Callable[[Params], torch.Tensor]) -> Iterator[None]:
    """Inside the block :func:`global_norm` (and so
    :func:`clip_by_global_norm`) is ``fn``: a mesh trainer's norm of
    leaves held as shards (``parallel/collectives.py``)."""
    token = _NORM.set(fn)
    try:
        yield
    finally:
        _NORM.reset(token)


def global_norm(updates: Params) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ x²)``, a 0-d tensor on the leaves' device (or
    the norm :func:`norm_over` sets)."""
    sharded = _NORM.get()
    if sharded is not None:
        return sharded(updates)
    total = None
    for x in updates.values():
        s = (x * x).sum()
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(0, _zeros_like(params), _zeros_like(params))

    def update(updates, state, params=None):
        del params
        count = _increment(state.count)
        bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(count))
        for k, g in updates.items():
            mu, nu = state.mu[k], state.nu[k]
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_((g * g).mul_(1 - b2))
            denom = nu / bc2
            if eps_root:
                denom.add_(eps_root)
            denom.sqrt_().add_(eps)
            updates[k] = (mu / bc1).div_(denom)
        return updates, ScaleByAdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update(updates, state, params):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        for k, u in updates.items():
            u.add_(params[k] * weight_decay)
        return updates, state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        for u in updates.values():
            u.mul_(step_size)
        return updates, state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    def update(updates, state, params=None):
        step_size = _f32(step_size_fn(state.count))
        for u in updates.values():
            u.mul_(step_size)
        return updates, ScaleByScheduleState(_increment(state.count))

    return GradientTransformation(lambda params: ScaleByScheduleState(0),
                                  update)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule
                           ) -> GradientTransformation:
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-learning_rate)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None:
                                  (updates, state))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        # t / 1 * 1 is t: one in-place pass gives select(trigger, t,
        # t / g_norm * max_norm) without a host sync.
        div = torch.where(trigger, torch.ones_like(g_norm), g_norm)
        mul = torch.where(trigger, torch.ones_like(g_norm),
                          torch.full_like(g_norm, max_norm))
        for u in updates.values():
            u.div_(div).mul_(mul)
        return updates, state

    return GradientTransformation(lambda params: EmptyState(), update)


def adamw(learning_rate: ScalarOrSchedule, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw`` with its defaults (mask None, mu in the param's
    dtype): chain(scale_by_adam, add_decayed_weights,
    scale_by_learning_rate)."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate: ScalarOrSchedule) -> GradientTransformation:
    """``optax.sgd`` without momentum: chain(identity,
    scale_by_learning_rate)."""
    return chain(identity(), scale_by_learning_rate(learning_rate))


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """``p + u`` in the param's dtype, in place."""
    for k, u in updates.items():
        params[k].add_(u)
    return params


# -- schedules (float32 on the host) ----------------------------------------

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    """optax's ``linear_schedule`` (its polynomial schedule at power 1)."""
    transition_begin = max(transition_begin, 0)

    def schedule(count: int) -> np.float32:
        if transition_steps <= 0:
            return np.float32(init_value)
        c = min(max(count - transition_begin, 0), transition_steps)
        frac = np.float32(1) - np.float32(c) / np.float32(transition_steps)
        return (np.float32(init_value - end_value) * frac
                + np.float32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"the cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}")

    def schedule(count: int) -> np.float32:
        c = np.float32(min(float(count), float(decay_steps)))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps)))
        decayed = (np.float32(1 - alpha) * cosine ** np.float32(exponent)
                   + np.float32(alpha))
        return np.float32(init_value) * decayed

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    def schedule(step: int) -> np.float32:
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return np.float32(out)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` at
    ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha, exponent)],
        [warmup_steps])
