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

"""kubeflow_tpu_torch.training.optim against optax, update by update.

The same seeded tree of params and 20 seeded gradient trees go through
each optax transformation the reference's trainers use and through the
port's: params and moments within 1e-6 after every update (fp32; the
bias corrections' powers and the schedules' cosines come from another
math library than XLA's, a few ulps apart). The flat state keys are
optax's tree paths.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.training.checkpoint import flatten_state as jax_flatten
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.training import optim

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"dense/w": (6, 5), "dense/b": (5,), "scale": (7,),
          "emb/table": (9, 4)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return out


PAIRS = {
    "adamw": (lambda: optax.adamw(1e-2),
              lambda: optim.adamw(1e-2)),
    "adamw_wd_eps_root": (
        lambda: optax.adamw(3e-3, b1=0.8, b2=0.95, eps=1e-6,
                            eps_root=1e-9, weight_decay=0.05),
        lambda: optim.adamw(3e-3, b1=0.8, b2=0.95, eps=1e-6,
                            eps_root=1e-9, weight_decay=0.05)),
    "pretrain_chain": (
        lambda: optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adamw(optax.schedules.warmup_cosine_decay_schedule(
                0.0, 1e-2, 4, 20), weight_decay=0.01)),
        lambda: optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(optim.warmup_cosine_decay_schedule(
                0.0, 1e-2, 4, 20), weight_decay=0.01))),
    "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_twenty_updates_match_optax(name):
    make_ref, make_port = PAIRS[name]
    rng = np.random.RandomState(0)
    init = _tree(rng)
    ref_tx, tx = make_ref(), make_port()
    ref_params = _nest(init)
    ref_state = ref_tx.init(ref_params)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    state = tx.init(params)
    for i in range(20):
        # Large gradients now and then, so the clip triggers.
        grads = _tree(rng, scale=3.0 if i % 3 == 0 else 0.1)
        updates, ref_state = ref_tx.update(_nest(grads), ref_state,
                                           ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        updates, state = tx.update(
            {k: torch.from_numpy(v.copy()) for k, v in grads.items()},
            state, params)
        optim.apply_updates(params, updates)
        ref_flat = flatten_dict(ref_params, sep="/")
        for k in SHAPES:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(ref_flat[k]), **TOL,
                                       err_msg=f"{name} update {i}: {k}")
    ref_state_flat, _ = jax_flatten({"opt_state": ref_state})
    port_flat = convert.state_to_flax({"opt_state": state})
    assert set(port_flat) == set(ref_state_flat)
    for k, v in ref_state_flat.items():
        np.testing.assert_allclose(np.asarray(port_flat[k]), np.asarray(v),
                                   **TOL, err_msg=k)


def test_schedules_match_optax():
    pairs = [
        (optax.schedules.warmup_cosine_decay_schedule(0.0, 1e-4, 2, 10),
         optim.warmup_cosine_decay_schedule(0.0, 1e-4, 2, 10)),
        (optax.schedules.warmup_cosine_decay_schedule(1e-5, 3e-4, 5, 40,
                                                      end_value=1e-6,
                                                      exponent=2.0),
         optim.warmup_cosine_decay_schedule(1e-5, 3e-4, 5, 40,
                                            end_value=1e-6, exponent=2.0)),
        (optax.linear_schedule(1.0, 0.1, 7, transition_begin=3),
         optim.linear_schedule(1.0, 0.1, 7, transition_begin=3)),
        (optax.cosine_decay_schedule(2.0, 9, alpha=0.1),
         optim.cosine_decay_schedule(2.0, 9, alpha=0.1)),
    ]
    for ref, port in pairs:
        for count in range(0, 50):
            np.testing.assert_allclose(float(port(count)),
                                       float(ref(jnp.int32(count))),
                                       rtol=1e-6, atol=1e-12)
    # The pretrain CLI's first update runs at schedule(0) = 0.
    assert float(optim.warmup_cosine_decay_schedule(0.0, 1e-4, 2, 10)(0)) \
        == 0.0


def test_clip_by_global_norm_is_optax_not_clip_grad_norm():
    """optax divides by the norm itself (clip_grad_norm_ by norm +
    1e-6) and leaves a tree under the limit untouched."""
    g = {"a": torch.tensor([3.0, 4.0])}  # norm 5
    updates, _ = optim.clip_by_global_norm(1.0).update(
        {"a": g["a"].clone()}, optim.EmptyState())
    ref, _ = optax.clip_by_global_norm(1.0).update(
        {"a": jnp.asarray([3.0, 4.0])}, optax.EmptyState())
    np.testing.assert_array_equal(updates["a"].numpy(), np.asarray(ref["a"]))
    small = {"a": torch.tensor([0.3, 0.4])}
    out, _ = optim.clip_by_global_norm(1.0).update(
        {"a": small["a"].clone()}, optim.EmptyState())
    assert torch.equal(out["a"], small["a"])
    np.testing.assert_allclose(
        float(optim.global_norm({"a": g["a"], "b": torch.ones(3)})),
        float(optax.global_norm({"a": jnp.asarray([3.0, 4.0]),
                                 "b": jnp.ones(3)})), rtol=1e-7)


def test_adamw_defaults_are_optax_defaults():
    """weight_decay 1e-4 (torch's AdamW: 1e-2), the decay scaled by the
    rate with the Adam direction; the first update's count is 1."""
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    tx = optim.adamw(0.1)
    state = tx.init(p)
    updates, state = tx.update({"w": g["w"].clone()}, state, p)
    ref_tx = optax.adamw(0.1)
    ref_p = {"w": jnp.asarray([1.0, -2.0])}
    ref_u, ref_state = ref_tx.update({"w": jnp.asarray([0.5, 0.5])},
                                     ref_tx.init(ref_p), ref_p)
    np.testing.assert_allclose(updates["w"].numpy(), np.asarray(ref_u["w"]),
                               rtol=1e-7)
    assert state[0].count == int(ref_state[0].count) == 1
    # In the param's dtype, as optax keeps its moments.
    assert state[0].mu["w"].dtype == torch.float32
