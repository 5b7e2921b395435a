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

"""Gradient accumulation in kubeflow_tpu_torch.training.lm, against the
reference's and against the full batch.

Twins of tests/test_lm.py's ``test_grad_accum_*``: ``llama-test`` fp32
from the reference's init, one SGD step, ``grad_accum`` 1 and 2 (and an
indivisible batch). Token-weighted microbatches give the full-batch
gradient, so 2 equals 1 and both equal the reference's, within 1e-5
(fp32 sums in another order).
"""

import numpy as np
import optax
import pytest

from _torch_training import assert_close_to_reference, ids, lm_pair
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu_torch.training import lm, optim


def test_grad_accum_matches_the_reference_and_the_full_batch():
    batch = {"input_ids": ids(3, b=8, l=32)}
    out = {}
    for n in (1, 2):
        ref_state, params, model = lm_pair(optax.sgd(0.1))
        ref_step = jlm.make_lm_train_step(None, None, donate=False,
                                          grad_accum=n)
        ref_state, ref_m = ref_step(ref_state, batch)
        state, _ = lm.create_lm_state(model, optim.sgd(0.1), params)
        state, m = lm.make_lm_train_step(grad_accum=n)(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5)
        assert_close_to_reference(state, ref_state, ("params",), 1e-5)
        out[n] = (state, m)
    np.testing.assert_allclose(float(out[2][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    for k, v in out[1][0].params.items():
        np.testing.assert_allclose(out[2][0].params[k].detach().numpy(),
                                   v.detach().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_grad_accum_exact_for_uneven_weights():
    """Microbatches whose token weights differ 6x (mlm masks on a
    Llama, as the reference's lm_targets allows) still give the
    full-batch gradient, and the reference's."""
    b, l = 8, 32
    rng = np.random.default_rng(0)
    weights = np.zeros((b, l), np.int32)
    weights[:4, :12] = 1
    weights[4:, :2] = 1
    batch = {"input_ids": ids(5, b, l),
             "mlm_labels": rng.integers(0, 512, (b, l)).astype(np.int32),
             "mlm_weights": weights}
    runs = {}
    for n in (1, 2):
        ref_state, params, model = lm_pair(optax.sgd(0.1))
        ref_state, ref_m = jlm.make_lm_train_step(
            None, None, objective="mlm", donate=False,
            grad_accum=n)(ref_state, batch)
        state, _ = lm.create_lm_state(model, optim.sgd(0.1), params)
        state, m = lm.make_lm_train_step(objective="mlm", grad_accum=n)(
            state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["accuracy"]),
                                   float(ref_m["accuracy"]), atol=1e-6)
        assert_close_to_reference(state, ref_state, ("params",), 1e-5)
        runs[n] = state
    for k, v in runs[1].params.items():
        np.testing.assert_allclose(runs[2].params[k].detach().numpy(),
                                   v.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_grad_accum_rejects_indivisible_batch():
    _, params, model = lm_pair(optax.sgd(0.1))
    state, _ = lm.create_lm_state(model, optim.sgd(0.1), params)
    step = lm.make_lm_train_step(grad_accum=4)
    with pytest.raises(ValueError, match="grad_accum"):
        step(state, {"input_ids": ids(0, b=6, l=16)})
