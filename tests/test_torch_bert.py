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

"""kubeflow_tpu_torch.models.bert and the mlm objective against the
reference.

``bert-test``, its params carried across from the reference's jitted
init, the same numpy-seeded inputs through both. Tolerances: MLM logits
1e-4 fp32 and 3e-2 bf16 (bf16 products and LayerNorm outputs rounded
in another order), with and without padded rows (the reference's
flash_attention takes blockwise_attention on the CPU, the port its
flash kernel's plain version); the mlm train step's loss 1e-5 relative
a step over 5; the tpu-lm CLI at ``--model bert-test`` the reference
CLI's losses at each logged step, 1e-3 relative, from the same init (the
CLI trains the registry's bf16 model: its bf16 products round apart,
about 1e-4 of the loss).
Twins of tests/test_lm.py's BERT cases.
"""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_training import (
    assert_close_to_reference,
    port_variables,
    reference_variables,
)
from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu.training.lm import LMState
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import apply
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.training import lm, optim
from kubeflow_tpu_torch.training.benchmark import lm_train_flops
from kubeflow_tpu_torch.training.data import synthetic_mlm
from kubeflow_tpu_torch.training.pretrain import main as pretrain_main

VOCAB = 512
L = 16
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_RTOL = 1e-5
CLI_RTOL = 1e-3
SHAPES = [((1, L), jnp.int32), ((1, L), jnp.int32), ((1, L), jnp.int32)]


def _inputs(seed, padded, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, VOCAB, (b, L)).astype(np.int32)
    types = (np.arange(L)[None] >= L // 2).astype(np.int32).repeat(b, 0)
    valid = np.ones((b, L), np.int32)
    if padded:
        valid[1, 11:] = 0
        valid[2, 5:] = 0
    return ids, types, valid


def _pair(dtype="float32", seed=0):
    ref, variables = reference_variables("bert-test", SHAPES, seed=seed,
                                         dtype=getattr(jnp, dtype))
    model, params, _ = port_variables("bert-test", variables, dtype=dtype)
    return ref, variables, model, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
def test_mlm_logits_match_the_reference(dtype, padded):
    ref, variables, model, params = _pair(dtype)
    ids, types, valid = _inputs(1, padded)
    ref_logits = np.asarray(ref.apply(variables, ids, types, valid),
                            np.float32)
    logits = apply(model, params, *(torch.from_numpy(a)
                                    for a in (ids, types, valid)))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits,
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_valid_none_stays_none_and_equals_all_ones():
    ref, variables, model, params = _pair()
    ids, _, valid = _inputs(2, False)
    seen = []

    def spy(q, k, v, kv_segment_valid=None):
        seen.append(kv_segment_valid)
        from kubeflow_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, kv_segment_valid=kv_segment_valid)

    spied = get_model("bert-test").make(dtype="float32", attention_fn=spy)
    out = apply(spied, params, torch.from_numpy(ids))
    assert seen == [None, None]
    ones = apply(model, params, torch.from_numpy(ids), None,
                 torch.from_numpy(valid))
    np.testing.assert_allclose(out.detach().numpy(), ones.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(ref.apply(variables, ids)),
        atol=TOL["float32"], rtol=TOL["float32"])


def _mlm_batches(n, seed=3):
    gen = synthetic_mlm(4, L, VOCAB, seed=seed)
    out = []
    for i, batch in enumerate(gen):
        batch["valid"][i % 4, L - 3 - i:] = 0  # a padded row a batch
        out.append(batch)
        if len(out) == n:
            return out


def test_mlm_train_step_tracks_the_reference():
    ref, variables, model, params = _pair(seed=1)
    tx_ref = optax.adamw(1e-3)
    ref_state = LMState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        opt_state=tx_ref.init(variables["params"]),
                        apply_fn=ref.apply, tx=tx_ref)
    ref_step = jlm.make_lm_train_step(None, None, objective="mlm",
                                      donate=False)
    state, _ = lm.create_lm_state(model, optim.adamw(1e-3), params)
    step = lm.make_lm_train_step(objective="mlm")
    for i, batch in enumerate(_mlm_batches(5)):
        ref_state, ref_m = ref_step(ref_state, batch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["accuracy"]),
                                   float(ref_m["accuracy"]), atol=1e-6)
    assert_close_to_reference(state, ref_state, ("params",), 1e-4)


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_tpu_lm_cli_at_bert_matches_the_reference_cli(tmp_path, capsys,
                                                      monkeypatch):
    from kubeflow_tpu.training.pretrain import main as jax_pretrain_main

    args = ["--model", "bert-test", "--global_batch", "8", "--seq_len",
            str(L), "--steps", "4", "--log_every", "1", "--seed", "2"]
    jax_pretrain_main(args + ["--metrics_path", str(tmp_path / "ref.jsonl")])
    ref_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # The reference CLI initialises from PRNGKey(seed) over its stream's
    # first batch; the port carries that init across.
    first = next(synthetic_mlm(8, L, VOCAB, seed=2))
    init = jax.jit(jax_get_model("bert-test").make().init)(
        jax.random.PRNGKey(2), first["input_ids"], first["type_ids"],
        first["valid"])
    carried = convert.flatten_tree(nn.meta.unbox(init["params"]))
    monkeypatch.setattr(
        convert, "init_params",
        lambda model, seed=0, device=None, dtype=None:
        convert.params_from_flax(carried, model, device=device))
    assert pretrain_main(args + ["--device", "cpu", "--metrics_path",
                                 str(tmp_path / "port.jsonl")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == ref_out["model"] == "bert-test"
    assert out["objective"] == ref_out["objective"] == "mlm"
    assert out["final_step"] == ref_out["final_step"] == 4
    ref_losses = [r["loss"] for r in _metrics(tmp_path / "ref.jsonl")]
    losses = [r["loss"] for r in _metrics(tmp_path / "port.jsonl")]
    assert len(losses) == len(ref_losses) == 4
    np.testing.assert_allclose(losses, ref_losses, rtol=CLI_RTOL)


def test_bert_flops_formula_counts_the_tied_head_and_two_mlp_weights():
    model = get_model("bert-test").make()
    b, l, d, f, v = 2, 16, 64, 128, VOCAB
    t = b * l
    forward = (2 * t * 4 * d * d * 2 + 2 * t * d * f * 2 * 2
               + 2 * t * d * (v + d) + 4 * b * 4 * l * l * 16 * 2)
    assert lm_train_flops(model, b, l) == 3 * forward


def test_served_bert_predict_equals_the_reference(tmp_path):
    """A reference export of bert-test served by the port's
    ``load_version``: predict on ``input_ids`` alone (``type_ids`` and
    ``valid`` None, as the reference's ``module.apply(variables, x,
    train=False)``) within the fp32 logits tolerance."""
    from kubeflow_tpu.serving.export import export_model as jax_export
    from kubeflow_tpu.serving.model import load_version as jax_load
    from kubeflow_tpu.serving.signature import ModelMetadata as JaxMeta
    from kubeflow_tpu_torch.serving.model import load_version
    from kubeflow_tpu_torch.serving.signature import (
        ModelMetadata,
        Signature,
        TensorSpec,
    )

    meta = ModelMetadata(
        model_name="bert", registry_name="bert-test",
        model_kwargs={"dtype": "float32"},
        signatures={"serving_default": Signature(
            method="predict",
            inputs={"input_ids": TensorSpec("int32", (-1, L))},
            outputs={"logits": TensorSpec("float32", (-1, L, VOCAB))})})
    ref_model = jax_get_model("bert-test").make(dtype=jnp.float32)
    variables = jax.jit(ref_model.init)(jax.random.PRNGKey(3),
                                        jnp.zeros((1, L), jnp.int32))
    jax_export(str(tmp_path), 1, JaxMeta.loads(meta.dumps()), variables)
    ids, _, _ = _inputs(4, False, b=2)
    want = jax_load(str(tmp_path / "1")).run({"input_ids": ids})["logits"]
    got = load_version(str(tmp_path / "1"), device="cpu").run(
        {"input_ids": ids})["logits"]
    np.testing.assert_allclose(got, want, atol=TOL["float32"],
                               rtol=TOL["float32"])
