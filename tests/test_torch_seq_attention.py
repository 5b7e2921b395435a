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

"""The seq axis: ring and Ulysses attention, and the trainers on a seq
mesh, in a 4-rank gloo gang against the reference.

Twins of ``tests/test_attention.py``'s sequence-parallel cases (ring and
Ulysses, causal and not, a padding mask, the ring with heads on
``tensor``), of the BERT ring cases of ``tests/test_lm.py`` and
``tests/test_flash_attention.py`` (the port's ring model against the
reference's dense model, as those tests hold the reference's ring
model), and of the LM step on ``data=2, seq=2``. One gang of four ranks runs every case (``_torch_gang.py``);
the reference runs in this process at its own meshes on its virtual CPU
devices, and both sides take the same numpy inputs. The port runs the
reference's ``data=2, seq=4`` cases on ``data=2, seq=2`` and on
``seq=4``, and its ``seq=4, tensor=2`` case on ``seq=2, tensor=2``.
Tolerances: the output within the reference's 2e-5 (BERT: its 2e-2 in
bf16, 2e-4 in fp32); the gradients of ``sum(out²)`` against
``jax.grad`` of the reference within 5e-4 (the reference's flash
gradient tolerance); the LM step's loss and grad norm within 1e-4, its
state within 5e-4, and the seq ranks of one data row bitwise equal.
"""

import concurrent.futures
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from _torch_gang import run_gang
from _torch_training import VOCAB, flat, reference_flat_state
from kubeflow_tpu.models.bert import bert_test as jax_bert_test
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.parallel.mesh import MeshSpec, batch_sharding, build_mesh
from kubeflow_tpu.parallel.ring_attention import (
    make_sequence_parallel_attention as jax_sp_attention,
)
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu_torch.parallel.mesh import Mesh, MeshSpec as PortSpec
from kubeflow_tpu_torch.parallel.ring_attention import (
    make_sequence_parallel_attention,
    ulysses_attention,
)

ATOL = 2e-5
GRAD_TOL = 5e-4
LOSS_RTOL = 1e-4
PARAM_TOL = 5e-4
STEPS = 3

#: The port's meshes for the reference's data=2, seq=4 cases.
PORT_MESHES = {"data2-seq2": {"data": 2, "seq": 2}, "seq4": {"seq": 4}}


def make_qkv(seed, b=2, l=64, h=4, d=16, kv_heads=None):
    """q, k, v from a numpy seed: both sides take these arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, h, d), np.float32)
    k = rng.standard_normal((b, l, kv_heads or h, d), np.float32)
    v = rng.standard_normal((b, l, kv_heads or h, d), np.float32)
    return q, k, v


def _pad_mask(seed, b, l):
    """A 0/1 padding mask with at least one valid key a row."""
    lengths = np.random.default_rng(seed).integers(1, l + 1, b)
    return (np.arange(l)[None, :] < lengths[:, None]).astype(np.int32)


def reference_attention(spec, devices, combos, qkv, mask, head_axis=None):
    """A thunk of the reference's sequence-parallel output and
    ``jax.grad`` of ``sum(out²)`` in q, k, v for each (strategy, causal)
    of ``combos`` on one mesh and inputs (one compiled program):
    {(strategy, causal): (out, grads)}."""
    def run():
        mesh = build_mesh(MeshSpec(**spec), jax.devices()[:devices])
        kw = {} if head_axis == "tensor" else {"head_axis": head_axis}

        def loss(fn, q, k, v):
            out = fn(q, k, v, kv_segment_valid=mask)
            return jnp.sum(out ** 2), out

        def all_combos(q, k, v):
            return {combo: jax.value_and_grad(
                functools.partial(loss, jax_sp_attention(
                    mesh, strategy=combo[0], causal=combo[1], **kw)),
                argnums=(0, 1, 2), has_aux=True)(q, k, v)
                for combo in combos}

        got = jax.jit(all_combos)(*qkv)
        return {combo: (np.asarray(out), [np.asarray(g) for g in grads])
                for combo, ((_, out), grads) in got.items()}
    return run


def attention_cases():
    """name → ((reference thunk, its combo), the port's case)."""
    out = {}

    def add(name, port_spec, strategy, causal, qkv, mask, ref,
            head_axis=None):
        q, k, v = (np.asarray(t) for t in qkv)
        out[name] = ((ref, (strategy, causal)), {
            "name": name, "kind": "attn", "spec": port_spec,
            "strategy": strategy, "causal": causal, "head_axis": head_axis,
            "q": q, "k": k, "v": v,
            "mask": None if mask is None else np.asarray(mask)})

    both = [(s, c) for s in ("ring", "ulysses") for c in (False, True)]
    qkv = make_qkv(2, b=4, l=128, h=4, d=8)
    ref = reference_attention({"data": 2, "seq": 4}, 8, both, qkv, None)
    for strategy, causal in both:
        for mesh, spec in PORT_MESHES.items():
            add(f"{strategy}-{causal}-{mesh}", spec, strategy, causal, qkv,
                None, ref)
    qkv = make_qkv(3, b=2, l=64, h=4, d=8)
    ref = reference_attention({"seq": 4, "tensor": 2}, 8, [("ring", True)],
                              qkv, None, head_axis="tensor")
    add("ring-tensor", {"seq": 2, "tensor": 2}, "ring", True, qkv, None,
        ref, head_axis="tensor")
    qkv = make_qkv(7, b=4, l=128, h=4, d=8)
    mask = _pad_mask(8, 4, 128)
    combos = [("ring", False), ("ulysses", False)]
    ref = reference_attention({"data": 2, "seq": 4}, 8, combos, qkv, mask)
    for strategy, _ in combos:
        add(f"{strategy}-mask", {"data": 2, "seq": 2}, strategy, False, qkv,
            mask, ref)
    # GQA: k and v un-repeated (as a Llama hands them over), their heads
    # split over seq as the reference splits them.
    qkv = make_qkv(11, b=2, l=64, h=8, d=8, kv_heads=4)
    combos = [("ring", True), ("ulysses", True)]
    ref = reference_attention({"data": 2, "seq": 4}, 8, combos, qkv, None)
    for strategy, _ in combos:
        add(f"{strategy}-gqa", {"data": 2, "seq": 2}, strategy, True, qkv,
            None, ref)
    return out


def bert_cases():
    """The BERT ring cases (tests/test_lm.py:138 in its default dtype,
    tests/test_flash_attention.py:136 in fp32 with a padded row): name
    → (thunk of the reference's dense model's output, which those tests
    hold the reference's ring model to, at their tolerance; tolerance;
    the port's case)."""
    out = {}
    rng = np.random.default_rng(0)
    for name, kw, port_kw, ids, valid, tol in (
            ("bert-default", {}, {}, rng.integers(0, 512, (4, 32)), None,
             2e-2),
            ("bert-fp32-padded", {"dtype": jnp.float32},
             {"dtype": "float32"}, rng.integers(0, 512, (2, 64)),
             (np.arange(64)[None, :] < np.array([[37], [64]])).astype(
                 np.int32), 2e-4)):
        ids = ids.astype(np.int32)
        dense = jax_bert_test(**kw)
        params = nn.meta.unbox(jax.jit(dense.init)(jax.random.PRNGKey(1),
                                                   ids)["params"])

        def run(dense=dense, params=params, ids=ids, valid=valid):
            return np.asarray(jax.jit(dense.apply)(
                {"params": params}, ids, None, valid), np.float32)

        out[name] = (run, tol, {
            "name": name, "kind": "bert", "spec": {"data": 2, "seq": 2},
            "kwargs": port_kw, "params": flat(params),
            "ids": np.asarray(ids),
            "valid": None if valid is None else np.asarray(valid)})
    return out


def lm_case():
    """The reference's LM step on ``data=2, seq=2`` (``llama-test`` fp32,
    ``adamw(1e-3)``): a thunk of its metrics and final state, and the
    port's case."""
    mesh = build_mesh(MeshSpec(data=2, seq=2), jax.devices()[:4])
    rng = np.random.default_rng(5)
    batches = [{"input_ids": rng.integers(0, VOCAB, (4, 32)).astype(
        np.int32)} for _ in range(STEPS)]
    state, sh = jlm.create_lm_state(jax_llama_test(dtype=jnp.float32),
                                    optax.adamw(1e-3), jax.random.PRNGKey(1),
                                    batches[0], mesh)
    case = {"name": "lm-data2-seq2", "kind": "lm",
            "spec": {"data": 2, "seq": 2}, "env": {}, "model": "llama-test",
            "kwargs": {"dtype": "float32"}, "objective": "causal",
            "params": flat(state.params), "lora": None, "tx": "adamw",
            "batches": batches}

    def run(state=state):
        step = jlm.make_lm_train_step(mesh, sh, donate=False)
        metrics = []
        for batch in batches:
            state, m = step(state, jax.device_put(batch,
                                                  batch_sharding(mesh)))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, reference_flat_state(state, ("step", "params",
                                                     "opt_state"))
    return run, case


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang runs (in a thread: it waits on its processes) while this
    process computes the reference's side."""
    attn, bert, (lm_run, lm) = attention_cases(), bert_cases(), lm_case()
    cases = [c for _, c in attn.values()] + [c for *_, c in bert.values()]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_gang, "seq", cases + [lm],
                            tmp_path_factory.mktemp("gang-seq"), world=4)
        refs = {}
        for (run, _), _ in attn.values():
            if run not in refs:
                refs[run] = run()
        attn = {name: refs[run][combo]
                for name, ((run, combo), _) in attn.items()}
        bert = {name: (run(), tol) for name, (run, tol, _) in bert.items()}
        metrics, state = lm_run()
        return attn, bert, (metrics, state, lm), ranks.result()


ATTN_NAMES = ([f"{s}-{c}-{m}" for s in ("ring", "ulysses")
               for c in (False, True) for m in PORT_MESHES]
              + ["ring-tensor", "ring-mask", "ulysses-mask", "ring-gqa",
                 "ulysses-gqa"])


@pytest.mark.parametrize("name", ATTN_NAMES)
def test_sequence_parallel_output_matches_the_reference(gang, name):
    attn, _, _, ranks = gang
    want, _ = attn[name]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[name]["out"], want, atol=ATOL,
                                   rtol=ATOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", ATTN_NAMES)
def test_sequence_parallel_gradients_match_jax_grad(gang, name):
    """The gradient reaching the whole q, k, v on every rank is the
    reference's: each split's gradient is all-gathered back."""
    attn, _, _, ranks = gang
    _, want = attn[name]
    for r, res in enumerate(ranks):
        for what, got, ref in zip("qkv", res[name]["grads"], want):
            np.testing.assert_allclose(got, ref, atol=GRAD_TOL,
                                       rtol=GRAD_TOL,
                                       err_msg=f"rank {r} d{what}")


@pytest.mark.parametrize("name", ["bert-default", "bert-fp32-padded"])
def test_bert_with_ring_attention_matches_the_reference(gang, name):
    _, bert, _, ranks = gang
    want, tol = bert[name]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[name]["out"], want, atol=tol,
                                   rtol=tol, err_msg=f"rank {r}")


def test_lm_step_on_a_seq_mesh_matches_the_reference(gang):
    """``seq`` is a replicated axis of the trainers: params, moments and
    batch whole on each seq rank, no gradient summed over seq; the
    steps are the reference's on its ``data=2, seq=2`` mesh."""
    _, _, (metrics, ref_state, case), ranks = gang
    name = case["name"]
    for r, res in enumerate(ranks):
        port = res[name]
        assert port["mesh"]["seq"] == 2 and port["mesh"]["data"] == 2
        assert all(a is None for s in port["specs"].values() for a in s)
        for i, (got, want) in enumerate(zip(port["metrics"], metrics)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                           err_msg=f"rank {r} step {i} {k}")
        state = {k: v for k, v in port["state"].items()
                 if k.split("/")[0] in ("step", "params", "opt_state")}
        assert set(state) == set(ref_state)
        for k, v in ref_state.items():
            np.testing.assert_allclose(
                np.asarray(state[k], np.float64), np.asarray(v, np.float64),
                rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=f"rank {r} {k}")


def test_seq_ranks_take_bitwise_equal_steps(gang):
    """Ranks 0 and 1 (and 2 and 3) differ only in their seq position:
    every metric and every leaf of their states is equal bit for bit."""
    _, _, (_, _, case), ranks = gang
    name = case["name"]
    for a, b in ((0, 1), (2, 3)):
        assert ranks[a][name]["coords"]["data"] == ranks[b][name][
            "coords"]["data"]
        assert ranks[a][name]["metrics"] == ranks[b][name]["metrics"]
        for k, v in ranks[a][name]["state"].items():
            assert np.array_equal(np.asarray(v),
                                  np.asarray(ranks[b][name]["state"][k])), k


def test_ulysses_raises_where_heads_do_not_split():
    """The reference's tiled all-to-all needs each head count to divide
    by the axis size; the port says so before any exchange."""
    import torch

    mesh = Mesh(PortSpec(seq=2), device="cpu")
    q = torch.zeros(1, 8, 3, 8)
    with pytest.raises(ValueError, match="3 query heads"):
        ulysses_attention(q, q, q, mesh=mesh)
    kv = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="1 kv heads"):
        ulysses_attention(torch.zeros(1, 8, 4, 8), kv, kv, mesh=mesh)
    with pytest.raises(ValueError, match="unknown strategy"):
        make_sequence_parallel_attention(mesh, strategy="tree")


def test_one_rank_strategies_are_flash_attention():
    """A mesh of one: both strategies give the plain flash twin's output
    (Ulysses's n == 1 path; the ring's single step)."""
    import torch

    from kubeflow_tpu_torch.ops.flash_attention import flash_attention

    mesh = Mesh(PortSpec(), device="cpu")
    q, k, v = (torch.from_numpy(np.array(t)) for t in make_qkv(
        4, b=2, l=32, h=4, d=8, kv_heads=2))
    want = flash_attention(q, k, v, causal=True)
    for strategy in ("ring", "ulysses"):
        got = make_sequence_parallel_attention(mesh, strategy=strategy,
                                               causal=True)(q, k, v)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=ATOL)
