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

"""The pipeline schedules in a 4-rank gloo gang against the reference.

Twins of the six cases of ``tests/test_pipeline.py`` (GPipe against the
sequential stages; the circular schedule, also with a microbatch count
the device count does not divide; its gradient; v = 1 against GPipe;
rows on the ``data`` axis; the gradient flowing), each run on the
port's ``pipeline=2, data=2`` and ``pipeline=4`` meshes, held to what
the reference's tests hold its schedules to: the reference's stage
function run stage after stage in this process (and ``jax.grad`` of it),
at their tolerances (1e-5 outputs, 1e-4 gradients, 1e-6 v = 1 against
GPipe). One gang runs every case; both sides take the same numpy inputs
(the stage params whole on every rank; each rank takes its own stages).
The tick plan and the bubble formulas are pure functions here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_gang import run_gang
from kubeflow_tpu.parallel.pipeline import (
    bubble_fraction as jax_bubble,
    bubble_fraction_interleaved as jax_bubble_interleaved,
    interleave_stage_params as jax_interleave,
    stack_stage_params as jax_stack,
)
from kubeflow_tpu_torch.parallel.pipeline import (
    bubble_fraction,
    bubble_fraction_interleaved,
    interleave_stage_params,
    slots,
    stack_stage_params,
    total_ticks,
)

#: The port's meshes: (name, spec, stages).
MESHES = (("pipeline2-data2", {"pipeline": 2, "data": 2}, 2),
          ("pipeline4", {"pipeline": 4}, 4))
CASES = ("sequential", "interleaved", "interleaved-ragged",
         "interleaved-grad", "v1-gpipe", "batch-axis", "grad-flows")


def stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def make_params(key, n_stages, d):
    out = []
    for _ in range(n_stages):
        k1, k2, key = jax.random.split(key, 3)
        out.append({"w": jax.random.normal(k1, (d, d)) / jnp.sqrt(d),
                    "b": jax.random.normal(k2, (d,)) * 0.1})
    return out


def sequential(params, x):
    for p in params:
        x = stage_fn(p, x)
    return x


def host(tree):
    return {k: np.array(v) for k, v in tree.items()}


def reference(kind, n):
    """(the reference's sequential stages' output and, for a gradient
    case, ``jax.grad`` of ``sum(out²)`` in the case's stacked layout; the
    port's case fields) of one case at ``n`` stages: the numbers the
    reference's own pipeline tests hold its schedules to."""
    v = 2

    def grads_in(params, x, layout):
        g = jax.grad(lambda pl: jnp.sum(sequential(pl, x) ** 2))(params)
        return host(layout(jax_stack(g)))

    def interleaved(tree):
        return jax_interleave(tree, n)

    if kind == "sequential":
        params = make_params(jax.random.PRNGKey(0), n, 16)
        x = jax.random.normal(jax.random.PRNGKey(1), (24, 16))
        return (np.asarray(sequential(params, x)), None,
                dict(stacked=host(jax_stack(params)), x=np.array(x),
                     n_micro=8, n_virtual=0, grad=False))
    if kind in ("interleaved", "interleaved-ragged"):
        params = make_params(jax.random.PRNGKey(0), n * v, 16)
        n_micro, rows = (8, 24) if kind == "interleaved" else (6, 18)
        x = jax.random.normal(jax.random.PRNGKey(1), (24, 16))[:rows]
        return (np.asarray(sequential(params, x)), None,
                dict(stacked=host(interleaved(jax_stack(params))),
                     x=np.array(x), n_micro=n_micro, n_virtual=v,
                     grad=False))
    if kind == "interleaved-grad":
        params = make_params(jax.random.PRNGKey(2), n * v, 8)
        x = jax.random.normal(jax.random.PRNGKey(3), (16, 8))
        return (np.asarray(sequential(params, x)),
                grads_in(params, x, interleaved),
                dict(stacked=host(interleaved(jax_stack(params))),
                     x=np.array(x), n_micro=8, n_virtual=v, grad=True))
    if kind == "v1-gpipe":
        params = make_params(jax.random.PRNGKey(4), n, 16)
        x = jax.random.normal(jax.random.PRNGKey(5), (16, 16))
        return (np.asarray(sequential(params, x)), None,
                dict(stacked=host(interleaved(jax_stack(params))),
                     x=np.array(x), n_micro=8, n_virtual=1, grad=False,
                     gpipe_too=True))
    if kind == "batch-axis":
        params = make_params(jax.random.PRNGKey(6), n * v, 16)
        x = jax.random.normal(jax.random.PRNGKey(7), (24, 16))
        return (np.asarray(sequential(params, x)), None,
                dict(stacked=host(interleaved(jax_stack(params))),
                     x=np.array(x), n_micro=4, n_virtual=v, grad=False,
                     batch_axis="data"))
    # grad-flows: GPipe's gradient.
    params = make_params(jax.random.PRNGKey(2), n, 8)
    x = jax.random.normal(jax.random.PRNGKey(3), (8, 8))
    return (np.asarray(sequential(params, x)),
            grads_in(params, x, lambda t: t),
            dict(stacked=host(jax_stack(params)), x=np.array(x), n_micro=4,
                 n_virtual=0, grad=True))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    cases, refs = [], {}
    for mesh_name, spec, n in MESHES:
        for kind in CASES:
            out, grads, fields = reference(kind, n)
            name = f"{kind}-{mesh_name}"
            cases.append({"name": name, "spec": spec, **fields})
            refs[name] = (out, grads)
    ranks = run_gang("pipeline", cases,
                     tmp_path_factory.mktemp("gang-pipeline"), world=4)
    return refs, {c["name"]: c for c in cases}, ranks


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
@pytest.mark.parametrize("kind", CASES)
def test_pipeline_matches_the_reference(gang, kind, mesh):
    """The schedule's output (each rank's rows of the data axis for the
    batch-axis case) and the stacked params' gradient, against the
    sequential stages the reference's tests hold its schedules to, at
    their tolerances; v = 1 against GPipe at 1e-6."""
    refs, cases, ranks = gang
    name = f"{kind}-{mesh}"
    want, want_grads = refs[name]
    case = cases[name]
    for r, res in enumerate(ranks):
        got = res[name]
        if case.get("batch_axis"):
            # Each rank's rows of the data axis (data is outer to
            # pipeline in the rank order).
            data = case["spec"].get("data", 1)
            rows = want.shape[0] // data
            pos = r // (4 // data)
            want_rows = want[pos * rows:(pos + 1) * rows]
        else:
            want_rows = want
        np.testing.assert_allclose(got["out"], want_rows, atol=1e-5,
                                   rtol=1e-5, err_msg=f"rank {r}")
        if want_grads is not None:
            for k, g in want_grads.items():
                assert got["grads"][k].shape == g.shape
                np.testing.assert_allclose(got["grads"][k], g, atol=1e-4,
                                           rtol=1e-4,
                                           err_msg=f"rank {r} d{k}")
                assert np.abs(got["grads"][k]).sum() > 0
        if case.get("gpipe_too"):
            np.testing.assert_allclose(got["out"], got["gpipe"], atol=1e-6,
                                       rtol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("n,m,v", [(1, 1, 1), (2, 4, 1), (4, 8, 1),
                                   (2, 4, 2), (4, 8, 2), (4, 6, 2),
                                   (3, 7, 3), (4, 5, 4)])
def test_tick_plan_and_bubbles_are_the_reference_arithmetic(n, m, v):
    """Every device's plan holds each (microbatch, virtual stage) once,
    each microbatch's stages in order one tick apart on consecutive
    devices; the idle share of the plan is the bubble formula, which is
    the reference's."""
    ticks = total_ticks(n, m, v)
    seen = {}
    for idx in range(n):
        plan = slots(n, idx, m, v)
        assert len(plan) == ticks
        for t, slot in enumerate(plan):
            if slot is not None:
                assert slot not in seen.get(idx, {})
                seen.setdefault(idx, {})[slot] = t
    for mb in range(m):
        hops = sorted((t, idx, virt) for idx in seen
                      for (mm, virt), t in seen[idx].items() if mm == mb)
        assert len(hops) == n * v
        for (t0, i0, v0), (t1, i1, v1) in zip(hops, hops[1:]):
            assert t1 == t0 + 1 and i1 == (i0 + 1) % n
            assert (v1, i1) == ((v0, i1) if i1 else (v0 + 1, 0))
    active = sum(len(s) for s in seen.values())
    assert active == n * m * v
    idle = 1 - active / (n * ticks)
    got = bubble_fraction_interleaved(n, m, v)
    assert got == pytest.approx(idle)
    assert got == pytest.approx(jax_bubble_interleaved(n, m, v))
    if v == 1:
        assert bubble_fraction(n, m) == pytest.approx(jax_bubble(n, m))
        assert ticks == m + n - 1


def test_bubble_formulas_raise_as_the_reference():
    for fn, args in ((bubble_fraction, (0, 4)), (bubble_fraction, (4, 0)),
                     (bubble_fraction_interleaved, (4, 4, 0))):
        with pytest.raises(ValueError):
            fn(*args)


def test_stacking_and_interleaving_are_the_reference_layouts():
    import torch

    params = make_params(jax.random.PRNGKey(0), 4, 4)
    want = jax_interleave(jax_stack(params), 2)
    got = interleave_stage_params(stack_stage_params(
        [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
         for p in params]), 2)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="stage count"):
        interleave_stage_params(got, 3)


@pytest.mark.parametrize("axis,match", [
    ("seq", None), ("pipeline", "pipeline LM trainer"),
    pytest.param("expert", None, id="expert-expert parallelism")])
def test_the_trainers_take_seq_and_name_what_they_do_not_run(axis, match):
    """Every trainer takes ``seq`` (a replicated axis) and ``expert`` (the
    LM trainers check it against their model at the call; the vision
    trainer runs it replicated); ``pipeline`` outside the pipeline
    trainer raises, naming where it runs."""
    from kubeflow_tpu_torch.parallel.mesh import Mesh, MeshSpec as PortSpec
    from kubeflow_tpu_torch.training.finetune import make_lora_train_step
    from kubeflow_tpu_torch.training.lm import make_lm_train_step
    from kubeflow_tpu_torch.training.train import make_train_step

    mesh = Mesh(PortSpec(**{axis: 2}), device="cpu")
    for build in (make_train_step, make_lora_train_step, make_lm_train_step):
        if match is None:
            assert callable(build(mesh))
            continue
        with pytest.raises(NotImplementedError, match=match):
            build(mesh)


def test_the_pipeline_trainer_refuses_other_models_and_axes():
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.parallel.mesh import Mesh, MeshSpec as PortSpec
    from kubeflow_tpu_torch.training import optim
    from kubeflow_tpu_torch.training.pipeline_lm import (
        create_pipeline_lm_state,
        make_pipeline_lm_train_step,
    )

    mesh = Mesh(PortSpec(pipeline=2), device="cpu")
    bert = get_model("bert-test").make(dtype="float32")
    with pytest.raises(ValueError, match="stages a Llama"):
        make_pipeline_lm_train_step(mesh, bert)
    llama = get_model("llama-test").make(dtype="float32")
    with pytest.raises(NotImplementedError, match="expert"):
        make_pipeline_lm_train_step(
            Mesh(PortSpec(pipeline=2, expert=2), device="cpu"), llama)
    with pytest.raises(ValueError, match="mesh pipeline axis"):
        create_pipeline_lm_state(llama, optim.sgd(0.1), {}, mesh,
                                 n_stages=4)
