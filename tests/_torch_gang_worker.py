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

"""One rank of a gloo gang on the CPU: the port's side of the mesh tests.

``python _torch_gang_worker.py JOB CASES OUT RANK WORLD PORT`` joins the
gang (``tcp://127.0.0.1:PORT``), runs JOB over the pickled cases and
pickles its results to ``OUT/rank<RANK>.pkl``. It imports nothing of the
reference: the cases carry the reference's numbers (params, batches).
"""

import contextlib
import importlib
import os
import pickle
import sys

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from kubeflow_tpu_torch.training import optim
from kubeflow_tpu_torch.training.checkpoint import gathered_state
from kubeflow_tpu_torch.training.data import host_shard_range


@contextlib.contextmanager
def environ(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def make_model(case):
    """The case's port model: a registry entry, or ``factory``
    (``module:attr``) called with the kwargs."""
    if "factory" in case:
        module, attr = case["factory"].split(":")
        return getattr(importlib.import_module(module), attr)(
            **case["kwargs"])
    return get_model(case["model"]).make(**case["kwargs"])


def mesh_of(case):
    with environ(case.get("env", {})):
        return build_mesh(MeshSpec(**case["spec"]), "cpu")


def rows(batch):
    r = host_shard_range(next(iter(batch.values())).shape[0])
    return {k: v[r.start:r.stop] for k, v in batch.items()}


TXS = {
    "adamw": lambda: optim.adamw(1e-3),
    "sgd": lambda: optim.sgd(0.1),
    "pretrain_chain": lambda: optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10),
                    weight_decay=0.01)),
}


def lm_job(case):
    from kubeflow_tpu_torch.training.finetune import (
        create_lora_state,
        make_lora_train_step,
    )
    from kubeflow_tpu_torch.training.lm import (
        create_lm_state,
        make_lm_train_step,
    )

    mesh = mesh_of(case)
    model = make_model(case)
    params = convert.params_from_flax(case["params"], model, device="cpu")
    tx = TXS[case["tx"]]()
    if case.get("lora") is not None:
        lora = convert.lora_from_flax(case["lora"], model, device="cpu")
        state, _ = create_lora_state(model, tx, params, lora, mesh=mesh)
        step = make_lora_train_step(mesh, objective=case["objective"])
        trained = state.lora
    else:
        state, _ = create_lm_state(model, tx, params, mesh)
        step = make_lm_train_step(mesh, objective=case["objective"])
        trained = state.params
    pieces = {k: tuple(v.shape) for k, v in trained.items()}
    metrics = []
    for batch in case["batches"]:
        state, m = step(state, rows(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    flat = convert.state_to_flax(gathered_state(state))
    return {"metrics": metrics, "state": flat, "pieces": pieces,
            "mesh": mesh.shape, "coords": mesh.coords()}


def prefetch_job(case):
    from kubeflow_tpu_torch.training.data import (
        DevicePrefetcher,
        synthetic_causal_lm,
    )

    mesh = mesh_of(case)
    it = DevicePrefetcher(synthetic_causal_lm(case["global_batch"],
                                              seq_len=8, vocab_size=64),
                          mesh, prefetch=2)
    try:
        batch = next(it)
    finally:
        it.close()
    return {"input_ids": batch["input_ids"].numpy(),
            "device": str(batch["input_ids"].device)}


def vision_job(case):
    from kubeflow_tpu_torch.ops import bn_fused
    from kubeflow_tpu_torch.training.train import (
        create_train_state,
        make_train_step,
        place_state,
        sgd,
    )

    mesh = mesh_of(case)
    model = make_model(case)
    params = convert.params_from_flax(case["params"], model, device="cpu")
    stats = convert.batch_stats_from_flax(case["batch_stats"], model,
                                          device="cpu") if case[
        "batch_stats"] else {}
    state = place_state(mesh, create_train_state(
        model, sgd(case["lr"], momentum=case["momentum"]), params, stats))
    pieces = {k: tuple(v.shape) for k, v in state.params.items()}
    step = make_train_step(mesh)
    metrics = []
    calls = []
    real = bn_fused.bn_stats

    def spy(x, **kw):
        calls.append(x.shape)
        return real(x, **kw)

    bn_fused.bn_stats = spy
    try:
        for batch in case["batches"]:
            local = {k: torch.from_numpy(v) for k, v in rows(batch).items()}
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        bn_fused.bn_stats = real
    full = gathered_state(state)
    return {"metrics": metrics, "pieces": pieces, "stats_calls": len(calls),
            "params": convert.params_to_flax(
                {k: v.detach() for k, v in full.params.items()}),
            "batch_stats": {k: v.numpy().copy()
                            for k, v in state.batch_stats.items()}}


JOBS = {"lm": lm_job, "prefetch": prefetch_job, "vision": vision_job}


def main():
    job, cases_path, out, rank, world, port = sys.argv[1:]
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        cases = pickle.loads(open(cases_path, "rb").read())
        results = {c["name"]: JOBS[job](c) for c in cases}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main()
