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

import numpy as np
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


def make_model(case, mesh=None):
    """The case's port model: a registry entry, or ``factory``
    (``module:attr``) called with the kwargs; built on ``mesh`` where
    its tensor axis is live (the tensor-parallel Llama and BERT), and an
    MoE model on any mesh of more than one rank."""
    kwargs = dict(case["kwargs"])
    if "factory" in case:
        module, attr = case["factory"].split(":")
        make = getattr(importlib.import_module(module), attr)
    else:
        make = get_model(case["model"]).make
    if mesh is not None and (mesh.shape["tensor"] > 1 or (
            getattr(make(**kwargs), "num_experts", 0) and mesh.size > 1)):
        kwargs["mesh"] = mesh
    return make(**kwargs)


def mesh_of(case):
    with environ(case.get("env", {})):
        return build_mesh(MeshSpec(**case["spec"]), "cpu")


def rows(batch, mesh):
    r = host_shard_range(next(iter(batch.values())).shape[0], mesh=mesh)
    return {k: v[r.start:r.stop] for k, v in batch.items()}


TXS = {
    "adamw": lambda: optim.adamw(1e-3),
    "adamw5e-3": lambda: optim.adamw(5e-3),
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

    from kubeflow_tpu_torch.parallel.mesh import mirror_param_shardings
    from kubeflow_tpu_torch.training.checkpoint import (
        ContinuousCheckpointConfig,
        ShardedCheckpointer,
    )

    mesh = mesh_of(case)
    model = make_model(case, mesh)
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
    if case.get("restore_dir"):
        # A one-rank run's checkpoint, cut to this rank's pieces.
        reader = ShardedCheckpointer(ContinuousCheckpointConfig(
            directory=case["restore_dir"], async_save=False))
        state = reader.restore(state)
        reader.close()
        trained = state.lora if case.get("lora") is not None else \
            state.params
        restored = convert.state_to_flax(gathered_state(state))
    pieces = {k: tuple(v.shape) for k, v in trained.items()}
    opt_paths = [k for k in convert.state_to_flax(state)
                 if k.startswith("opt_state/")]
    by_flax = {convert.flax_key(k): v for k, v in state.shardings.items()}
    moments = {p: tuple(sh.spec) for p, sh in mirror_param_shardings(
        opt_paths, by_flax, gathered_replicated(mesh)).items()}
    if case.get("grad_accum", 1) > 1:
        step = make_lm_train_step(mesh, objective=case["objective"],
                                  grad_accum=case["grad_accum"])
    own = {k: v.detach().clone() for k, v in trained.items()}
    metrics = []
    save_at = case.get("save_at", len(case["batches"]))
    for i, batch in enumerate(case["batches"]):
        if i == save_at:
            flat = _save(case, mesh, state)
        state, m = step(state, rows(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    if save_at == len(case["batches"]):
        flat = _save(case, mesh, state)
    out = {"metrics": metrics, "state": flat, "pieces": pieces,
           "own": {convert.flax_key(k): v.numpy() for k, v in own.items()},
            "mesh": mesh.shape, "coords": mesh.coords(),
            "moments": moments,
            "specs": {convert.flax_key(k): tuple(v.spec)
                      for k, v in state.shardings.items()}}
    if case.get("restore_dir"):
        out["restored"] = restored
    return out


def _save(case, mesh, state):
    """The state's host-sharded checkpoint (where the case asks for
    one), each rank a host, and the whole state, gathered."""
    from kubeflow_tpu_torch.training.checkpoint import (
        ContinuousCheckpointConfig,
        ShardedCheckpointer,
    )

    if case.get("save_dir"):
        writer = ShardedCheckpointer(ContinuousCheckpointConfig(
            directory=case["save_dir"], async_save=False,
            num_hosts=mesh.size, host_id=mesh.rank))
        writer.save(state.step, state, force=True)
        writer.close()
    return convert.state_to_flax(gathered_state(state))


def moe_job(case):
    """An MoE layer built on the case's mesh over this rank's rows of the
    case's tokens: its output rows, the aux loss it sows and the
    gradients of ``sum(out²) + 0.01·aux`` (the reference's
    ``test_moe_gradients_flow_and_aux_loss_sown`` loss) summed over the
    batch line, as a trainer sums them: the router's whole, the experts'
    this rank's pieces."""
    from kubeflow_tpu_torch.ops.moe import MoE, collect_losses
    from kubeflow_tpu_torch.parallel import collectives

    mesh = mesh_of(case)
    moe = MoE(**case["kwargs"], dtype=torch.float32, device="meta",
              mesh=mesh)
    params = {"router.weight": _t(case["router"].T)}
    for name in ("w_in", "w_out"):
        shape = tuple(getattr(moe, name).shape)
        full = case[name]
        piece = full[mesh.coords()["expert"] * shape[0]:][:shape[0]]
        dim = 2 if name == "w_in" else 1
        t = mesh.coords()["tensor"]
        piece = np.take(piece, range(t * shape[dim], (t + 1) * shape[dim]),
                        axis=dim)
        params[name] = _t(np.ascontiguousarray(piece))
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    x = rows({"x": _t(case["x"])}, mesh)["x"]
    with collect_losses() as sown:
        out = torch.func.functional_call(moe, params, (x,))
    aux = sown[0]
    grads = torch.autograd.grad((out ** 2).sum() + 0.01 * aux,
                                list(params.values()))
    return {"out": out.detach().numpy(), "aux": float(aux),
            "pieces": {k: tuple(v.shape) for k, v in params.items()},
            "grads": {k: collectives.all_reduce_sum(g.clone(), mesh).numpy()
                      for k, g in zip(params, grads)}}


def gathered_replicated(mesh):
    from kubeflow_tpu_torch.parallel.mesh import replicated

    return replicated(mesh)


def prefetch_job(case):
    from kubeflow_tpu_torch.training.data import (
        DevicePrefetcher,
        synthetic_causal_lm,
    )

    mesh = mesh_of(case)
    it = DevicePrefetcher(synthetic_causal_lm(case["global_batch"],
                                              seq_len=8, vocab_size=64,
                                              mesh=mesh),
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
            local = {k: torch.from_numpy(v)
                     for k, v in rows(batch, mesh).items()}
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


def serve_job(case):
    """Each export of the case loaded by the gang (a serving mesh of its
    ranks, each reading its own shard), its forward's logits, then rank
    0 drives ``run`` and the engine while the others ``follow()``."""
    import numpy as np

    from kubeflow_tpu_torch.models.llama import apply
    from kubeflow_tpu_torch.serving.model import load_version

    out = {}
    for name, path in case["exports"].items():
        loaded = load_version(path, max_batch=4, device="cpu")
        model = get_model("llama-test").make(dtype="float32",
                                             mesh=loaded.mesh)
        with torch.no_grad():
            logits = apply(model, loaded.params,
                           torch.from_numpy(case["ids"])).numpy()
        got = {"topology": loaded.shard_topology(),
               "opened": loaded.shard_files, "logits": logits,
               "rank": dist.get_rank()}
        if dist.get_rank() != 0:
            got.update(loaded.follow())
            out[name] = got
            continue
        got["run"] = loaded.run({"input_ids": case["run_prompts"]})["tokens"]
        got["b1"] = [loaded.run({"input_ids": p[None]},
                                row_rngs=np.asarray([k]))["tokens"][0]
                     for p, k in zip(case["engine_prompts"], case["keys"])]
        engine = loaded.ensure_engine()
        streams = [engine.submit(p, rng=k) for p, k in
                   zip(case["engine_prompts"], case["keys"])]
        got["streams"] = [s.result(120.0) for s in streams]
        got["stats"] = engine.stats()
        got["engine"] = {gid: s.tokens_so_far
                         for gid, s in engine.gang_streams.items()}
        loaded.close()
        out[name] = got
    return out


def _lane_engine(loaded, sampling, knobs):
    """A copy of ``loaded`` (the same params on the same mesh and
    channel) whose export asks for ``sampling`` and the lane's
    ``knobs``, and its engine."""
    import dataclasses

    from kubeflow_tpu_torch.serving.model import LoadedModel

    meta = loaded.metadata
    model = LoadedModel(
        metadata=dataclasses.replace(meta, generate_config=dict(
            meta.generate_config, **sampling, **knobs)),
        version=loaded.version, params=loaded.params, max_batch=4,
        device="cpu", mesh=loaded.mesh)
    return model


def _streams(engine, prompts, keys):
    streams = [engine.submit(p, rng=k) for p, k in zip(prompts, keys)]
    return [s.result(120.0) for s in streams]


def _cold_then_warm(engine, prompts, keys):
    """Each prompt cold (the index cleared after it), then the same
    prompts again in one pass, where the later ones hit the earlier."""
    cold = []
    for p, k in zip(prompts, keys):
        cold.append(engine.submit(p, rng=k).result(120.0))
        engine.clear_prefix_cache()
    warm = [engine.submit(p, rng=k).result(120.0)
            for p, k in zip(prompts, keys)]
    return cold, warm


def lanes_job(case):
    """Every eager engine lane of a ``tensor=2`` export on the gang:
    rank 0 drives each lane's requests through a ``LoadedModel`` over
    the gang's params, the other ranks ``follow()``."""
    from kubeflow_tpu_torch.inference import prng
    from kubeflow_tpu_torch.serving import wire
    from kubeflow_tpu_torch.serving.model import load_version

    loaded = load_version(case["export"], max_batch=4, device="cpu")
    lead = dist.get_rank() == 0
    prompts, keys = case["prompts"], case["keys"]
    out = {"opened": loaded.shard_files}
    for mode, sampling in case["modes"].items():
        for lane, knobs in case["lanes"].items():
            model = _lane_engine(loaded, sampling, knobs)
            if not lead:
                out[mode, lane] = model.follow()
                continue
            engine = model.ensure_engine()
            got = {}
            if lane == "plain":
                got["streams"] = _streams(engine, prompts, keys)
                got["b1"] = [model.run({"input_ids": p[None]},
                                       row_rngs=np.asarray([k]))["tokens"][0]
                             for p, k in zip(prompts, keys)]
                steps = prng.split(np.asarray(keys[0], np.uint32),
                                   len(got["streams"][0]))
                got["resumes"] = [engine.submit(
                    np.concatenate([prompts[0], got["streams"][0][:cut]]),
                    step_keys=steps[cut:], prompt_len=len(prompts[0])
                ).result(120.0) for cut in case["cuts"]]
            elif lane == "spec":
                got["streams"] = _streams(engine, prompts, keys)
            elif lane in ("prefix", "chunk"):
                got["cold"], got["warm"] = _cold_then_warm(
                    engine, case["prefix_prompts"], case["prefix_keys"])
            elif lane == "tier":
                seq = case["tier_prompts"]
                tkeys = case["tier_keys"]
                got["streams"] = [engine.submit(p, rng=k).result(120.0)
                                  for p, k in zip(seq, tkeys)]
            if lane in ("plain", "prefix"):
                # KV handoff both ways: this gang's blob for a
                # one-process engine, and a one-process engine's here.
                p, k = case["handoff_prompt"], case["handoff_key"]
                got["local"] = engine.submit(p, rng=k).result(120.0)
                got["blob"] = wire.encode_kv_handoff(
                    "sharded", 1, engine.run_prefill(p, rng=k))
                carried = wire.decode_kv_handoff(
                    case["incoming"][mode, lane], model="sharded",
                    version=1)
                got["adopted"] = engine.submit(
                    handoff=carried).result(120.0)
            if lane == "prefix":
                # Fleet blocks: this gang's export of a prompt's blocks
                # (every KV head), and an import of a one-process
                # engine's into a tiered lane below.
                got["blocks"] = wire.encode_kv_blocks(
                    "sharded", 1, engine.config.page_size,
                    engine.export_prefix_blocks(case["prefix_prompts"][0]))
            if lane == "tier":
                blocks = wire.decode_kv_blocks(
                    case["incoming_blocks"][mode], model="sharded",
                    version=1, page_size=engine.config.page_size)
                got["imported"] = engine.import_prefix_blocks(blocks)
                p = case["prefix_prompts"][0]
                got["imported_stream"] = engine.submit(
                    p, rng=case["prefix_keys"][0]).result(120.0)
            got["stats"] = engine.stats()
            got["engine"] = {gid: s.tokens_so_far
                             for gid, s in engine.gang_streams.items()}
            got["laps"] = engine.gang_laps
            model.close()
            out[mode, lane] = got
    return out


def fsdp_job(case):
    """Each fsdp export of the case on the gang's serving mesh: the
    files each rank opened, what it holds at rest, the cache-free
    logits, the same ranks' tensor-only forward (params whole over
    fsdp), and greedy tokens through ``run`` (rank 0 drives)."""
    from kubeflow_tpu_torch.models.llama import apply
    from kubeflow_tpu_torch.serving.model import load_version

    out = {}
    ids = torch.from_numpy(case["ids"])
    for name, path in case["exports"].items():
        loaded = load_version(path, max_batch=2, device="cpu")
        model = get_model("llama-test").make(
            dtype="float32", mesh=loaded.mesh, fsdp_pieces=True)
        with torch.no_grad():
            logits = apply(model, loaded.params, ids).numpy()
        got = {"opened": loaded.shard_files,
               "topology": loaded.shard_topology(), "logits": logits,
               "shapes": {k: tuple(v.shape)
                          for k, v in loaded.params.items()}}
        if loaded.mesh.shape["tensor"] > 1:
            tensor_only = get_model("llama-test").make(dtype="float32",
                                                       mesh=loaded.mesh)
            params = convert.params_from_flax(case["flat"], tensor_only,
                                              device="cpu")
            with torch.no_grad():
                got["tensor_logits"] = apply(tensor_only, params,
                                             ids).numpy()
        if dist.get_rank() == 0:
            got["tokens"] = loaded.run(
                {"input_ids": case["prompt"]})["tokens"]
            loaded.close()
        else:
            got.update(loaded.follow())
        out[name] = got
    return out


def tensor_sum_job(case):
    """The tensor line's sum (``reduce_from_tensor``) of each rank's
    rows, alone and in batches, and the gather of its pieces."""
    from kubeflow_tpu_torch.parallel import collectives

    mesh = mesh_of(case)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows = torch.from_numpy(case["rows"][mesh.coords()["tensor"]]).to(
            dtype)
        name = str(dtype).replace("torch.", "")
        out[name] = {b: collectives.reduce_from_tensor(
            rows[:b].clone(), mesh).float().numpy() for b in (1, 4)}
    out["gather"] = collectives.gather_from_tensor(
        torch.from_numpy(case["rows"][mesh.coords()["tensor"]]), mesh
    ).numpy()
    return out


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def seq_job(case):
    """The sequence-parallel attention of a case on its mesh (every rank
    given the whole tensors): the output and, for ``grad``, the
    gradients of ``sum(out²)`` in q, k, v; a BERT forward with the ring
    as its ``attention_fn``; or an LM step on a seq mesh (``lm_job``)."""
    from kubeflow_tpu_torch.models.llama import apply
    from kubeflow_tpu_torch.parallel.ring_attention import (
        make_sequence_parallel_attention,
    )

    if case["kind"] == "lm":
        return lm_job(case)
    mesh = mesh_of(case)
    if case["kind"] == "bert":
        fn = make_sequence_parallel_attention(mesh, strategy="ring",
                                              head_axis=None)
        model = get_model("bert-test").make(**case["kwargs"],
                                            attention_fn=fn)
        params = convert.params_from_flax(case["params"], model,
                                          device="cpu")
        valid = None if case["valid"] is None else _t(case["valid"])
        with torch.no_grad():
            out = apply(model, params, _t(case["ids"]), None, valid)
        return {"out": out.float().numpy()}
    fn = make_sequence_parallel_attention(
        mesh, strategy=case["strategy"], causal=case["causal"],
        head_axis=case["head_axis"])
    q, k, v = (_t(case[n], True) for n in "qkv")
    mask = None if case["mask"] is None else _t(case["mask"])
    out = fn(q, k, v, kv_segment_valid=mask)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    return {"out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def pipeline_job(case):
    """A case of ``tests/test_pipeline.py`` on the case's mesh: the
    pipeline's output on this rank's rows and, for ``grad``, the whole
    stacked params' gradient of ``sum(out²)`` (each pipeline rank's own
    stages' summed over the pipeline line)."""
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.parallel.pipeline import (
        spmd_pipeline,
        spmd_pipeline_interleaved,
    )

    mesh = mesh_of(case)

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    stacked = {k: _t(v, case["grad"]) for k, v in case["stacked"].items()}
    x = _t(case["x"])
    if case.get("batch_axis"):
        x = rows({"x": x}, mesh)["x"]
    kw = dict(mesh=mesh, n_microbatches=case["n_micro"])
    if case["n_virtual"]:
        out = spmd_pipeline_interleaved(stage_fn, stacked, x,
                                        n_virtual=case["n_virtual"], **kw)
    else:
        out = spmd_pipeline(stage_fn, stacked, x, **kw)
    got = {"out": out.detach().numpy()}
    if case.get("gpipe_too"):
        # The same stages on GPipe (the [1, n, ...] layout's stage dim).
        got["gpipe"] = spmd_pipeline(
            stage_fn, {k: t[0] for k, t in stacked.items()}, x,
            **kw).detach().numpy()
    if case["grad"]:
        grads = torch.autograd.grad((out ** 2).sum(), list(stacked.values()))
        got["grads"] = {k: collectives.all_reduce_sum(
            g.clone(), mesh, ("pipeline",)).numpy()
            for k, g in zip(stacked, grads)}
    return got


def pipeline_lm_job(case):
    """A case of ``tests/test_pipeline_lm.py``: the staged forward's
    logits (and, under remat, its gradients' finiteness), or the
    pipeline trainer's steps: each step's metrics, then the whole state
    (gathered over the pipeline line)."""
    from kubeflow_tpu_torch.models.llama import Llama
    from kubeflow_tpu_torch.training.pipeline_lm import (
        create_pipeline_lm_state,
        make_pipeline_lm_train_step,
        partition_llama_params,
        staged_llama_forward,
    )
    from kubeflow_tpu_torch.training.checkpoint import (
        ContinuousCheckpointConfig,
        ShardedCheckpointer,
    )

    mesh = mesh_of(case)
    model = Llama(**case["kwargs"])
    params = convert.params_from_flax(case["params"], model, device="cpu")
    v = case.get("n_virtual", 1)
    if case["kind"] == "forward":
        staged = {k: t.requires_grad_(True) for k, t in
                  partition_llama_params(params, case["stages"]).items()}
        ids = rows({"ids": _t(case["ids"])}, mesh)["ids"]
        logits = staged_llama_forward(model, staged, ids, mesh=mesh,
                                      n_microbatches=case["n_micro"],
                                      n_virtual=v)
        grads = torch.autograd.grad((logits ** 2).mean(),
                                    list(staged.values()))
        return {"logits": logits.detach().numpy(),
                "finite": all(bool(torch.isfinite(g).all()) for g in grads)}
    tx = TXS[case["tx"]]()
    state, _ = create_pipeline_lm_state(model, tx, params, mesh,
                                        n_virtual=v)
    step = make_pipeline_lm_train_step(mesh, model,
                                       n_microbatches=case["n_micro"],
                                       n_virtual=v)
    pieces = {k: tuple(t.shape) for k, t in state.params.items()}
    metrics = []
    for i, batch in enumerate(case["batches"]):
        if case.get("save_dir") and i == case["save_at"]:
            writer = ShardedCheckpointer(ContinuousCheckpointConfig(
                directory=case["save_dir"], async_save=False,
                num_hosts=mesh.size, host_id=mesh.rank))
            writer.save(state.step, state, force=True)
            writer.close()
            dist.barrier()  # rank 0 has committed the manifest
            # A fresh state (from the same init) restored from it takes
            # the remaining steps.
            fresh, _ = create_pipeline_lm_state(
                model, tx, convert.params_from_flax(case["params"], model,
                                                    device="cpu"),
                mesh, n_virtual=v)
            reader = ShardedCheckpointer(ContinuousCheckpointConfig(
                directory=case["save_dir"], async_save=False))
            restored = reader.restore(fresh)
            reader.close()
            same = all(torch.equal(restored.params[k], t)
                       for k, t in state.params.items())
            state = restored
            metrics.append({"restored_bitwise": same,
                            "restored_step": state.step})
        state, m = step(state, rows(batch, mesh))
        metrics.append({k: float(val) for k, val in m.items()})
    return {"metrics": metrics, "pieces": pieces,
            "state": convert.state_to_flax(gathered_state(state))}


def cli_job(case):
    """tpu-lm (``pretrain.main``) in the gang with the case's argv, its
    init carried across from the reference's; the metrics it wrote."""
    import contextlib
    import io
    import json

    from kubeflow_tpu_torch.training.pretrain import main as pretrain_main

    carried = case["params"]
    real = convert.init_params
    convert.init_params = (lambda model, seed=0, device=None, dtype=None:
                           convert.params_from_flax(carried, model,
                                                    device=device))
    path = os.path.join(case["out"], f"metrics{dist.get_rank()}.jsonl")
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = pretrain_main(case["argv"] + ["--metrics_path", path])
    finally:
        convert.init_params = real
    with open(path) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    return {"rc": rc, "final": json.loads(out.getvalue().strip()
                                          .splitlines()[-1]),
            "metrics": lines}


JOBS = {"lm": lm_job, "moe": moe_job, "prefetch": prefetch_job, "vision": vision_job,
        "serve": serve_job, "tensor_sum": tensor_sum_job, "seq": seq_job,
        "pipeline": pipeline_job, "pipeline_lm": pipeline_lm_job,
        "cli": cli_job, "lanes": lanes_job, "fsdp": fsdp_job}


def main():
    job, cases_path, out, rank, world, port = sys.argv[1:]
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        cases = pickle.loads(open(cases_path, "rb").read())
        results = {c["name"]: JOBS[c.get("job", job)](c) for c in cases}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main()
