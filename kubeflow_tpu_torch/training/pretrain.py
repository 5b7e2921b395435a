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


"""tpu-lm: LM pretraining on one GPU (BERT mlm, causal Llama).

The port of ``kubeflow_tpu/training/pretrain.py``, the tpu-lm pod
command, for one device. It keeps the reference's flags and final JSON
line, and adds ``--device`` (``cuda`` unless ``--device cpu`` or the
env's ``JAX_PLATFORMS=cpu``, the operator's simulated mode)::

    python -m kubeflow_tpu_torch.training.pretrain --global_batch 32 \\
        --steps 100                       # bert-base, mlm: the default
    python -m kubeflow_tpu_torch.training.pretrain --model llama-test \\
        --global_batch 8 --seq_len 16 --steps 4 --device cpu \\
        --checkpoint_dir ckpt --save_every 2

Flow: the gang join from the operator's ``KFT_*`` env
(``training/launcher.py``; nothing for one process) → synthetic batches
(the reference's seeded streams: mlm with dynamic masking for ``bert*``,
the objective's default, causal otherwise) or token shards (``--data``;
every id checked against the vocabulary on the host, before it reaches
the card, where a bad id would be a device-side assert; masked per batch
for mlm) → :class:`~kubeflow_tpu_torch.training.data.DevicePrefetcher`
→ ``fit`` with the reference's optimizer (``clip_by_global_norm(1.0)``,
then ``adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps),
weight_decay=0.01)``) over fp32 master params, checkpoint/resume and the
preemption drain (agreed across a gang's processes). Any model and
objective the reference's CLI accepts is accepted on the batch axes:
``--mesh`` takes dcn_data, data and fsdp (``"data=2,fsdp=2"``; a gang
with no ``--mesh`` trains data-parallel over every rank, the
reference's all-data default), the megascale env fills dcn_data, and
each rank writes its host shard of the checkpoints. ``--mesh
tensor=T`` (and ``fsdp=F,tensor=T``) runs a Llama or BERT
tensor-parallel, and ``--mesh expert=X`` (with the batch axes and
tensor: ``data=2,expert=2``) an MoE Llama's experts split over X ranks,
each from the whole model's init cut to each rank's pieces. ``seq`` is a
replicated axis (each seq rank takes the unmeshed step), as are
``tensor`` and ``expert`` for a model with no param on them (``expert``
on a dense Llama or BERT).
``--mesh pipeline=N`` (with the batch axes: ``data=2,pipeline=2``)
runs a causal Llama on the pipeline trainer (``training/
pipeline_lm.py``): ``--microbatches`` a step, ``--virtual_stages`` > 1
for the interleaved schedule, each rank holding and checkpointing its
own stages; another model or objective raises, as the reference's
guard does, and so does an MoE model there.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

OBJECTIVES = ("mlm", "causal")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-lm")
    p.add_argument("--model", default="bert-base")
    p.add_argument("--objective", choices=OBJECTIVES, default=None,
                   help="default: mlm for bert*, causal otherwise")
    p.add_argument("--global_batch", type=int, default=256)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--num_layers", type=int, default=None,
                   help="cut the model's depth, its widths kept (a model "
                        "whose fp32 train state outgrows one card); "
                        "default: the model's own depth")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=10)
    p.add_argument("--mesh", default=None,
                   help="e.g. data=2,fsdp=2 over the gang's ranks (the "
                        "batch axes; seq, replicated; pipeline=N for a "
                        "causal Llama; tensor for a Llama or BERT; expert "
                        "for an MoE Llama, replicated elsewhere). "
                        "Default: all-data in a gang, one device alone")
    p.add_argument("--data", default=None,
                   help="token shards (.npy / raw .bin): comma-separated "
                        "files, dirs, or globs; gs://-style fsspec paths "
                        "download into a local cache. Default: the "
                        "reference's synthetic data")
    p.add_argument("--bin_dtype", default="uint16",
                   help="dtype of raw .bin token dumps (headerless; .npy "
                        "shards self-describe)")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--save_every", type=int, default=200)
    p.add_argument("--continuous_every", type=int, default=0,
                   help="continuous sharded checkpoints every N steps "
                        "under <checkpoint_dir>/continuous (manifest-last "
                        "commit); 0 = off")
    p.add_argument("--metrics_path", default=None)
    p.add_argument("--remat", action="store_true",
                   help="rematerialize blocks (llama only)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline schedule microbatch count (only with a "
                        "pipeline mesh axis)")
    p.add_argument("--virtual_stages", type=int, default=1,
                   help="virtual stages a device for the interleaved "
                        "(circular) pipeline schedule; 1 = GPipe")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda or cpu (default: cpu where the env has "
                        "JAX_PLATFORMS=cpu, else cuda)")
    return p


def check_vocab(source, bound: int):
    """Pass batches through, raising on a token id ``>= bound``: on the
    host, before the batch reaches the device (in a CUDA embedding a bad
    id is a device-side assert, not a message)."""
    for batch in source:
        top = int(batch["input_ids"].max())
        if top >= bound:
            raise ValueError(f"shard token id {top} >= model vocab {bound} "
                             f"— wrong tokenizer or wrong --bin_dtype?")
        yield batch


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.continuous_every > 0 and not args.checkpoint_dir:
        # A continuous tier with nowhere durable to land would restart
        # the run from step 0.
        parser.error("--continuous_every needs --checkpoint_dir")
    from kubeflow_tpu_torch.parallel.mesh import build_mesh, parse_mesh

    from kubeflow_tpu_torch.models.llama import Llama
    from kubeflow_tpu_torch.models.registry import get_model

    entry = get_model(args.model)
    objective = args.objective or (
        "mlm" if entry.name.startswith("bert") else "causal")
    spec = parse_mesh(args.mesh)
    sizes = spec.sizes() if spec is not None else {}
    pipeline = sizes.get("pipeline", 1) != 1
    if pipeline and (objective != "causal"
                     or not isinstance(entry.make(), Llama)):
        # The reference's guard: a non-decoder tree has no blocks to
        # stage.
        raise SystemExit(
            "a pipeline mesh axis needs a causal decoder (Llama) model "
            f"(got {entry.name!r}, objective={objective!r})")
    if sizes.get("tensor", 1) != 1 and pipeline:
        raise SystemExit(
            f"--mesh {args.mesh}: the pipeline trainer's blocks are "
            f"whole; tensor with pipeline is not a preset")

    from kubeflow_tpu_torch.training.launcher import initialize_distributed
    from kubeflow_tpu_torch.utils.platform import default_device

    args.device = default_device(args.device)
    # The tpu-lm pod command joins its gang itself (the env travels to
    # it; a launcher's own join would not).
    gang = initialize_distributed(device=args.device)
    mesh = build_mesh(spec, args.device) if (spec or gang) else None

    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.training import optim
    from kubeflow_tpu_torch.training.checkpoint import (
        CheckpointConfig,
        ContinuousCheckpointConfig,
    )
    from kubeflow_tpu_torch.training.data import (
        DevicePrefetcher,
        mlm_mask_batches,
        resolve_shards,
        synthetic_causal_lm,
        synthetic_mlm,
        token_shard_batches,
    )
    from kubeflow_tpu_torch.training.lm import (
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.training.loop import (
        DRAIN_EXIT_CODE,
        DrainInterrupt,
        LoopConfig,
        fit,
    )
    from kubeflow_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    kwargs = {}
    if entry.decoder:
        kwargs["param_dtype"] = "float32"  # fp32 masters (BERT keeps them)
    if args.remat:
        kwargs["remat"] = True
    if args.num_layers is not None:
        kwargs["num_layers"] = args.num_layers
    # The init is the whole model's, so a tensor=T or expert=X run
    # starts from the weights a one-rank run draws; the trainer cuts them
    # to the rank's pieces. A model runs on the mesh built on it where
    # its tensor axis is live, and an MoE model wherever the gang has
    # more than one rank (it routes the global batch).
    whole = entry.make(**kwargs)
    model = whole
    if mesh is not None and not pipeline and (
            mesh.shape["tensor"] > 1
            or (getattr(whole, "num_experts", 0) and mesh.size > 1)):
        model = entry.make(**kwargs, mesh=mesh)
    vocab = entry.num_classes_or_vocab

    if args.data:
        gen = token_shard_batches(
            resolve_shards(args.data), args.global_batch, args.seq_len,
            seed=args.seed, bin_dtype=args.bin_dtype, mesh=mesh)
        gen = check_vocab(gen, vocab)
        if objective == "mlm":
            gen = mlm_mask_batches(gen, seed=args.seed, mesh=mesh)
    elif objective == "mlm":
        gen = synthetic_mlm(args.global_batch, args.seq_len, vocab,
                            seed=args.seed, mesh=mesh)
    else:
        gen = synthetic_causal_lm(args.global_batch, args.seq_len, vocab,
                                  seed=args.seed, mesh=mesh)

    # The reference initializes from the stream's first batch and trains
    # from the second; the port draws its init from --seed, and skips
    # that batch all the same, so both train on the same batches.
    next(gen)

    tx = optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(
            optim.warmup_cosine_decay_schedule(
                0.0, args.learning_rate, args.warmup_steps,
                max(args.steps, args.warmup_steps + 1)),
            weight_decay=0.01))
    params = init_params(whole, seed=args.seed, device=device)
    if pipeline:
        # The pipeline trainer (training/pipeline_lm.py): the blocks
        # staged over the pipeline axis, GPipe or the interleaved
        # schedule; each rank keeps its own stages.
        from kubeflow_tpu_torch.training.pipeline_lm import (
            create_pipeline_lm_state,
            make_pipeline_lm_train_step,
        )

        state, _ = create_pipeline_lm_state(
            model, tx, params, mesh, n_virtual=args.virtual_stages)
        step_fn = make_pipeline_lm_train_step(
            mesh, model, n_microbatches=args.microbatches,
            objective=objective, n_virtual=args.virtual_stages)
    else:
        state, _ = create_lm_state(model, tx, params, mesh)
        step_fn = make_lm_train_step(mesh, objective=objective)
    del params

    ckpt = continuous = None
    mesh_shape = mesh.shape if mesh is not None else None
    if args.checkpoint_dir:
        ckpt = CheckpointConfig(directory=args.checkpoint_dir,
                                save_interval_steps=args.save_every,
                                mesh_shape=mesh_shape)
        if args.continuous_every > 0:
            continuous = ContinuousCheckpointConfig(
                directory=str(Path(args.checkpoint_dir) / "continuous"),
                save_interval_steps=args.continuous_every,
                mesh_shape=mesh_shape)
    config = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                        checkpoint=ckpt, continuous=continuous,
                        metrics_path=args.metrics_path)
    data = DevicePrefetcher(gen, mesh, device=device)
    try:
        state = fit(state, step_fn, data, config)
    except DrainInterrupt as drain:
        print(json.dumps({"drained": True, "step": drain.step,
                          "checkpointed": drain.checkpointed}))
        return DRAIN_EXIT_CODE
    finally:
        data.close()

    print(json.dumps({
        "model": entry.name,
        "objective": objective,
        "final_step": int(state.step),
        "mesh": mesh.shape if mesh is not None else {"data": 1},
        "device": str(device),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
