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
line, and adds ``--device`` (``cuda`` unless ``--device cpu``)::

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
objective the reference's CLI accepts without a mesh is accepted. Not
ported: a ``--mesh`` and its pipeline axis (ROADMAP A14: raises); in a
gang, each process trains its own state on its rows of the batch until
the data-parallel step lands with A14, and ``--checkpoint_dir`` raises
there (``fit`` refuses a gang's checkpoint until A14's sharded save).
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
                   help="a device mesh (ROADMAP A14: raises; the port "
                        "trains on one device)")
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
                        "pipeline mesh axis: ROADMAP A14)")
    p.add_argument("--virtual_stages", type=int, default=1,
                   help="interleaved pipeline stages (ROADMAP A14)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
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
    if args.mesh:
        raise SystemExit(
            f"--mesh {args.mesh}: the sharded trainer (and its pipeline "
            "axis) is not ported yet (ROADMAP A14); the port trains on one "
            "device")

    from kubeflow_tpu_torch.training.launcher import initialize_distributed

    # The tpu-lm pod command joins its gang itself (the env travels to
    # it; a launcher's own join would not).
    initialize_distributed(device=args.device)

    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.models.registry import get_model
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

    entry = get_model(args.model)
    objective = args.objective or (
        "mlm" if entry.name.startswith("bert") else "causal")
    device = resolve_device(args.device)
    kwargs = {}
    if entry.decoder:
        kwargs["param_dtype"] = "float32"  # fp32 masters (BERT keeps them)
    if args.remat:
        kwargs["remat"] = True
    if args.num_layers is not None:
        kwargs["num_layers"] = args.num_layers
    model = entry.make(**kwargs)
    vocab = entry.num_classes_or_vocab

    if args.data:
        gen = token_shard_batches(
            resolve_shards(args.data), args.global_batch, args.seq_len,
            seed=args.seed, bin_dtype=args.bin_dtype)
        gen = check_vocab(gen, vocab)
        if objective == "mlm":
            gen = mlm_mask_batches(gen, seed=args.seed)
    elif objective == "mlm":
        gen = synthetic_mlm(args.global_batch, args.seq_len, vocab,
                            seed=args.seed)
    else:
        gen = synthetic_causal_lm(args.global_batch, args.seq_len, vocab,
                                  seed=args.seed)

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
    params = init_params(model, seed=args.seed, device=device)
    state, _ = create_lm_state(model, tx, params)
    step_fn = make_lm_train_step(objective=objective)

    ckpt = continuous = None
    if args.checkpoint_dir:
        ckpt = CheckpointConfig(directory=args.checkpoint_dir,
                                save_interval_steps=args.save_every)
        if args.continuous_every > 0:
            continuous = ContinuousCheckpointConfig(
                directory=str(Path(args.checkpoint_dir) / "continuous"),
                save_interval_steps=args.continuous_every)
    config = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                        checkpoint=ckpt, continuous=continuous,
                        metrics_path=args.metrics_path)
    data = DevicePrefetcher(gen, device=device)
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
        "mesh": {"data": 1},
        "device": str(device),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
