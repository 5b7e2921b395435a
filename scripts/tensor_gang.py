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

"""The tensor gang phase of ``chip_smoke.py``: a ``tensor=2`` export of
llama3-8b served on a gang of ranks, each reading only its own shard.

Run from the repository root, on one GPU::

    python3 scripts/tensor_gang.py

builds the kernels, holds each kernel at the per-rank shapes of
``tensor=2`` against its plain version (``chip_smoke.tensor_rows``) and
runs ``chip_smoke.gang_tensor``: ``kft-export --shards tensor=2``, the
same weights loaded monolithically in this process, and two rank
processes of this script (``--rank``) that form the gang. Two ranks on
one card cannot form an nccl group (nccl refuses two ranks on one
device), so they join a gloo group, whose documented CUDA collectives
are ``all_reduce`` and ``broadcast``; the port's tensor all-gather runs
as an all-reduce of a zeroed buffer there. ``--transport nccl --world
4`` (four cards, one rank each) runs the same gang over nccl at
``tensor=4``.

As a rank (``--rank R``), the script joins the gang, loads the export
with ``load_version`` (rank r reads shard r), and writes what it
computed to ``--out``: the shard files it opened, its kernel launches
over the phase's main path, the prefill's logits and the logits of each
request's tokens fed back (rank 0), and the tokens of ``run`` and of
the engine, greedy and sampled (rank 0 drives, the others
``follow()``).
"""

import argparse
import dataclasses
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def log(msg: str) -> None:
    print(f"[tensor_gang] {msg}", flush=True)


COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "broadcast")


def timed_collectives(names=COLLECTIVES):
    """Count this rank's collectives (by default all_reduce, the
    all-gather, broadcast, and the broadcasts inside
    ``broadcast_object_list``: the gang's control messages) and time
    them. A call on CUDA tensors is timed on the card, by CUDA events on
    the current stream around it: an nccl call only enqueues its work,
    and the stream then waits for it, so the gap between the events is
    the collective on the device's clock, its wait for the peers
    included. A call on CPU tensors (gloo's object broadcasts) is timed
    by the host clock. ``batch_isend_irecv`` is timed by its first op's
    tensor. Returns a function that synchronizes the card and gives the
    totals so far."""
    c10d = torch.distributed.distributed_c10d
    spent = {"calls": 0, "host_s": 0.0}
    events = []
    for name in names:
        real = getattr(c10d, name)

        def call(first, *args, _real=real, **kw):
            spent["calls"] += 1
            tensor = first[0].tensor if isinstance(first, list) else first
            if tensor.is_cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _real(first, *args, **kw)
                end.record()
                events.append((start, end))
                return out
            t0 = time.monotonic()
            try:
                return _real(first, *args, **kw)
            finally:
                spent["host_s"] += time.monotonic() - t0

        # broadcast_object_list finds broadcast in the module's globals;
        # the port calls them through torch.distributed.
        setattr(c10d, name, call)
        setattr(torch.distributed, name, call)

    def totals():
        if events:
            torch.cuda.synchronize()
        device_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
        return dict(spent, device_s=device_s, device_calls=len(events))

    return totals


def rank_main(args) -> int:
    from kubeflow_tpu_torch.models.llama import apply
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import decode_attention as da
    from kubeflow_tpu_torch.ops import decode_gemm as dg
    from kubeflow_tpu_torch.ops import prefill_gemm as pg
    from kubeflow_tpu_torch.ops import rms_norm as rn
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.serving.model import LoadedModel, load_version

    case = pickle.loads(open(args.case, "rb").read())
    # Ranks sharing one card all compute on it.
    index = 0 if args.transport == "gloo" else args.rank
    torch.cuda.set_device(index)
    device = torch.device("cuda", index)
    dist = torch.distributed
    kw = {"device_id": device} if args.transport == "nccl" else {}
    dist.init_process_group(
        args.transport, init_method=f"tcp://localhost:{args.port}",
        world_size=args.world, rank=args.rank, **kw)
    log(f"rank {args.rank}/{args.world}: transport {args.transport} "
        f"on {device}")
    counters = {"flash_attention": flash_attention,
                "decode_gemm": dg.decode_linear, "rms_norm": rn.rms_norm,
                "add_rms_norm": rn.add_rms_norm,
                "decode_attention": da.decode_attention,
                "prefill_gemm": pg.prefill_linear}
    out = {"rank": args.rank}
    try:
        t0 = time.monotonic()
        loaded = load_version(case["export"], max_batch=1, device=device)
        out["load_s"] = time.monotonic() - t0
        out["opened"] = loaded.shard_files
        out["topology"] = loaded.shard_topology()
        forward = get_model(case["model"]).make(
            dtype=case["dtype"], num_layers=case["layers"],
            mesh=loaded.mesh)
        collectives = timed_collectives()
        for fn in counters.values():
            fn.launches = 0
        t_main = time.monotonic()
        with torch.inference_mode():
            ids = torch.from_numpy(case["prefill"]).to(device)
            logits = apply(forward, loaded.params, ids)
            if args.rank == 0:
                out["prefill_logits"] = logits.float().cpu().numpy()
            # Each request's tokens fed back: the logits of each step,
            # where the monolithic run's tokens are the context.
            fed = []
            for prompt, tokens in zip(case["prompts"], case["mono_tokens"]):
                seq = np.concatenate([prompt, tokens[:-1]])[None]
                step = apply(forward, loaded.params,
                             torch.from_numpy(seq).to(device))
                fed.append(step[0, len(prompt) - 1:].float().cpu().numpy())
            if args.rank == 0:
                out["fed_logits"] = fed
        for mode, sampling in case["modes"].items():
            meta = loaded.metadata
            config = dict(meta.generate_config, **sampling)
            model = LoadedModel(
                metadata=dataclasses.replace(meta, generate_config=config),
                version=loaded.version, params=loaded.params, max_batch=1,
                device=device, mesh=loaded.mesh)
            if args.rank != 0:
                out[mode] = model.follow()
                continue
            got = {"b1": [], "b1_s": []}
            for prompt, key in zip(case["prompts"], case["keys"]):
                t0 = time.monotonic()
                got["b1"].append(model.run(
                    {"input_ids": prompt[None]},
                    row_rngs=np.asarray([key], np.uint32))["tokens"][0])
                got["b1_s"].append(time.monotonic() - t0)
            engine = model.ensure_engine()
            t0 = time.monotonic()
            streams = [engine.submit(p, rng=k) for p, k in
                       zip(case["prompts"], case["keys"])]
            got["streams"] = [s.result(600.0) for s in streams]
            got["engine_s"] = time.monotonic() - t0
            got["engine"] = {gid: s.tokens_so_far
                             for gid, s in engine.gang_streams.items()}
            got["stats"] = engine.stats()
            model.close()
            out[mode] = got
        out["collectives"] = collectives()
        out["launches"] = {k: fn.launches for k, fn in counters.items()}
        out["main_s"] = time.monotonic() - t_main
    finally:
        dist.destroy_process_group()
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    log(f"rank {args.rank}: launches {out['launches']}, collectives "
        f"{out['collectives']}")
    return 0


def phase_main(args) -> int:
    if not torch.cuda.is_available():
        print("tensor_gang: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    card = smoke.environment()
    t0 = time.monotonic()
    reports = smoke._build.build_all()
    smoke.log(f"built in {time.monotonic() - t0:.1f} s")
    kernels = smoke.compiler_report(reports["flash_attention"])
    smoke.tensor_rows(kernels)
    smoke.gang_tensor(card, transport=args.transport, world=args.world)
    smoke.log(f"tensor gang phase: {time.monotonic() - t0:.1f} s from the "
              f"build")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rank", type=int, default=None,
                        help="run as this rank of the gang")
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--transport", default="gloo",
                        choices=("gloo", "nccl"))
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--case", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if args.rank is None:
        return phase_main(args)
    return rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
