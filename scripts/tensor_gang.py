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

As a rank (``--rank R``), the script joins the gang and writes what it
computed to ``--out``, rank 0 driving and the others following: first a
``ModelManager`` (rank 0: a model a mode, loaded onto the gang by its
poll, a gRPC server, the engine mix through ``ServedModel``; the others:
``ModelManager.follow()``); then the export loaded with ``load_version``
(rank r reads shard r): the shard files it opened, the prefill's logits
and the logits of each request's tokens fed back (rank 0), and each
engine lane's tokens, greedy and sampled (``LoadedModel.follow()`` on
the others); then the ``fsdp=world`` export of the same weights: its
files, the bytes held at rest, the peak memory, the prefill's logits and
a greedy ``run``, each timed beside its collectives. Its kernel
launches over the whole path.
"""

import argparse
import dataclasses
import gc
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


def _variant(loaded, device, **config):
    """``loaded``'s params on its mesh under an export config changed by
    ``config`` (a lane's engine knobs, a mode's sampling): a version of
    its own on the gang's line (rank 0 drives it, the others follow)."""
    from kubeflow_tpu_torch.serving.model import LoadedModel

    meta = loaded.metadata
    return LoadedModel(
        metadata=dataclasses.replace(
            meta, generate_config=dict(meta.generate_config, **config)),
        version=loaded.version, params=loaded.params, max_batch=1,
        device=device, mesh=loaded.mesh)


def _results(streams, timeout=600.0):
    return [s.result(timeout) for s in streams]


def _lane(model, case, mode, lane):
    """Rank 0's requests of one lane (the other ranks follow): the
    tokens it streamed, its engine's stats and every request's tokens
    by gang id."""
    from kubeflow_tpu_torch.inference import prng
    from kubeflow_tpu_torch.serving import wire

    engine = model.ensure_engine()
    prompts, keys = case["prompts"], case["keys"]
    got = {}
    t0 = time.monotonic()
    if lane in ("plain", "spec"):
        got["streams"] = _results([engine.submit(p, rng=k)
                                   for p, k in zip(prompts, keys)])
    if lane == "plain":
        # Three resumes of request 0: at 1, the middle and budget - 1.
        full = got["streams"][0]
        steps = prng.split(np.asarray(keys[0], np.uint32), len(full))
        got["resumes"] = [engine.submit(
            np.concatenate([prompts[0], full[:cut]]), step_keys=steps[cut:],
            prompt_len=len(prompts[0])).result(600.0)
            for cut in case["cuts"]]
        # KV handoff: the gang's own blob adopted here (its heads
        # gathered, then cut again), the gang's blob for the parent's
        # one-card load, and the parent's adopted here.
        p, k = case["handoff_prompt"], case["handoff_key"]
        got["local"] = engine.submit(p, rng=k).result(600.0)
        handoff = engine.run_prefill(p, rng=k)
        got["blob"] = wire.encode_kv_handoff("llama", 1, handoff)
        got["own_adopted"] = engine.submit(handoff=wire.decode_kv_handoff(
            got["blob"], model="llama", version=1)).result(600.0)
        got["adopted"] = engine.submit(handoff=wire.decode_kv_handoff(
            case["incoming"][mode], model="llama", version=1)).result(600.0)
    if lane in ("prefix", "chunk"):
        # Each prompt of the prefix mix cold (the index cleared after
        # it), then the mix in one pass, where the later ones hit.
        mix, mix_keys = case["prefix_prompts"], case["prefix_keys"]
        got["cold"] = []
        for p, k in zip(mix, mix_keys):
            got["cold"].append(engine.submit(p, rng=k).result(600.0))
            engine.clear_prefix_cache()
        got["warm"] = [engine.submit(p, rng=k).result(600.0)
                       for p, k in zip(mix, mix_keys)]
    got["s"] = time.monotonic() - t0
    got["stats"] = engine.stats()
    got["engine"] = {gid: s.tokens_so_far
                     for gid, s in engine.gang_streams.items()}
    return got


def manager_part(case, device):
    """Rank 0: a ``ModelManager`` over the export, a model a mode (each
    loading onto the gang as its first poll), and a gRPC server; the
    engine mix through ``ServedModel.submit``, ``submit_stream`` and one
    gRPC Predict, beside the version's B = 1 ``run``. The other ranks:
    ``ModelManager.follow()`` until rank 0's manager stops."""
    from kubeflow_tpu_torch.inference.engine.gang import GangLink
    from kubeflow_tpu_torch.serving import wire
    from kubeflow_tpu_torch.serving.manager import ModelManager

    gang = GangLink()
    manager = ModelManager(poll_interval_s=3600, device=device, gang=gang)
    if not gang.leader:
        return manager.follow()
    import grpc

    from kubeflow_tpu_torch.serving.grpc_server import make_server

    out = {}
    t0 = time.monotonic()
    for mode, base in case["manager_bases"].items():
        manager.add_model(mode, base, max_batch=1, continuous_batching=True)
    out["load_s"] = time.monotonic() - t0
    server, port = make_server(manager, 0)
    server.start()
    try:
        for mode in case["manager_bases"]:
            served = manager.get_model(mode)
            loaded = served.get()
            rows = [{"input_ids": p[None]} for p in case["prompts"]]
            t0 = time.monotonic()
            futures = [served.submit(r, None, None, None) for r in rows]
            unary = [f.result(600.0)["tokens"][0] for f in futures]
            streamed = [_results(served.submit_stream(r, None, None)[1])[0]
                        for r in rows]
            with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
                reply = channel.unary_unary(
                    "/tensorflow.serving.PredictionService/Predict")(
                    wire.encode_predict_request(mode, rows[0]),
                    timeout=600.0)
            grpc_tokens = wire.decode_predict_response(reply)[1]["tokens"]
            served_s = time.monotonic() - t0
            b1 = [loaded.run(r)["tokens"][0] for r in rows]
            out[mode] = {"unary": unary, "streamed": streamed,
                         "grpc": grpc_tokens[0], "b1": b1,
                         "served_s": served_s,
                         "topology": loaded.shard_topology()}
    finally:
        server.stop(grace=None)
        manager.stop()
    return out


def fsdp_part(case, device, collectives):
    """The ``fsdp=2`` export of the same weights: each rank reads its
    own shard and holds half of every kernel and table at rest, its
    peak memory, the [1, 512] prefill's logits (rank 0) and request 0's
    greedy tokens through ``run`` (rank 0 drives; the export's budget),
    each timed beside
    the collectives' device time in it (the fsdp gathers)."""
    from kubeflow_tpu_torch.models.llama import apply
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.model import load_version

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    loaded = load_version(case["fsdp_export"], max_batch=1, device=device)
    out = {"load_s": time.monotonic() - t0, "opened": loaded.shard_files,
           "topology": loaded.shard_topology(),
           "held_bytes": sum(t.numel() * t.element_size()
                             for t in loaded.params.values())}
    forward = get_model(case["model"]).make(
        dtype=case["dtype"], num_layers=case["layers"], mesh=loaded.mesh,
        fsdp_pieces=True)
    with torch.inference_mode():
        before = collectives()
        t0 = time.monotonic()
        logits = apply(forward, loaded.params,
                       torch.from_numpy(case["prefill"]).to(device))
        torch.cuda.synchronize()
        after = collectives()
        out["prefill_s"] = time.monotonic() - t0
        out["prefill_gather_s"] = after["device_s"] - before["device_s"]
        if torch.distributed.get_rank() == 0:
            out["prefill_logits"] = logits.float().cpu().numpy()
        del logits
    before = collectives()
    t0 = time.monotonic()
    if torch.distributed.get_rank() == 0:
        out["tokens"] = loaded.run({"input_ids": case["prompts"][0][None]})[
            "tokens"][0]
        loaded.close()
    else:
        out.update(loaded.follow())
    torch.cuda.synchronize()
    after = collectives()
    out["run_s"] = time.monotonic() - t0
    out["run_gather_s"] = after["device_s"] - before["device_s"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def rank_main(args) -> int:
    from kubeflow_tpu_torch.models.llama import apply
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import decode_attention as da
    from kubeflow_tpu_torch.ops import decode_gemm as dg
    from kubeflow_tpu_torch.ops import prefill_gemm as pg
    from kubeflow_tpu_torch.ops import rms_norm as rn
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.serving.model import load_version

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
    lead = args.rank == 0
    out = {"rank": args.rank}
    try:
        collectives = timed_collectives()
        for fn in counters.values():
            fn.launches = 0
        t_main = time.monotonic()
        t0 = time.monotonic()
        out["manager"] = manager_part(case, device)
        out["manager_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        loaded = load_version(case["export"], max_batch=1, device=device)
        out["load_s"] = time.monotonic() - t0
        out["opened"] = loaded.shard_files
        out["topology"] = loaded.shard_topology()
        forward = get_model(case["model"]).make(
            dtype=case["dtype"], num_layers=case["layers"],
            mesh=loaded.mesh)
        with torch.inference_mode():
            ids = torch.from_numpy(case["prefill"]).to(device)
            logits = apply(forward, loaded.params, ids)
            if lead:
                out["prefill_logits"] = logits.float().cpu().numpy()
            # Each request's tokens fed back: the logits of each step,
            # where the monolithic run's tokens are the context.
            fed = []
            for prompt, tokens in zip(case["prompts"], case["mono_tokens"]):
                seq = np.concatenate([prompt, tokens[:-1]])[None]
                step = apply(forward, loaded.params,
                             torch.from_numpy(seq).to(device))
                fed.append(step[0, len(prompt) - 1:].float().cpu().numpy())
            if lead:
                out["fed_logits"] = fed
        for mode, sampling in case["modes"].items():
            for lane, knobs in case["lanes"].items():
                model = _variant(loaded, device, **sampling, **knobs)
                if not lead:
                    out[mode, lane] = model.follow()
                    continue
                got = _lane(model, case, mode, lane)
                if lane == "plain":
                    got["b1"], got["b1_s"] = [], []
                    for prompt, key in zip(case["prompts"], case["keys"]):
                        t0 = time.monotonic()
                        got["b1"].append(model.run(
                            {"input_ids": prompt[None]},
                            row_rngs=np.asarray([key], np.uint32))[
                                "tokens"][0])
                        got["b1_s"].append(time.monotonic() - t0)
                model.close()
                out[mode, lane] = got
        out["lanes_s"] = time.monotonic() - t_main - out["manager_s"]
        del loaded, forward
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        out["fsdp"] = fsdp_part(case, device, collectives)
        out["fsdp_s"] = time.monotonic() - t0
        out["collectives"] = collectives()
        out["launches"] = {k: fn.launches for k, fn in counters.items()}
        out["main_s"] = time.monotonic() - t_main
    finally:
        dist.destroy_process_group()
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    log(f"rank {args.rank}: launches {out['launches']}, collectives "
        f"{out['collectives']}, manager {out['manager_s']:.1f} s, lanes "
        f"{out['lanes_s']:.1f} s, fsdp {out['fsdp_s']:.1f} s")
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
