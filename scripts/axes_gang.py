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

"""The seq and pipeline phase of ``chip_smoke.py`` (``gang_axes``): ring
and Ulysses attention, a ring-attention Llama forward and the GPipe and
interleaved pipeline trainer on a gang of ranks.

Run from the repository root, on one GPU::

    python3 scripts/axes_gang.py

builds the kernels, runs the one-process yardsticks (the flash call, the
plain twin's gradients, the unpipelined forward and train steps) and
then two rank processes of this script (``--rank``) sharing the card:
nccl refuses two ranks on one device, so they join a gloo group, whose
documented CUDA collectives are ``all_reduce`` and ``broadcast``; the
port's shifts, exchanges and gathers run as all-reduces of zeroed
buffers there (``parallel/collectives.py``). ``--transport nccl --world
4`` (four cards, one rank each) runs the attention on ``seq=4`` and the
pipeline on ``data=2, pipeline=2`` over nccl.

As a rank (``--rank R``), the script joins the gang and writes to
``--out`` what it computed: (a) each attention case's output through
both strategies on ``seq=world`` (and, for the llama3-8b case, dq, dk,
dv of ``sum(out · g)``), its flash launches and ms; (b) the ring
forward's logits (rank 0) and a fingerprint of every bit of them; (c)
each schedule's step metrics, walls, flash launches, each updated
param's distance from the unpipelined step's, relative to that param's
norm and to its update's (``|w - w_ref| / |w_ref - w0|``), the bubble
formula and the measured idle share; and the collectives' calls and
device seconds (CUDA events around each, as ``scripts/tensor_gang.py``
times them). Times on one card are time-slicing of two processes, not
a speed-up.
"""

import argparse
import gc
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: The collectives the axes issue, on every transport.
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "broadcast",
               "all_to_all_single", "batch_isend_irecv")


def log(msg: str) -> None:
    print(f"[axes_gang] {msg}", flush=True)


def fingerprint(t: torch.Tensor) -> int:
    """An integer of every bit of ``t`` (fp32): its words weighted by
    their positions mod a prime, summed in int64 (equal tensors give
    equal prints)."""
    bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weights = torch.arange(bits.numel(), device=t.device) % 1000003 + 1
    return int((bits * weights).sum())


def attention_part(case, mesh, device, smoke):
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.parallel.ring_attention import (
        make_sequence_parallel_attention,
    )

    out = {}
    for shape, seed in zip(case["attention"], case["seeds"]):
        name, causal, grads = shape[0], shape[6], shape[8]
        q, k, v, g, mask = smoke.axes_qkv(shape, seed, device)
        rows = {}
        for strategy in ("ulysses", "ring"):
            fn = make_sequence_parallel_attention(mesh, strategy=strategy,
                                                  causal=causal)
            inputs = [t.detach().requires_grad_(grads) for t in (q, k, v)]
            torch.cuda.synchronize()
            before = flash_attention.launches
            t0 = time.monotonic()
            with torch.set_grad_enabled(grads):
                o = fn(*inputs, kv_segment_valid=mask)
            row = {"launches": flash_attention.launches - before}
            if grads:
                row["grads"] = [t.float().cpu() for t in
                                torch.autograd.grad(o, inputs, g)]
            torch.cuda.synchronize()
            row["ms"] = (time.monotonic() - t0) * 1e3
            row["out"] = o.detach().cpu()
            rows[strategy] = row
            del o, inputs
        out[name] = rows
        del q, k, v, g, mask
        gc.collect()
    return out


def llama_part(case, mesh, device, smoke):
    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.models.llama import apply
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.parallel.ring_attention import (
        make_sequence_parallel_attention,
    )

    model = get_model(case["model"]).make(
        **case["llama"]["kwargs"],
        attention_fn=make_sequence_parallel_attention(
            mesh, strategy="ring", causal=True))
    params = init_params(model, seed=0, device=device)
    ids = torch.from_numpy(case["llama"]["ids"]).to(device)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.inference_mode():
        logits = apply(model, params, ids)
    torch.cuda.synchronize()
    row = {"ms": (time.monotonic() - t0) * 1e3,
           "fingerprint": fingerprint(logits)}
    if mesh.rank == 0:
        row["logits"] = logits.cpu()
    del params, logits
    return row


def reference_leaf(files, name, device):
    path, shape = files[name]
    return torch.from_numpy(np.fromfile(path, np.float32).reshape(
        shape)).to(device)


def param_rel(state, pipeline, mesh, n_virtual, device):
    """Each of this rank's leaves against the unpipelined step's updated
    params, by the unpipelined leaf's name (a stage leaf's layers by
    their global index: stage ``q·n + d`` of the rank at pipeline
    position d): ``|w - w_ref|`` over ``|w_ref|`` and over the update's
    ``|w_ref - w0|``, which a missing or misplaced update moves to about
    1 (``inf`` where the reference did not move and this rank did)."""
    n = mesh.shape["pipeline"]
    idx = mesh.coords()["pipeline"]
    leaves = []
    for name, t in state.params.items():
        if not name.startswith("stages."):
            leaves.append((name, t))
            continue
        rest = name[len("stages."):]
        pieces = ([(idx, t[0])] if n_virtual == 1 else
                  [(q * n + idx, t[q, 0]) for q in range(n_virtual)])
        for stage, leaf in pieces:
            for j in range(leaf.shape[0]):
                layer = stage * leaf.shape[0] + j
                leaves.append((f"layers.{layer}.{rest}", leaf[j]))
    params, updates = {}, {}
    for key, leaf in leaves:
        ref = reference_leaf(pipeline["files"], key, device)
        diff = float((leaf.detach() - ref).norm())
        moved = pipeline["update_norms"][key]
        params[key] = diff / float(ref.norm())
        updates[key] = (diff / moved if moved else
                        0.0 if diff == 0 else float("inf"))
    return params, updates


def pipeline_part(case, mesh, device, smoke, collectives):
    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.parallel.pipeline import (
        bubble_fraction_interleaved,
    )
    from kubeflow_tpu_torch.training.pipeline_lm import (
        create_pipeline_lm_state,
        make_pipeline_lm_train_step,
    )

    model, tx, batches = smoke.axes_pipeline_config(
        case["model"], case["pipeline"], mesh)
    out = {}
    for schedule, v in (("gpipe", 1),
                        ("interleaved", case["pipeline"]["virtual"])):
        params = init_params(model, seed=0, device=device)
        state, _ = create_pipeline_lm_state(model, tx, params, mesh,
                                            n_virtual=v)
        del params
        gc.collect()
        stats = {}
        step = make_pipeline_lm_train_step(
            mesh, model, n_microbatches=case["micro"], n_virtual=v,
            stats=stats)
        before = collectives()
        flash_before = flash_attention.launches
        metrics, walls = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = step(state, batch)
            metrics.append({k: float(x) for k, x in m.items()})
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        after = collectives()
        compute_s = sum(a.elapsed_time(b) for a, b in
                        stats.get("compute_events", [])) / 1e3
        n = mesh.shape["pipeline"]
        params_rel, update_rel = param_rel(state, case["pipeline"], mesh, v,
                                           device)
        out[schedule] = {
            "metrics": metrics, "step_s": walls,
            "flash_launches": flash_attention.launches - flash_before,
            "param_rel_rms": params_rel, "update_rel": update_rel,
            "ticks": stats.get("ticks"), "active_ticks": stats.get("active"),
            "bubble_formula": bubble_fraction_interleaved(
                n, case["micro"], v),
            # Time-slicing of the ranks on one card: the stage compute's
            # device time over the steps' walls.
            "idle_share": 1 - compute_s / sum(walls),
            "collective_share": ((after["device_s"] - before["device_s"])
                                 / sum(walls)),
            "collective_calls": after["calls"] - before["calls"],
        }
        log(f"rank {mesh.rank} {schedule}: loss "
            f"{[m['loss'] for m in metrics]}, step s {walls}, flash "
            f"{out[schedule]['flash_launches']}")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rank_main(args) -> int:
    import tensor_gang

    import chip_smoke as smoke
    from kubeflow_tpu_torch.ops import rms_norm as rn
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh

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
    out = {"rank": args.rank}
    counters = {"flash_attention": flash_attention,
                "rms_norm": rn.rms_norm, "add_rms_norm": rn.add_rms_norm}
    try:
        collectives = tensor_gang.timed_collectives(COLLECTIVES)
        # The phase's main path, its kernels' counts zeroed just before.
        for fn in counters.values():
            fn.launches = 0
        t_main = time.monotonic()
        seq = build_mesh(MeshSpec(seq=args.world), device)
        out["attention"] = attention_part(case, seq, device, smoke)
        out["llama"] = llama_part(case, seq, device, smoke)
        pipe = build_mesh(MeshSpec(pipeline=2, data=args.world // 2),
                          device)
        out["pipeline"] = pipeline_part(case, pipe, device, smoke,
                                        collectives)
        out["collectives"] = collectives()
        out["main_s"] = time.monotonic() - t_main
        out["launches"] = {k: fn.launches for k, fn in counters.items()}
    finally:
        dist.destroy_process_group()
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    log(f"rank {args.rank}: collectives {out['collectives']}, main "
        f"{out['main_s']:.1f} s")
    return 0


def phase_main(args) -> int:
    if not torch.cuda.is_available():
        print("axes_gang: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    card = smoke.environment()
    t0 = time.monotonic()
    reports = smoke._build.build_all()
    smoke.log(f"built in {time.monotonic() - t0:.1f} s")
    smoke.axes_flash_rows(smoke.compiler_report(reports["flash_attention"]))
    smoke.gang_axes(card, transport=args.transport, world=args.world)
    smoke.log(f"axes gang phase: {time.monotonic() - t0:.1f} s from the "
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
