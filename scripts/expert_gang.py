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

"""The expert and tensor phase of ``chip_smoke.py`` (``gang_expert``):
the MoE Llama on an expert and a data mesh and BERT on a tensor mesh,
each through the tpu-lm chain (``create_lm_state`` → ``make_lm_train_step``)
on a gang of ranks.

Run from the repository root, on one GPU::

    python3 scripts/expert_gang.py

builds the kernels, times flash at the gang's shapes, runs the
one-process yardsticks (the same steps unmeshed) and then two rank
processes of this script (``--rank``) sharing the card: nccl refuses two
ranks on one device, so they join a gloo group, whose documented CUDA
collectives are ``all_reduce`` and ``broadcast``; the port's gathers run
as all-reduces of zeroed buffers there (``parallel/collectives.py``).
``--transport nccl --world 4`` (four cards, one rank each) runs
llama-moe-bench on ``data=2, expert=2`` and ``expert=2, tensor=2`` and
BERT on ``data=2, tensor=2`` over nccl (FOUR_CARD_RUNS).

As a rank (``--rank R``), the script joins the gang and writes to
``--out`` what it computed for each run: its step metrics and walls,
each of its param pieces' distance from the one-process step's
(relative to that piece's norm and to its update's, ``|w - w_ref| /
|w_ref - w0|``), whether it holds only its own experts or heads, the
collectives' share of its steps (CUDA events around each, as
``scripts/tensor_gang.py`` times them), the MoE layer's device ms on an
expert=2 rank, and its kernels' launches over the phase's main path.
Times on one card are time-slicing of two processes, not a speed-up.
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

#: The collectives the runs issue, on every transport.
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "broadcast",
               "reduce_scatter_tensor")
#: The runs on four cards (one nccl rank a card).
FOUR_CARD_RUNS = (
    ("moe data=2,expert=2", "moe", {"data": 2, "expert": 2}),
    ("moe expert=2,tensor=2", "moe", {"expert": 2, "tensor": 2}),
    ("bert data=2,tensor=2", "bert", {"data": 2, "tensor": 2}),
)


def log(msg: str) -> None:
    print(f"[expert_gang] {msg}", flush=True)


def reference_leaf(files, name, device):
    path, shape = files[name]
    return torch.from_numpy(np.fromfile(path, np.float32).reshape(
        shape)).to(device)


def own_pieces(kind, state, mesh):
    """Whether this rank holds only its own experts' ``w_in`` and
    ``w_out`` (E/X of them) or its own heads (H/T of q, k and v)."""
    params = state.params
    if kind == "moe":
        model = state.model
        experts = model.num_experts // mesh.shape["expert"]
        width = model.mlp_dim // mesh.shape["tensor"]
        return all(
            tuple(params[f"layers.{i}.moe.w_in"].shape)
            == (experts, model.d_model, width)
            and tuple(params[f"layers.{i}.moe.w_out"].shape)
            == (experts, width, model.d_model)
            for i in range(model.num_layers))
    model = state.model
    heads = model.d_model // mesh.shape["tensor"]
    return all(tuple(params[f"layers.{i}.attention.{p}.weight"].shape)
               == (heads, model.d_model)
               for i in range(model.num_layers)
               for p in ("query", "key", "value"))


def run_part(name, kind, spec, case, device, smoke, collectives):
    """One run: the state from the whole model's init (seed 0) cut to
    this rank's pieces, the steps through the tpu-lm chain, and its
    pieces against the one-process step's params."""
    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from kubeflow_tpu_torch.training.lm import (
        create_lm_state,
        make_lm_train_step,
    )

    mesh = build_mesh(MeshSpec(**spec), device)
    whole, model, tx, batches, objective = smoke.expert_config(kind, mesh)
    initial = init_params(whole, seed=0, device=device)
    state, shardings = create_lm_state(
        model, tx, {k: v.clone() for k, v in initial.items()}, mesh)
    step = make_lm_train_step(mesh, objective=objective)
    before = collectives()
    metrics, walls = [], []
    with smoke.counted_run(f"rank {mesh.rank} {name}", smoke.EXPERT_STEPS,
                           smoke.expert_launches(kind, model)) as launches:
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = step(state, batch)
            metrics.append({k: float(x) for k, x in m.items()})
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
    after = collectives()
    files = case["files"][kind]
    param_rel, update_rel, noise_moves = {}, {}, {}
    for key, leaf in state.params.items():
        index = shardings[key].index(files[key][1])
        ref = reference_leaf(files, key, device)[index]
        w0 = initial[key].float()[index]
        if key.endswith(smoke.ZERO_GRADIENT_LEAVES):
            noise_moves[key] = (
                float((leaf.detach().float() - w0).abs().max()),
                float((ref - w0).abs().max()))
            continue
        diff = float((leaf.detach().float() - ref).norm())
        moved = float((ref - w0).norm())
        param_rel[key] = diff / float(ref.norm())
        update_rel[key] = (diff / moved if moved else
                           0.0 if diff == 0 else float("inf"))
    out = {"metrics": metrics, "step_s": walls,
           "collective_share": ((after["device_s"] - before["device_s"])
                                / sum(walls)),
           "collective_calls": after["calls"] - before["calls"],
           "param_rel": param_rel, "update_rel": update_rel,
           "noise_moves": noise_moves,
           "own_pieces": own_pieces(kind, state, mesh),
           "pieces": {k: tuple(v.shape) for k, v in state.params.items()
                      if ".moe.w_in" in k or "attention.query.weight" in k},
           "launches": dict(launches)}
    log(f"rank {mesh.rank} {name}: loss {[m['loss'] for m in metrics]}, "
        f"aux {[m['aux_loss'] for m in metrics]}, step s {walls}")
    del state, step, initial
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rank_main(args) -> int:
    import tensor_gang

    import chip_smoke as smoke
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
    out = {"rank": args.rank, "runs": {}}
    try:
        collectives = tensor_gang.timed_collectives(COLLECTIVES)
        # The phase's main path: each run's counts are zeroed just before
        # its steps and read just after (counted_run), and summed here.
        total = dict.fromkeys(smoke.TRAIN_KERNELS, 0)
        t_main = time.monotonic()
        for name, kind, spec in case["runs"]:
            got = run_part(name, kind, spec, case, device, smoke,
                           collectives)
            out["runs"][name] = got
            for k in total:
                total[k] += got["launches"][k]
        out["collectives"] = collectives()
        out["main_s"] = time.monotonic() - t_main
        # BERT has no RMSNorm: the norms' launches are the MoE runs'.
        out["launches"] = total
        experts = next((spec for _, kind, spec in case["runs"]
                        if kind == "moe" and "expert" in spec), None)
        if experts is not None:
            mesh = build_mesh(MeshSpec(**experts), device)
            out["moe_layer_ms"] = smoke.moe_layer_rows(device,
                                                       mesh)["moe_ms"]
    finally:
        dist.destroy_process_group()
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    log(f"rank {args.rank}: collectives {out['collectives']}, main "
        f"{out['main_s']:.1f} s")
    return 0


def phase_main(args) -> int:
    if not torch.cuda.is_available():
        print("expert_gang: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    card = smoke.environment()
    t0 = time.monotonic()
    reports = smoke._build.build_all()
    smoke.log(f"built in {time.monotonic() - t0:.1f} s")
    smoke.expert_flash_rows(smoke.compiler_report(
        reports["flash_attention"]))
    if args.world == 4:
        smoke.EXPERT_RUNS = FOUR_CARD_RUNS
    smoke.gang_expert(card, transport=args.transport, world=args.world)
    smoke.log(f"expert gang phase: {time.monotonic() - t0:.1f} s from the "
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
