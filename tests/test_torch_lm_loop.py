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

"""The LM input pipeline, training loop, evaluation and the tpu-lm CLI
of kubeflow_tpu_torch against kubeflow_tpu's.

Twins of tests/test_data_loop.py (generators bit-equal to the
reference's, the prefetcher's errors, fit's resume and metrics, token
shards), tests/test_evaluate.py (exact aggregates, pre-shifted targets,
the empty stream) and tests/test_pretrain.py (llama causal with a
checkpoint, real token shards), all on ``llama-test`` fp32 on the CPU.
"""

import json
import signal

import numpy as np
import optax
import pytest
import torch

from _torch_training import ids, lm_pair, lora_pair
from kubeflow_tpu.training import data as jdata
from kubeflow_tpu.training.evaluate import evaluate_lm as jax_evaluate_lm
from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.training import data, finetune, lm, optim
from kubeflow_tpu_torch.training.checkpoint import CheckpointConfig
from kubeflow_tpu_torch.training.evaluate import evaluate_lm
from kubeflow_tpu_torch.training.loop import (
    agree_on_drain,
    DRAIN_EXIT_CODE,
    DrainInterrupt,
    LoopConfig,
    fit,
)
from kubeflow_tpu_torch.training.pretrain import main as pretrain_main


# -- data --------------------------------------------------------------------

def test_host_shard_range_partitions():
    ranges = [data.host_shard_range(64, pi, 4) for pi in range(4)]
    assert [i for r in ranges for i in r] == list(range(64))
    assert data.host_shard_range(8) == range(0, 8)
    with pytest.raises(ValueError):
        data.host_shard_range(10, 0, 4)


@pytest.mark.parametrize("name", ["causal", "mlm", "mlm_mask"])
def test_generators_are_the_reference_batches(name):
    if name == "causal":
        ours = data.synthetic_causal_lm(8, 16, 100, seed=5)
        ref = jdata.synthetic_causal_lm(8, 16, 100, seed=5)
    elif name == "mlm":
        ours = data.synthetic_mlm(8, seq_len=16, vocab_size=100, seed=2)
        ref = jdata.synthetic_mlm(8, seq_len=16, vocab_size=100, seed=2)
    else:
        x = np.arange(200, dtype=np.int32).reshape(2, 100) + 200
        ours = data.mlm_mask_batches(iter([{"input_ids": x}] * 3), seed=1)
        ref = jdata.mlm_mask_batches(iter([{"input_ids": x}] * 3), seed=1)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    m = next(data.synthetic_mlm(8, seq_len=16, vocab_size=100))
    masked = m["mlm_weights"] == 1
    assert (m["input_ids"][masked] == 103).all()
    assert (m["input_ids"][~masked] == m["mlm_labels"][~masked]).all()


def test_token_shard_batches_are_the_reference_batches(tmp_path):
    """Exact coverage, chunks straddling shards, the seeded epoch
    shuffle, eager errors; batch for batch the reference's."""
    tokens = np.arange(1000, dtype=np.int64)
    paths = []
    for i, (lo, hi) in enumerate([(0, 333), (333, 700), (700, 1000)]):
        p = tmp_path / f"shard{i}.npy"
        np.save(p, tokens[lo:hi].astype(np.uint16))
        paths.append(str(p))
    raw = tmp_path / "raw.bin"
    tokens[:600].astype(np.uint16).tofile(raw)
    seen = []
    for a, b in zip(data.token_shard_batches(paths, 4, 16, seed=3,
                                             epochs=2),
                    jdata.token_shard_batches(paths, 4, 16, seed=3,
                                              epochs=2)):
        assert a["input_ids"].dtype == np.int32
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        for row in a["input_ids"]:
            assert (np.diff(row) == 1).all()
            seen.append(int(row[0]))
    assert len(seen) == 2 * 15 * 4
    assert len(set(seen[:60])) == 60  # no chunk twice in an epoch
    for a, b in zip(data.token_shard_batches([str(raw)], 2, 32, epochs=1),
                    jdata.token_shard_batches([str(raw)], 2, 32,
                                              epochs=1)):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    with pytest.raises(ValueError, match="chunks"):
        data.token_shard_batches(paths[:1], 64, 512, epochs=1)
    with pytest.raises(ValueError, match="at least one shard"):
        data.token_shard_batches([], 4, 16)


def test_prefetcher_places_propagates_errors_and_stops():
    it = data.DevicePrefetcher(data.synthetic_causal_lm(4, 8, 64),
                               prefetch=2, device="cpu")
    batch = next(it)
    assert isinstance(batch["input_ids"], torch.Tensor)
    assert batch["input_ids"].shape == (4, 8)
    assert batch["input_ids"].dtype == torch.int32
    it.close()

    def bad_gen():
        yield {"x": np.zeros((2,))}
        raise RuntimeError("boom")

    it = data.DevicePrefetcher(bad_gen(), prefetch=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)

    def short_gen():
        yield {"x": np.zeros((2,))}

    it2 = data.DevicePrefetcher(short_gen(), device="cpu")
    next(it2)
    with pytest.raises(StopIteration):
        next(it2)
    with pytest.raises(NotImplementedError, match="A14"):
        data.DevicePrefetcher(short_gen(), mesh=object(), device="cpu")


# -- the loop ------------------------------------------------------------------

def _lm_state(lr=0.01):
    _, params, model = lm_pair(optax.sgd(lr))
    state, _ = lm.create_lm_state(model, optim.sgd(lr), params)
    return state


def test_fit_resume_and_metrics(tmp_path):
    gen = data.synthetic_causal_lm(8, seq_len=16, vocab_size=512, seed=3)
    ckpt_cfg = CheckpointConfig(directory=str(tmp_path / "ckpt"),
                                save_interval_steps=2)
    metrics_path = tmp_path / "metrics.jsonl"
    steps_before = obs_metrics.REGISTRY.render().count("kft_training")
    cfg = LoopConfig(total_steps=4, log_every=2, checkpoint=ckpt_cfg,
                     metrics_path=str(metrics_path))
    prefetch = data.DevicePrefetcher(gen, device="cpu")
    state = fit(_lm_state(), lm.make_lm_train_step(), prefetch, cfg)
    prefetch.close()
    assert state.step == 4
    lines = [json.loads(x) for x in metrics_path.read_text().splitlines()]
    assert lines and lines[-1]["step"] == 4 and "loss" in lines[-1]
    assert {"loss", "accuracy", "aux_loss", "grad_norm",
            "steps_per_sec"} <= set(lines[-1])
    exposition = obs_metrics.REGISTRY.render()
    assert "kft_training_steps_total" in exposition
    assert "kft_training_step_seconds_bucket" in exposition
    assert exposition.count("kft_training") >= steps_before
    # A restart: a fresh state, the same checkpoint dir, resumes at 4.
    cfg2 = LoopConfig(total_steps=6, log_every=2, checkpoint=ckpt_cfg,
                      metrics_path=str(metrics_path))
    state2 = fit(_lm_state(), lm.make_lm_train_step(),
                 data.synthetic_causal_lm(8, 16, 512, seed=4), cfg2)
    assert state2.step == 6
    # A checkpoint already at or past total_steps returns as restored.
    done = fit(_lm_state(), lm.make_lm_train_step(), iter(()),
               LoopConfig(total_steps=4, log_every=2, checkpoint=ckpt_cfg))
    assert done.step == 6


def test_fit_drains_on_sigterm_and_profiles(tmp_path):
    """The drain: SIGTERM mid-run finishes the step, force-saves and
    raises DrainInterrupt; a restart resumes at the drain step. The
    profiler window writes a Chrome trace."""
    cfg = LoopConfig(total_steps=10, log_every=1,
                     checkpoint=CheckpointConfig(
                         directory=str(tmp_path / "ckpt"),
                         save_interval_steps=100),
                     profile_start=0, profile_stop=2,
                     profile_dir=str(tmp_path / "prof"))

    def hook(step, state, metrics):
        if step == 3:
            signal.raise_signal(signal.SIGTERM)

    gen = data.synthetic_causal_lm(4, 16, 512, seed=1)
    with pytest.raises(DrainInterrupt) as drained:
        fit(_lm_state(), lm.make_lm_train_step(), gen, cfg, hooks=[hook])
    assert drained.value.step == 3 and drained.value.checkpointed
    assert (tmp_path / "prof" / "trace.json").exists()
    assert DRAIN_EXIT_CODE == 77
    # The handler is restored: the default SIGTERM action again.
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)
    resumed = fit(_lm_state(), lm.make_lm_train_step(), gen,
                  LoopConfig(total_steps=5, log_every=5,
                             checkpoint=cfg.checkpoint, drain_signals=()))
    assert resumed.step == 5


def test_fit_agrees_on_the_drain_in_a_gang_of_one(tmp_path):
    """A one-process gloo group is no gang: ``fit`` drains on its own
    flag as before, and ``agree_on_drain`` over the group is the flag
    (the two-process agreement: tests/test_torch_launcher.py)."""
    dist = torch.distributed
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        world_size=1, rank=0)
    try:
        assert agree_on_drain(True) is True
        assert agree_on_drain(False) is False
        state = fit(_lm_state(), lm.make_lm_train_step(),
                    iter([{"input_ids": ids(0)}]),
                    LoopConfig(total_steps=1, drain_signals=()))
        assert state.step == 1
    finally:
        dist.destroy_process_group()


# -- evaluation ------------------------------------------------------------------

def _batches(seed, n, b=4, l=16):
    return [{"input_ids": ids(seed + i, b, l)} for i in range(n)]


def test_evaluate_matches_the_reference_and_is_exact():
    ref_state, params, model = lm_pair(optax.sgd(0.1))
    stream = _batches(2, 3)
    ref = jax_evaluate_lm(ref_state.apply_fn, {"params": ref_state.params},
                          iter(stream))
    out = evaluate_lm(model, {"params": params}, iter(stream))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, err_msg=k)
    # Untrained on uniform tokens: CE ≈ ln(512), next-token targets.
    assert 256 < out["perplexity"] < 1024 and out["tokens"] == 3 * 4 * 15
    # Token-weighted over the stream, not a mean of batch means.
    b1 = {"input_ids": ids(3, 2, 8)}
    b2 = {"input_ids": ids(4, 6, 8)}
    both = evaluate_lm(model, {"params": params}, iter([b1, b2]))
    only1 = evaluate_lm(model, {"params": params}, iter([b1, b2]),
                        max_batches=1)
    only2 = evaluate_lm(model, {"params": params}, iter([b2]))
    assert only1["batches"] == 1.0
    w1, w2 = only1["tokens"], only2["tokens"]
    np.testing.assert_allclose(
        both["loss"], (only1["loss"] * w1 + only2["loss"] * w2) / (w1 + w2),
        rtol=1e-6)


def test_evaluate_honors_preshifted_targets_and_empty_stream():
    _, params, model = lm_pair(optax.sgd(0.1))
    x = ids(6, 2, 8)
    implicit = evaluate_lm(model, {"params": params},
                           iter([{"input_ids": x}]))
    explicit = evaluate_lm(model, {"params": params}, iter([{
        "input_ids": x[:, :-1], "targets": x[:, 1:]}]))
    np.testing.assert_allclose(implicit["loss"], explicit["loss"],
                               rtol=1e-5)
    with pytest.raises(ValueError, match="no weighted tokens"):
        evaluate_lm(model, {"params": params}, iter([]))


def test_evaluate_improves_after_lora_finetune():
    ref_state, base, lora, model = lora_pair(optax.adamw(1e-2))
    batch = {"input_ids": ids(0)}
    state, _ = finetune.create_lora_state(model, optim.adamw(1e-2), base,
                                          lora)
    before = evaluate_lm(model, {"params": state.base_params,
                                 "lora": state.lora}, iter([batch]))
    ref_before = jax_evaluate_lm(
        ref_state.apply_fn, {"params": ref_state.base_params,
                             "lora": ref_state.lora}, iter([batch]))
    np.testing.assert_allclose(before["loss"], ref_before["loss"],
                               rtol=1e-5)
    step = finetune.make_lora_train_step()
    for _ in range(6):
        state, _ = step(state, batch)
    after = evaluate_lm(model, {"params": state.base_params,
                                "lora": state.lora}, iter([batch]))
    assert after["loss"] < before["loss"]


# -- the tpu-lm CLI ----------------------------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_pretrain_llama_causal_with_ckpt(tmp_path, capsys):
    args = ["--model", "llama-test", "--global_batch", "8", "--seq_len",
            "16", "--steps", "2", "--log_every", "1", "--device", "cpu",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--save_every", "1",
            "--continuous_every", "1",
            "--metrics_path", str(tmp_path / "m.jsonl")]
    assert pretrain_main(args) == 0
    out = _last_json(capsys)
    assert out["objective"] == "causal" and out["final_step"] == 2
    assert out["device"] == "cpu"
    args[7] = "4"  # resume: the same checkpoint dir continues from 2
    assert pretrain_main(args) == 0
    assert _last_json(capsys)["final_step"] == 4
    assert (tmp_path / "ckpt" / "continuous" / "step-00000004"
            / "manifest.json").exists()


def test_pretrain_on_real_token_shards_and_vocab_check(tmp_path, capsys):
    toks = np.random.RandomState(0).randint(0, 500, 40_000).astype(np.int32)
    np.save(tmp_path / "shard0.npy", toks[:20_000])
    np.save(tmp_path / "shard1.npy", toks[20_000:])
    rc = pretrain_main(["--model", "llama-test", "--global_batch", "8",
                        "--seq_len", "32", "--steps", "2", "--log_every",
                        "1", "--device", "cpu", "--remat",
                        "--data", str(tmp_path / "*.npy")])
    assert rc == 0 and _last_json(capsys)["final_step"] == 2
    bad = tmp_path / "bad"
    bad.mkdir()
    np.save(bad / "s.npy", np.full(4_000, 600, np.int32))  # vocab is 512
    with pytest.raises(ValueError, match="vocab"):
        pretrain_main(["--model", "llama-test", "--global_batch", "4",
                       "--seq_len", "16", "--steps", "1", "--device", "cpu",
                       "--data", str(bad)])


def test_pretrain_num_layers_cuts_the_depth(tmp_path, capsys):
    """``--num_layers`` keeps the widths and cuts the depth: the
    checkpointed params hold that many blocks."""
    from kubeflow_tpu_torch.training.checkpoint import (
        ContinuousCheckpointConfig,
        ShardedCheckpointer,
    )

    assert pretrain_main(["--model", "llama-test", "--num_layers", "1",
                          "--global_batch", "2", "--seq_len", "16",
                          "--steps", "1", "--device", "cpu",
                          "--checkpoint_dir", str(tmp_path / "ckpt"),
                          "--save_every", "1"]) == 0
    assert _last_json(capsys)["final_step"] == 1
    reader = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=str(tmp_path / "ckpt"), async_save=False))
    flat = reader._read_step(1)
    layers = {k.split("/")[1] for k in flat if k.startswith("params/layer_")}
    assert layers == {"layer_0"}
    assert flat["params/layer_0/attention/q_proj/kernel"].shape == (64, 64)


@pytest.mark.parametrize("argv,match", [
    (["--model", "llama-test", "--mesh", "data=4,pipeline=2"], "A14"),
])
def test_pretrain_refuses_what_is_not_ported(argv, match):
    with pytest.raises(SystemExit, match=match):
        pretrain_main(argv + ["--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("argv,objective", [
    (["--model", "llama-test", "--objective", "mlm"], "mlm"),
    (["--model", "bert-test"], "mlm"),
    (["--model", "bert-test", "--objective", "causal"], "causal"),
])
def test_pretrain_runs_what_the_reference_accepts(argv, objective, capsys):
    assert pretrain_main(argv + ["--device", "cpu", "--steps", "2",
                                 "--global_batch", "4", "--seq_len", "16",
                                 "--log_every", "1"]) == 0
    out = _last_json(capsys)
    assert out["objective"] == objective and out["final_step"] == 2


def test_lm_trace_summary_classes(tmp_path):
    """The LM breakdown: kernels inside a backward-recompute or
    optimizer span charged to it, the port's kernels by name, cuBLAS's
    products split by operand type; the host's time inside each span."""
    from kubeflow_tpu_torch.training.benchmark import summarize_lm_trace

    def kernel(name, ts, dur):
        return {"cat": "kernel", "ph": "X", "name": name, "ts": ts,
                "dur": dur}

    def span(cat, name, ts, dur):
        return {"cat": cat, "ph": "X", "name": name, "ts": ts, "dur": dur}

    events = [
        kernel("flash_fwd_kernel_wgmma<128>", 0, 100),
        kernel("rms_norm_kernel<bf16>", 100, 10),
        kernel("nvjet_tst_176x128_64x5_1x2_h_bz_TNN", 200, 300),
        kernel("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 500, 400),
        kernel("void at::native::nll_loss_forward_reduce_cuda_kernel_2d",
               900, 20),
        span("gpu_user_annotation", "flash_backward_recompute", 1000, 600),
        kernel("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n", 1000, 250),
        kernel("void at::native::reduce_kernel<512>", 1300, 50),
        span("gpu_user_annotation", "Optimizer.step", 2000, 100),
        kernel("void at::native::elementwise_kernel<128>", 2000, 40),
        span("user_annotation", "flash_backward_recompute", 900, 1500),
        span("user_annotation", "Optimizer.step", 2400, 300),
    ]
    (tmp_path / "trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    out = summarize_lm_trace(str(tmp_path), wall_ms=4.0)
    assert out["by_class_ms"] == pytest.approx({
        "flash_forward_kernel": 0.1, "rms_norm_kernel": 0.01,
        "gemm_bf16": 0.3, "gemm_fp32": 0.4, "cross_entropy": 0.02,
        "flash_backward_plain_recompute": 0.3, "optimizer": 0.04})
    assert out["host_span_ms"] == pytest.approx({
        "flash_backward_plain_recompute": 1.5, "optimizer": 0.3,
        "rms_norm_backward_plain_recompute": 0.0})
    assert out["device_idle_share"] == pytest.approx(1 - 1.17 / 4.0)
