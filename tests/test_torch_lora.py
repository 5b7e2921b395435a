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

"""LoRA in kubeflow_tpu_torch against kubeflow_tpu's (ops/lora.py,
training/finetune.py), and twins of tests/test_lora.py.

``llama-test`` fp32, base and adapters carried across from the
reference's ``create_lora_state``, the same numpy-seeded batches: the
loss at each of 5 steps within 1e-5 relative, the adapters and their
moments within 1e-4 after them; the base bitwise untouched.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_training import assert_close_to_reference, flat, ids, lora_pair
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.ops.lora import merge_lora as jax_merge_lora
from kubeflow_tpu.training import finetune as jft
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import apply, llama_test
from kubeflow_tpu_torch.ops.lora import LoRALinear, init_lora, merge_lora
from kubeflow_tpu_torch.training import finetune, optim


def test_lora_init_is_exactly_base_model():
    """B starts at zero: step 0 is the base model, bitwise; and both
    equal the reference's forward."""
    ref_state, base, lora, model = lora_pair(optax.adamw(1e-2))
    x = ids(0, b=4, l=16)
    out_lora = apply(model, {**base, **lora}, torch.from_numpy(x))
    out_base = apply(llama_test(dtype="float32"), base, torch.from_numpy(x))
    assert torch.equal(out_lora, out_base)
    ref = jax.jit(jax_llama_test(dtype=jnp.float32, lora_rank=4).apply)(
        {"params": ref_state.base_params, "lora": ref_state.lora},
        jnp.asarray(x))
    np.testing.assert_allclose(out_lora.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_lora_adapters_only_on_attention_projections():
    model = llama_test(lora_rank=4)
    lora = init_lora(model, seed=0, device="cpu")
    assert lora and all(
        any(p in name for p in ("q_proj", "k_proj", "v_proj", "o_proj"))
        for name in lora)
    assert all(isinstance(model.get_submodule(n.rsplit(".", 1)[0]),
                          LoRALinear) for n in lora)
    n_lora = sum(t.numel() for t in lora.values())
    n_base = sum(t.numel() for n, t in model.named_parameters()
                 if n not in lora)
    assert n_lora < 0.15 * n_base
    # A is normal(0.02), B zeros, fp32, in the reference's layout.
    a = lora["layers.0.attention.q_proj.lora_a"]
    assert a.shape == (64, 4) and a.dtype == torch.float32
    assert 0.005 < float(a.std()) < 0.04
    assert not lora["layers.0.attention.q_proj.lora_b"].any()
    # The same collection, key for key, as the reference's.
    ref_state, *_ = lora_pair(optax.adamw(1e-2))
    assert set(convert.lora_to_flax(lora)) == set(flat(ref_state.lora))


def test_lora_train_step_tracks_the_reference():
    batches = [{"input_ids": ids(20 + i, b=4, l=16)} for i in range(5)]
    ref_state, base, lora, model = lora_pair(optax.adamw(1e-2))
    ref_step = jft.make_lora_train_step(None, None, donate=False)
    state, _ = finetune.create_lora_state(model, optim.adamw(1e-2), base,
                                          lora)
    step = finetune.make_lora_train_step()
    for i, batch in enumerate(batches):
        ref_state, ref_m = ref_step(ref_state, batch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
    assert_close_to_reference(state, ref_state,
                              ("step", "lora", "opt_state", "base_params"),
                              1e-4)


def test_lora_train_step_freezes_base_and_learns():
    batch = {"input_ids": ids(0, b=4, l=16)}
    _, base, lora, model = lora_pair(optax.adamw(1e-2))
    state, _ = finetune.create_lora_state(model, optim.adamw(1e-2), base,
                                          lora)
    before = {k: v.clone() for k, v in state.base_params.items()}
    step = finetune.make_lora_train_step()
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses
    for k, v in state.base_params.items():
        assert torch.equal(v, before[k]), k
        assert v.grad is None and not v.requires_grad, k
    # No moment of a base tensor: the optimizer sees the adapters only.
    adam = state.opt_state[0]
    assert set(adam.mu) == set(state.lora)


def test_lora_base_dtype_bf16_and_adapters_fp32():
    _, base, lora, model = lora_pair(optax.adamw(1e-2))
    state, _ = finetune.create_lora_state(
        model, optim.adamw(1e-2), base, lora, base_dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16
               for t in state.base_params.values())
    assert all(t.dtype == torch.float32 for t in state.lora.values())
    # A bf16 base runs (the head widened to fp32 at its op).
    model16 = llama_test(lora_rank=4)  # bf16 compute
    state16, _ = finetune.create_lora_state(
        model16, optim.adamw(1e-2), base, lora, base_dtype=torch.bfloat16)
    _, m = finetune.make_lora_train_step()(
        state16, {"input_ids": ids(0, b=2, l=16)})
    assert np.isfinite(float(m["loss"]))


def test_merge_lora_matches_adapter_forward_and_the_reference():
    batch = {"input_ids": ids(0, b=4, l=16)}
    ref_state, base, lora, model = lora_pair(optax.adamw(1e-2))
    state, _ = finetune.create_lora_state(model, optim.adamw(1e-2), base,
                                          lora)
    step = finetune.make_lora_train_step()
    for _ in range(3):
        state, _ = step(state, batch)
    x = torch.from_numpy(batch["input_ids"])
    with torch.no_grad():
        out_adapter = apply(model, state.variables(), x)
        merged = merge_lora(state.base_params, state.lora,
                            alpha=model.lora_alpha)
        out_merged = apply(llama_test(dtype="float32"), merged, x)
    np.testing.assert_allclose(out_adapter.numpy(), out_merged.numpy(),
                               rtol=2e-2, atol=2e-2)
    # The merge itself is the reference's.
    ref_merged = jax_merge_lora(
        _nest(convert.params_to_flax(state.base_params)),
        _nest(convert.lora_to_flax(state.lora)), alpha=model.lora_alpha)
    ref_flat = flat(ref_merged)
    port_flat = convert.params_to_flax(merged)
    assert set(ref_flat) == set(port_flat)
    for k, v in ref_flat.items():
        np.testing.assert_allclose(port_flat[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # Unmerged weights are shared, not copied; dtypes kept.
    assert merged["tok_embed.weight"] is state.base_params["tok_embed.weight"]


def _nest(flat_dict):
    out = {}
    for k, v in flat_dict.items():
        node = out
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return out


def test_lora_rank_rejected_for_vision_models():
    from kubeflow_tpu_torch.training.benchmark import main as bench_main

    with pytest.raises(SystemExit) as exc:
        bench_main(["--model", "resnet-test", "--lora_rank", "4",
                    "--device", "cpu"])
    assert exc.value.code != 0


def test_lora_benchmark_on_the_cpu(tmp_path):
    """run_lora_benchmark on llama-test, synthetic and from token
    shards: the reference's result keys, a trainable fraction."""
    from kubeflow_tpu_torch.training.benchmark import (
        LoRABenchConfig,
        run_lora_benchmark,
    )

    rng = np.random.RandomState(0)
    paths = []
    for i in range(2):
        p = tmp_path / f"s{i}.npy"
        np.save(p, rng.randint(0, 512, 20_000).astype(np.uint16))
        paths.append(str(p))
    for data in (None, tuple(paths)):
        result = run_lora_benchmark(LoRABenchConfig(
            model="llama-test", lora_rank=4, batch_size=2, seq_len=32,
            steps=2, warmup_steps=1, data_paths=data), device="cpu")
        assert {"model", "lora_rank", "global_batch_size", "seq_len",
                "n_chips", "steps", "step_time_ms", "tokens_per_sec",
                "compile_plus_warmup_s", "final_loss", "base_params",
                "trainable_params", "trainable_pct",
                "flops_per_step"} <= set(result)
        assert result["tokens_per_sec"] > 0
        assert result["trainable_params"] < 0.2 * result["base_params"]
        assert result["lora_rank"] == 4 and "mfu_pct" not in result


def test_fine_tune_lora_returns_the_trained_state():
    """run_lora_benchmark's run, with its state: step 0 (the warmup) is
    the base model's loss exactly (B = 0), the base comes back
    untouched and without gradients, and the adapters moved."""
    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.training.benchmark import (
        LoRABenchConfig,
        fine_tune_lora,
    )
    from kubeflow_tpu_torch.training.data import synthetic_causal_lm
    from kubeflow_tpu_torch.training.lm import (
        causal_lm_loss,
        lm_forward_with_aux,
    )
    from kubeflow_tpu_torch.utils.trees import cast_floating

    entry = get_model("llama-test")
    params = cast_floating(init_params(entry.make(param_dtype="float32"),
                                       seed=1, device="cpu"),
                           torch.bfloat16)
    frozen = {k: v.clone() for k, v in params.items()}
    batch = next(synthetic_causal_lm(2, 32, 512, seed=0))
    with torch.no_grad():
        _, (base_loss, _, _) = lm_forward_with_aux(
            entry.make(), params, {"input_ids": torch.from_numpy(
                batch["input_ids"])}, causal_lm_loss, 0.01)
    result, state = fine_tune_lora(LoRABenchConfig(
        model="llama-test", lora_rank=4, batch_size=2, seq_len=32,
        steps=3, warmup_steps=1, learning_rate=1e-2), "cpu", params)
    assert result["warmup_losses"] == [float(base_loss)]
    assert len(result["losses"]) == 3 and result["final_loss"] < float(
        base_loss)
    assert state.step == 4
    for k, v in state.base_params.items():
        assert torch.equal(v, frozen[k]) and v.grad is None, k
    assert any(bool(v.abs().sum() > 0) for k, v in state.lora.items()
               if k.endswith(".lora_b"))


def test_lm_train_flops_model_and_hardware_counts():
    """The hardware count adds the remat recompute and attention's full
    square; the model count takes neither."""
    from kubeflow_tpu_torch.models.llama import llama_test
    from kubeflow_tpu_torch.training.benchmark import lm_train_flops

    model = llama_test(lora_rank=4)
    b, l = 2, 32
    attn = 4 * b * model.num_heads * model.head_dim * model.num_layers
    full = lm_train_flops(model, b, l, lora_rank=4)
    causal = lm_train_flops(model, b, l, lora_rank=4, causal=True)
    # Attention's forward and its twice-as-large backward: 3 times.
    assert full - causal == 3 * attn * (l * l - l * (l + 1) // 2)
    remat = lm_train_flops(model, b, l, lora_rank=4, remat=True)
    d, kv = model.d_model, model.num_kv_heads * model.head_dim
    hq = model.num_heads * model.head_dim
    proj = 2 * b * l * model.num_layers * (
        2 * d * hq + 2 * d * kv + 3 * d * model.mlp_dim)
    lora = 2 * b * l * 4 * model.num_layers * ((d + hq) * 2 + (d + kv) * 2)
    assert remat - full == proj + attn * l * l + lora


def test_resolve_shards_local_and_errors(tmp_path):
    from kubeflow_tpu.training.data import resolve_shards as ref_resolve
    from kubeflow_tpu_torch.training.data import resolve_shards

    np.save(tmp_path / "a.npy", np.arange(4))
    np.save(tmp_path / "b.npy", np.arange(4))
    (tmp_path / "notes.txt").write_text("not a shard")
    got = resolve_shards(str(tmp_path))
    assert [p.rsplit("/", 1)[1] for p in got] == ["a.npy", "b.npy"]
    assert got == ref_resolve(str(tmp_path))
    assert resolve_shards(f"{tmp_path}/*.npy") == got
    assert resolve_shards(f"{tmp_path}/a.npy,{tmp_path}/b.npy") == got
    with pytest.raises(ValueError, match="does not exist"):
        resolve_shards(str(tmp_path / "missing.npy"))
    with pytest.raises(ValueError, match="matched no shards"):
        resolve_shards(f"{tmp_path}/*.bin")
    with pytest.raises(ValueError, match="empty"):
        resolve_shards(" , ")


def test_resolve_remote_memory_shards(tmp_path):
    """gs://-style shards through fsspec into the local cache, as the
    reference fetches them (memory:// stands in for a bucket)."""
    fsspec = pytest.importorskip("fsspec")
    from kubeflow_tpu_torch.training.data import resolve_shards

    fs = fsspec.filesystem("memory")
    rng = np.random.RandomState(0)
    for i in range(2):
        buf = io.BytesIO()
        np.save(buf, rng.randint(0, 512, 2_000).astype(np.uint16))
        fs.pipe_file(f"/port-lora-shards/s{i}.npy", buf.getvalue())
    paths = resolve_shards("memory://port-lora-shards",
                           cache_root=str(tmp_path / "cache"))
    assert [p.rsplit("/", 1)[1] for p in paths] == ["s0.npy", "s1.npy"]
    assert resolve_shards("memory://port-lora-shards",
                          cache_root=str(tmp_path / "cache")) == paths


def test_lora_fit_with_checkpoint_resume(tmp_path):
    """Shards → fit → a restart resumes from the adapter checkpoint and
    finishes (twin of tests/test_lora.py)."""
    from kubeflow_tpu_torch.training.checkpoint import CheckpointConfig
    from kubeflow_tpu_torch.training.data import token_shard_batches
    from kubeflow_tpu_torch.training.loop import LoopConfig, fit

    rng = np.random.RandomState(0)
    shard = tmp_path / "s0.npy"
    np.save(shard, rng.randint(0, 512, 30_000).astype(np.uint16))
    _, base, lora, model = lora_pair(optax.adamw(5e-3))

    def build():
        state, _ = finetune.create_lora_state(
            model, optim.adamw(5e-3), base,
            {k: v.clone() for k, v in lora.items()})
        batches = token_shard_batches([str(shard)], 4, 16, seed=7)
        return state, finetune.make_lora_train_step(), batches

    ckpt = CheckpointConfig(directory=str(tmp_path / "ckpt"),
                            save_interval_steps=2)
    state, step, batches = build()
    state = fit(state, step, batches,
                LoopConfig(total_steps=4, log_every=2, checkpoint=ckpt))
    assert state.step == 4
    state2, step2, batches2 = build()
    assert state2.step == 0
    state2 = fit(state2, step2, batches2,
                 LoopConfig(total_steps=8, log_every=2, checkpoint=ckpt))
    assert state2.step == 8
    fresh, _, _ = build()
    assert max(float((state2.lora[k] - fresh.lora[k]).abs().max().detach())
               for k in fresh.lora) > 0
    # The adapters restored as trainable leaves; the base still frozen.
    assert all(v.requires_grad for v in state2.lora.values())
    assert not any(v.requires_grad for v in state2.base_params.values())
