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

"""kubeflow_tpu_torch.training.checkpoint, and its interchange with
kubeflow_tpu's.

Twins of tests/test_checkpoint.py and tests/test_checkpoint_sharded.py
(interval, fresh start, LoRA round trip, torn manifest, atomic write,
corrupt latest step, stable keys). And the interchange: a continuous
(sharded) checkpoint written by the port is restored by the reference's
``ShardedCheckpointer``, and the reverse, with the keys equal, every
value bit-equal, and the next step's loss equal to an uninterrupted
run's within 1e-5 (the two packages' fp32 steps, as
tests/test_torch_lm.py holds them).
"""

import dataclasses
import os
import threading

import numpy as np
import optax
import pytest
import torch

from _torch_training import ids, lm_pair, lora_pair, reference_flat_state
from kubeflow_tpu.training import checkpoint as jckpt
from kubeflow_tpu.training import finetune as jft
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.training import finetune, lm, optim
from kubeflow_tpu_torch.training.checkpoint import (
    CheckpointConfig,
    Checkpointer,
    ContinuousCheckpointConfig,
    ShardedCheckpointer,
    atomic_write_bytes,
    flatten_state,
)


def _small_state(step=1, scale=1.0):
    return {"params": {"w": torch.arange(48, dtype=torch.float32)
                       .reshape(12, 4) * scale,
                       "b": torch.ones(3) * scale},
            "opt": {"mu": torch.full((8, 2), 0.25 * scale)},
            "step": step}


def _assert_states_equal(a, b):
    fa, fb = convert.state_to_flax(a), convert.state_to_flax(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


def _lm_state(tx=None):
    tx = tx or optim.adamw(1e-2)
    _, params, model = lm_pair(optax.adamw(1e-2))
    return lm.create_lm_state(model, tx, params)[0]


def test_save_interval_policy_and_fresh_start(tmp_path):
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path / "c"),
                                         save_interval_steps=5))
    state = _small_state()
    assert ckpt.latest_step() is None
    assert ckpt.restore(state) is state  # fresh start
    assert ckpt.save(0, state)        # step 0 always saves
    assert not ckpt.save(1, state)    # below the interval
    assert ckpt.save(5, state)
    assert not ckpt.save(5, state, force=True)  # saved already
    assert ckpt.latest_step() == 5
    for step in (10, 15, 20):
        assert ckpt.save(step, state)
    assert ckpt.all_steps() == [10, 15, 20]  # keep = 3
    assert not [p for p in os.listdir(tmp_path / "c") if "tmp" in p]


def test_save_restore_resumes_bitwise(tmp_path):
    """A restart restores params, moments and step, and the next step
    is the same bits as the run that never stopped."""
    batch = {"input_ids": ids(0)}
    state = _lm_state()
    step = lm.make_lm_train_step()
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path / "c"),
                                         save_interval_steps=1))
    assert ckpt.save(state.step, state, force=True)
    restored = Checkpointer(ckpt.config).restore(_lm_state())
    assert restored.step == 2
    _assert_states_equal(restored, state)
    assert all(p.requires_grad for p in restored.params.values())
    a, ma = step(restored, batch)
    b, mb = step(state, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    _assert_states_equal(a, b)


def test_lora_adapter_checkpoint_roundtrip(tmp_path):
    """Only the adapter state needs saving (the frozen base restores
    from its pretrained source)."""
    _, base, lora, model = lora_pair(optax.adamw(1e-2))
    state, _ = finetune.create_lora_state(model, optim.adamw(1e-2), base,
                                          lora)
    step = finetune.make_lora_train_step()
    for _ in range(3):
        state, _ = step(state, {"input_ids": ids(0, b=4, l=16)})
    adapter_state = {"step": state.step, "lora": state.lora,
                     "opt_state": state.opt_state}
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path / "lora"),
                                         save_interval_steps=1))
    assert ckpt.save(state.step, adapter_state, force=True)
    zeros = {"step": 0,
             "lora": {k: torch.zeros_like(v) for k, v in state.lora.items()},
             "opt_state": optim.adamw(1e-2).init(state.lora)}
    restored = ckpt.restore(zeros)
    _assert_states_equal(restored, adapter_state)


def test_monolithic_restore_skips_corrupt_latest_step(tmp_path):
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path / "mono"),
                                         save_interval_steps=1))
    state1, state2 = _small_state(1, 1.0), _small_state(2, 2.0)
    assert ckpt.save(1, state1, force=True)
    assert ckpt.save(2, state2, force=True)
    victim = (tmp_path / "mono" / "step-00000002"
              / "state.shard-00000-of-00001.msgpack")
    victim.write_bytes(victim.read_bytes()[:32])
    restored = Checkpointer(ckpt.config).restore(_small_state(0, 0.0))
    assert restored["step"] == 1
    _assert_states_equal(restored, state1)
    with pytest.raises(Exception):
        ckpt.restore(_small_state(), step=2)


def test_manifest_commits_last_and_torn_write_is_invisible(tmp_path):
    root = tmp_path / "cont"
    ckpt = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=str(root), save_interval_steps=1, async_save=False))
    state1, state2 = _small_state(1, 1.0), _small_state(2, 2.0)
    assert ckpt.save(1, state1, force=True)
    assert ckpt.all_steps() == [1]
    # A writer killed after the shard, before the manifest: invisible.
    gate = threading.Event()
    ckpt._commit = lambda step: gate.set()
    assert ckpt.save(2, state2, force=True)
    assert gate.is_set() and (root / "step-00000002").is_dir()
    assert ckpt.all_steps() == [1]
    restored = ckpt.restore(_small_state(0, 0.0))
    assert restored["step"] == 1
    _assert_states_equal(restored, state1)
    # A committed step whose shard was truncated later is skipped; an
    # explicit request for it raises.
    del ckpt._commit
    ckpt._commit(2)
    assert ckpt.all_steps() == [1, 2]
    shard = next((root / "step-00000002").glob("state.shard-*"))
    shard.write_bytes(shard.read_bytes()[:10])
    assert ckpt.restore(_small_state(0, 0.0))["step"] == 1
    with pytest.raises(Exception):
        ckpt.restore(_small_state(), step=2)
    ckpt.close()


def test_interval_dedupe_prune_and_newest_wins(tmp_path):
    ckpt = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=str(tmp_path / "cont"), save_interval_steps=5, keep=2))
    state = _small_state()
    assert not ckpt.save(3, state)
    for step in (5, 10, 15):
        assert ckpt.save(step, state)
        assert not ckpt.save(step, state, force=True)
        assert ckpt.wait(15.0)
    assert ckpt.all_steps() == [10, 15]
    gate = threading.Event()
    original = ckpt._write_one
    ckpt._write_one = lambda item: (gate.wait(10), original(item))
    assert ckpt.save(20, _small_state(20), force=True)
    for _ in range(200):
        with ckpt._slot_lock:
            if ckpt._writing:
                break
        gate.wait(0.01)
    assert ckpt.save(21, _small_state(21), force=True)
    assert ckpt.save(22, _small_state(22), force=True)  # replaces 21
    gate.set()
    assert ckpt.wait(10.0)
    assert 22 in ckpt.all_steps() and 21 not in ckpt.all_steps()
    assert ckpt._dropped >= 1
    ckpt.close()


def test_atomic_write_never_leaves_truncation(tmp_path):
    path = tmp_path / "blob.bin"
    atomic_write_bytes(path, b"a" * 1024)
    assert path.read_bytes() == b"a" * 1024
    atomic_write_bytes(path, b"b" * 10)
    assert path.read_bytes() == b"b" * 10
    assert [p.name for p in tmp_path.iterdir()] == ["blob.bin"]


def test_flatten_state_keys_are_the_reference_keys():
    flat, _ = flatten_state({"params": {"w": torch.ones(4, 4)}, "step": 0})
    assert set(flat) == {"params/w", "step"}
    ref_state, params, model = lm_pair(optax.chain(
        optax.clip_by_global_norm(1.0), optax.adamw(
            optax.schedules.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10))))
    state, _ = lm.create_lm_state(model, optim.chain(
        optim.clip_by_global_norm(1.0), optim.adamw(
            optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10))), params)
    port = convert.state_to_flax(state)
    ref = reference_flat_state(ref_state, ("step", "params", "opt_state"))
    assert set(port) == set(ref)
    assert "opt_state/1/0/mu/layer_0/attention/q_proj/kernel" in port
    assert "opt_state/1/2/count" in port
    for k, v in ref.items():
        assert port[k].shape == v.shape and port[k].dtype == v.dtype, k
    ref_lora, base, lora, lmodel = lora_pair(optax.adamw(1e-2))
    lstate, _ = finetune.create_lora_state(lmodel, optim.adamw(1e-2), base,
                                           lora)
    assert set(convert.state_to_flax(lstate)) == set(reference_flat_state(
        ref_lora, ("step", "base_params", "lora", "opt_state")))


@dataclasses.dataclass
class _Tiny:
    step: int
    w: torch.Tensor


def test_fit_continuous_tier_saves_and_resumes(tmp_path):
    from kubeflow_tpu_torch.training.loop import LoopConfig, fit

    def step_fn(state, batch):
        state = _Tiny(state.step + 1, state.w + batch)
        return state, {"loss": state.w.sum()}

    def batches():
        while True:
            yield torch.ones(16)

    config = LoopConfig(
        total_steps=3, log_every=10,
        checkpoint=CheckpointConfig(directory=str(tmp_path / "mono"),
                                    save_interval_steps=100),
        continuous=ContinuousCheckpointConfig(
            directory=str(tmp_path / "cont"), save_interval_steps=1),
        drain_signals=())
    done = fit(_Tiny(0, torch.zeros(16)), step_fn, batches(), config)
    assert done.step == 3
    reader = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=str(tmp_path / "cont")))
    assert reader.latest_step() == 3
    reader.close()
    config2 = dataclasses.replace(config, total_steps=5)
    resumed = fit(_Tiny(0, torch.zeros(16)), step_fn, batches(), config2)
    assert resumed.step == 5
    assert torch.equal(resumed.w, torch.full((16,), 5.0))


# -- the interchange -------------------------------------------------------------

def _pairs(kind):
    """(reference state, port state, reference step, port step, fields)
    from one init."""
    if kind == "lm":
        ref, params, model = lm_pair(optax.adamw(1e-2))
        port, _ = lm.create_lm_state(model, optim.adamw(1e-2), params)
        return (ref, port, jlm.make_lm_train_step(None, None, donate=False),
                lm.make_lm_train_step(), ("step", "params", "opt_state"))
    ref, base, lora, model = lora_pair(optax.adamw(1e-2))
    port, _ = finetune.create_lora_state(model, optim.adamw(1e-2), base,
                                         lora)
    return (ref, port, jft.make_lora_train_step(None, None, donate=False),
            finetune.make_lora_train_step(),
            ("step", "base_params", "lora", "opt_state"))


BATCHES = [{"input_ids": ids(30 + i, b=4, l=16)} for i in range(3)]


@pytest.mark.parametrize("tier", ["continuous", "periodic"])
@pytest.mark.parametrize("kind", ["lm", "lora"])
def test_port_checkpoint_resumes_in_the_reference(tmp_path, kind, tier):
    """Either of the port's tiers: both are the one sharded writer."""
    ref0, port, ref_step, port_step, fields = _pairs(kind)
    for batch in BATCHES[:2]:
        port, _ = port_step(port, batch)
    writer = (ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=str(tmp_path / "cont"), async_save=False))
        if tier == "continuous" else Checkpointer(CheckpointConfig(
            directory=str(tmp_path / "cont"), save_interval_steps=1)))
    assert writer.save(2, port, force=True)
    writer.close()
    reader = jckpt.ShardedCheckpointer(jckpt.ContinuousCheckpointConfig(
        directory=str(tmp_path / "cont"), async_save=False))
    restored = reader.restore(ref0)
    reader.close()
    ref_flat = reference_flat_state(restored, fields)
    port_flat = convert.state_to_flax(port)
    assert set(ref_flat) == set(port_flat)
    for k, v in ref_flat.items():
        np.testing.assert_array_equal(v, np.asarray(port_flat[k]),
                                      err_msg=k)
    assert int(restored.step) == 2
    _, ref_m = ref_step(restored, BATCHES[2])
    _, port_m = port_step(port, BATCHES[2])  # the run that never stopped
    np.testing.assert_allclose(float(ref_m["loss"]), float(port_m["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["lm", "lora"])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, kind):
    ref, port0, ref_step, port_step, fields = _pairs(kind)
    for batch in BATCHES[:2]:
        ref, _ = ref_step(ref, batch)
    writer = jckpt.ShardedCheckpointer(jckpt.ContinuousCheckpointConfig(
        directory=str(tmp_path / "cont"), async_save=False))
    assert writer.save(2, ref, force=True)
    writer.close()
    reader = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=str(tmp_path / "cont"), async_save=False))
    restored = reader.restore(port0)
    reader.close()
    ref_flat = reference_flat_state(ref, fields)
    port_flat = convert.state_to_flax(restored)
    assert set(ref_flat) == set(port_flat)
    for k, v in ref_flat.items():
        np.testing.assert_array_equal(np.asarray(port_flat[k]), v,
                                      err_msg=k)
    assert restored.step == 2
    _, port_m = port_step(restored, BATCHES[2])
    _, ref_m = ref_step(ref, BATCHES[2])  # the run that never stopped
    np.testing.assert_allclose(float(port_m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
