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

"""kubeflow_tpu_torch.serving.export_cli (kft-export) against the reference's.

Twins of the 8 cases of tests/test_export_cli.py. Each export the port
writes is held against the reference's export of the same variables
(the port's tree restored raw, saved as the reference's Orbax checkpoint
and exported by the reference's CLI): ``signature.json`` equal, and the
stored trees equal leaf for leaf, bit for bit, partitioning boxes and
dtypes included. The reference's ``load_version`` serves the port's
export and the port's serves the reference's: equal tokens, and each
package's outputs equal over both exports. Checkpoints come from the
port's own trainers and checkpointer; the export's LoRA merge is the
port's ``merge_lora``.
"""

import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

from kubeflow_tpu.serving import export_cli as jax_cli
from kubeflow_tpu.serving.model import load_version as jax_load_version
from kubeflow_tpu.training.checkpoint import (
    CheckpointConfig as JaxCheckpointConfig,
)
from kubeflow_tpu.training.checkpoint import Checkpointer as JaxCheckpointer
from kubeflow_tpu.training import checkpoint as jckpt
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.generate import generate
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import llama_test
from kubeflow_tpu_torch.ops.lora import merge_lora
from kubeflow_tpu_torch.serving import export_cli
from kubeflow_tpu_torch.serving.export_cli import export_from_checkpoint, main
from kubeflow_tpu_torch.serving.model import load_version
from kubeflow_tpu_torch.serving.sharding import ShardSpec
from kubeflow_tpu_torch.training import finetune, optim
from kubeflow_tpu_torch.training.checkpoint import (
    CheckpointConfig,
    Checkpointer,
)
from kubeflow_tpu_torch.training.data import place_batch, token_shard_batches
from kubeflow_tpu_torch.training.loop import LoopConfig, fit
from kubeflow_tpu_torch.training.train import (
    create_train_state,
    make_train_step,
    sgd,
)

GEN = {"max_new_tokens": 4, "temperature": 0.0}
F32 = {"dtype": "float32"}


def _stored(version_dir):
    data = open(f"{version_dir}/params.msgpack", "rb").read()
    return flatten_dict(serialization.msgpack_restore(data), sep="/")


def assert_same_export(port_dir, ref_dir):
    """signature.json equal; the stored trees equal leaf for leaf."""
    assert (open(f"{port_dir}/signature.json").read()
            == open(f"{ref_dir}/signature.json").read())
    ours, theirs = _stored(port_dir), _stored(ref_dir)
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        got = ours[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=key)


def unboxed(version_dir):
    """An export's stored tree without the partitioning boxes."""
    data = open(f"{version_dir}/params.msgpack", "rb").read()

    def strip(node):
        if isinstance(node, dict):
            if set(node) == {"value"} and not isinstance(node["value"],
                                                         dict):
                return node["value"]
            return {k: strip(v) for k, v in node.items()}
        return node

    return strip(serialization.msgpack_restore(data))


def reference_export(tmp_path, tree, name, **kw):
    """The reference CLI's export of ``tree`` (a nested dict of arrays),
    through its own Orbax checkpoint."""
    ckpt_dir = str(tmp_path / f"orbax-{name}")
    ckpt = JaxCheckpointer(JaxCheckpointConfig(directory=ckpt_dir,
                                               async_save=False))
    assert ckpt.save(1, tree, force=True)
    ckpt.close()
    return jax_cli.export_from_checkpoint(
        out=str(tmp_path / f"ref-{name}"), version=1, checkpoint=ckpt_dir,
        **kw)


def assert_served_alike(port_dir, ref_dir, inputs, key):
    """Each package serves the other's export as its own, bit for bit
    (resnet-test computes in bf16, so the two packages' logits are held
    each to itself, not to each other)."""
    ours = load_version(port_dir, device="cpu")
    theirs = load_version(ref_dir, device="cpu")
    np.testing.assert_array_equal(theirs.run(inputs)[key],
                                  ours.run(inputs)[key])
    np.testing.assert_array_equal(
        np.asarray(jax_load_version(port_dir).run(inputs)[key]),
        np.asarray(jax_load_version(ref_dir).run(inputs)[key]))


def prompt(seed, b):
    return prng.randint(prng.PRNGKey(seed), (b, 8), 0, 512)


def test_export_fresh_generate_model_and_serve(tmp_path):
    kw = dict(registry_name="llama-test", seq_len=8, generate_config=GEN,
              model_kwargs=F32)
    path = export_from_checkpoint(out=str(tmp_path / "models" / "lm"),
                                  version=1, device="cpu", **kw)
    loaded = load_version(path, device="cpu")
    x = prompt(0, 2)
    tokens = loaded.run({"input_ids": x})["tokens"]
    assert tokens.shape == (2, 4)
    ref = reference_export(tmp_path, unboxed(path), "fresh", **kw)
    assert_same_export(path, ref)
    # Each package serves the other's export, token for token.
    np.testing.assert_array_equal(
        np.asarray(jax_load_version(path).run({"input_ids": x})["tokens"]),
        tokens)
    np.testing.assert_array_equal(
        load_version(ref, device="cpu").run({"input_ids": x})["tokens"],
        tokens)


def test_export_lora_finetune_checkpoint_and_serve(tmp_path):
    """A fit()-saved LoRAState (its base and adapters in one checkpoint)
    → the merged export → the served model decodes as the merged
    weights do, and the reference's export of the same checkpoint is the
    same bytes."""
    rng = np.random.RandomState(0)
    shard = tmp_path / "s.npy"
    np.save(shard, rng.randint(0, 512, 20_000).astype(np.uint16))
    model = llama_test(lora_rank=4, dtype="float32", param_dtype="float32")
    base = convert.init_params(model, seed=1, device="cpu")
    state, _ = finetune.create_lora_state(model, optim.adamw(5e-3), base,
                                          seed=1)
    batches = (place_batch(b, torch.device("cpu")) for b in
               token_shard_batches([str(shard)], 4, 16, seed=3))
    ckpt_dir = str(tmp_path / "ckpt")
    state = fit(state, finetune.make_lora_train_step(), batches, LoopConfig(
        total_steps=3, log_every=3,
        checkpoint=CheckpointConfig(directory=ckpt_dir,
                                    save_interval_steps=1)))

    kw = dict(registry_name="llama-test", lora=True, lora_rank=4,
              seq_len=8, generate_config=GEN, model_kwargs=F32)
    path = export_from_checkpoint(out=str(tmp_path / "models" / "ft"),
                                  version=1, checkpoint=ckpt_dir,
                                  device="cpu", **kw)
    loaded = load_version(path, device="cpu")
    x = prompt(2, 1)
    served = loaded.run({"input_ids": x})["tokens"]

    # Greedy decode through the merged weights, not through the export.
    merged = merge_lora(state.base_params, state.lora,
                        alpha=model.lora_alpha)
    gen_model = llama_test(dtype="float32", cache_size=16)
    want, _ = generate(gen_model, merged, torch.from_numpy(x),
                       max_new_tokens=4)
    np.testing.assert_array_equal(served, want.numpy())

    raw = Checkpointer(CheckpointConfig(directory=ckpt_dir)).restore_raw()
    assert int(raw["step"]) == 3
    raw.pop("opt_state")
    ref = reference_export(tmp_path, raw, "lora", **kw)
    assert_same_export(path, ref)
    np.testing.assert_array_equal(
        np.asarray(jax_load_version(path).run({"input_ids": x})["tokens"]),
        served)


def test_export_cli_main_smoke(tmp_path, monkeypatch):
    # The CLI takes its device from the pod env's JAX_PLATFORMS=cpu.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    out = str(tmp_path / "m")
    argv = ["--model", "llama-test", "--out", out, "--version", "3",
            "--seq_len", "8", "--generate", '{"max_new_tokens": 4}',
            "--model_kwargs", '{"dtype": "float32"}']
    assert main(argv) == 0
    loaded = load_version(out + "/3", device="cpu")
    assert loaded.version == 3
    assert loaded.signature().method == "generate"
    ref = str(tmp_path / "r")
    assert jax_cli.main(argv[:2] + ["--out", ref] + argv[4:]) == 0
    assert (open(f"{out}/3/signature.json").read()
            == open(f"{ref}/3/signature.json").read())
    # The same draw from the same seed, on the env's device or named.
    assert main(argv[:5] + ["4"] + argv[6:] + ["--device", "cpu"]) == 0
    for key, leaf in _stored(f"{out}/3").items():
        np.testing.assert_array_equal(leaf, _stored(f"{out}/4")[key])


def test_export_missing_checkpoint_fails_loudly(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export_from_checkpoint(
            registry_name="llama-test", out=str(tmp_path / "x"),
            version=1, checkpoint=str(tmp_path / "empty"), seq_len=8,
            model_kwargs=F32, device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export_from_checkpoint(
            registry_name="llama-test", out=str(tmp_path / "x"),
            version=1, checkpoint=str(tmp_path / "empty"), seq_len=8,
            model_kwargs=F32, device="cpu")
    # The reference's periodic tier is Orbax, which the port does not
    # read: it says so rather than guess.
    orbax = str(tmp_path / "orbax")
    ckpt = JaxCheckpointer(JaxCheckpointConfig(directory=orbax,
                                               async_save=False))
    assert ckpt.save(1, {"params": {"w": np.zeros(3, np.float32)}},
                     force=True)
    ckpt.close()
    with pytest.raises(ValueError, match="reads no Orbax"):
        export_from_checkpoint(
            registry_name="llama-test", out=str(tmp_path / "x"),
            version=1, checkpoint=orbax, seq_len=8, model_kwargs=F32,
            device="cpu")
    assert not (tmp_path / "x").exists()


def test_export_vision_model_with_batch_stats(tmp_path):
    """Vision models carry batch_stats; the export includes them or
    load_version rejects the version dir."""
    path = export_from_checkpoint(
        registry_name="resnet-test", out=str(tmp_path / "vision"),
        version=1, device="cpu")
    loaded = load_version(path, device="cpu")
    images = np.random.default_rng(0).random((2, 32, 32, 3), np.float32)
    out = loaded.run({"images": images})
    assert out["logits"].shape[0] == 2
    ref = reference_export(tmp_path, unboxed(path), "vision",
                           registry_name="resnet-test")
    assert_same_export(path, ref)
    assert_served_alike(path, ref, {"images": images}, "logits")


def test_export_vision_fit_checkpoint_carries_trained_batch_stats(tmp_path):
    """A trained vision state's checkpoint carries its batch_stats, and
    the export serves the TRAINED statistics, not fresh ones."""
    from kubeflow_tpu_torch.models.registry import get_model

    model = get_model("resnet-test").make(num_classes=10)
    params, stats = convert.init_vision(model, seed=0, device="cpu")
    state = create_train_state(model, sgd(0.1), params, stats)
    step = make_train_step(None)
    rng = np.random.RandomState(0)
    batch = {"inputs": torch.from_numpy(
        rng.rand(4, 32, 32, 3).astype(np.float32)).to(torch.bfloat16),
        "labels": torch.from_numpy(rng.randint(0, 10, 4))}
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt_dir = str(tmp_path / "ckpt")
    ckpt = Checkpointer(CheckpointConfig(directory=ckpt_dir))
    assert ckpt.save(int(state.step), {"step": int(state.step),
                                       "params": state.params,
                                       "batch_stats": state.batch_stats},
                     force=True)
    ckpt.close()

    path = export_from_checkpoint(
        registry_name="resnet-test", out=str(tmp_path / "served"),
        version=1, checkpoint=ckpt_dir, model_kwargs={"num_classes": 10},
        device="cpu")
    loaded = load_version(path, device="cpu")
    # Trained BN statistics differ from init zeros and ones; the export
    # carries the trained values.
    assert any(float(v.abs().sum()) > 0 and not torch.equal(
        v, torch.ones_like(v)) for v in state.batch_stats.values())
    for name, value in state.batch_stats.items():
        assert torch.equal(loaded.batch_stats[name], value), name
    images = rng.rand(2, 32, 32, 3).astype(np.float32)
    out = loaded.run({"images": images})
    assert out["logits"].shape == (2, 10)
    raw = Checkpointer(CheckpointConfig(directory=ckpt_dir)).restore_raw()
    ref = reference_export(tmp_path, raw, "trained",
                           registry_name="resnet-test",
                           model_kwargs={"num_classes": 10})
    assert_same_export(path, ref)
    assert_served_alike(path, ref, {"images": images}, "logits")


BAD_CONFIGS = [
    ({"max_tokens": 8}, "unknown generate config"),
    ({"top_k": 50.5}, "must be an integer"),
    ({"max_new_tokens": "many"}, "int-like"),
    ({"top_p": 1.5}, "top_p"),
    ({"deterministic": "false"}, "boolean"),
    ({"top_k": True}, "int-like"),
    ({"decode_chunk_tokens": 0}, "decode_chunk_tokens"),
    ({"prompt_buckets": []}, "prompt_buckets"),
    ({"prompt_buckets": [0, 8]}, "prompt_buckets"),
    ({"prompt_buckets": "128,512"}, "prompt_buckets"),
    ({"engine_host_cache_bytes": -1}, "engine_host_cache_bytes"),
    ({"kv_fetch_deadline_ms": -250}, "kv_fetch_deadline_ms"),
    ({"engine_host_cache_bytes": True}, "int-like"),
    ({"kv_fetch_deadline_ms": "fast"}, "int-like"),
]


def test_generate_config_validation(tmp_path):
    validate = export_cli.validate_generate_config
    for cfg in ({"top_k": 50.0, "temperature": 1, "max_new_tokens": 8},
                {"decode_chunk_tokens": 16,
                 "prompt_buckets": [512, 128, 128]},
                {"engine_host_cache_bytes": 2 ** 30,
                 "kv_fetch_deadline_ms": 250.0},
                {"engine_host_cache_bytes": 0, "kv_fetch_deadline_ms": 0}):
        got = validate(cfg)
        want = jax_cli.validate_generate_config(cfg)
        assert got == want
        assert {k: type(v) for k, v in got.items()} == {
            k: type(v) for k, v in want.items()}
    assert validate({"top_k": 50.0})["top_k"] == 50
    assert validate({"prompt_buckets": [512, 128, 128]})[
        "prompt_buckets"] == [128, 512]
    for cfg, match in BAD_CONFIGS:
        with pytest.raises(ValueError, match=match):
            validate(cfg)
        with pytest.raises(ValueError, match=match):
            jax_cli.validate_generate_config(cfg)
    # The exporter runs it: a bad config produces no version dir.
    with pytest.raises(ValueError, match="unknown generate config"):
        export_from_checkpoint(
            registry_name="llama-test", out=str(tmp_path / "bad"),
            version=1, seq_len=8,
            generate_config={"max_new_tokens": 4, "typo_key": 1},
            model_kwargs=F32, device="cpu")
    assert not (tmp_path / "bad").exists()


def test_export_rejects_incoherent_signatures(tmp_path):
    with pytest.raises(ValueError, match="language model"):
        export_from_checkpoint(
            registry_name="resnet-test", out=str(tmp_path / "a"),
            version=1, signature_kind="generate",
            generate_config={"max_new_tokens": 4}, device="cpu")
    with pytest.raises(ValueError, match="vision model"):
        export_from_checkpoint(
            registry_name="llama-test", out=str(tmp_path / "b"),
            version=1, signature_kind="classify", seq_len=8,
            model_kwargs=F32, device="cpu")
    # A sharded export is the layout the shard spec names (its bytes:
    # tests/test_torch_export_sharded.py); one shard is the monolithic
    # layout.
    sharded = export_from_checkpoint(
        registry_name="llama-test", out=str(tmp_path / "c"),
        version=1, seq_len=8, model_kwargs=F32,
        shard_spec=ShardSpec(tensor=2), device="cpu")
    assert load_version(sharded, device="cpu").shard_topology() == {
        "num_shards": 2, "mesh": {"tensor": 2, "fsdp": 1},
        "on_mesh": False}
    assert main(["--model", "llama-test", "--out", str(tmp_path / "c"),
                 "--version", "2", "--shards", "tensor=2",
                 "--device", "cpu"]) == 0
    path = export_from_checkpoint(
        registry_name="llama-test", out=str(tmp_path / "d"), version=1,
        seq_len=8, model_kwargs=F32, shard_spec=ShardSpec(), device="cpu")
    assert load_version(path, device="cpu").shard_topology() == {
        "num_shards": 1, "on_mesh": False}


def _host_state(step, scale):
    return {"params": {"w": np.arange(48, dtype=np.float32).reshape(12, 4)
                       * scale, "b": np.ones(3, np.float32) * scale},
            "opt": {"mu": np.full((8, 2), 0.25 * scale, np.float32)},
            "step": np.asarray(step, np.int32)}


def test_restore_raw_reads_the_references_sharded_tier_and_the_ports(
        tmp_path):
    """``restore_raw`` takes no template: the latest committed step or a
    given one, as the reference's nested tree. The reference's
    continuous tier written by a two-host gang (each leaf's planned
    pieces joined), and the port's own checkpoints."""
    gang = [jckpt.ShardedCheckpointer(jckpt.ContinuousCheckpointConfig(
        directory=str(tmp_path / "cont"), num_hosts=2, host_id=h,
        save_interval_steps=1, min_shard_size=8,
        commit_timeout_seconds=10.0)) for h in range(2)]
    for step, scale in ((5, 1.0), (7, 3.0)):
        for ckpt in gang:
            assert ckpt.save(step, _host_state(step, scale), force=True)
        for ckpt in gang:
            assert ckpt.wait(15.0)
    for ckpt in gang:
        ckpt.close()
    reader = Checkpointer(CheckpointConfig(directory=str(tmp_path / "cont")))
    manifest = (tmp_path / "cont" / "step-00000007" / "manifest.json")
    assert '"num_hosts": 2' in manifest.read_text()
    for step, scale in ((None, 3.0), (7, 3.0), (5, 1.0)):
        raw = reader.restore_raw(step)
        want = _host_state(7 if step is None else step, scale)
        assert set(raw) == set(want)
        for key, leaf in convert.flatten_tree(want).items():
            np.testing.assert_array_equal(
                convert.flatten_tree(raw)[key], leaf, err_msg=key)
    reader.close()
    empty = Checkpointer(CheckpointConfig(directory=str(tmp_path / "none")))
    assert empty.restore_raw() is None
    # The port's own: a state's tree in the reference's layout.
    params = {"head.weight": torch.arange(6.0).reshape(2, 3),
              "scale": torch.ones(3, dtype=torch.bfloat16)}
    empty.save(2, {"step": 2, "params": params}, force=True)
    raw = empty.restore_raw()
    assert int(raw["step"]) == 2
    np.testing.assert_array_equal(raw["params"]["head"]["kernel"],
                                  params["head.weight"].numpy().T)
    assert torch.equal(raw["params"]["scale"], params["scale"])


@pytest.mark.parametrize("name", ["llama-test", "llama-moe-test", "bert-test",
                                  "vit-test", "resnet-test", "vgg-test",
                                  "inception-v3", "alexnet"])
def test_each_model_names_the_params_its_reference_boxes(name):
    # The reference's init (shapes only) boxes each param its module
    # annotates with nn.with_partitioning; the port's module names the
    # same keys through partitioned(), which the exporter asks.
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from flax.core import unfreeze

    from kubeflow_tpu.models.registry import get_model as jax_get_model
    from kubeflow_tpu_torch.models.registry import get_model

    entry = jax_get_model(name)
    if entry.family == "language":
        inputs = (jnp.zeros((1, 8), jnp.int32),)
    else:
        inputs = (jnp.zeros((1, *entry.input_spec[0]), jnp.float32),)
    ref = jax.eval_shape(lambda: entry.make().init(
        jax.random.PRNGKey(0), *inputs))
    tree = flatten_dict(unfreeze(ref["params"]), sep="/",
                        is_leaf=lambda _, v: isinstance(v, nn.Partitioned))
    boxed = {k for k, v in tree.items() if isinstance(v, nn.Partitioned)}
    module = get_model(name).make()
    keys = {convert._flax_key(n) for n, _ in module.named_parameters()}
    assert keys == set(tree)
    assert {k for k in keys if module.partitioned(k)} == boxed
    if name != "llama-test":
        return
    with pytest.raises(TypeError, match="partitioned"):
        export_cli._rebox(torch.nn.Linear(2, 2), {})
