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

"""Host-sharded checkpoints of the port against the reference's.

Twins of ``tests/test_checkpoint_sharded.py::
test_reshard_4_to_3_to_2_and_back_with_moments`` and
``::test_restore_reshards_plain_state_across_host_counts``: an emulated
N-host gang is N checkpointers over one directory. The files cross both
ways: a port 4-host checkpoint restores bitwise into the reference's
meshes of 1, 3, 2 and 4 devices, and a reference 4-host checkpoint into
the port's mesh pieces of 3-, 2- and 4-rank meshes, each rank's piece
the slice of the whole; the plain state reassembles for any reader host
count in either package; the plan and manifest the port writes are the
reference's.
"""

import dataclasses
import json
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.training import checkpoint as jckpt
from kubeflow_tpu_torch.models.convert import state_from_flax, state_to_flax
from kubeflow_tpu_torch.parallel import mesh as pmesh
from kubeflow_tpu_torch.training import optim
from kubeflow_tpu_torch.training.checkpoint import (
    MANIFEST_FILE,
    ContinuousCheckpointConfig,
    ShardedCheckpointer,
)

HOSTS = 4


@dataclasses.dataclass
class State:
    """A port train state: params and optimizer state as its trainers
    hold them, and their mesh layouts (not part of the checkpoint)."""

    step: int
    params: Any
    opt_state: Any
    shardings: Optional[dict] = dataclasses.field(
        default=None, metadata={"static": True})


def _gang(path, package, num_hosts=HOSTS, **kw):
    kw.setdefault("save_interval_steps", 1)
    kw.setdefault("min_shard_size", 8)
    kw.setdefault("commit_timeout_seconds", 10.0)
    cls, cfg = ((ShardedCheckpointer, ContinuousCheckpointConfig)
                if package == "port" else
                (jckpt.ShardedCheckpointer, jckpt.ContinuousCheckpointConfig))
    return [cls(cfg(directory=str(path), num_hosts=num_hosts, host_id=h,
                    **kw)) for h in range(num_hosts)]


def _save_all(gang, step, state):
    for ckpt in gang:
        assert ckpt.save(step, state, force=True)
    for ckpt in gang:
        assert ckpt.wait(15.0)
        ckpt.close()


def _reference_adamw_state(mesh, updates=2):
    """tests/test_checkpoint_sharded.py's ``_adamw_train_state``."""
    params = {"dense": {"w": jnp.arange(48 * 16, dtype=jnp.float32)
                        .reshape(48, 16) / 97.0,
                        "b": jnp.ones((8,))},
              "scale": jnp.asarray(2.0)}
    shardings = jmesh.fsdp_params_sharding(mesh, params, min_weight_size=64)
    params = jax.tree.map(jax.device_put, params, shardings)
    tx = optax.adamw(1e-2)
    opt_state = tx.init(params)
    opt_sh = jmesh.mirror_param_shardings(opt_state, shardings,
                                          jmesh.replicated(mesh))
    opt_state = jax.tree.map(
        lambda leaf, sh: jax.device_put(leaf, sh)
        if hasattr(leaf, "shape") else leaf, opt_state, opt_sh)
    step = 0
    for _ in range(updates):
        grads = jax.tree.map(lambda p: p * 0.01 + 0.5, params)
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        step += 1
    return {"step": jnp.asarray(step), "params": params,
            "opt_state": opt_state}


def _port_template():
    """The port's whole adamw state of the same tree (zeros)."""
    params = {"dense.w": torch.zeros(48, 16), "dense.b": torch.zeros(8),
              "scale": torch.zeros(())}
    return State(0, params, optim.adamw(1e-2).init(params))


def _port_pieces(spec, rank):
    """The port's state at ``rank`` of a mesh of ``spec``: its params and
    moments the rank's pieces by ``fsdp_params_sharding``."""
    mesh = pmesh.Mesh(spec, rank=rank)
    whole = _port_template()
    sh = pmesh.fsdp_params_sharding(mesh, whole.params, min_weight_size=64)
    params = {k: s.shard(whole.params[k]) for k, s in sh.items()}
    return State(0, params, optim.adamw(1e-2).init(params), shardings=sh)


def _reference_flat(state):
    flat, _ = jckpt.flatten_state(state)
    return {k: np.asarray(v) for k, v in flat.items()}


def test_a_port_4_host_checkpoint_restores_into_reference_meshes(tmp_path):
    devices = jax.devices()
    mesh4 = jmesh.build_mesh(jmesh.MeshSpec(data=2, fsdp=2), devices[:4])
    ref_state = _reference_adamw_state(mesh4)
    want = _reference_flat(ref_state)
    # The port's state of the same numbers, written by 4 port hosts.
    port_state = state_from_flax(want, _port_template())
    assert state_to_flax(port_state).keys() == want.keys()
    _save_all(_gang(tmp_path / "c", "port",
                    mesh_shape={"data": 2, "fsdp": 2}), 2, port_state)
    step_dir = sorted((tmp_path / "c").glob("step-*"))[-1]
    manifest = json.loads((step_dir / MANIFEST_FILE).read_text())
    assert manifest["num_hosts"] == HOSTS
    assert manifest["mesh"] == {"data": 2, "fsdp": 2}
    planner = jckpt.ShardedCheckpointer(jckpt.ContinuousCheckpointConfig(
        directory=str(tmp_path / "plan"), num_hosts=HOSTS, min_shard_size=8,
        async_save=False))
    assert manifest["plan"] == planner._plan(want)
    ref_reader = jckpt.ShardedCheckpointer(jckpt.ContinuousCheckpointConfig(
        directory=str(tmp_path / "c"), min_shard_size=8))
    for n, spec in ((1, jmesh.MeshSpec(data=1)),
                    (3, jmesh.respec_for_devices(
                        jmesh.MeshSpec(data=2, fsdp=2), 3)),
                    (2, jmesh.MeshSpec(data=2, fsdp=1)),
                    (4, jmesh.MeshSpec(data=2, fsdp=2))):
        mesh = jmesh.build_mesh(spec, devices[:n])
        restored = ref_reader.restore(_reference_adamw_state(mesh, 0))
        got = _reference_flat(restored)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value,
                                          err_msg=f"{key} on {n}")
    ref_reader.close()


def test_a_reference_4_host_checkpoint_restores_into_port_pieces(tmp_path):
    devices = jax.devices()
    mesh4 = jmesh.build_mesh(jmesh.MeshSpec(data=2, fsdp=2), devices[:4])
    ref_state = _reference_adamw_state(mesh4)
    want = _reference_flat(ref_state)
    _save_all(_gang(tmp_path / "c", "reference",
                    mesh_shape={"data": 2, "fsdp": 2}), 2, ref_state)
    reader = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=str(tmp_path / "c"), async_save=False))
    whole = state_to_flax(reader.restore(_port_template()))
    for key, value in want.items():
        np.testing.assert_array_equal(whole[key], value, err_msg=key)
    for spec in (pmesh.respec_for_devices(pmesh.MeshSpec(data=2, fsdp=2), 3),
                 pmesh.MeshSpec(data=2, fsdp=1),
                 pmesh.MeshSpec(data=2, fsdp=2)):
        for rank in range(int(np.prod(list(spec.sizes().values())))):
            live = _port_pieces(spec, rank)
            restored = reader.restore(live)
            assert restored.step == 2
            for name, sh in live.shardings.items():
                full = torch.from_numpy(np.array(
                    want[f"params/{name.replace('.', '/')}"]))
                piece = full[sh.index(full.shape)]
                assert torch.equal(restored.params[name], piece), name
                mu = restored.opt_state[0].mu[name]
                assert mu.shape == piece.shape
                assert restored.params[name].requires_grad is False
    reader.close()


def _small_state(step=1, scale=1.0):
    """tests/test_checkpoint_sharded.py's ``_small_state``."""
    return {"params": {"w": (jnp.arange(48, dtype=jnp.float32)
                             .reshape(12, 4) * scale),
                       "b": jnp.ones((3,)) * scale},
            "opt": {"mu": jnp.full((8, 2), 0.25 * scale)},
            "step": jnp.asarray(step)}


def _port_small(step=0, scale=0.0):
    return {"params": {"w": torch.arange(48, dtype=torch.float32)
                       .reshape(12, 4) * scale,
                       "b": torch.ones(3) * scale},
            "opt": {"mu": torch.full((8, 2), 0.25 * scale)},
            "step": step}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restore_reshards_plain_state_across_host_counts(tmp_path, writer):
    """Twin of the reference's test of that name: 4 writer shards
    reassemble identically whatever the reader's host count, in either
    package, and structure drift raises."""
    state = _small_state(step=7, scale=3.0)
    want = _reference_flat(state)
    source = state if writer == "reference" else _port_small(7, 3.0)
    _save_all(_gang(tmp_path / "c", writer), 7, source)
    for hosts in (1, 2, 3):
        reader = ShardedCheckpointer(ContinuousCheckpointConfig(
            directory=str(tmp_path / "c"), num_hosts=hosts, host_id=0))
        got = state_to_flax(reader.restore(_port_small()))
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        reader.close()
        ref_reader = jckpt.ShardedCheckpointer(
            jckpt.ContinuousCheckpointConfig(
                directory=str(tmp_path / "c"), num_hosts=hosts,
                host_id=0))
        got = _reference_flat(ref_reader.restore(_small_state(0, 0.0)))
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        ref_reader.close()
    reader = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=str(tmp_path / "c")))
    bad = _port_small()
    bad["params"]["extra"] = torch.zeros(2)
    with pytest.raises(ValueError):
        reader.restore(bad, step=7)
    reader.close()


def test_a_step_missing_a_host_shard_stays_uncommitted(tmp_path):
    """The commit barrier: host 0 writes no manifest until every host's
    shard exists; a step some host never wrote is invisible to
    restore."""
    gang = _gang(tmp_path / "c", "port", async_save=False,
                 commit_timeout_seconds=0.3)
    assert gang[0].save(1, _port_small(1, 1.0), force=True)
    assert gang[0].all_steps() == []
    for ckpt in gang[1:]:
        ckpt.save(1, _port_small(1, 1.0), force=True)
    gang[0]._commit(1, gang[0]._plan(state_to_flax(_port_small(1, 1.0))))
    assert gang[0].all_steps() == [1]
    for ckpt in gang[:2]:
        ckpt.save(2, _port_small(2, 2.0), force=True)
    restored = gang[0].restore(_port_small())
    assert restored["step"] == 1
    for ckpt in gang:
        ckpt.close()
    with pytest.raises(ValueError, match="host_id"):
        ShardedCheckpointer(ContinuousCheckpointConfig(
            directory=str(tmp_path / "d"), num_hosts=2, host_id=2))
