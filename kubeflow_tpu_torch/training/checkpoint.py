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


"""Checkpoint and resume: the periodic tier and the continuous tier.

The port of ``kubeflow_tpu/training/checkpoint.py``. A state is written
as the reference writes it: the flat ``"/"``-keyed dict of the
reference's tree paths, Flax's layouts and dtypes
(``models/convert.py`` :func:`state_to_flax`, e.g. ``step``,
``params/layer_0/attention/q_proj/kernel`` ``[in, out]``,
``opt_state/0/mu/...``), in Flax's msgpack
(``serving/flax_msgpack.py``). Restoring goes through the live state
(:func:`state_from_flax`): shapes, dtypes and devices come from the
running program, never from disk.

Both tiers are one writer, :class:`ShardedCheckpointer`, in the
reference's continuous layout: ``step-XXXXXXXX/state.shard-<i>-of-
<n>.msgpack`` written by temp file + fsync + rename, then
``manifest.json`` last, so a step without a manifest does not exist to
``restore``; ``keep`` newest steps; a restore that skips an unreadable
latest step for the previous one. This is the interchange with the
reference: a JAX run resumes from the port's shards and the port from a
JAX run's continuous tier. The reference's periodic tier is Orbax,
which the port does not import; the port's (:class:`Checkpointer`,
:class:`CheckpointConfig`) is the same writer at the periodic interval,
synchronous by default, so the reference's ``ShardedCheckpointer``
reads it too.

A gang writes host shards, as the reference's does: each of
``num_hosts`` writers (``host_id``, a gang's rank) writes its contiguous
slice of every leaf the plan splits (the first dim divisible by the
host count, on a leaf of at least ``min_shard_size`` elements; the rest
whole in shard 0), and host 0 commits the manifest once every shard
file of the step exists. A state held as a mesh's pieces (a trainer's
``shardings``) is all-gathered first, at the same step on every rank,
so the files are the reference's whatever the mesh. A restore joins
each leaf's pieces along its planned dim, whatever host count wrote
them, and cuts the live state's pieces from the whole.

Background waits are bounded and on monotonic clocks, as the
reference's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from kubeflow_tpu_torch.models.convert import (
    state_from_flax,
    state_to_flax,
    unflatten_tree,
)
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.serving import flax_msgpack

logger = logging.getLogger(__name__)


def atomic_write_bytes(path: Path, data: bytes) -> None:
    """Temp file + fsync + atomic rename: ``path`` holds either its old
    bytes or all of the new ones, never a truncation. The temp name
    carries the pid, so hosts sharing a mount cannot collide."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def flatten_state(state: Any) -> Tuple[Dict[str, Any], None]:
    """``(flat key → host leaf, None)`` of a train state: the
    reference's ``flatten_state`` keys. Its treedef has no port
    counterpart: ``models.convert.state_from_flax`` rebuilds a state
    from the live one."""
    return state_to_flax(state), None


# -- the sharded writer (both tiers) -------------------------------------------

MANIFEST_FORMAT = 1
MANIFEST_FILE = "manifest.json"
STEP_DIR_FMT = "step-{step:08d}"
_STEP_DIR_RE = re.compile(r"^step-(\d{8})$")
SHARD_FILE_FMT = "state.shard-{i:05d}-of-{n:05d}.msgpack"


@dataclasses.dataclass
class CheckpointConfig:
    """The periodic tier's knobs: the reference's (whose tier is Orbax),
    with the continuous tier's gang knobs. Saves are synchronous unless
    ``async_save``: at this tier's interval the device-to-host copy is
    most of a save's cost. ``num_hosts``/``host_id``: the gang's size
    and this writer's rank (``fit`` fills them in a gang); tests emulate
    an N-host gang with N checkpointers over one directory.
    ``mesh_shape`` is recorded in the manifest."""

    directory: str
    save_interval_steps: int = 1000
    keep: int = 3
    async_save: bool = False
    num_hosts: int = 1
    host_id: int = 0
    commit_timeout_seconds: float = 30.0
    min_shard_size: int = 1024
    mesh_shape: Optional[Dict[str, int]] = None


@dataclasses.dataclass
class ContinuousCheckpointConfig(CheckpointConfig):
    """The continuous tier's knobs: the reference's."""

    save_interval_steps: int = 10
    async_save: bool = True


def _shardings_of(state: Any) -> Dict[str, Any]:
    """The live state's per-name shardings (a mesh trainer's state), or
    {}: only leaves split over a live axis."""
    found = getattr(state, "shardings", None) or {}
    return {k: sh for k, sh in found.items() if not sh.replicated}


def map_sharded(node: Any, shardings: Dict[str, Any], fn) -> Any:
    """``node`` rebuilt with ``fn(name, tensor, sharding)`` in place of
    each tensor held in a dict under a sharded param's name (the params
    and every optimizer-state dict that mirrors them), walking what
    ``state_to_flax`` walks."""
    if not shardings:
        return node
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: map_sharded(getattr(node, f.name), shardings, fn)
            for f in dataclasses.fields(node)
            if not f.metadata.get("static")})
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(map_sharded(v, shardings, fn) for v in node))
    if isinstance(node, (tuple, list)):
        return type(node)(map_sharded(v, shardings, fn) for v in node)
    if isinstance(node, dict):
        return {k: (fn(k, v, shardings[k]) if k in shardings
                    and isinstance(v, torch.Tensor)
                    else map_sharded(v, shardings, fn))
                for k, v in node.items()}
    return node


def gathered_state(state: Any) -> Any:
    """The state with every mesh piece all-gathered to its whole leaf (a
    collective: every rank calls it at the same step)."""
    return map_sharded(
        state, _shardings_of(state),
        lambda k, v, sh: collectives.gather_leaf(v.detach(), sh, sh.mesh))


def _whole_template(state: Any) -> Any:
    """The state with every mesh piece replaced by an uninitialized
    tensor of its whole leaf's shape (a restore's target)."""
    def whole(k, v, sh):
        shape = list(v.shape)
        for axis, dim in collectives.dims_by_axis(sh).items():
            shape[dim] *= sh.mesh.shape[axis]
        return torch.empty(shape, dtype=v.dtype, device=v.device,
                           requires_grad=v.requires_grad)
    return map_sharded(state, _shardings_of(state), whole)


def _pieces(restored: Any, live: Any) -> Any:
    """The whole leaves of ``restored`` cut to the live state's pieces."""
    def piece(k, v, sh):
        return sh.shard(v.detach()).requires_grad_(v.requires_grad)
    return map_sharded(restored, _shardings_of(live), piece)


class ShardedCheckpointer:
    """Per-host shard writes of the full train state, the reference's
    continuous layout and protocol: a save takes the device-to-host
    snapshot of this host's slice; the shard (temp + fsync + rename) is
    written at once or, with ``async_save``, by a background writer,
    where a save handed over while the writer is still busy replaces any
    snapshot not yet written (newest wins); host 0 then commits the
    manifest once every host's shard of the step exists (bounded by
    ``commit_timeout_seconds``: a step some host never wrote stays
    uncommitted). ``restore`` walks committed steps newest first and
    skips unreadable ones."""

    def __init__(self, config: CheckpointConfig):
        if config.num_hosts < 1:
            raise ValueError("num_hosts must be >= 1")
        if not 0 <= config.host_id < config.num_hosts:
            raise ValueError(f"host_id {config.host_id} outside "
                             f"[0, {config.num_hosts})")
        self.config = config
        self.root = Path(config.directory).resolve()
        self.root.mkdir(parents=True, exist_ok=True)
        self._stop = threading.Event()
        self._slot: Optional[Tuple[int, Dict[str, Any]]] = None
        self._slot_lock = threading.Lock()
        self._writing = False
        self._idle = threading.Event()
        self._idle.set()
        self._dropped = 0
        self._last_saved: Optional[int] = None
        self._plans: Dict[int, Dict[str, Dict[str, int]]] = {}
        self._writer: Optional[threading.Thread] = None
        if config.async_save:
            self._writer = threading.Thread(
                target=self._writer_loop,
                name=f"ckpt-writer-{config.host_id}",
                daemon=True)
            self._writer.start()

    # -- layout ---------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.root / STEP_DIR_FMT.format(step=step)

    def _shard_file(self, step: int, host: int) -> Path:
        return self._step_dir(step) / SHARD_FILE_FMT.format(
            i=host, n=self.config.num_hosts)

    def all_steps(self) -> List[int]:
        """Committed steps (manifest present), ascending."""
        steps = []
        for child in self.root.iterdir() if self.root.is_dir() else ():
            match = _STEP_DIR_RE.match(child.name)
            if match and (child / MANIFEST_FILE).is_file():
                steps.append(int(match.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -----------------------------------------------------------------

    def _plan(self, flat: Dict[str, Any]) -> Dict[str, Dict[str, int]]:
        """Each leaf's split: the first dim divisible by ``num_hosts`` on
        a leaf of at least ``min_shard_size`` elements; every other leaf
        whole in shard 0. From shapes alone, so every host computes the
        same plan with no collective."""
        n = self.config.num_hosts
        plan: Dict[str, Dict[str, int]] = {}
        if n == 1:
            return plan
        for key, leaf in flat.items():
            shape = tuple(getattr(leaf, "shape", ()))
            size = int(np.prod(shape)) if shape else 1
            if size < self.config.min_shard_size:
                continue
            for dim, width in enumerate(shape):
                if width % n == 0 and width >= n:
                    plan[key] = {"dim": dim}
                    break
        return plan

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Snapshot this host's slice of the state and hand its write to
        the writer; True if a save was scheduled. Every rank of a gang
        calls it at the same step (a state of mesh pieces is gathered
        first)."""
        interval = max(1, int(self.config.save_interval_steps))
        if not force and step % interval != 0:
            return False
        if self._last_saved == step:
            return False
        flat = state_to_flax(gathered_state(state))
        plan = self._plan(flat)
        host, n = self.config.host_id, self.config.num_hosts
        host_flat: Dict[str, Any] = {}
        for key, value in flat.items():
            entry = plan.get(key)
            if entry is None:
                if host == 0:
                    host_flat[key] = value
                continue
            dim = entry["dim"]
            width = value.shape[dim] // n
            sl = [slice(None)] * value.ndim
            sl[dim] = slice(host * width, (host + 1) * width)
            piece = value[tuple(sl)]
            host_flat[key] = (piece.contiguous()
                              if isinstance(piece, torch.Tensor)
                              else np.ascontiguousarray(piece))
        item = (step, host_flat, plan)
        self._last_saved = step
        if self._writer is None:
            self._write_one(item)
        else:
            with self._slot_lock:
                if self._slot is not None:
                    self._dropped += 1
                    logger.warning(
                        "checkpoint writer behind; dropping "
                        "unwritten step %d for step %d", self._slot[0],
                        step)
                self._slot = item
                self._idle.clear()
        return True

    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            with self._slot_lock:
                item = self._slot
                self._slot = None
                self._writing = item is not None
            if item is None:
                self._idle.set()
                self._stop.wait(0.05)
                continue
            try:
                self._write_one(item)
            except Exception:  # noqa: BLE001 — a failed save must not
                # kill training; the next interval retries.
                logger.exception("checkpoint write failed")
            finally:
                with self._slot_lock:
                    self._writing = False
                    if self._slot is None:
                        self._idle.set()

    def _write_one(self, item) -> None:
        step, host_flat, plan = item
        step_dir = self._step_dir(step)
        step_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_bytes(self._shard_file(step, self.config.host_id),
                           flax_msgpack.dumps(host_flat))
        if self.config.host_id == 0:
            self._plans[step] = plan
            self._commit(step)

    def _commit(self, step: int,
                plan: Optional[Dict[str, Dict[str, int]]] = None) -> None:
        """The manifest, last, once every host's shard of the step is
        durable (a barrier on the shared directory, bounded by
        ``commit_timeout_seconds``). ``plan``: the step's, as its save
        planned it unless given."""
        if plan is None:
            plan = self._plans.pop(step, {})
        n = self.config.num_hosts
        deadline = time.monotonic() + self.config.commit_timeout_seconds
        while True:
            missing = [h for h in range(n)
                       if not self._shard_file(step, h).is_file()]
            if not missing:
                break
            if time.monotonic() >= deadline or self._stop.is_set():
                logger.warning("checkpoint step %d: shards %s never "
                               "arrived; step left uncommitted", step,
                               missing)
                return
            self._stop.wait(0.05)
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": step,
            "num_hosts": n,
            "mesh": dict(self.config.mesh_shape or {}),
            "plan": plan,
            "shards": [SHARD_FILE_FMT.format(i=i, n=n) for i in range(n)],
        }
        atomic_write_bytes(
            self._step_dir(step) / MANIFEST_FILE,
            json.dumps(manifest, indent=1, sort_keys=True).encode("utf-8"))
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for old in steps[:-max(1, int(self.config.keep))]:
            step_dir = self._step_dir(old)
            # The manifest first: a racing reader sees an uncommitted
            # step, never a half-deleted valid one.
            (step_dir / MANIFEST_FILE).unlink(missing_ok=True)
            shutil.rmtree(step_dir, ignore_errors=True)
        if steps:
            newest = steps[-1]
            for child in self.root.iterdir():
                match = _STEP_DIR_RE.match(child.name)
                if (match and int(match.group(1)) < newest
                        and not (child / MANIFEST_FILE).is_file()):
                    shutil.rmtree(child, ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def _read_step(self, step: int) -> Dict[str, Any]:
        """The flat state of a committed step, each planned leaf joined
        from every host's shard along its dim."""
        step_dir = self._step_dir(step)
        manifest = json.loads((step_dir / MANIFEST_FILE).read_text())
        if int(manifest.get("format", 0)) != MANIFEST_FORMAT:
            raise ValueError(f"unsupported checkpoint format "
                             f"{manifest.get('format')!r}")
        shards = [flax_msgpack.loads((step_dir / fname).read_bytes())
                  for fname in manifest["shards"]]
        if len(shards) != int(manifest["num_hosts"]):
            raise ValueError("manifest shard count mismatch")
        plan: Dict[str, Dict[str, int]] = manifest["plan"]
        flat: Dict[str, Any] = {}
        for key, value in shards[0].items():
            entry = plan.get(key)
            if entry is None:
                flat[key] = value
                continue
            pieces = [np.asarray(shard[key]) for shard in shards]
            flat[key] = np.concatenate(pieces, axis=int(entry["dim"]))
        for i, shard in enumerate(shards[1:], start=1):
            extra = set(shard) - set(flat)
            if extra:
                raise ValueError(f"shard {i} carries unplanned leaves "
                                 f"{sorted(extra)}")
        return flat

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """The freshest committed step in ``state``'s structure, or
        ``step`` (raising if it is unreadable); ``state`` itself when no
        step is usable (a fresh start)."""
        if step is not None:
            return self._fill(self._read_step(step), state)
        for candidate in reversed(self.all_steps()):
            try:
                flat = self._read_step(candidate)
            except Exception:  # noqa: BLE001 — torn/corrupt artifact
                logger.warning("checkpoint step %d unreadable; "
                               "trying the previous one", candidate,
                               exc_info=True)
                continue
            restored = self._fill(flat, state)
            logger.info("restored checkpoint step %d from %s",
                        candidate, self.root)
            return restored
        logger.info("no checkpoint in %s; fresh start", self.root)
        return state

    @staticmethod
    def _fill(flat: Dict[str, Any], state: Any) -> Any:
        """The whole leaves into the live state's structure, then cut to
        its mesh pieces (the reshard: any host count and mesh restores
        onto the live one)."""
        return _pieces(state_from_flax(flat, _whole_template(state)), state)

    def restore_raw(self, step: Optional[int] = None) -> Optional[Dict]:
        """The latest committed step, or ``step``, in the checkpoint's
        own structure with no live state to fit: the nested dict of the
        reference's tree paths (``{"step", "params": {...}, "opt_state":
        {...}}``; numpy arrays in Flax's layout, bf16 leaves as CPU
        tensors). ``kft-export``'s entry point, where only a subtree
        (the params, the LoRA adapters) is wanted. None when no step is
        committed. Reads the port's checkpoints and the reference's
        sharded tier; an Orbax directory (the reference's periodic
        tier) raises: the port reads no Orbax."""
        self._refuse_orbax()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return unflatten_tree(self._read_step(step))

    def _refuse_orbax(self) -> None:
        """Orbax's step dirs are bare integers (``<root>/3/``) where this
        layout's are ``step-XXXXXXXX``: such a directory is raised on,
        not guessed at."""
        if not self.root.is_dir() or self.all_steps():
            return
        orbax = sorted(c.name for c in self.root.iterdir()
                       if c.is_dir() and c.name.isdigit())
        if orbax:
            raise ValueError(
                f"{self.root} holds Orbax step dirs {orbax[:3]}: the port "
                f"reads no Orbax, only the sharded layout "
                f"(step-XXXXXXXX/manifest.json) of its own checkpoints "
                f"and of the reference's continuous tier")

    # -- lifecycle --------------------------------------------------------------

    def wait(self, timeout: Optional[float] = 60.0) -> bool:
        """Block until the handed-over write is durable; False on
        timeout."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while True:
            with self._slot_lock:
                if self._slot is None and not self._writing:
                    return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self._idle.wait(timeout=0.05)

    def close(self) -> None:
        self.wait(timeout=self.config.commit_timeout_seconds)
        self._stop.set()
        if self._writer is not None:
            self._writer.join(timeout=5.0)


#: The periodic tier: the one writer at the periodic interval.
Checkpointer = ShardedCheckpointer
