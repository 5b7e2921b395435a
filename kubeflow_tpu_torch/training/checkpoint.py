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
reads it too. The port writes as one host (a gang's shards are ROADMAP
A14, and ``fit`` refuses a checkpoint in a gang until then); it reads a
checkpoint of any host count (each leaf's pieces joined along its
planned dim).

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

from kubeflow_tpu_torch.models.convert import state_from_flax, state_to_flax
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
    """The periodic tier's knobs: the reference's (whose tier is Orbax).
    Saves are synchronous unless ``async_save``: at this tier's interval
    the device-to-host copy is most of a save's cost."""

    directory: str
    save_interval_steps: int = 1000
    keep: int = 3
    async_save: bool = False


@dataclasses.dataclass
class ContinuousCheckpointConfig(CheckpointConfig):
    """The continuous tier's knobs: the reference's, less those of a
    gang (host count and id, the shard plan, the commit barrier), which
    are ROADMAP A14."""

    save_interval_steps: int = 10
    async_save: bool = True


class ShardedCheckpointer:
    """Shard writes of the full train state, the reference's continuous
    layout and protocol (one host): a save takes the device-to-host
    snapshot; the shard (temp + fsync + rename) and then the manifest
    are written at once or, with ``async_save``, by a background writer,
    where a save handed over while the writer is still busy replaces any
    snapshot not yet written (newest wins). ``restore`` walks committed
    steps newest first and skips unreadable ones."""

    def __init__(self, config: CheckpointConfig):
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
        self._writer: Optional[threading.Thread] = None
        if config.async_save:
            self._writer = threading.Thread(
                target=self._writer_loop, name="ckpt-writer-0",
                daemon=True)
            self._writer.start()

    # -- layout ---------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.root / STEP_DIR_FMT.format(step=step)

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

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Snapshot the state to the host and hand its write to the
        writer; True if a save was scheduled."""
        interval = max(1, int(self.config.save_interval_steps))
        if not force and step % interval != 0:
            return False
        if self._last_saved == step:
            return False
        item = (step, state_to_flax(state))
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

    def _write_one(self, item: Tuple[int, Dict[str, Any]]) -> None:
        step, flat = item
        step_dir = self._step_dir(step)
        step_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_bytes(step_dir / SHARD_FILE_FMT.format(i=0, n=1),
                           flax_msgpack.dumps(flat))
        self._commit(step)

    def _commit(self, step: int) -> None:
        """The manifest, last (one host: its shard is durable)."""
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": step,
            "num_hosts": 1,
            "mesh": {},
            "plan": {},
            "shards": [SHARD_FILE_FMT.format(i=0, n=1)],
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
            return state_from_flax(self._read_step(step), state)
        for candidate in reversed(self.all_steps()):
            try:
                flat = self._read_step(candidate)
            except Exception:  # noqa: BLE001 — torn/corrupt artifact
                logger.warning("checkpoint step %d unreadable; "
                               "trying the previous one", candidate,
                               exc_info=True)
                continue
            restored = state_from_flax(flat, state)
            logger.info("restored checkpoint step %d from %s",
                        candidate, self.root)
            return restored
        logger.info("no checkpoint in %s; fresh start", self.root)
        return state

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
        self.wait(timeout=30.0)
        self._stop.set()
        if self._writer is not None:
            self._writer.join(timeout=5.0)


#: The periodic tier: the one writer at the periodic interval.
Checkpointer = ShardedCheckpointer
