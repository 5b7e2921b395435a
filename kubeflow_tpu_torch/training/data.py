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

"""Input pipeline: synthetic and file-backed batches, and the device
prefetch.

Port of ``kubeflow_tpu/training/data.py``. In a gang (a
``torch.distributed`` group, ``training/launcher.py``) each process
yields its rows of the global batch (:func:`host_shard_range`, the
reference's arithmetic over rank and world size). The generators use numpy's ``RandomState`` with the
reference's seed schedules, so their batches are the reference's to the
bit. The LM generators yield numpy batches, as the reference's do;
:class:`DevicePrefetcher` puts them on the device from a thread of its
own. ``synthetic_images`` yields tensors on the device: its fp32 draws
are the reference's, and both round them to bf16 to nearest even.
"""

from __future__ import annotations

import glob as _glob
import os
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    torch_dtype,
)

Batch = Dict[str, torch.Tensor]
HostBatch = Dict[str, np.ndarray]


def process_index_and_count(mesh: Optional[Any] = None) -> Tuple[int, int]:
    """This process's rank and the gang's size: the
    ``torch.distributed`` group's, or (0, 1) without one (the
    reference's ``jax.process_index()`` / ``process_count()``). Given
    the gang's ``mesh`` (``parallel/mesh.py``), its position and count
    over the batch axes instead: the ranks of one tensor line read the
    same rows."""
    if mesh is not None:
        from kubeflow_tpu_torch.parallel.mesh import BATCH_AXES

        return mesh.index(BATCH_AXES), mesh.axes_size(BATCH_AXES)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard_range(global_batch: int,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None,
                     mesh: Optional[Any] = None) -> range:
    """This process's row range of the global batch (by default the
    gang's rank and size, or ``mesh``'s batch position:
    :func:`process_index_and_count`)."""
    rank, world = process_index_and_count(mesh)
    process_index = rank if process_index is None else process_index
    process_count = world if process_count is None else process_count
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} % hosts "
                         f"{process_count} != 0")
    per = global_batch // process_count
    return range(process_index * per, (process_index + 1) * per)


def synthetic_images(
    global_batch: int,
    image_shape: Sequence[int] = (224, 224, 3),
    num_classes: int = 1000,
    seed: int = 0,
    dtype: str = "bfloat16",
    device: DeviceLike = None,
) -> Iterator[Batch]:
    """Seeded synthetic image classification batches: NHWC ``inputs``
    in ``dtype`` and int32 ``labels``, a fresh draw each step."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    step = 0
    while True:
        rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31))
        images = rng.standard_normal(
            (global_batch, *image_shape)).astype(np.float32)
        labels = rng.randint(0, num_classes, (global_batch,))
        yield {
            "inputs": torch.from_numpy(images).to(device=device,
                                                  dtype=dtype),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(device),
        }
        step += 1


def _apply_mlm_mask(ids: np.ndarray, rng: np.random.RandomState,
                    mask_rate: float, mask_token: int) -> HostBatch:
    """The one mlm batch construction, for synthetic and real streams:
    mask positions at ``mask_rate``, inputs carry ``mask_token`` there,
    labels are the original tokens, weights the mask."""
    mask = rng.random_sample(ids.shape) < mask_rate
    return {
        "input_ids": np.where(mask, mask_token, ids).astype(np.int32),
        "type_ids": np.zeros_like(ids, dtype=np.int32),
        "valid": np.ones_like(ids, dtype=np.int32),
        "mlm_labels": ids.astype(np.int32),
        "mlm_weights": mask.astype(np.int32),
    }


def synthetic_mlm(global_batch: int, seq_len: int = 128,
                  vocab_size: int = 30522, mask_rate: float = 0.15,
                  mask_token: int = 103, seed: int = 0,
                  mesh: Optional[Any] = None) -> Iterator[HostBatch]:
    """Synthetic BERT pretraining batches with dynamic masking, drawn
    over the global batch before the row split (this rank's rows:
    :func:`host_shard_range` of ``mesh``)."""
    rows = host_shard_range(global_batch, mesh=mesh)
    # The generator's frame may outlive the gang (a prefetch thread's
    # source): it keeps no reference to the mesh's process groups.
    del mesh
    step = 0
    while True:
        rng = np.random.RandomState((seed * 2_000_003 + step) % (2 ** 31))
        ids = rng.randint(5, vocab_size, (global_batch, seq_len))
        batch = _apply_mlm_mask(ids, rng, mask_rate, mask_token)
        yield {k: v[rows.start:rows.stop] for k, v in batch.items()}
        step += 1


def synthetic_causal_lm(global_batch: int, seq_len: int = 2048,
                        vocab_size: int = 32000, seed: int = 0,
                        mesh: Optional[Any] = None) -> Iterator[HostBatch]:
    """Synthetic decoder pretraining / fine-tune batches (this rank's
    rows: :func:`host_shard_range` of ``mesh``)."""
    rows = host_shard_range(global_batch, mesh=mesh)
    del mesh  # see synthetic_mlm
    step = 0
    while True:
        rng = np.random.RandomState((seed * 3_000_017 + step) % (2 ** 31))
        ids = rng.randint(0, vocab_size, (global_batch, seq_len))
        yield {"input_ids": ids[rows.start:rows.stop].astype(np.int32)}
        step += 1


def mlm_mask_batches(source: Iterator[HostBatch], *, mask_rate: float = 0.15,
                     mask_token: int = 103, seed: int = 0,
                     process_index: Optional[int] = None,
                     mesh: Optional[Any] = None) -> Iterator[HostBatch]:
    """Dynamic BERT masking over a causal token stream: the mask is
    redrawn every batch, seeded, and folds in the process index (by
    default the gang's rank, or ``mesh``'s batch position, 0 for one
    process) as the reference's does."""
    if process_index is None:
        process_index = process_index_and_count(mesh)[0]
    del mesh  # see synthetic_mlm
    for step, batch in enumerate(source):
        ids = np.asarray(batch["input_ids"])
        rng = np.random.RandomState(
            (seed * 5_000_011 + step * 1_000_003 + process_index)
            % (2 ** 31))
        yield _apply_mlm_mask(ids, rng, mask_rate, mask_token)


def resolve_shards(spec, cache_root: Optional[str] = None) -> list:
    """A data-path spec as local shard files, fetching remote entries.

    ``spec`` is a comma-separated string (or a sequence) of files,
    directories (their ``.npy`` / ``.bin`` files, sorted) or glob
    patterns. ``gs://``-style entries resolve through fsspec into a
    local content cache (``serving/remote.py``'s keying and atomic
    fetch); without fsspec they raise its ImportError."""
    entries = ([e.strip() for e in spec.split(",") if e.strip()]
               if isinstance(spec, str) else [str(e) for e in spec])
    if not entries:
        raise ValueError("empty data spec")
    from kubeflow_tpu_torch.serving.remote import is_remote

    out: list = []
    for entry in entries:
        if is_remote(entry):
            out.extend(_materialize_remote_shards(entry, cache_root))
        elif os.path.isdir(entry):
            files = sorted(
                os.path.join(entry, f) for f in os.listdir(entry)
                if f.endswith((".npy", ".bin")))
            if not files:
                raise ValueError(f"{entry}: no .npy/.bin shards inside")
            out.extend(files)
        elif _glob.has_magic(entry):
            files = sorted(_glob.glob(entry))
            if not files:
                raise ValueError(f"{entry!r} matched no shards")
            out.extend(files)
        elif os.path.exists(entry):
            out.append(entry)
        else:
            raise ValueError(f"data shard {entry!r} does not exist")
    return out


def _materialize_remote_shards(entry: str,
                               cache_root: Optional[str] = None) -> list:
    """One remote spec entry as cached local files."""
    import tempfile

    import fsspec

    from kubeflow_tpu_torch.serving.remote import (
        atomic_get_file,
        cache_dir_for,
    )

    fs, root = fsspec.core.url_to_fs(entry)
    fs.invalidate_cache()  # a listing cache would serve stale results
    if _glob.has_magic(root):
        files = sorted(f for f in fs.glob(root) if not fs.isdir(f))
    elif fs.isdir(root):
        files = sorted(
            f for f in fs.ls(root, detail=False)
            if str(f).endswith((".npy", ".bin")) and not fs.isdir(f))
    elif fs.exists(root):
        files = [root]
    else:
        files = []
    if not files:
        raise ValueError(f"remote data spec {entry!r} matched no shards")
    cache_root = cache_root or os.environ.get(
        "KFT_DATA_CACHE",
        os.path.join(tempfile.gettempdir(), "kft-data-cache"))
    proto = (fs.protocol if isinstance(fs.protocol, str)
             else fs.protocol[0])
    out = []
    for remote_file in files:
        # Keyed by the file's own remote dir: same-named shards from
        # other dirs never collide.
        parent = f"{proto}://{os.path.dirname(str(remote_file))}"
        local_dir = cache_dir_for(parent, cache_root)
        local_dir.mkdir(parents=True, exist_ok=True)
        dest = str(local_dir / os.path.basename(str(remote_file)))
        atomic_get_file(fs, remote_file, dest)
        out.append(dest)
    return out


def _epoch_batch_indices(n_items, global_batch, seed, epochs, rows,
                         seed_stride):
    """A seeded permutation of item order each epoch, this process's
    row window of each global batch, partial trailing batches
    dropped."""
    per_epoch = n_items // global_batch
    epoch = 0
    while epochs is None or epoch < epochs:
        rng = np.random.RandomState(
            (seed * seed_stride + epoch) % (2 ** 31))
        order = rng.permutation(n_items)
        for b in range(per_epoch):
            yield order[b * global_batch + rows.start:
                        b * global_batch + rows.stop]
        epoch += 1


def _locate(offsets, i: int):
    """Flat index → (shard, local offset) via the cumulative sizes."""
    s = int(np.searchsorted(offsets, i, side="right") - 1)
    return s, int(i - offsets[s])


def token_shard_batches(paths: Sequence[str], global_batch: int,
                        seq_len: int, *, seed: int = 0,
                        epochs: Optional[int] = None, dtype: str = "int32",
                        bin_dtype: str = "uint16",
                        mesh: Optional[Any] = None) -> Iterator[HostBatch]:
    """Causal-LM batches ``{"input_ids": [batch, seq_len]}`` from flat
    token shards (this rank's rows: :func:`host_shard_range` of
    ``mesh``): ``.npy`` (self-describing) or raw ``.bin`` read as
    ``bin_dtype``. Shards are memory-mapped; the concatenated stream is
    cut into fixed ``seq_len`` chunks (a chunk may straddle shards), the
    chunk order is shuffled each epoch from ``seed``, and a tail that
    does not fill a batch is dropped. Missing shards and a stream too
    small for one batch raise here, at the call, not at the first
    ``next()`` inside a prefetch thread."""
    if not paths:
        raise ValueError("token_shard_batches needs at least one shard")
    arrays = []
    for path in paths:
        if str(path).endswith(".npy"):
            arr = np.load(path, mmap_mode="r")
        else:
            arr = np.memmap(path, dtype=np.dtype(bin_dtype), mode="r")
        arrays.append(arr.reshape(-1))
    total = sum(a.shape[0] for a in arrays)
    n_chunks = total // seq_len
    if n_chunks < global_batch:
        raise ValueError(
            f"{total} tokens / seq_len {seq_len} = {n_chunks} chunks "
            f"< global batch {global_batch}")
    offsets = np.cumsum([0] + [a.shape[0] for a in arrays])
    rows = host_shard_range(global_batch, mesh=mesh)
    return _token_shard_iter(arrays, offsets, n_chunks, global_batch,
                             seq_len, seed, epochs, dtype, rows)


def _token_shard_iter(arrays, offsets, n_chunks, global_batch, seq_len,
                      seed, epochs, dtype, rows) -> Iterator[HostBatch]:
    def read_chunk(i: int) -> np.ndarray:
        s, local = _locate(offsets, i * seq_len)
        out = np.empty((seq_len,), np.int64)
        filled = 0
        while filled < seq_len:
            take = min(seq_len - filled, arrays[s].shape[0] - local)
            out[filled:filled + take] = arrays[s][local:local + take]
            filled += take
            s += 1
            local = 0
        return out

    for mine in _epoch_batch_indices(n_chunks, global_batch, seed, epochs,
                                     rows, seed_stride=7_000_003):
        batch = np.stack([read_chunk(int(i)) for i in mine])
        yield {"input_ids": batch.astype(dtype)}


def place_batch(batch: Dict[str, Any], device: torch.device) -> Batch:
    """A host batch on ``device``: each array through pinned memory and
    a ``non_blocking`` copy on the current stream (a CUDA device), or as
    a CPU tensor. Tensors already on ``device`` pass as they are."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


class DevicePrefetcher:
    """A background thread that puts upcoming batches on the device.

    ``__next__`` returns a batch already on the device (or whose copy is
    queued ahead of any work the caller then issues on the same stream);
    an exception in the source is raised by the ``__next__`` that
    reaches it; the iterator stops when the source ends; ``close()``
    stops the thread. With a ``mesh`` (``parallel/mesh.py``) each batch
    goes to the mesh's device: the source yields this rank's rows of the
    global batch (every source here takes them by
    :func:`host_shard_range`), which is the rank's piece of the
    reference's ``batch_sharding`` (its multi-process prefetch assembles
    the global array from each process's rows the same way; here one
    process is one device, so the process count is the gang's size)."""

    _DONE = object()

    def __init__(self, source: Iterator[Any], mesh: Optional[object] = None,
                 prefetch: int = 2,
                 place: Optional[Callable[[Any], Any]] = None,
                 device: DeviceLike = None):
        if place is None:
            dev = mesh.device if mesh is not None else resolve_device(device)
            place = lambda b: place_batch(b, dev)  # noqa: E731
        self._place = place
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                self._q.put(self._place(batch))
        except BaseException as e:  # raised in the consumer
            self._q.put(e)
            return
        self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()
        # Unblock the producer if it waits on a full queue.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
