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

"""Remote model_base_path support: fsspec scanner + download cache.

The reference's primary serving flow pointed the server at GCS
(``kubeflow/tf-serving/tf-serving.libsonnet:110`` —
``model_base_path=gs://...``; versioned layout in
``components/k8s-model-server/README.md:95-105``), and our serving
prototype advertises the same (manifests/serving.py model_path). The
native POSIX scanner (native/kft_runtime.cc) cannot walk object
stores, so remote schemes take this path instead:

- ``scan_latest_version`` lists numeric version dirs through fsspec
  (gs:// via gcsfs, s3:// via s3fs, memory:// in tests — whatever
  protocol fsspec resolves);
- ``materialize`` downloads one version dir into a local content
  cache (atomic: temp dir + rename, same discipline as
  serving/export.py) and returns the local path the normal
  ``load_version`` loader consumes.

POSIX base paths never enter this module: ServedModel falls through
to the native scanner for them (serving/manager.py).
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)

#: Schemes that are really local paths — the native scanner owns them.
_LOCAL_SCHEMES = {"", "file", "local"}


def is_remote(path: str) -> bool:
    if "://" not in path:
        return False
    return path.split("://", 1)[0] not in _LOCAL_SCHEMES


def default_cache_root() -> str:
    return os.environ.get(
        "KFT_MODEL_CACHE",
        os.path.join(tempfile.gettempdir(), "kft-model-cache"))


def _fs_and_root(base_path: str):
    import fsspec

    return fsspec.core.url_to_fs(base_path)


def scan_versions(base_path: str) -> List[int]:
    """All numeric version dirs under a remote base path, ascending
    (the version-policy scanner: latest/all/specific need the full
    set, not just the max)."""
    try:
        fs, root = _fs_and_root(base_path)
        # fsspec filesystems are instance-cached and gcsfs/s3fs keep a
        # directory-listings cache with no expiry: without an explicit
        # invalidation, the first poll's listing is served forever and
        # a version exported by another process is never discovered.
        fs.invalidate_cache(root.rstrip("/"))
        entries = fs.ls(root.rstrip("/"), detail=True)
    except (FileNotFoundError, OSError):
        return []
    found = set()
    for entry in entries:
        name = os.path.basename(str(entry.get("name", "")).rstrip("/"))
        if name.isdigit() and entry.get("type") == "directory":
            found.add(int(name))
    return sorted(found)


def scan_latest_version(base_path: str) -> int:
    """Highest numeric version dir under a remote base path, or -1
    (mirrors the native scanner's contract for POSIX paths)."""
    versions = scan_versions(base_path)
    return versions[-1] if versions else -1


def cache_dir_for(base_path: str, cache_root: str) -> Path:
    """Local cache dir for a remote base path (content-addressed by
    the full path — same-named files under different remote dirs must
    never collide). Shared by the model cache here and the training
    data cache (training/data.py)."""
    digest = hashlib.sha256(base_path.encode()).hexdigest()[:16]
    return Path(cache_root) / digest



def atomic_get_file(fs, remote_file: str, dest: str) -> None:
    """Download one file so a crash can never leave a partial file at
    ``dest``: fetch to a temp sibling, then atomically replace. No-op
    when ``dest`` already exists (immutable-artifact caches)."""
    if os.path.exists(dest):
        return
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(dest),
        prefix=f".tmp-{os.path.basename(dest)}-")
    os.close(fd)
    try:
        fs.get_file(remote_file, tmp)
        os.replace(tmp, dest)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def materialize(base_path: str, version: int,
                cache_root: Optional[str] = None) -> str:
    """Download ``<base_path>/<version>`` into the local cache (no-op
    when already cached) and return the local version dir.

    The download lands in a temp dir first and is renamed into place,
    so a crashed/partial download can never be mistaken for a complete
    version by a concurrent loader.
    """
    cache_root = cache_root or default_cache_root()
    local_base = cache_dir_for(base_path, cache_root)
    final = local_base / str(version)
    if final.is_dir():
        return str(final)
    fs, root = _fs_and_root(base_path)
    remote_dir = f"{root.rstrip('/')}/{version}"
    fs.invalidate_cache(remote_dir)  # see scan_latest_version
    files = [f for f in fs.find(remote_dir)
             if not fs.isdir(f)] if fs.isdir(remote_dir) else []
    if not files:
        raise FileNotFoundError(
            f"remote version dir {base_path}/{version} is missing or "
            f"empty")
    local_base.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=local_base,
                                prefix=f".tmp-{version}-"))
    try:
        for remote_file in files:
            rel = os.path.relpath(remote_file, remote_dir)
            dest = tmp / rel
            dest.parent.mkdir(parents=True, exist_ok=True)
            fs.get_file(remote_file, str(dest))
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    logger.info("materialized %s/%d -> %s (%d files)",
                base_path, version, final, len(files))
    return str(final)


def prune_cache(base_path: str, keep_versions: List[int],
                cache_root: Optional[str] = None) -> None:
    """Drop cached version dirs no longer resident in the server (the
    manager keeps latest + previous; disk should match)."""
    cache_root = cache_root or default_cache_root()
    local_base = cache_dir_for(base_path, cache_root)
    if not local_base.is_dir():
        return
    keep = {str(v) for v in keep_versions}
    for entry in local_base.iterdir():
        if entry.name.isdigit() and entry.name not in keep:
            shutil.rmtree(entry, ignore_errors=True)
