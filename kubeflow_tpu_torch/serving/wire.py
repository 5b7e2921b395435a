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

"""The blobs that pass between replicas: KV handoff, the mid-stream
resume token and fleet KV blocks.

The port's copy of those three codecs of ``kubeflow_tpu/serving/wire.py``
(the handoff blob, the resume token, the ``:kv/fetch`` payload), written
and read through :mod:`~kubeflow_tpu_torch.serving.flax_msgpack` with
the reference's keys, int32 scalars and validation messages. A blob
either package writes decodes in the other: arrays travel byte-exact,
bfloat16 as its raw 16-bit words. The protobuf codec, gRPC framing and
SSE of the reference's module are not ported here.

- **Handoff** (role-split serving): a prefill replica's
  :class:`~kubeflow_tpu_torch.inference.engine.engine.PrefillHandoff`,
  its cache keyed by path (``"layer_0/attention/k"``, the reference's
  flat cache collection; ``models/convert.py`` ``cache_to_flax``), so
  the order of the keys does not matter.
- **Resume token** (mid-stream failover): the context ids and the
  remaining sampling schedule; no cache.
- **KV blocks** (the fleet pull-through): a chain of full prefix blocks,
  each a LIST of ``[page_size, heads, dim]`` arrays in
  ``paged_kv.kv_leaf_order``, the reference's tree-flatten order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubeflow_tpu_torch.models.convert import cache_from_flax, cache_to_flax
from kubeflow_tpu_torch.serving import flax_msgpack

__all__ = [
    "KV_BLOCKS_FORMAT",
    "KV_HANDOFF_FORMAT",
    "RESUME_TOKEN_FORMAT",
    "decode_kv_blocks",
    "decode_kv_handoff",
    "decode_resume_token",
    "encode_kv_blocks",
    "encode_kv_handoff",
    "encode_resume_token",
]

# --- KV handoff (role-split routing) ---------------------------------------

#: Version tag of the handoff blob. Prefill and decode replicas may be
#: mid-rollout on different builds; an unknown version must fail the
#: request with a clear 400, never mis-adopt pages.
KV_HANDOFF_FORMAT = 1


def encode_kv_handoff(model: str, version: int, handoff) -> bytes:
    """Serialize a ``PrefillHandoff`` for the prefill → decode hop. The
    cache leaves travel byte-exact (bf16 included), which keeps the
    adopted decode bitwise equal to a local one. ``model``/``version``
    pin the export the cache came from."""
    doc = {
        "format": np.int32(KV_HANDOFF_FORMAT),
        "model": model,
        "version": np.int32(version),
        "first_token": np.int32(handoff.first_token),
        "done": np.int32(1 if handoff.done else 0),
        "prompt_len": np.int32(handoff.prompt_len),
        "prompt_width": np.int32(handoff.prompt_width),
        "max_new_tokens": np.int32(handoff.max_new_tokens),
        "step_keys": np.asarray(handoff.step_keys),
        "cache": cache_to_flax(handoff.cache),
    }
    # Additive within format 1, as the reference's: readers that predate
    # them ignore unknown keys, and absent keys decode to the classic
    # left-padded layout.
    layout = getattr(handoff, "layout", "left") or "left"
    if layout != "left":
        doc["layout"] = layout
    tokens = getattr(handoff, "prompt_tokens", None)
    if tokens is not None:
        doc["prompt_tokens"] = np.asarray(tokens, np.int32)
    return flax_msgpack.dumps(doc)


def decode_kv_handoff(data: bytes, *, model: str,
                      version: Optional[int] = None):
    """Parse and validate a handoff blob against the adopting replica's
    (model, version). Returns the engine's ``PrefillHandoff``, its cache
    on the host. Raises ValueError on any mismatch or malformed payload
    (the server maps it to a 400; the proxy falls back to the classic
    single-replica path)."""
    from kubeflow_tpu_torch.inference.engine.engine import PrefillHandoff

    try:
        doc = flax_msgpack.loads(data)
        fmt = int(doc["format"])
    except Exception as e:  # noqa: BLE001 — malformed blob = 400
        raise ValueError(f"malformed KV handoff blob: {e}") from None
    if fmt != KV_HANDOFF_FORMAT:
        raise ValueError(
            f"KV handoff format {fmt} unsupported (this replica "
            f"speaks {KV_HANDOFF_FORMAT}); prefill/decode replicas "
            f"are mid-rollout on incompatible builds")
    if doc["model"] != model:
        raise ValueError(
            f"KV handoff is for model {doc['model']!r}, not {model!r}")
    if version is not None and int(doc["version"]) != int(version):
        raise ValueError(
            f"KV handoff came from version {int(doc['version'])} but "
            f"this replica serves version {version} — cache layout "
            f"may differ; retry (the prefill pool will re-resolve)")
    cache = cache_from_flax(doc["cache"])
    layout = doc.get("layout")
    layout = str(layout) if layout is not None else "left"
    if layout not in ("left", "right"):
        raise ValueError(
            f"KV handoff layout {layout!r} unknown (this replica "
            f"speaks left/right)")
    tokens = doc.get("prompt_tokens")
    return PrefillHandoff(
        cache=cache,
        first_token=int(doc["first_token"]),
        done=bool(int(doc["done"])),
        prompt_len=int(doc["prompt_len"]),
        prompt_width=int(doc["prompt_width"]),
        max_new_tokens=int(doc["max_new_tokens"]),
        step_keys=np.asarray(doc["step_keys"], np.uint32),
        layout=layout,
        prompt_tokens=(None if tokens is None
                       else np.asarray(tokens, np.int32)))


# --- mid-stream resume ------------------------------------------------------

#: Version tag of the mid-stream resume token. An unknown format fails
#: the resume with a clear 400 instead of mis-resuming.
RESUME_TOKEN_FORMAT = 1


def encode_resume_token(model: str, version: int,
                        prompt_tokens: np.ndarray,
                        step_keys: np.ndarray,
                        max_new_tokens: int) -> bytes:
    """Serialize one stream's resume context: the full context ids and
    the ORIGINAL per-token sampling schedule (re-deriving it with
    another budget would fork the sampled sequence). No cache: the
    replica that held the pages is the one that died, and the peer
    re-prefills the context."""
    return flax_msgpack.dumps({
        "format": np.int32(RESUME_TOKEN_FORMAT),
        "kind": "resume",
        "model": model,
        "version": np.int32(version),
        "prompt_tokens": np.asarray(prompt_tokens, np.int32),
        "step_keys": np.asarray(step_keys, np.uint32),
        "max_new_tokens": np.int32(max_new_tokens),
    })


def decode_resume_token(data: bytes, *, model: str,
                        version: Optional[int] = None) -> Dict[str, object]:
    """Parse and validate a resume token against the resuming replica's
    (model, version). Returns ``{"model", "version", "prompt_tokens",
    "step_keys", "max_new_tokens"}``. Raises ValueError on any mismatch
    or malformed payload."""
    try:
        doc = flax_msgpack.loads(data)
        fmt = int(doc["format"])
        kind = str(doc.get("kind"))
    except Exception as e:  # noqa: BLE001 — malformed blob = 400
        raise ValueError(f"malformed resume token: {e}") from None
    if fmt != RESUME_TOKEN_FORMAT or kind != "resume":
        raise ValueError(
            f"resume token format {fmt}/{kind!r} unsupported (this "
            f"replica speaks format {RESUME_TOKEN_FORMAT})")
    if doc["model"] != model:
        raise ValueError(
            f"resume token is for model {doc['model']!r}, "
            f"not {model!r}")
    if version is not None and int(doc["version"]) != int(version):
        raise ValueError(
            f"resume token came from version {int(doc['version'])} "
            f"but this replica serves version {version} — the "
            f"sampling schedule is version-bound")
    keys = np.asarray(doc["step_keys"], np.uint32)
    if keys.ndim != 2 or keys.shape[1] != 2 or not keys.size:
        raise ValueError(
            f"resume token step_keys shape {keys.shape} != [N, 2]")
    return {
        "model": str(doc["model"]),
        "version": int(doc["version"]),
        "prompt_tokens": np.asarray(doc["prompt_tokens"], np.int32),
        "step_keys": keys,
        "max_new_tokens": int(doc["max_new_tokens"]),
    }


# --- fleet KV block fetch (tiered KV memory) --------------------------------

#: Version tag of the ``:kv/fetch`` response payload. A fetch is always
#: an optimisation: an unknown format fails it and the asker prefills.
KV_BLOCKS_FORMAT = 1

Block = Tuple[Tuple[int, ...], List[object]]


def encode_kv_blocks(model: str, version: int, page_size: int,
                     blocks: Sequence[tuple]) -> bytes:
    """Serialize a chain of full KV blocks, ``[(block_tokens, layers)]``
    as ``DecodeEngine.export_prefix_blocks`` returns them: consecutive
    full blocks from the prompt root, each one ``[page_size, heads,
    dim]`` array or CPU tensor per KV leaf in ``kv_leaf_order``.
    ``model``/``version``/``page_size`` pin the export geometry."""
    return flax_msgpack.dumps({
        "format": np.int32(KV_BLOCKS_FORMAT),
        "kind": "kv_blocks",
        "model": model,
        "version": np.int32(version),
        "page_size": np.int32(page_size),
        "blocks": [
            {"tokens": np.asarray(tokens, np.int32), "layers": list(layers)}
            for tokens, layers in blocks
        ],
    })


def decode_kv_blocks(data: bytes, *, model: str,
                     version: Optional[int] = None,
                     page_size: Optional[int] = None) -> List[Block]:
    """Parse and validate a ``:kv/fetch`` payload against the importing
    replica's (model, version, page_size). Returns ``[(block_tokens,
    layers)]`` for ``DecodeEngine.import_prefix_blocks`` (which derives
    the chain hashes itself); a layer is a numpy array, or a CPU tensor
    where it is bfloat16. Raises ValueError on any mismatch or malformed
    payload; the fetching client falls back to local prefill."""
    try:
        doc = flax_msgpack.loads(data)
        fmt = int(doc["format"])
        kind = str(doc.get("kind"))
    except Exception as e:  # noqa: BLE001 — malformed blob = 400
        raise ValueError(f"malformed KV blocks payload: {e}") from None
    if fmt != KV_BLOCKS_FORMAT or kind != "kv_blocks":
        raise ValueError(
            f"KV blocks format {fmt}/{kind!r} unsupported (this "
            f"replica speaks format {KV_BLOCKS_FORMAT})")
    if doc["model"] != model:
        raise ValueError(
            f"KV blocks are for model {doc['model']!r}, not {model!r}")
    if version is not None and int(doc["version"]) != int(version):
        raise ValueError(
            f"KV blocks came from version {int(doc['version'])} but "
            f"this replica serves version {version} — cache bytes "
            f"are version-bound")
    if page_size is not None and int(doc["page_size"]) != int(page_size):
        raise ValueError(
            f"KV blocks use page_size {int(doc['page_size'])} but "
            f"this replica pages at {page_size}")
    psize = int(doc["page_size"])
    out = []
    for i, b in enumerate(doc.get("blocks") or []):
        try:
            tokens = np.asarray(b["tokens"], np.int32)
            layers = list(b["layers"])
        except Exception as e:  # noqa: BLE001 — malformed block = 400
            raise ValueError(f"malformed KV block {i}: {e}") from None
        if tokens.ndim != 1 or tokens.shape[0] != psize:
            raise ValueError(
                f"KV block {i} carries {tokens.shape} tokens, "
                f"expected [{psize}]")
        if not layers:
            raise ValueError(f"KV block {i} carries no KV layers")
        out.append((tuple(int(t) for t in tokens), layers))
    return out
