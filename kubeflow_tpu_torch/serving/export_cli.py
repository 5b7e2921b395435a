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

"""kft-export: a training checkpoint → a serving version dir.

The port of ``kubeflow_tpu/serving/export_cli.py``. It takes a
checkpoint written by the port or by the reference's sharded tier
(``training/checkpoint.py`` ``restore_raw``), optionally folds LoRA
adapters into the base weights (``ops/lora.py`` ``merge_lora``), and
writes a version dir the model server hot-loads::

    python -m kubeflow_tpu_torch.serving.export_cli \\
        --model llama3-8b --checkpoint ckpts/myft --lora --version 2 \\
        --out models/myllama \\
        --generate '{"max_new_tokens": 256, "temperature": 0.8}'

Without ``--checkpoint`` it exports freshly drawn weights (the port's
initializers, seeded with ``--seed``), the smoke-test path.

The export is the reference's byte format (``serving/export.py``): the
variables tree in Flax's layout and dtypes (fp32 masters for a fresh
init, the checkpoint's own leaves otherwise), with Flax's partitioning
boxes (``{"value": array}``) on the leaves the reference's modules
annotate, so each package loads the other's exports. A vision model's
``batch_stats`` travel with its params. ``--shards`` above one writes
the sharded layout (``serving/sharding.py``: one file per serving-mesh
position, split by the rule table over the model's logical axes), as
the reference's ``--shards`` does; a ``tensor=T`` export of a dense
Llama loads onto a T-rank gang (``load_version``), each rank reading
its own file.
The device the fresh weights are drawn on is ``--device``, else the
env's (``utils/platform.py``); the writing is host work.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.ops.lora import is_lora_name, merge_lora
from kubeflow_tpu_torch.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)

# generate_config comes from user JSON and sets the server's decode
# knobs: coerce and reject unknown keys here, so a bad config fails
# before a version dir is produced (the reference's table).
_GENERATE_CONFIG_COERCERS = {
    "max_new_tokens": int,
    "temperature": float,
    "top_k": int,
    "top_p": float,
    "eos_id": int,
    "seed": int,
    "deterministic": bool,
    "decode_chunk_tokens": int,
    # The continuous-batching engine's capacity knobs ride the export,
    # so a version dir fully describes how it serves.
    "engine_slots": int,
    "engine_page_size": int,
    "engine_slice_tokens": int,
    "engine_num_pages": int,
    "engine_prefix_cache": bool,
    "engine_draft_tokens": int,
    "engine_prefill_chunk": int,
    "engine_draft_export": str,
    "engine_host_cache_bytes": int,
    "kv_fetch_deadline_ms": int,
}


def validate_generate_config(config: Dict[str, Any]) -> Dict[str, Any]:
    unknown = sorted(set(config) - set(_GENERATE_CONFIG_COERCERS)
                     - {"prompt_buckets"})
    if unknown:
        raise ValueError(
            f"unknown generate config keys {unknown}; supported: "
            f"{sorted(_GENERATE_CONFIG_COERCERS) + ['prompt_buckets']}")
    out: Dict[str, Any] = {}
    config = dict(config)
    if "prompt_buckets" in config:
        # Prompt-length buckets (a list, outside the coercer table):
        # positive ints, deduped ascending.
        buckets = config.pop("prompt_buckets")
        if (not isinstance(buckets, (list, tuple)) or not buckets
                or any(isinstance(v, bool) or not isinstance(v, int)
                       or v < 1 for v in buckets)):
            raise ValueError(
                f"generate config 'prompt_buckets' must be a non-empty "
                f"list of positive integers; got {buckets!r}")
        out["prompt_buckets"] = sorted(set(int(v) for v in buckets))
    for key, value in config.items():
        coerce = _GENERATE_CONFIG_COERCERS[key]
        if coerce is bool:
            # bool("false") is True: require a real JSON boolean.
            if not isinstance(value, bool):
                raise ValueError(
                    f"generate config {key!r} must be a boolean; "
                    f"got {value!r}")
            out[key] = value
            continue
        if isinstance(value, bool):
            # bool subclasses int: {"top_k": true} would become top_k=1.
            raise ValueError(
                f"generate config {key!r} must be "
                f"{coerce.__name__}-like; got {value!r}")
        try:
            coerced = coerce(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"generate config {key!r} must be "
                f"{coerce.__name__}-like; got {value!r}") from None
        if coerce is int and isinstance(value, float) and value != coerced:
            raise ValueError(
                f"generate config {key!r} must be an integer; "
                f"got {value!r}")
        out[key] = coerced
    if "top_p" in out and not 0.0 < out["top_p"] <= 1.0:
        raise ValueError(f"top_p must be in (0, 1]; got {out['top_p']}")
    if "top_k" in out and out["top_k"] < 1:
        raise ValueError(f"top_k must be >= 1; got {out['top_k']}")
    if "max_new_tokens" in out and out["max_new_tokens"] < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1; got {out['max_new_tokens']}")
    if "decode_chunk_tokens" in out and out["decode_chunk_tokens"] < 1:
        raise ValueError(
            f"decode_chunk_tokens must be >= 1; got "
            f"{out['decode_chunk_tokens']}")
    for key in ("engine_slots", "engine_page_size",
                "engine_slice_tokens", "engine_num_pages"):
        if key in out and out[key] < 1:
            raise ValueError(f"{key} must be >= 1; got {out[key]}")
    for key in ("engine_draft_tokens", "engine_prefill_chunk",
                "engine_host_cache_bytes", "kv_fetch_deadline_ms"):
        # 0 is the documented "off" value.
        if key in out and out[key] < 0:
            raise ValueError(f"{key} must be >= 0; got {out[key]}")
    if "engine_draft_export" in out and not out["engine_draft_export"]:
        raise ValueError("engine_draft_export must be a non-empty path")
    if "temperature" in out and out["temperature"] < 0.0:
        raise ValueError(
            f"temperature must be >= 0; got {out['temperature']}")
    return out


def _build_metadata(model_name: str, registry_name: str, entry,
                    seq_len: int, signature_kind: str,
                    generate_config: Dict[str, Any],
                    model_kwargs: Dict[str, Any]) -> ModelMetadata:
    if signature_kind == "generate":
        max_new = int(generate_config.get("max_new_tokens", 32))
        sig = Signature(
            "generate",
            {"input_ids": TensorSpec("int32", (-1, seq_len))},
            {"tokens": TensorSpec("int32", (-1, max_new))})
        model_kwargs = dict(model_kwargs)
        model_kwargs.setdefault("cache_size", seq_len + max_new)
    elif entry.family == "language":
        sig = Signature(
            "predict",
            {"input_ids": TensorSpec("int32", (-1, seq_len))},
            {"logits": TensorSpec(
                "float32", (-1, seq_len, entry.num_classes_or_vocab))})
    else:
        shape, _ = entry.input_spec
        sig = Signature(
            signature_kind if signature_kind != "auto" else "predict",
            {"images": TensorSpec("float32", (-1, *shape))},
            {"logits": TensorSpec(
                "float32", (-1, entry.num_classes_or_vocab))})
    return ModelMetadata(
        model_name=model_name,
        registry_name=registry_name,
        signatures={ModelMetadata.DEFAULT_SIGNATURE: sig},
        model_kwargs=model_kwargs,
        generate_config=generate_config,
    )


def flax_shapes(module) -> Dict[str, tuple]:
    """The Flax params ``module`` takes: flat key → shape in Flax's
    layout (a Dense kernel ``[in, out]``, a conv HWIO); LoRA adapters
    are not params."""
    out = {}
    for name, t in module.named_parameters():
        if is_lora_name(name):
            continue
        key = convert._flax_key(name)
        shape = tuple(t.shape)
        if key.endswith("/kernel"):
            shape = (shape[::-1] if len(shape) == 2
                     else (shape[2], shape[3], shape[1], shape[0]))
        out[key] = shape
    return out


def _checked_params(flat: Dict[str, Any], module, what: str) -> None:
    want = flax_shapes(module)
    if set(flat) != set(want):
        raise ValueError(
            f"{what} does not fit the model: missing "
            f"{sorted(set(want) - set(flat))[:5]}, unknown "
            f"{sorted(set(flat) - set(want))[:5]}")
    for key, shape in want.items():
        if tuple(flat[key].shape) != shape:
            raise ValueError(f"{what} {key}: shape "
                             f"{tuple(flat[key].shape)} != {shape}")


def _flax_leaves(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port params as Flax's flat leaves on the host, each in its own
    dtype (a bf16 leaf as a CPU tensor: numpy has no bf16)."""
    out = {}
    for name, t in params.items():
        key = convert._flax_key(name)
        out[key] = convert._leaf_to_flax(key, t)
    return out


def _rebox(module, flat: Dict[str, Any]) -> Dict[str, Any]:
    """A flat params dict as the nested tree the reference exports:
    each leaf the module says its reference annotates
    (``module.partitioned(key)``) boxed as ``{"value": leaf}``."""
    if not hasattr(module, "partitioned"):
        raise TypeError(f"{type(module).__name__} does not say which of its "
                        "params the reference boxes (no partitioned())")
    return convert.unflatten_tree({
        key: {"value": leaf} if module.partitioned(key) else leaf
        for key, leaf in flat.items()})


def export_tree(module, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``module``'s port params as the ``params`` tree the reference
    exports: Flax's layout, each leaf in its own dtype, boxed where the
    reference's module annotates it."""
    return _rebox(module, _flax_leaves(params))


def _merged(module, params: Dict[str, Any], adapters: Dict[str, Any],
            device) -> Dict[str, Any]:
    """``params`` (flat, Flax layout) with the adapters folded in by the
    port's ``merge_lora``, on ``device``. Each leaf keeps its dtype (a
    merged weight is W + A·B·α/r in fp32, rounded to W's type once, as
    the reference merges); a leaf no adapter touches is passed through
    as it was read."""
    names = {convert._flax_key(n): n for n, _ in module.named_parameters()
             if not is_lora_name(n)}
    base = {}
    for key, leaf in params.items():
        t = (leaf.clone() if isinstance(leaf, torch.Tensor)
             else torch.from_numpy(np.array(leaf)))
        if key.endswith("/kernel"):
            t = convert._as_torch_kernel(t)
        base[names[key]] = t.to(device)
    lora = convert.lora_from_flax(adapters, module, device=device)
    merged = merge_lora(base, lora, alpha=float(module.lora_alpha))
    adapted = [name[:-len(".lora_a")] + ".weight" for name in lora
               if name.endswith(".lora_a")]
    return {**params, **_flax_leaves({w: merged[w] for w in adapted})}


def _restore(checkpoint: str) -> Dict[str, Any]:
    from kubeflow_tpu_torch.training.checkpoint import (
        CheckpointConfig,
        Checkpointer,
    )

    if not Path(checkpoint).is_dir():
        raise FileNotFoundError(f"no checkpoint found under {checkpoint!r}")
    ckpt = Checkpointer(CheckpointConfig(directory=checkpoint,
                                         async_save=False))
    try:
        restored = ckpt.restore_raw()
    finally:
        ckpt.close()
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found under {checkpoint!r}")
    restored.pop("opt_state", None)  # never exported; free early
    return restored


def export_from_checkpoint(
    *,
    registry_name: str,
    out: str,
    version: int,
    model_name: Optional[str] = None,
    checkpoint: Optional[str] = None,
    lora: bool = False,
    lora_rank: int = 16,
    lora_alpha: Optional[float] = None,
    seq_len: int = 128,
    signature_kind: str = "auto",
    generate_config: Optional[Dict[str, Any]] = None,
    model_kwargs: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    shard_spec: Optional[Any] = None,
    device=None,
) -> str:
    """Export one serving version; returns the version dir path.

    With ``lora=True`` the checkpoint is an adapter checkpoint (the
    ``{"step", "lora", "opt_state"}`` or ``fit``-saved ``LoRAState``
    layout, ``base_params`` beside the adapters) and the adapters are
    merged into the base (restored, or drawn from ``seed``): the
    serving form with no adapter cost. ``device``: where fresh weights
    are drawn and the merge runs (``None`` → cuda; ``"cpu"`` on
    request)."""
    entry = get_model(registry_name)
    model_kwargs = dict(model_kwargs or {})
    generate_config = validate_generate_config(dict(generate_config or {}))
    if signature_kind == "auto":
        signature_kind = ("generate" if generate_config
                          and entry.family == "language" else "predict")
    # Incoherent signature/model combinations fail at export time, not
    # as a version dir that can never serve.
    if signature_kind == "generate" and entry.family != "language":
        raise ValueError(
            f"generate signatures need a language model; "
            f"{registry_name!r} is {entry.family}")
    if signature_kind == "classify" and entry.family == "language":
        raise ValueError("classify signatures need a vision model")
    if generate_config and signature_kind != "generate":
        raise ValueError(
            "--generate config given but the signature is "
            f"{signature_kind!r}")

    build_kwargs = dict(model_kwargs)
    if lora:
        build_kwargs["lora_rank"] = lora_rank
        if lora_alpha is not None:
            # Must equal the training lora_alpha: a mismatched merge
            # mis-scales every adapter delta.
            build_kwargs["lora_alpha"] = lora_alpha
    if entry.decoder:
        # Flax keeps params in fp32 whatever the compute dtype; so do
        # fresh weights and merges here.
        build_kwargs.setdefault("param_dtype", "float32")
    module = entry.make(**build_kwargs)
    collections = ["params"] + (["batch_stats"]
                                if dict(module.named_buffers()) else [])

    restored = _restore(checkpoint) if checkpoint else None
    need_init_values = (restored is None
                        or (lora and "base_params" not in restored))
    params: Optional[Dict[str, Any]] = None  # flat, Flax layout
    init_stats: Optional[Dict[str, Any]] = None
    if need_init_values:
        if entry.family == "vision":
            drawn, stats = convert.init_vision(module, seed=seed,
                                               device=device)
            init_stats = {k.replace(".", "/"): v.cpu().numpy()
                          for k, v in stats.items()}
        else:
            drawn = convert.init_params(module, seed=seed, device=device)
        params = _flax_leaves(drawn)

    if restored is not None and lora:
        if "lora" not in restored:
            raise ValueError(
                f"--lora expects an adapter checkpoint with a "
                f"'lora' subtree; found {sorted(restored)}")
        if "base_params" in restored:
            # A fit()-saved LoRAState: base and adapters in one
            # checkpoint, no init-seed coordination needed.
            params = convert.flatten_tree(restored["base_params"])
            _checked_params(params, module, "the checkpoint's base_params")
        # else: an adapters-only checkpoint; the base is this process's
        # draw (the same --seed as training), the caller's to match.
        params = _merged(module, params, convert.flatten_tree(
            restored["lora"]), device)
    elif restored is not None:
        if "params" not in restored:
            raise ValueError(
                f"checkpoint has no 'params' subtree; found "
                f"{sorted(restored)}")
        params = convert.flatten_tree(restored["params"])
        _checked_params(params, module, "the checkpoint's params")

    # Every collection the model owns: params (the LoRA adapters merged
    # away) and a vision model's batch_stats, the checkpoint's where it
    # carries them (a fit()-saved vision state's trained statistics),
    # else a fresh init's.
    export_vars: Dict[str, Any] = {"params": _rebox(module, params)}
    for collection in collections[1:]:
        if restored is not None and collection in restored:
            export_vars[collection] = restored[collection]
        elif need_init_values:
            export_vars[collection] = convert.unflatten_tree(init_stats)
        else:
            raise ValueError(
                f"model has collection {collection!r} but the "
                f"checkpoint carries neither it nor 'base_params'; "
                f"export from a full-variables checkpoint instead")

    metadata = _build_metadata(
        model_name or registry_name, registry_name, entry, seq_len,
        signature_kind, generate_config, model_kwargs)
    if shard_spec is not None and shard_spec.num_shards > 1:
        from kubeflow_tpu_torch.serving.sharding import export_model_sharded

        return str(export_model_sharded(out, version, metadata, export_vars,
                                        shard_spec, module))
    from kubeflow_tpu_torch.serving.export import export_model

    return str(export_model(out, version, metadata, export_vars))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kft-export")
    parser.add_argument("--model", required=True,
                        help="registry name (kft prototype for names)")
    parser.add_argument("--out", required=True,
                        help="serving base path (versioned dirs)")
    parser.add_argument("--version", type=int, default=1)
    parser.add_argument("--name", default=None, help="served model name")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint dir to restore (the port's, or "
                             "the reference's sharded tier; not Orbax)")
    parser.add_argument("--lora", action="store_true",
                        help="checkpoint is an adapter checkpoint; "
                             "merge into the base for serving")
    parser.add_argument("--lora_rank", type=int, default=16)
    parser.add_argument("--lora_alpha", type=float, default=None,
                        help="MUST match the training lora_alpha "
                             "(default: the model's default)")
    parser.add_argument("--seed", type=int, default=0,
                        help="base init seed; must match training for "
                             "adapters-only LoRA checkpoints")
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--signature", default="auto",
                        choices=("auto", "predict", "classify",
                                 "generate"))
    parser.add_argument("--generate", default=None,
                        help='JSON generate config, e.g. '
                             '\'{"max_new_tokens": 64, '
                             '"temperature": 0.8}\'')
    parser.add_argument("--model_kwargs", default=None,
                        help="JSON kwargs for the model constructor")
    parser.add_argument("--shards", default=None,
                        help="sharded export: 'tensor=T,fsdp=F' or a bare "
                             "tensor count (one file per serving-mesh "
                             "position). Omitted/1 = the monolithic layout")
    parser.add_argument("--device", default=None,
                        help="where fresh weights are drawn: cuda or cpu "
                             "(default: cpu where the env has "
                             "JAX_PLATFORMS=cpu, else cuda)")
    args = parser.parse_args(argv)
    from kubeflow_tpu_torch.utils.platform import default_device

    shard_spec = None
    if args.shards:
        from kubeflow_tpu_torch.serving.sharding import parse_shard_spec

        shard_spec = parse_shard_spec(args.shards)
    path = export_from_checkpoint(
        registry_name=args.model,
        out=args.out,
        version=args.version,
        model_name=args.name,
        checkpoint=args.checkpoint,
        lora=args.lora,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        seed=args.seed,
        seq_len=args.seq_len,
        signature_kind=args.signature,
        generate_config=json.loads(args.generate) if args.generate else None,
        model_kwargs=(json.loads(args.model_kwargs)
                      if args.model_kwargs else None),
        shard_spec=shard_spec,
        device=default_device(args.device),
    )
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
