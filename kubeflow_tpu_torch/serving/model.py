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

"""LoadedModel: one model version resident on the GPU.

Port of ``kubeflow_tpu/serving/model.py``'s ``LoadedModel``:

- Requests are padded to a power-of-two *batch bucket* up to
  ``max_batch`` (the reference compiles one program per bucket; the
  port keeps the same shapes so both serve identical batches), and
  oversized requests are split.
- ``predict`` returns fp32 logits; ``classify`` is predict + fp32
  softmax + top-k; ``generate`` left-pads prompts to a length bucket
  and decodes, greedy or sampled, with one threefry key per row
  (inference/generate.py), so a request's tokens do not depend on
  where a batch placed it.
- ``ensure_engine`` builds the continuous-batching decode engine
  (inference/engine/) from the export's ``generate_config``, the path
  ``:generate`` is served through, with the speculative draft that
  ``engine_draft_export`` names (``_load_draft``; a draft that fails to
  load or does not fit the verifier degrades to vanilla decoding with a
  warning, as the reference does: the output is the same either way).

The model is built from a registry name and the params of
``models/convert.py``; :func:`load_version` reads an export directory
(``serving/export.py``). Every family of the registry serves ``predict``
and ``classify`` as the reference's ``module.apply(variables, x,
train=False)``: a vision model on its params and ``batch_stats`` (BN at
its running statistics), BERT on ``input_ids`` alone (``type_ids`` and
``valid`` None), a Llama on ``input_ids``; the Llama family also serves
``generate``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.generate import generate, prompt_bucket
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.layers import apply as apply_vision
from kubeflow_tpu_torch.models.llama import apply
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving.export import (
    read_metadata,
    read_variables,
    unbox,
)
from kubeflow_tpu_torch.serving.signature import ModelMetadata, Signature
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

_NP_DTYPES = {
    "float32": np.float32,
    # numpy has no bfloat16: a bf16 input is taken as fp32 on the host
    # (exact for bf16 values) and rounded to bf16 on the device.
    "bfloat16": np.float32,
    "int32": np.int32,
    "int64": np.int64,
    "uint8": np.uint8,
    "bool": np.bool_,
}


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two ≥ n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


@dataclasses.dataclass
class LoadedModel:
    metadata: ModelMetadata
    version: int
    params: Dict[str, torch.Tensor]
    max_batch: int = 64
    top_k: int = 5
    #: ``None`` → cuda (raises without a GPU); ``"cpu"`` on request.
    device: DeviceLike = None
    #: A BN model's running statistics (the ``batch_stats`` collection).
    batch_stats: Optional[Dict[str, torch.Tensor]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        entry = get_model(self.metadata.registry_name)
        self._family = entry.family
        self._module = entry.make(**self.metadata.model_kwargs)
        self.params = {k: v.to(self.device) for k, v in self.params.items()}
        self.batch_stats = {k: v.to(self.device) for k, v in
                            (self.batch_stats or {}).items()}
        self._gen_counter = 0  # per-request rng fold for sampling
        self._gen_lock = threading.Lock()
        # Continuous-batching decode engine (inference/engine/): built
        # on demand by ensure_engine(); None otherwise.
        self._engine = None
        self._engine_lock = threading.Lock()
        # Execution time of one full max_batch bucket, measured by
        # warmup(); None until warmup runs.
        self.warmup_batch_seconds: Optional[float] = None

    def signature(self, name: Optional[str] = None) -> Signature:
        name = name or ModelMetadata.DEFAULT_SIGNATURE
        try:
            return self.metadata.signatures[name]
        except KeyError:
            raise KeyError(
                f"model {self.metadata.model_name!r} has no signature "
                f"{name!r}; available: {sorted(self.metadata.signatures)}"
            ) from None

    def _prepare(self, signature: Signature, inputs: Dict[str, np.ndarray],
                 variable_length: bool = False) -> Tuple[np.ndarray, int]:
        (name, spec), = signature.inputs.items()  # single-input models
        if name not in inputs:
            raise ValueError(
                f"missing input {name!r}; got {sorted(inputs)}")
        if spec.dtype not in _NP_DTYPES:
            raise ValueError(f"input dtype {spec.dtype!r} is not served by "
                             "the port yet")
        x = np.asarray(inputs[name], dtype=_NP_DTYPES[spec.dtype])
        expected = tuple(spec.shape[1:])
        if x.shape[1:] != expected:
            # Generate signatures treat the exported prompt length as
            # a MAXIMUM: shorter prompts are admitted and padded to a
            # length bucket (mixed-length micro-batching).
            short_ok = (variable_length and len(expected) == 1
                        and x.ndim == 2 and 1 <= x.shape[1] <= expected[0])
            if not short_ok:
                raise ValueError(
                    f"input {name!r} shape {x.shape[1:]} != signature "
                    f"{expected}" + (" (generate prompts may be shorter "
                                     "than the signature max, never "
                                     "longer)" if variable_length else ""))
        return x, x.shape[0]

    def _length_bucket(self, n: int, max_len: int) -> int:
        """Prompt-length bucket (``generate.prompt_bucket``)."""
        return prompt_bucket(
            n, max_len,
            self.metadata.generate_config.get("prompt_buckets"))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """``module.apply(variables, x, train=False)``."""
        if self._family == "vision":
            return apply_vision(self._module, self.params, self.batch_stats,
                                x, train=False)
        return apply(self._module, self.params, x)

    def _forward(self, method: str, x: np.ndarray) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            sig_dtype = next(iter(self.signature().inputs.values())).dtype
            inputs = torch.from_numpy(x).to(self.device)
            if sig_dtype == "bfloat16":
                inputs = inputs.to(torch.bfloat16)
            logits = self._logits(inputs)
            if method == "predict":
                return {"logits": logits}
            probs = torch.softmax(logits.float(), dim=-1)
            scores, classes = torch.topk(probs, self.top_k, dim=-1)
            return {"classes": classes.to(torch.int32), "scores": scores}

    def request_rngs(self, n: int) -> np.ndarray:
        """Per-row sampling keys ``[n, 2]`` for one request's rows:
        row i gets ``fold_in(base, i)``, where base folds a process-
        wide request counter (fresh completions per request) unless the
        export pins ``deterministic: true`` (replayable serving). Keys
        are per ROW so a request's outputs don't depend on where the
        batcher placed it inside a coalesced batch."""
        cfg = self.metadata.generate_config
        base = prng.PRNGKey(int(cfg.get("seed", 0)))
        if not cfg.get("deterministic", False):
            with self._gen_lock:
                self._gen_counter += 1
                counter = self._gen_counter
            base = prng.fold_in(base, counter)
        return prng.fold_in(base, np.arange(n))

    def _load_draft(self) -> Tuple[Any, Any]:
        """Load the speculative-decoding draft model named by the
        export's ``engine_draft_export`` (a version dir written by either
        package, typically a much smaller model sharing the verifier's
        vocab) onto this model's device. Returns ``(module, params)`` or
        ``(None, None)``: any load failure degrades to vanilla decoding
        with a warning rather than failing the serve path, because
        speculation changes how many verifier forwards a token costs,
        never which token it is."""
        cfg = self.metadata.generate_config
        path = cfg.get("engine_draft_export")
        if not path or not int(cfg.get("engine_draft_tokens", 0) or 0):
            return None, None
        try:
            draft = load_version(path, device=self.device)
            return draft._module, draft.params
        except Exception as e:  # noqa: BLE001 — degrade, never fail
            logger.warning(
                "model %s: draft model load from %r failed (%s); "
                "serving with vanilla decoding",
                self.metadata.model_name, path, e)
            return None, None

    def ensure_engine(self, name: Optional[str] = None,
                      queue_capacity: Optional[int] = None):
        """The version's continuous-batching decode engine, built once
        per LoadedModel. Generate-method signatures only. Capacity
        knobs ride the export's ``generate_config`` (``engine_slots`` /
        ``engine_page_size`` / ``engine_slice_tokens`` /
        ``engine_num_pages``, plus ``engine_prefix_cache`` for the
        prefix lane, ``engine_prefill_chunk`` for sliced long-prompt
        admission, and ``engine_draft_tokens`` / ``engine_draft_export``
        for speculative decoding). The host KV tier is not ported and
        raises."""
        with self._engine_lock:
            if self._engine is not None:
                return self._engine
            sig = self.signature()
            if sig.method != "generate":
                raise ValueError(
                    f"model {self.metadata.model_name!r} has a "
                    f"{sig.method!r} signature; the decode engine "
                    f"serves generate-method exports only")
            from kubeflow_tpu_torch.inference.engine import (
                DecodeEngine,
                EngineConfig,
            )

            (_, spec), = sig.inputs.items()
            config = EngineConfig.from_generate_config(
                self.metadata.generate_config, spec.shape[1],
                queue_capacity=queue_capacity)
            draft_model, draft_params = self._load_draft()
            try:
                self._engine = DecodeEngine(
                    self._module, self.params, config,
                    name=name or self.metadata.model_name,
                    device=self.device, draft_model=draft_model,
                    draft_params=draft_params)
            except ValueError:
                if draft_model is None:
                    raise
                # Incompatible draft (vocab / cache mismatch): the
                # engine rejected it. Degrade to vanilla, as for a
                # failed load.
                logger.warning(
                    "model %s: draft model incompatible with "
                    "verifier; serving with vanilla decoding",
                    self.metadata.model_name, exc_info=True)
                self._engine = DecodeEngine(
                    self._module, self.params, config,
                    name=name or self.metadata.model_name,
                    device=self.device)
            return self._engine

    def shard_topology(self) -> Dict[str, Any]:
        """Healthz-facing layout summary, the reference's shape: the
        port loads monolithic exports only (``load_version`` refuses
        sharded ones), so one shard and no mesh."""
        return {"num_shards": 1, "on_mesh": False}

    @property
    def engine(self):
        """The built engine or None (never builds)."""
        return self._engine

    def close(self) -> None:
        """Release background resources (the decode engine's thread
        and page pool). Idempotent."""
        with self._engine_lock:
            engine, self._engine = self._engine, None
        if engine is not None:
            engine.stop()

    def run(self, inputs: Dict[str, np.ndarray],
            signature_name: Optional[str] = None,
            method: Optional[str] = None, *,
            prompt_lengths: Optional[np.ndarray] = None,
            row_rngs: Optional[np.ndarray] = None
            ) -> Dict[str, np.ndarray]:
        """Execute one (possibly already micro-batched) request batch.

        Generate-method extras (the batcher's coalescing contract):
        ``prompt_lengths`` [n] true token counts of LEFT-padded rows
        (None = every row is full-width), ``row_rngs`` [n, 2] per-row
        sampling keys (None = mint fresh ones via request_rngs)."""
        sig = self.signature(signature_name)
        method = method or sig.method
        if (method == "generate") != (sig.method == "generate"):
            raise ValueError(
                f"method {method!r} incompatible with signature method "
                f"{sig.method!r}")
        x, n = self._prepare(sig, inputs, variable_length=(
            method == "generate"))
        if n == 0:
            raise ValueError("empty batch")
        if method == "generate":
            if prompt_lengths is None:
                prompt_lengths = np.full((n,), x.shape[1], np.int32)
            else:
                prompt_lengths = np.asarray(prompt_lengths, np.int32)
                if prompt_lengths.shape != (n,):
                    raise ValueError(
                        f"prompt_lengths shape {prompt_lengths.shape} "
                        f"!= ({n},)")
            row_rngs = (self.request_rngs(n) if row_rngs is None
                        else np.asarray(row_rngs, np.uint32))
        if n > self.max_batch:
            # Split oversized requests; concatenate results.
            outs: List[Dict[str, np.ndarray]] = []
            for i in range(0, n, self.max_batch):
                sl = slice(i, i + self.max_batch)
                outs.append(self.run(
                    {next(iter(sig.inputs)): x[sl]}, signature_name,
                    method,
                    prompt_lengths=(None if prompt_lengths is None
                                    else prompt_lengths[sl]),
                    row_rngs=None if row_rngs is None else row_rngs[sl]))
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        bucket = _bucket(n, self.max_batch)
        if method == "generate":
            return self._run_generate(sig, x, n, bucket, prompt_lengths,
                                      row_rngs)
        if n < bucket:
            pad = np.zeros((bucket - n, *x.shape[1:]), dtype=x.dtype)
            x = np.concatenate([x, pad])
        out = self._forward(method, x)
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def _run_generate(self, sig: Signature, x: np.ndarray, n: int,
                      bucket: int, prompt_lengths: np.ndarray,
                      row_rngs: np.ndarray) -> Dict[str, np.ndarray]:
        """One coalesced decode: pad the prompt axis (LEFT) to a length
        bucket and the batch axis to its power-of-two bucket, generate
        once, trim both paddings."""
        (_, spec), = sig.inputs.items()
        target_len = self._length_bucket(x.shape[1], spec.shape[1])
        if x.shape[1] < target_len:
            x = np.pad(x, ((0, 0), (target_len - x.shape[1], 0)))
        if n < bucket:
            # Pad rows are full-length zero prompts with throwaway
            # keys; their tokens are trimmed below.
            x = np.concatenate(
                [x, np.zeros((bucket - n, x.shape[1]), x.dtype)])
            prompt_lengths = np.concatenate(
                [prompt_lengths,
                 np.full((bucket - n,), x.shape[1], np.int32)])
            row_rngs = np.concatenate(
                [row_rngs,
                 np.zeros((bucket - n, *row_rngs.shape[1:]),
                          row_rngs.dtype)])
        cfg = self.metadata.generate_config
        chunk = cfg.get("decode_chunk_tokens")
        tokens, _ = generate(
            self._module, self.params, torch.from_numpy(x).to(self.device),
            max_new_tokens=int(cfg.get("max_new_tokens", 32)),
            temperature=float(cfg.get("temperature", 0.0)),
            rng=row_rngs,
            eos_id=cfg.get("eos_id"),
            top_k=cfg.get("top_k"),
            top_p=cfg.get("top_p"),
            chunk_tokens=int(chunk) if chunk else None,
            prompt_lengths=torch.from_numpy(prompt_lengths).to(self.device))
        return {"tokens": tokens[:n].cpu().numpy()}

    def warmup(self) -> None:
        """Run every (method, bucket) pair once before traffic arrives,
        then time one more run of the full max_batch bucket into
        ``warmup_batch_seconds`` (the admission controller's
        batch-latency prior). For predict/classify models both methods
        are warmed; generate models warm every exported prompt bucket."""
        sig = self.signature()
        (name, spec), = sig.inputs.items()
        methods = (("generate",) if sig.method == "generate"
                   else ("predict", "classify"))
        lengths = [spec.shape[1]]
        if sig.method == "generate":
            lengths = sorted({
                min(int(v), spec.shape[1])
                for v in self.metadata.generate_config.get(
                    "prompt_buckets", ())} | {spec.shape[1]})
        bucket = 1
        while True:
            for length in lengths:
                x = np.zeros((bucket, length) if sig.method == "generate"
                             else (bucket, *spec.shape[1:]),
                             dtype=_NP_DTYPES[spec.dtype])
                for method in methods:
                    self.run({name: x}, method=method)
            if bucket >= self.max_batch:
                break
            bucket = min(bucket * 2, self.max_batch)
        x = np.zeros((bucket, lengths[-1]) if sig.method == "generate"
                     else (bucket, *spec.shape[1:]),
                     dtype=_NP_DTYPES[spec.dtype])
        t0 = time.monotonic()
        self.run({name: x}, method=methods[0])  # ends in a host copy
        self.warmup_batch_seconds = time.monotonic() - t0


def load_version(version_dir: str, *, max_batch: int = 64, top_k: int = 5,
                 warmup: bool = False,
                 device: DeviceLike = None) -> LoadedModel:
    """Load one version dir written by either package: its signature,
    then its Flax params, carried across to the port's layout and
    dtypes (``models/convert.py``) on ``device`` (``None`` → cuda).
    A vision export's ``batch_stats`` collection is carried across
    beside its params; any other collection raises. Exports with a shard
    manifest (``metadata.sharding``) raise until parallelism is ported
    (ROADMAP A14)."""
    metadata = read_metadata(version_dir)
    if metadata.sharding and int(metadata.sharding.get("num_shards",
                                                       1)) > 1:
        raise NotImplementedError(
            "sharded exports are not ported yet (ROADMAP A14)")
    variables = read_variables(version_dir)
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if extra:
        raise NotImplementedError(
            f"export {version_dir} carries collections {extra}; the "
            f"port serves params and batch_stats")
    template = get_model(metadata.registry_name).make(
        **metadata.model_kwargs)
    params = convert.params_from_flax(
        convert.flatten_tree(unbox(variables["params"])), template,
        device=device)
    batch_stats = None
    if "batch_stats" in variables or dict(template.named_buffers()):
        batch_stats = convert.batch_stats_from_flax(
            convert.flatten_tree(unbox(variables.get("batch_stats", {}))),
            template, device=device)
    del variables
    version = int(os.path.basename(os.path.normpath(version_dir)))
    loaded = LoadedModel(metadata=metadata, version=version, params=params,
                         max_batch=max_batch, top_k=top_k, device=device,
                         batch_stats=batch_stats)
    if warmup:
        loaded.warmup()
    return loaded
