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
  and decodes greedily (inference/generate.py).

The model is built from a registry name and the params of
``models/convert.py``. Reading an export directory (Flax msgpack
params) and the continuous-batching engine are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.inference.generate import generate, prompt_bucket
from kubeflow_tpu_torch.models.llama import apply
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving.signature import ModelMetadata, Signature
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

_NP_DTYPES = {
    "float32": np.float32,
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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        entry = get_model(self.metadata.registry_name)
        self._module = entry.make(**self.metadata.model_kwargs)
        self.params = {k: v.to(self.device) for k, v in self.params.items()}
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

    def _forward(self, method: str, x: np.ndarray) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            ids = torch.from_numpy(x).to(self.device)
            logits = apply(self._module, self.params, ids)
            if method == "predict":
                return {"logits": logits}
            probs = torch.softmax(logits.float(), dim=-1)
            scores, classes = torch.topk(probs, self.top_k, dim=-1)
            return {"classes": classes.to(torch.int32), "scores": scores}

    def run(self, inputs: Dict[str, np.ndarray],
            signature_name: Optional[str] = None,
            method: Optional[str] = None, *,
            prompt_lengths: Optional[np.ndarray] = None
            ) -> Dict[str, np.ndarray]:
        """Execute one (possibly already micro-batched) request batch.

        Generate-method extra: ``prompt_lengths`` [n] true token counts
        of LEFT-padded rows (None = every row is full-width)."""
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
        if n > self.max_batch:
            # Split oversized requests; concatenate results.
            outs: List[Dict[str, np.ndarray]] = []
            for i in range(0, n, self.max_batch):
                sl = slice(i, i + self.max_batch)
                outs.append(self.run(
                    {next(iter(sig.inputs)): x[sl]}, signature_name,
                    method,
                    prompt_lengths=(None if prompt_lengths is None
                                    else prompt_lengths[sl])))
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        bucket = _bucket(n, self.max_batch)
        if method == "generate":
            return self._run_generate(sig, x, n, bucket, prompt_lengths)
        if n < bucket:
            pad = np.zeros((bucket - n, *x.shape[1:]), dtype=x.dtype)
            x = np.concatenate([x, pad])
        out = self._forward(method, x)
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def _run_generate(self, sig: Signature, x: np.ndarray, n: int,
                      bucket: int, prompt_lengths: np.ndarray
                      ) -> Dict[str, np.ndarray]:
        """One coalesced decode: pad the prompt axis (LEFT) to a length
        bucket and the batch axis to its power-of-two bucket, generate
        once, trim both paddings."""
        (_, spec), = sig.inputs.items()
        target_len = self._length_bucket(x.shape[1], spec.shape[1])
        if x.shape[1] < target_len:
            x = np.pad(x, ((0, 0), (target_len - x.shape[1], 0)))
        if n < bucket:
            # Pad rows are full-length zero prompts; their tokens are
            # trimmed below.
            x = np.concatenate(
                [x, np.zeros((bucket - n, x.shape[1]), x.dtype)])
            prompt_lengths = np.concatenate(
                [prompt_lengths,
                 np.full((bucket - n,), x.shape[1], np.int32)])
        cfg = self.metadata.generate_config
        chunk = cfg.get("decode_chunk_tokens")
        tokens, _ = generate(
            self._module, self.params, torch.from_numpy(x).to(self.device),
            max_new_tokens=int(cfg.get("max_new_tokens", 32)),
            temperature=float(cfg.get("temperature", 0.0)),
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
