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

"""Autoregressive generation: prefill + KV-cache decode loop (greedy).

Port of ``kubeflow_tpu/inference/generate.py``:

- The KV cache is a static-size buffer per layer (``cache_size`` on the
  Llama family), written in place at a running index.
- Prefill runs the full prompt once and fills the cache; decode steps
  run in a Python loop under ``torch.inference_mode()`` (the
  reference's ``lax.scan``), each through the one decode-step function.
- Batched decode: mixed-length prompts ride one decode via LEFT-padding
  + ``prompt_lengths`` (per-row position offsets and a cache-slot mask
  keep each row identical to its B=1 run).

Only greedy decoding is ported. Sampling (``temperature > 0``, with
``top_k``/``top_p``) must reproduce ``jax.random``'s threefry2x32 bit
for bit and waits for that port; such a call raises
``NotImplementedError`` rather than return different tokens.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from kubeflow_tpu_torch.models.llama import LayerCache, apply


def prompt_bucket(n: int, max_len: int,
                  buckets: Optional[Sequence[int]] = None) -> int:
    """THE prompt-length bucketing policy: the export's explicit
    ``buckets`` list when present, else the smallest power of two
    ≥ ``n`` — either way capped at ``max_len``."""
    if buckets:
        for b in sorted(int(v) for v in buckets):
            if b >= n:
                return min(b, max_len)
        return max_len
    b = 1
    while b < n and b < max_len:
        b *= 2
    return min(b, max_len)


def init_cache(model: Any, params: Dict[str, torch.Tensor],
               batch: int) -> List[LayerCache]:
    """Zero KV caches for ``model`` (built with a ``cache_size``), one
    per layer, in the model's dtype on the params' device."""
    device = next(iter(params.values())).device
    shape = (batch, model.cache_size, model.num_kv_heads, model.head_dim)
    return [LayerCache(torch.zeros(shape, dtype=model.dtype, device=device),
                       torch.zeros(shape, dtype=model.dtype, device=device))
            for _ in range(model.num_layers)]


def _prompt_positions(b: int, prompt_len: int,
                      pad_lengths: Optional[torch.Tensor],
                      device: torch.device) -> torch.Tensor:
    """RoPE positions for a (possibly left-padded) prompt: row i's
    real tokens get positions 0..len_i-1 whatever slot they occupy;
    pad slots clamp to 0 (their K/V are masked out of attention)."""
    ar = torch.arange(prompt_len, device=device)[None, :]
    if pad_lengths is None:
        return ar.expand(b, prompt_len)
    return torch.clamp_min(ar - pad_lengths[:, None], 0)


def _sample_logits(logits: torch.Tensor) -> torch.Tensor:
    """Greedy: the first index of the largest logit, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _make_decode_step(model, params, eos_id, pad_lengths=None):
    """THE one-token decode step (cache write + sample + EOS latch),
    shared by the monolithic and the chunked loops."""

    def decode_step(carry):
        cache, token, position, done = carry
        logits = apply(model, params, token[:, None], position[:, None],
                       pad_lengths=pad_lengths, cache=cache)[:, 0]
        next_token = _sample_logits(logits)
        if eos_id is not None:
            next_token = torch.where(done, torch.full_like(next_token, eos_id),
                                     next_token)
            done = done | (next_token == eos_id)
        return (cache, next_token, position + 1, done), (next_token, logits)

    return decode_step


def generate(
    model: Any,
    params: Dict[str, torch.Tensor],
    prompt_ids: torch.Tensor,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    eos_id: Optional[int] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    chunk_tokens: Optional[int] = None,
    prompt_lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate ``max_new_tokens`` greedy continuations of
    ``prompt_ids`` ([B, L] int, on the params' device).

    ``model`` must be built with ``cache_size >= prompt_len +
    max_new_tokens``. Returns ``(tokens [B, max_new_tokens] int32,
    logits [B, max_new_tokens, V] fp32)``. With ``eos_id``, tokens after
    the first EOS are replaced by EOS. ``top_k``/``top_p`` only apply
    when ``temperature > 0``, which is not ported yet.

    ``prompt_lengths`` — ``[B]`` true per-row token counts, with
    ``prompt_ids`` LEFT-padded; row i of the batch then equals the same
    prompt run alone at B=1.

    ``chunk_tokens`` — decode in K-token slices with a device sync
    between them (the serving yield point for a shared device). Tokens
    are identical to the monolithic loop.
    """
    if temperature > 0.0:
        raise NotImplementedError("sampling needs the threefry port")
    b, prompt_len = prompt_ids.shape
    if model.cache_size < prompt_len + max_new_tokens:
        raise ValueError(
            f"cache_size {model.cache_size} < prompt "
            f"{prompt_len} + max_new_tokens {max_new_tokens}")
    if chunk_tokens is not None and chunk_tokens < 1:
        raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
    device = prompt_ids.device
    pad_lengths = None
    if prompt_lengths is not None:
        prompt_lengths = torch.as_tensor(prompt_lengths, dtype=torch.int32,
                                         device=device)
        if tuple(prompt_lengths.shape) != (b,):
            raise ValueError(
                f"prompt_lengths shape {tuple(prompt_lengths.shape)} != "
                f"(batch,) = ({b},)")
        lo, hi = int(prompt_lengths.min()), int(prompt_lengths.max())
        if lo < 1 or hi > prompt_len:
            raise ValueError(
                f"prompt_lengths must be in [1, {prompt_len}] "
                f"(the padded prompt width); got range [{lo}, {hi}]")
        pad_lengths = prompt_len - prompt_lengths
    with torch.inference_mode():
        cache = init_cache(model, params, b)
        positions = _prompt_positions(b, prompt_len, pad_lengths, device)
        last_logits = apply(model, params, prompt_ids, positions,
                            pad_lengths=pad_lengths, cache=cache)[:, -1]
        first = _sample_logits(last_logits)
        done = (first == eos_id if eos_id is not None
                else torch.zeros((b,), dtype=torch.bool, device=device))
        if pad_lengths is None:
            position = torch.full((b,), prompt_len, dtype=torch.int32,
                                  device=device)
        else:
            position = (prompt_len - pad_lengths).to(torch.int32)
        carry = (cache, first, position, done)
        step = _make_decode_step(model, params, eos_id, pad_lengths)
        tokens, logits = [first], [last_logits]
        n_decode = max_new_tokens - 1
        chunk = chunk_tokens if chunk_tokens else max(n_decode, 1)
        for start in range(0, n_decode, chunk):
            for _ in range(min(chunk, n_decode - start)):
                carry, (token, step_logits) = step(carry)
                tokens.append(token)
                logits.append(step_logits)
            if chunk_tokens and device.type == "cuda":
                # The yield point: let this slice drain before queueing
                # the next, so other work on the device gets a turn.
                torch.cuda.current_stream(device).synchronize()
        tokens = torch.stack(tokens, dim=1)[:, :max_new_tokens]
        logits = torch.stack(logits, dim=1)[:, :max_new_tokens]
    return tokens, logits
