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

"""Autoregressive generation: prefill + KV-cache decode loop.

Port of ``kubeflow_tpu/inference/generate.py``:

- The KV cache is a static-size buffer per layer (``cache_size`` on the
  Llama family), written in place at a running index.
- Prefill runs the full prompt once and fills the cache
  (:func:`_prefill`, the head the decode engine calls too); decode steps
  run in a Python loop under ``torch.inference_mode()`` (the
  reference's ``lax.scan``), each through the one decode-step function.
- Greedy (``temperature=0``) or temperature sampling with ``top_k`` /
  ``top_p`` truncation. Sampling draws from ``inference/prng.py``, a
  threefry that matches ``jax.random`` bit for bit, so a key gives the
  reference's tokens (up to Gumbel noise rounded differently by about
  1e-6, which flips only a near-tie).
- Batched decode: mixed-length prompts ride one decode via LEFT-padding
  + ``prompt_lengths`` (per-row position offsets and a cache-slot mask
  keep each row identical to its B=1 run), and ``rng`` takes per-row
  keys ``[B, 2]`` so a sampled row reproduces its B=1 stream.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.models.llama import LayerCache, apply

KeyArray = Union[np.ndarray, torch.Tensor]


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
    shape = (batch, model.cache_size,
             getattr(model, "cache_kv_heads", model.num_kv_heads),
             model.head_dim)
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


def _row_cumsum(probs: torch.Tensor) -> torch.Tensor:
    """Cumulative sums along the last axis, each row scanned alone. One
    scan over ``[B, V]`` is not row-invariant on CUDA: PyTorch scans a
    single row with another algorithm than a batch of rows, so a row's
    sums round apart at B=1 and at B=4 (``scripts/decode_invariance.py``)
    and a top-p boundary could move with the batch."""
    rows = probs.reshape(-1, probs.shape[-1])
    return torch.stack([torch.cumsum(r, dim=-1) for r in rows]).reshape(
        probs.shape)


def _truncate_logits(logits: torch.Tensor, top_k: Optional[int],
                     top_p: Optional[float]) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p (nucleus)
    set to -inf. Top-k keeps every logit at or above the k-th largest;
    top-p sorts descending, keeps the smallest prefix whose softmax
    mass reaches ``top_p`` and turns it into a value threshold. The top
    token is always kept, so ``top_p <= 0`` is greedy rather than an
    all -inf row (over which categorical would emit token 0)."""
    # Constants made on the device (``torch.full``), not copied from
    # the host: a captured decode program cannot hold a host copy.
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype,
                         device=logits.device)
    # top_k in (None, 0) and top_p in (None, >= 1.0) mean "disabled";
    # top_k >= vocab is a no-op.
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = _row_cumsum(probs)
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        threshold = torch.where(
            keep, sorted_logits,
            torch.full((), float("inf"), dtype=logits.dtype,
                       device=logits.device)).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, neg_inf, logits)
    return logits


def _split_step_rngs(rng: KeyArray, n: int) -> np.ndarray:
    """Per-step keys from one shared key (``[2]`` → ``[n, 2]``, one
    stream for the whole batch) or per-row keys (``[B, 2]`` →
    ``[n, B, 2]``, one stream per row, so a row sampled inside a batch
    equals the same request at B=1 with its own key). Host uint32."""
    rng = np.asarray(rng.cpu() if isinstance(rng, torch.Tensor) else rng,
                     np.uint32)
    if rng.ndim == 2:
        return np.stack([prng.split(k, n) for k in rng], axis=1)
    return prng.split(rng, n)


def _sample_logits(logits: torch.Tensor, step_rng: Optional[torch.Tensor],
                   temperature: float, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """One token per row, int32: the first index of the largest logit
    when ``temperature <= 0``; else a categorical draw from the
    truncated, tempered fp32 logits with ``step_rng`` (one ``[2]`` key
    for the batch, or ``[B, 2]`` per-row keys, on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _truncate_logits(logits.float() / temperature, top_k, top_p)
    return prng.categorical(step_rng, logits).to(torch.int32)


def _device_keys(keys: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host uint32 keys as int64 on ``device`` (one copy per call)."""
    return torch.from_numpy(np.asarray(keys, np.uint32).astype(
        np.int64)).to(device)


def _make_decode_step(model, params, temperature, eos_id, top_k, top_p,
                      pad_lengths=None):
    """THE one-token decode step (cache write + sample + EOS latch),
    shared by the monolithic and the chunked loops."""

    def decode_step(carry, step_rng):
        cache, token, position, done = carry
        logits = apply(model, params, token[:, None], position[:, None],
                       pad_lengths=pad_lengths, cache=cache)[:, 0]
        next_token = _sample_logits(logits, step_rng, temperature, top_k,
                                    top_p)
        if eos_id is not None:
            next_token = torch.where(done, torch.full_like(next_token, eos_id),
                                     next_token)
            done = done | (next_token == eos_id)
        return (cache, next_token, position + 1, done), (next_token, logits)

    return decode_step


def _prefill(model, params, prompt_ids: torch.Tensor,
             first_rng: Optional[torch.Tensor], cache: List[LayerCache],
             pad_lengths: Optional[torch.Tensor], *, temperature: float,
             eos_id: Optional[int], top_k: Optional[int],
             top_p: Optional[float]):
    """Prompt pass + first sampled token: ``((cache, first, position,
    done), last_logits)``, ``cache`` filled in place. The head of
    :func:`generate` and of the decode engine's admission."""
    b, prompt_len = prompt_ids.shape
    positions = _prompt_positions(b, prompt_len, pad_lengths,
                                  prompt_ids.device)
    last_logits = apply(
        model, params, prompt_ids, positions, pad_lengths=pad_lengths,
        cache=cache, logits_at=torch.full(
            (b,), prompt_len - 1, device=prompt_ids.device))[:, 0]
    first = _sample_logits(last_logits, first_rng, temperature, top_k, top_p)
    done = (first == eos_id if eos_id is not None
            else torch.zeros((b,), dtype=torch.bool, device=first.device))
    if pad_lengths is None:
        position = torch.full((b,), prompt_len, dtype=torch.int32,
                              device=first.device)
    else:
        position = (prompt_len - pad_lengths).to(torch.int32)
    return (cache, first, position, done), last_logits


def generate(
    model: Any,
    params: Dict[str, torch.Tensor],
    prompt_ids: torch.Tensor,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    rng: Optional[KeyArray] = None,
    eos_id: Optional[int] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    chunk_tokens: Optional[int] = None,
    prompt_lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate ``max_new_tokens`` continuations of ``prompt_ids``
    ([B, L] int, on the params' device).

    ``model`` must be built with ``cache_size >= prompt_len +
    max_new_tokens``. Returns ``(tokens [B, max_new_tokens] int32,
    logits [B, max_new_tokens, V] fp32)``. With ``eos_id``, tokens after
    the first EOS are replaced by EOS. ``top_k``/``top_p`` truncate the
    sampling distribution; both only apply when ``temperature > 0``.

    ``prompt_lengths`` — ``[B]`` true per-row token counts, with
    ``prompt_ids`` LEFT-padded; row i of the batch then equals the same
    prompt run alone at B=1.

    ``rng`` — one threefry key (``[2]`` uint32: the batch shares one
    per-step stream) or per-row keys (``[B, 2]``: row i samples from
    ``rng[i]``'s stream, as it would alone). Default ``PRNGKey(0)``.

    ``chunk_tokens`` — decode in K-token slices with a device sync
    between them (the serving yield point for a shared device). Tokens
    are identical to the monolithic loop (the same step keys).
    """
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
    step_rngs = [None] * max_new_tokens
    if temperature > 0.0:
        keys = prng.PRNGKey(0) if rng is None else rng
        step_rngs = _device_keys(_split_step_rngs(keys, max_new_tokens),
                                 device)
    sample_kw = dict(temperature=temperature, eos_id=eos_id, top_k=top_k,
                     top_p=top_p)
    with torch.inference_mode():
        carry, last_logits = _prefill(
            model, params, prompt_ids, step_rngs[0],
            init_cache(model, params, b), pad_lengths, **sample_kw)
        step = _make_decode_step(model, params, temperature, eos_id, top_k,
                                 top_p, pad_lengths)
        tokens, logits = [carry[1]], [last_logits]
        n_decode = max_new_tokens - 1
        chunk = chunk_tokens if chunk_tokens else max(n_decode, 1)
        for start in range(0, n_decode, chunk):
            for i in range(start, min(start + chunk, n_decode)):
                carry, (token, step_logits) = step(carry, step_rngs[i + 1])
                tokens.append(token)
                logits.append(step_logits)
            if chunk_tokens and device.type == "cuda":
                # The yield point: let this slice drain before queueing
                # the next, so other work on the device gets a turn.
                torch.cuda.current_stream(device).synchronize()
        tokens = torch.stack(tokens, dim=1)[:, :max_new_tokens]
        logits = torch.stack(logits, dim=1)[:, :max_new_tokens]
    return tokens, logits
