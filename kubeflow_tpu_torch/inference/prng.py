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

"""Threefry-2x32 keys and sampling, bit for bit with ``jax.random``.

The reference samples with ``jax.random`` (``inference/generate.py``,
the engine's step keys, the server's per-row keys), and its keys travel
between processes as uint32 ``[N, 2]`` arrays. A port that drew other
bits from the same key could neither join a mixed fleet nor resume a
stream, so this module reproduces JAX's default PRNG exactly:

- the threefry2x32 block cipher (20 rounds, rotations 13 15 26 6 /
  17 29 16 24, key schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``);
- the *partitionable* counter layout that ``jax_threefry_partitionable``
  selects (the default since jax 0.5): element i of a draw of any shape
  hashes the 64-bit counter i, split into hi and lo words, and
  ``random_bits`` is the xor of the two output words; ``split`` keeps
  the two words as the new key; ``fold_in`` hashes the counter
  ``(0, data)``;
- ``uniform``: the top 23 bits into the mantissa of a float in [1, 2),
  minus 1, scaled, and clamped below at ``minval``;
- ``gumbel`` (``-log(-log(u))``, u uniform in [tiny, 1)) and
  ``categorical`` (argmax of logits plus Gumbel noise);
- ``randint``: JAX's modulus method, two 32-bit draws from the key's
  split and the span arithmetic in uint32 (8- and 16-bit types drawn at
  32 bits and cast, as JAX does).

Arithmetic is on int64 tensors holding uint32 values, masked after each
add: torch's uint32 support is thin, and int64 wraps nothing. Keys are
tiny and live on the host as numpy uint32; the bits of a ``[B, V]``
draw are made on the logits' device.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32's smallest normal, ``jnp.finfo(jnp.float32).tiny``.
_TINY = float(np.finfo(np.float32).tiny)

KeyLike = Union[np.ndarray, torch.Tensor, "list[int]"]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counters ``(x0, x1)`` under key
    ``(k0, k1)``: int64 tensors of uint32 values, broadcast together.
    Returns the two output words, int64 in ``[0, 2**32)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _key_words(key: KeyLike, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``[..., 2]`` uint32 key as two int64 tensors ``[...]`` on
    ``device``."""
    if isinstance(key, torch.Tensor):
        k = key.to(device=device, dtype=torch.int64) & _MASK
    else:
        k = torch.from_numpy(
            np.asarray(key, np.uint32).astype(np.int64)).to(device)
    if k.shape[-1] != 2:
        raise ValueError(f"a threefry key is [..., 2] uint32, got shape "
                         f"{tuple(k.shape)}")
    return k[..., 0], k[..., 1]


def _to_uint32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 — jax.random's name
    """``jax.random.PRNGKey(seed)`` as JAX makes it without x64: the
    high word is 0 and the low word is the seed's low 32 bits (a
    negative seed wraps to its two's complement)."""
    seed = int(seed)
    if not -2**63 <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit 64 bits")
    return np.asarray([0, seed & _MASK], np.uint32)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit iota ``0..n-1`` as (hi, lo) words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def split(key: KeyLike, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` uint32."""
    k0, k1 = _key_words(key, "cpu")
    hi, lo = _counters(num, "cpu")
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return _to_uint32(torch.stack([b0, b1], dim=-1))


def fold_in(key: KeyLike, data: Union[int, np.ndarray]) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: ``[2]`` uint32, or
    ``[n, 2]`` for a vector of data (JAX's ``vmap`` over it)."""
    k0, k1 = _key_words(key, "cpu")
    d = torch.as_tensor(np.asarray(data, np.int64) & _MASK)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return _to_uint32(torch.stack([b0, b1], dim=-1))


def random_bits(key: KeyLike, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 on ``device``.

    ``key`` is one ``[2]`` key, or ``[B, 2]`` per-row keys for a shape
    ``[B, ...]``: row b then holds ``bits(key[b], shape[1:])`` (JAX's
    ``vmap`` over the keys)."""
    shape = tuple(int(s) for s in shape)
    k0, k1 = _key_words(key, device)
    if k0.ndim == 0:
        n = int(np.prod(shape, dtype=np.int64))
        hi, lo = _counters(n, device)
        b0, b1 = threefry2x32(k0, k1, hi, lo)
        return (b0 ^ b1).reshape(shape)
    if k0.ndim != 1 or not shape or shape[0] != k0.shape[0]:
        raise ValueError(f"per-row keys {tuple(k0.shape)} do not lead "
                         f"shape {shape}")
    n = int(np.prod(shape[1:], dtype=np.int64))
    hi, lo = _counters(n, device)
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], hi[None], lo[None])
    return (b0 ^ b1).reshape(shape)


def uniform(key: KeyLike, shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape, device)
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mantissa.view(torch.float32) - 1.0
    # Made on the device, not copied from the host (a captured decode
    # program cannot hold a host copy).
    lo = torch.full((), minval, dtype=torch.float32, device=floats.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: KeyLike, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (the default "low"
    mode): ``-log(-log(u))`` for u uniform in ``[tiny, 1)``. The
    uniforms are JAX's exactly; the two logs may round differently
    from XLA's in the last bit (about 1e-6 of noise)."""
    u = uniform(key, shape, device, minval=_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: KeyLike, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``logits``,
    int64: one shared ``[2]`` key draws noise for the whole
    ``logits.shape``; ``[B, 2]`` keys draw row b's noise from key b."""
    noise = gumbel(key, logits.shape, logits.device)
    return torch.argmax(noise + logits, dim=-1)


#: ``randint``'s integer types: JAX without x64 has no 64-bit ones.
_RANDINT_DTYPES = {np.dtype(t) for t in (np.int8, np.int16, np.int32,
                                         np.uint8, np.uint16, np.uint32)}
_INT32 = np.iinfo(np.int32)


def randint(key: KeyLike, shape, minval, maxval,
            dtype=np.int32) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, dtype)`` (x64
    off): a numpy array of ``dtype`` in ``[minval, maxval)``, bit for
    bit. ``minval`` and ``maxval`` are int32 values or arrays that
    broadcast to ``shape``.

    JAX's algorithm: integer types narrower than 32 bits sample at
    int32 with the bounds clipped to the narrow type's range (the upper
    one to its max + 1) and cast at the end. At 32 bits, the key splits
    into two, each draws 32-bit words, and with ``span = maxval -
    minval`` as uint32 (1 where ``maxval <= minval``) the offset is
    ``((hi % span) * m + lo % span) % span`` with ``m = ((2**16 %
    span)**2) % span``, every product and sum wrapping in uint32 (so
    ``m`` is 0 for a span above 2**16, as in JAX), added to
    ``minval``."""
    dtype = np.dtype(dtype)
    if dtype not in _RANDINT_DTYPES:
        raise TypeError(f"randint takes 8-, 16- or 32-bit integer types "
                        f"(JAX without x64), not {dtype}")
    shape = tuple(int(s) for s in shape)
    lo = np.asarray(minval)
    hi = np.asarray(maxval)
    for v in (lo, hi):
        if v.dtype.kind not in "iu" or (v.size and (
                v.min() < _INT32.min or v.max() > _INT32.max)):
            raise ValueError("randint bounds are int32 values")
    lo, hi = lo.astype(np.int64), hi.astype(np.int64)
    info = np.iinfo(dtype)
    sampling = dtype
    if info.bits < 32:
        # Sampled at 32 bits: jnp.asarray(minval).astype('int32').clip(
        # info.min, info.max), maxval's clip to info.max + 1.
        sampling = np.dtype(np.int32)
        lo = np.clip(lo, info.min, info.max)
        hi = np.clip(hi, info.min, info.max + 1)
    # _convert_and_clip_integer of the int32 bounds to the sampling type
    # (uint32 clips to [0, 2**31 - 1]); maxval is never out of range.
    s_info = np.iinfo(sampling)
    lo = np.clip(lo, max(s_info.min, _INT32.min), min(s_info.max, _INT32.max))
    hi = np.clip(hi, max(s_info.min, _INT32.min), min(s_info.max, _INT32.max))
    lo = torch.from_numpy(np.broadcast_to(lo, shape).copy())
    hi = torch.from_numpy(np.broadcast_to(hi, shape).copy())
    k1, k2 = split(key, 2)
    higher = random_bits(k1, shape, "cpu")
    lower = random_bits(k2, shape, "cpu")
    span = torch.where(hi <= lo, torch.ones_like(lo), (hi - lo) & _MASK)
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((higher % span) * multiplier) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    out = (lo + offset) & _MASK
    if sampling.kind == "i":
        out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.numpy().astype(sampling).astype(dtype)
