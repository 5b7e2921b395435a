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

"""Decode attention: one query per row over the KV cache, a hand-written
CUDA kernel for Hopper.

Source note. The kernel (``csrc/decode_attention.cu``) has no Pallas
original: the reference runs its cache path under XLA
(``kubeflow_tpu/ops/attention.py::dense_attention``). It computes
:func:`~kubeflow_tpu_torch.ops.attention.dense_attention` for
``q [B, 1, H, D]`` over ``k, v [B, S, Hkv, D]`` and a ``[B, S]``
validity mask, with its constants (``NEG_INF``, the ``m_safe`` clamp,
the ``max(l, 1e-30)`` normalizer) and its rounding points (fp32 scores
and statistics, the global max first, P cast to V's dtype before an
fp32 PV). One thread-block cluster per (row, kv head) splits the keys
into ranges of ``span = 64 * ceil(S / 512)`` keys over
``C = ceil(S / span) <= 8`` CTAs, each holding the kv head's
``H / Hkv`` query heads (GQA without ``_repeat_kv`` copies), its keys'
scores and V rows in shared memory; the CTAs exchange their maxima,
partial normalizers and partial outputs through distributed shared
memory and add them in rank order. Every sum is in an order fixed by
S's 512-key band, D and the kernel's constants, never by B, so a row has
the same bits at any batch size, and at any cache length of its band
(a masked key adds exact zeros): a B = 1 ``generate`` on a cache of
``max_prompt + new_tokens`` keys gives the bits of an engine whose slot
rounds that up to whole pages, for any page size dividing 512. One launch where the plain version is about twenty.
Bound by bytes (K and V read once).

Dispatch. A CPU tensor goes to ``dense_attention`` itself, the plain
version. A CUDA tensor goes to the kernel, or the call raises, also
where a CTA's share of S's scores does not fit in shared memory.
``decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import dense_attention
from kubeflow_tpu_torch.ops.flash_attention import MAX_SMEM_BYTES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Head dims the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Query heads one kv head may serve (the kernel's kMaxRep).
MAX_REP = 8
#: The kernel's warps a CTA.
WARPS = 4
#: CTAs a cluster at most, and the keys a CTA's range is a multiple of.
MAX_SPLIT, SPLIT_KEYS = 8, 64
#: V rows a CTA stages in shared memory at once, in bytes at most.
V_STAGE_BYTES = 32768
#: The kernel's static shared memory: a float per warp and head, at most.
STATIC_SMEM_BYTES = 4 * WARPS * MAX_REP


def span(s: int) -> int:
    """Keys a CTA's range at S keys: SPLIT_KEYS for each started band of
    MAX_SPLIT × SPLIT_KEYS keys (the kernel's ``span``)."""
    return SPLIT_KEYS * max(1, -(-s // (MAX_SPLIT * SPLIT_KEYS)))


def splits(s: int) -> int:
    """CTAs a cluster at S keys (the kernel's ``splits``)."""
    return max(1, -(-s // span(s)))


def padded_rep(rep: int) -> int:
    """H / Hkv rounded up to a power of two: the heads a CTA's loops
    run (the kernel's ``padded_rep``)."""
    return 1 if rep <= 1 else 2 if rep <= 2 else 4 if rep <= 4 else 8


def smem_bytes(h: int, hkv: int, s: int, d: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one CTA at ``elem_bytes`` a K/V element:
    its V rows (one stage of at most ``V_STAGE_BYTES`` where its range
    fits, else two), then in fp32 for the padded heads its q, its keys'
    scores, its partial output and the heads' local max, global max and
    partial normalizer, then a validity byte a key (as the kernel's
    ``kft_decode_attention_smem_bytes``)."""
    r = padded_rep(h // hkv)
    keys_a_cta = span(s)
    row = d * elem_bytes
    keys = min(keys_a_cta, V_STAGE_BYTES // row)
    buffers = 2 if keys_a_cta > keys else 1
    return (buffers * keys * row + 4 * r * (2 * d + keys_a_cta + 3)
            + keys_a_cta)


def _library() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if not getattr(lib, "_kft_bound", False):
        lib.kft_decode_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.kft_decode_attention.restype = ctypes.c_int
        lib.kft_decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.kft_decode_attention_smem_bytes.restype = ctypes.c_longlong
        lib.kft_decode_attention_splits.argtypes = [ctypes.c_int]
        lib.kft_decode_attention_splits.restype = ctypes.c_int
        lib._kft_bound = True
    return lib


def kernel_smem_bytes(h: int, hkv: int, s: int, d: int,
                      elem_bytes: int) -> int:
    """The built kernel's own figure for :func:`smem_bytes`."""
    return _library().kft_decode_attention_smem_bytes(h, hkv, s, d,
                                                      elem_bytes)


def kernel_splits(s: int) -> int:
    """The built kernel's own figure for :func:`splits`."""
    return _library().kft_decode_attention_splits(s)


def _check_inputs(q, k, v, valid) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be [B, 1, H, D] and k, v "
                         "[B, S, Hkv, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2] or h // k.shape[2] > MAX_REP:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads, at most {MAX_REP} a "
                         "KV head")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")
    if k.shape[1] == 0:
        raise ValueError("the cache has no keys")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, all three alike")
    if tuple(valid.shape) != (b, k.shape[1]) or valid.dtype != torch.bool \
            or valid.stride(1) != 1:
        raise ValueError(f"valid must be a [B, S] = ({b}, {k.shape[1]}) bool "
                         f"mask with contiguous keys, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if any(t.device != q.device for t in (k, v, valid)):
        raise ValueError("q, k, v and valid must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any((st * t.element_size()) % 16
                                    for st in t.stride()[:3]):
            raise ValueError(f"{name}'s rows must be 16-byte aligned "
                             "(16-byte loads)")
    need = smem_bytes(h, k.shape[2], k.shape[1], d,
                      k.element_size()) + STATIC_SMEM_BYTES
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"S = {k.shape[1]}: a CTA's share of the keys "
                         f"takes {need} bytes of shared memory, more than "
                         f"{MAX_SMEM_BYTES}")


def _launch(q, k, v, valid) -> torch.Tensor:
    _check_inputs(q, k, v, valid)
    b, _, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kft_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], b, h, hkv, s, d,
            q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
            valid.stride(0), float(d ** -0.5), stream)
    _build.check(lib, err, "decode_attention launch")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Softmax attention of one query per row, ``q [B, 1, H, D]``, over
    ``k, v [B, S, Hkv, D]`` where the ``[B, S]`` bool ``valid`` is True:
    ``dense_attention(q, k, v, kv_segment_valid=valid)``. A CPU tensor
    takes ``dense_attention``; a CUDA tensor launches the kernel on the
    current stream (no synchronisation) or raises, also where a gradient
    is wanted: the decode step runs under ``inference_mode``."""
    if q.device.type == "cpu":
        return dense_attention(q, k, v, kv_segment_valid=valid)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention has no gradient on the card: "
                           "the decode step runs under inference_mode")
    return _launch(q, k, v, valid)


#: Kernel launches since the count was last set to 0.
decode_attention.launches = 0
