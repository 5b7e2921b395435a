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

"""The msgpack that Flax writes, read and written without ``msgpack``.

An export's ``params.msgpack`` is ``flax.serialization.to_bytes`` of the
variables: msgpack maps of str keys down to array leaves, each array an
ext object. The port reads and writes that subset of msgpack itself (the
GPU machine has no ``msgpack`` package):

- nil, bool, int, float (float64 on write), str, bin, array and map;
- ext type 1 (``ndarray``): the msgpack of ``(shape, dtype name, raw C
  bytes)``; ext 3 (``npscalar``): the same of a 0-d array, read back as
  a numpy scalar; ext 2 (``native_complex``): ``(real, imag)``;
- Flax's chunked arrays: an array over :data:`MAX_CHUNK_SIZE` bytes is
  written as ``{"__msgpack_chunked_array__": True, "shape": {"0": d0,
  ...}, "chunks": {"0": flat0, ...}}`` (msgpack caps one object at
  2**31 - 1 bytes; ``llama3-8b``'s fp32 embedding is 2.1 GB) and read
  back whole.

Arrays come back as numpy views of the file's bytes (no copy); a
``bfloat16`` array, which numpy has no type for, comes back as a
``torch.bfloat16`` tensor, and a ``torch.Tensor`` leaf is written as
the array of its dtype. Writing streams to a file object, so an export
never holds a second copy of its params in memory.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, List

import numpy as np
import torch

#: Flax's chunking threshold (``flax/serialization.py``): arrays larger
#: than this many bytes are split into flat chunks of at most this size.
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# -- writing -----------------------------------------------------------------


def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, bound in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                                 (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
            if n < bound:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack")
    else:
        for code, fmt, bound in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                                 (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
            if n >= -bound:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: List[bytes]
              ) -> None:
    """A length header: the fix form below ``fix_max``, else the
    smallest of ``codes`` (8/16/32-bit lengths; None where the family
    has no such form)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, bound in zip(codes, (">B", ">H", ">I"),
                                (2**8, 2**16, 2**32)):
        if code is not None and n < bound:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"msgpack object of length {n} is too large")


def _pack_bin(b, out: List[bytes]) -> None:
    _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_ext_header(code: int, n: int, out: List[bytes]) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
        out.append(bytes([code]))


def _array_ext(code: int, x, out: List[bytes]) -> None:
    """An ndarray ext object: the msgpack of ``(shape, dtype name,
    bytes)``, the bytes appended as a view (never copied)."""
    name, shape, data = _array_bytes(x)
    head: List[bytes] = []
    _pack_len(3, 0x90, 16, (None, 0xDC, 0xDD), head)
    _pack_len(len(shape), 0x90, 16, (None, 0xDC, 0xDD), head)
    for d in shape:
        _pack_int(int(d), head)
    _pack(name, head)
    _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), head)
    prefix = b"".join(head)
    _pack_ext_header(code, len(prefix) + len(data), out)
    out.append(prefix)
    out.append(data)


def _array_bytes(x) -> tuple:
    """``(dtype name, shape, C-order bytes)`` of a numpy array or a
    torch tensor (bfloat16 as its raw 16-bit words)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", tuple(t.shape),
                    memoryview(t.view(torch.int16).numpy().reshape(-1)
                               .view(np.uint8)))
        x = t.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:
        x = x.copy(order="C")
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no msgpack "
                         "array form")
    # Bytes through a uint8 view: a dtype numpy only knows by extension
    # (ml_dtypes' bfloat16) has no buffer-protocol format of its own.
    return x.dtype.name, x.shape, memoryview(x.reshape(-1).view(np.uint8))


def _chunked(x) -> Dict[str, Any]:
    """Flax's chunked form of an oversized array: flat chunks of at
    most MAX_CHUNK_SIZE bytes."""
    flat = x.reshape(-1)
    itemsize = flat.element_size() if isinstance(x, torch.Tensor) \
        else flat.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.size) * x.dtype.itemsize


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(_chunked(obj), out)
            return
        _array_ext(_EXT_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _array_ext(_EXT_NPSCALAR, np.asarray(obj), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, complex):
        inner: List[bytes] = [b"\x92"]
        _pack(obj.real, inner)
        _pack(obj.imag, inner)
        payload = b"".join(inner)
        _pack_ext_header(_EXT_COMPLEX, len(payload), out)
        out.append(payload)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(obj, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, list):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"no msgpack form for {type(obj).__name__}")


def dump(obj: Any, f: BinaryIO) -> None:
    """Write ``obj`` to ``f`` as ``flax.serialization.msgpack_serialize``
    would, one top-level value (arrays written as they are reached, so
    the file is never assembled in memory)."""
    if isinstance(obj, dict):
        head: List[bytes] = []
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), head)
        f.write(b"".join(head))
        for k, v in obj.items():
            out: List[bytes] = []
            _pack(k, out)
            f.write(b"".join(out))
            dump(v, f)
        return
    out = []
    _pack(obj, out)
    for piece in out:
        f.write(piece)


def _sorted_tree(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _sorted_tree(obj[k]) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        return [_sorted_tree(v) for v in obj]
    return obj


def dumps(obj: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(obj)``: the bytes of the
    blobs replicas exchange. Unlike :func:`dump` (``to_bytes``, which
    keeps a map's order), it writes every map of ``obj`` with its keys
    sorted, as Flax's copy of the tree through ``jax.tree_util``
    leaves them."""
    out: List[bytes] = []
    _pack(_sorted_tree(obj), out)
    return b"".join(out)


# -- reading -----------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self, raw: bool = False) -> Any:
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack((">B", ">H", ">I")[b - 0xC4])
            return self.take(n)
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self._ext(n)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self._ext(1 << (b - 0xD4))
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self.unpack((">B", ">H", ">I")[b - 0xD9]),
                             raw)
        if b in (0xDC, 0xDD):
            n = self.unpack((">H", ">I")[b - 0xDC])
            return [self.read(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack((">H", ">I")[b - 0xDE]), raw)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def _map(self, n: int, raw: bool) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read(raw)
            out[key] = self.read(raw)
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _array_from(data)
        if code == _EXT_NPSCALAR:
            return _array_from(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _array_from(data: memoryview):
    shape, name, buf = _Reader(data).read(raw=True)
    if name == b"bfloat16":
        words = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(
        shape, order="C")


def _unchunk(tree: Any) -> Any:
    """Reassemble Flax's chunked arrays, anywhere in ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)]
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)]
                  for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of ``data``
    (bytes, or a buffer such as an ``mmap``), chunked arrays whole."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of "
                         f"trailing data after the msgpack object")
    return _unchunk(obj)
