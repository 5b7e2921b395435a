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

"""The model server's wire: the PredictionService codec, its gRPC and
gRPC-Web framing, the SSE stream, and the blobs that pass between
replicas.

The port's copy of the reference's ``serving/wire.py``, so a port
replica answers with the same bytes as a JAX replica:

- **Protobuf** (TF-Serving's public schema, hand-rolled, no protoc
  step): ``TensorProto``, ``PredictRequest``/``Response``,
  ``ClassificationRequest``/``Response`` over ``tf.Example``, and
  ``GetModelMetadataResponse`` with its ``SignatureDefMap``. The
  native gRPC listener (:mod:`grpc_server`) and the gRPC-Web route of
  the REST port both speak it. Numpy and ``struct`` only.
- **gRPC framing**: the ``grpc-timeout`` header codec and the
  length-prefixed gRPC-Web frames with their trailer frame.
- **SSE**: the streaming ``:generate`` events (``token``, ``error``,
  ``done``, and ``resume`` when asked), framed as EventSource expects.
- **Blobs**, written and read through
  :mod:`~kubeflow_tpu_torch.serving.flax_msgpack` with the reference's
  keys, int32 scalars and validation messages; a blob either package
  writes decodes in the other (arrays byte-exact, bfloat16 as its raw
  16-bit words):

  - *Handoff* (role-split serving): a prefill replica's
    :class:`~kubeflow_tpu_torch.inference.engine.engine.PrefillHandoff`,
    its cache keyed by path (``"layer_0/attention/k"``, the
    reference's flat cache collection; ``models/convert.py``
    ``cache_to_flax``), so the order of the keys does not matter.
  - *Resume token* (mid-stream failover): the context ids and the
    remaining sampling schedule; no cache. A resumed stream's token
    also carries ``prompt_len``, the length of the original prompt
    inside the context (see :func:`encode_resume_token`).
  - *KV blocks* (the fleet pull-through): a chain of full prefix
    blocks, each a LIST of ``[page_size, heads, dim]`` arrays in
    ``paged_kv.kv_leaf_order``, the reference's tree-flatten order.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from kubeflow_tpu_torch.models.convert import cache_from_flax, cache_to_flax
from kubeflow_tpu_torch.serving import flax_msgpack

__all__ = [
    "DT_BOOL",
    "DT_DOUBLE",
    "DT_FLOAT",
    "DT_STRING",
    "DT_TO_STR",
    "GRPC_WEB_CONTENT_TYPES",
    "KV_BLOCKS_FORMAT",
    "KV_HANDOFF_FORMAT",
    "RESUME_TOKEN_FORMAT",
    "SIGNATURE_DEF_TYPE_URL",
    "SSE_CONTENT_TYPE",
    "SSE_EVENTS",
    "SSE_KEEPALIVE",
    "decode_classification_request",
    "decode_classification_response",
    "decode_example",
    "decode_get_model_metadata_request",
    "decode_get_model_metadata_response",
    "decode_kv_blocks",
    "decode_kv_handoff",
    "decode_model_spec",
    "decode_predict_request",
    "decode_predict_response",
    "decode_resume_token",
    "decode_signature_def_map",
    "decode_tensor",
    "encode_classification_request",
    "encode_classification_response",
    "encode_example",
    "encode_get_model_metadata_request",
    "encode_get_model_metadata_response",
    "encode_kv_blocks",
    "encode_kv_handoff",
    "encode_model_spec",
    "encode_predict_request",
    "encode_predict_response",
    "encode_resume_token",
    "encode_signature_def_map",
    "encode_tensor",
    "format_grpc_timeout",
    "format_sse_event",
    "frame_message",
    "iter_sse_events",
    "parse_grpc_timeout",
    "trailers_frame",
    "unframe_messages",
]

# --- protobuf wire primitives ---------------------------------------------

_VARINT = 0
_I64 = 1
_LEN = 2
_I32 = 5


def _encode_varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _tag(field: int, wire_type: int) -> bytes:
    return _encode_varint((field << 3) | wire_type)


def _field_varint(field: int, value: int) -> bytes:
    return _tag(field, _VARINT) + _encode_varint(value)


def _field_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, _LEN) + _encode_varint(len(data)) + data


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message."""
    pos = 0
    while pos < len(buf):
        key, pos = _decode_varint(buf, pos)
        field, wire_type = key >> 3, key & 7
        if wire_type == _VARINT:
            value, pos = _decode_varint(buf, pos)
        elif wire_type == _LEN:
            length, pos = _decode_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire_type == _I64:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire_type == _I32:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field, wire_type, value


# --- DataType enum (tensorflow/core/framework/types.proto) -----------------

DT_FLOAT = 1
DT_DOUBLE = 2
DT_INT32 = 3
DT_UINT8 = 4
DT_STRING = 7
DT_INT64 = 9
DT_BOOL = 10
DT_BFLOAT16 = 14

_NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.float64): DT_DOUBLE,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int64): DT_INT64,
    np.dtype(np.bool_): DT_BOOL,
}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}


# --- messages ---------------------------------------------------------------

def encode_tensor(array: np.ndarray) -> bytes:
    """numpy → TensorProto bytes (dtype=1, tensor_shape=2,
    tensor_content=4)."""
    array = np.ascontiguousarray(array)
    dt = _NP_TO_DT.get(array.dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {array.dtype}")
    shape = b"".join(
        _field_bytes(2, _field_varint(1, dim)) for dim in array.shape)
    return (_field_varint(1, dt)
            + _field_bytes(2, shape)
            + _field_bytes(4, array.tobytes()))


def decode_tensor(buf: bytes) -> np.ndarray:
    """TensorProto bytes → numpy. Handles tensor_content and the
    repeated *_val fallbacks clients like tf.make_tensor_proto emit
    for small tensors."""
    dtype_enum: Optional[int] = None
    dims: List[int] = []
    content = b""
    float_vals: List[float] = []
    int_vals: List[int] = []
    string_vals: List[bytes] = []
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _VARINT:
            dtype_enum = int(value)
        elif field == 2 and wire_type == _LEN:
            for sfield, swt, sval in _iter_fields(value):
                if sfield == 2 and swt == _LEN:  # Dim message
                    for dfield, dwt, dval in _iter_fields(sval):
                        if dfield == 1 and dwt == _VARINT:
                            # size is int64; -1 (unknown) arrives as
                            # 2^64-1 — reject, shapes must be static.
                            size = int(dval)
                            if size >= 1 << 63:
                                raise ValueError("unknown dim size")
                            dims.append(size)
        elif field == 4 and wire_type == _LEN:
            content = bytes(value)
        elif field == 5:  # float_val (packed or not)
            if wire_type == _LEN:
                float_vals.extend(
                    struct.unpack(f"<{len(value) // 4}f", value))
            else:
                float_vals.append(struct.unpack("<f", value)[0])
        elif field == 7 and wire_type == _VARINT:  # int_val
            int_vals.append(int(value))
        elif field == 7 and wire_type == _LEN:  # packed int_val
            pos = 0
            while pos < len(value):
                v, pos = _decode_varint(value, pos)
                int_vals.append(v)
        elif field == 8 and wire_type == _LEN:  # string_val
            string_vals.append(bytes(value))
        elif field == 10:  # int64_val
            if wire_type == _VARINT:
                int_vals.append(int(value))
            else:
                pos = 0
                while pos < len(value):
                    v, pos = _decode_varint(value, pos)
                    int_vals.append(v)
    if dtype_enum is None:
        raise ValueError("TensorProto without dtype")
    if dtype_enum == DT_STRING:
        raise ValueError("string tensors are not supported")
    np_dtype = _DT_TO_NP.get(dtype_enum)
    if np_dtype is None:
        raise ValueError(f"unsupported DataType enum {dtype_enum}")
    shape = tuple(dims)
    if content:
        return np.frombuffer(content, dtype=np_dtype).reshape(shape)
    if float_vals:
        values = np.asarray(float_vals, dtype=np_dtype)
    elif int_vals:
        # Varints are two's-complement for negative ints.
        values = np.asarray(
            [v - (1 << 64) if v >= 1 << 63 else v for v in int_vals],
            dtype=np_dtype)
    else:
        values = np.zeros(0, np_dtype)
    if values.size == 1 and int(np.prod(shape or (1,))) > 1:
        # Proto3 scalar broadcast (tf.make_tensor_proto fill).
        return np.full(shape, values[0], np_dtype)
    return values.reshape(shape)


def encode_model_spec(name: str, version: Optional[int] = None,
                      signature_name: str = "") -> bytes:
    out = _field_bytes(1, name.encode())
    if version is not None:
        out += _field_bytes(2, _field_varint(1, version))  # Int64Value
    if signature_name:
        out += _field_bytes(3, signature_name.encode())
    return out


def decode_model_spec(buf: bytes) -> Dict[str, object]:
    spec: Dict[str, object] = {"name": "", "version": None,
                               "signature_name": ""}
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _LEN:
            spec["name"] = bytes(value).decode()
        elif field == 2 and wire_type == _LEN:
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 1 and wt2 == _VARINT:
                    spec["version"] = int(v2)
        elif field == 3 and wire_type == _LEN:
            spec["signature_name"] = bytes(value).decode()
    return spec


def encode_predict_request(model_name: str,
                           inputs: Dict[str, np.ndarray],
                           signature_name: str = "",
                           version: Optional[int] = None) -> bytes:
    out = _field_bytes(1, encode_model_spec(model_name, version,
                                            signature_name))
    for key, tensor in inputs.items():
        entry = (_field_bytes(1, key.encode())
                 + _field_bytes(2, encode_tensor(tensor)))
        out += _field_bytes(2, entry)  # map<string, TensorProto> inputs
    return out


def decode_predict_request(buf: bytes):
    """→ (model_spec dict, {input_name: ndarray}, [output_filter])."""
    spec: Dict[str, object] = {"name": "", "version": None,
                               "signature_name": ""}
    inputs: Dict[str, np.ndarray] = {}
    output_filter: List[str] = []
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _LEN:
            spec = decode_model_spec(value)
        elif field == 2 and wire_type == _LEN:  # inputs map entry
            key = ""
            tensor = None
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 1 and wt2 == _LEN:
                    key = bytes(v2).decode()
                elif f2 == 2 and wt2 == _LEN:
                    tensor = decode_tensor(v2)
            if key and tensor is not None:
                inputs[key] = tensor
        elif field == 3 and wire_type == _LEN:
            output_filter.append(bytes(value).decode())
    return spec, inputs, output_filter


def encode_predict_response(outputs: Dict[str, np.ndarray],
                            model_name: str,
                            version: Optional[int] = None) -> bytes:
    out = b""
    for key, tensor in outputs.items():
        entry = (_field_bytes(1, key.encode())
                 + _field_bytes(2, encode_tensor(np.asarray(tensor))))
        out += _field_bytes(1, entry)  # map<string, TensorProto> outputs
    out += _field_bytes(2, encode_model_spec(model_name, version))
    return out


def decode_predict_response(buf: bytes):
    """→ (model_spec dict, {output_name: ndarray})."""
    spec: Dict[str, object] = {"name": "", "version": None,
                               "signature_name": ""}
    outputs: Dict[str, np.ndarray] = {}
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _LEN:
            key = ""
            tensor = None
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 1 and wt2 == _LEN:
                    key = bytes(v2).decode()
                elif f2 == 2 and wt2 == _LEN:
                    tensor = decode_tensor(v2)
            if key and tensor is not None:
                outputs[key] = tensor
        elif field == 2 and wire_type == _LEN:
            spec = decode_model_spec(value)
    return spec, outputs


# --- tf.Example / Classification messages ----------------------------------

_DT_FROM_STR = {
    "float32": DT_FLOAT,
    "bfloat16": DT_BFLOAT16,
    "int32": DT_INT32,
    "int64": DT_INT64,
    "uint8": DT_UINT8,
    "bool": DT_BOOL,
}


def encode_example(features: Dict[str, object]) -> bytes:
    """{name: value} → tensorflow.Example bytes. Floats go to
    float_list, ints to int64_list, bytes to bytes_list."""
    entries = b""
    for name, value in features.items():
        if isinstance(value, bytes):
            feature = _field_bytes(1, _field_bytes(1, value))  # BytesList
        else:
            arr = np.asarray(value).reshape(-1)
            if np.issubdtype(arr.dtype, np.integer):
                packed = b"".join(_encode_varint(int(v) & (1 << 64) - 1)
                                  for v in arr)
                feature = _field_bytes(3, _field_bytes(1, packed))
            else:
                packed = struct.pack(f"<{arr.size}f",
                                     *arr.astype(np.float32))
                feature = _field_bytes(2, _field_bytes(1, packed))
        entry = _field_bytes(1, name.encode()) + _field_bytes(2, feature)
        entries += _field_bytes(1, entry)  # Features.feature map entry
    return _field_bytes(1, entries)  # Example.features


def decode_example(buf: bytes) -> Dict[str, object]:
    """tensorflow.Example bytes → {name: ndarray | [bytes]}."""
    out: Dict[str, object] = {}
    for field, wire_type, value in _iter_fields(buf):
        if field != 1 or wire_type != _LEN:
            continue
        for f2, wt2, v2 in _iter_fields(value):  # Features.feature entries
            if f2 != 1 or wt2 != _LEN:
                continue
            name = ""
            feature: object = None
            for f3, wt3, v3 in _iter_fields(v2):
                if f3 == 1 and wt3 == _LEN:
                    name = bytes(v3).decode()
                elif f3 == 2 and wt3 == _LEN:
                    feature = _decode_feature(v3)
            if name and feature is not None:
                out[name] = feature
    return out


def _decode_feature(buf: bytes):
    bytes_vals: List[bytes] = []
    float_vals: List[float] = []
    int_vals: List[int] = []
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _LEN:  # BytesList
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 1 and wt2 == _LEN:
                    bytes_vals.append(bytes(v2))
        elif field == 2 and wire_type == _LEN:  # FloatList
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 1 and wt2 == _LEN:  # packed
                    float_vals.extend(
                        struct.unpack(f"<{len(v2) // 4}f", v2))
                elif f2 == 1 and wt2 == _I32:
                    float_vals.append(struct.unpack("<f", v2)[0])
        elif field == 3 and wire_type == _LEN:  # Int64List
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 1 and wt2 == _LEN:  # packed
                    pos = 0
                    while pos < len(v2):
                        v, pos = _decode_varint(v2, pos)
                        int_vals.append(
                            v - (1 << 64) if v >= 1 << 63 else v)
                elif f2 == 1 and wt2 == _VARINT:
                    v = int(v2)
                    int_vals.append(v - (1 << 64) if v >= 1 << 63 else v)
    if bytes_vals:
        return bytes_vals
    if float_vals:
        return np.asarray(float_vals, np.float32)
    return np.asarray(int_vals, np.int64)


def encode_classification_request(model_name: str,
                                  examples: List[Dict[str, object]],
                                  signature_name: str = "",
                                  version: Optional[int] = None) -> bytes:
    example_list = b"".join(
        _field_bytes(1, encode_example(ex)) for ex in examples)
    return (_field_bytes(1, encode_model_spec(model_name, version,
                                              signature_name))
            + _field_bytes(2, _field_bytes(1, example_list)))


def decode_classification_request(buf: bytes):
    """→ (model_spec dict, [example feature dicts])."""
    spec: Dict[str, object] = {"name": "", "version": None,
                               "signature_name": ""}
    examples: List[Dict[str, object]] = []
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _LEN:
            spec = decode_model_spec(value)
        elif field == 2 and wire_type == _LEN:  # Input
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 1 and wt2 == _LEN:  # ExampleList
                    for f3, wt3, v3 in _iter_fields(v2):
                        if f3 == 1 and wt3 == _LEN:
                            examples.append(decode_example(v3))
                elif f2 == 2 and wt2 == _LEN:
                    raise ValueError(
                        "ExampleListWithContext is not supported")
    return spec, examples


def encode_classification_response(
        classifications: List[List[Tuple[str, float]]],
        model_name: str, version: Optional[int] = None) -> bytes:
    """[[(label, score), ...] per example] → ClassificationResponse."""
    result = b""
    for classes in classifications:
        row = b"".join(
            _field_bytes(1, _field_bytes(1, label.encode())
                         + _tag(2, _I32) + struct.pack("<f", score))
            for label, score in classes)
        result += _field_bytes(1, row)  # Classifications
    return (_field_bytes(1, result)
            + _field_bytes(2, encode_model_spec(model_name, version)))


def decode_classification_response(buf: bytes):
    """→ (model_spec dict, [[(label, score), ...] per example])."""
    spec: Dict[str, object] = {"name": "", "version": None,
                               "signature_name": ""}
    classifications: List[List[Tuple[str, float]]] = []
    for field, wire_type, value in _iter_fields(buf):
        if field == 2 and wire_type == _LEN:
            spec = decode_model_spec(value)
        elif field == 1 and wire_type == _LEN:  # ClassificationResult
            for f2, wt2, v2 in _iter_fields(value):
                if f2 != 1 or wt2 != _LEN:
                    continue
                classes: List[Tuple[str, float]] = []
                for f3, wt3, v3 in _iter_fields(v2):
                    if f3 != 1 or wt3 != _LEN:
                        continue
                    label, score = "", 0.0
                    for f4, wt4, v4 in _iter_fields(v3):
                        if f4 == 1 and wt4 == _LEN:
                            label = bytes(v4).decode()
                        elif f4 == 2 and wt4 == _I32:
                            score = struct.unpack("<f", v4)[0]
                    classes.append((label, score))
                classifications.append(classes)
    return spec, classifications


# --- GetModelMetadata / SignatureDefMap -------------------------------------

SIGNATURE_DEF_TYPE_URL = (
    "type.googleapis.com/tensorflow.serving.SignatureDefMap")


def encode_get_model_metadata_request(
        model_name: str, metadata_fields: Tuple[str, ...] = ("signature_def",),
        version: Optional[int] = None) -> bytes:
    out = _field_bytes(1, encode_model_spec(model_name, version))
    for f in metadata_fields:
        out += _field_bytes(2, f.encode())
    return out


def decode_get_model_metadata_request(buf: bytes):
    """→ (model_spec dict, [metadata_field])."""
    spec: Dict[str, object] = {"name": "", "version": None,
                               "signature_name": ""}
    fields: List[str] = []
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _LEN:
            spec = decode_model_spec(value)
        elif field == 2 and wire_type == _LEN:
            fields.append(bytes(value).decode())
    return spec, fields


def _encode_tensor_info(name: str, dtype: str,
                        shape: Tuple[int, ...]) -> bytes:
    dt = _DT_FROM_STR.get(dtype)
    if dt is None:
        raise ValueError(f"unsupported signature dtype {dtype!r}")
    dims = b"".join(_field_bytes(2, _field_varint(1, d & (1 << 64) - 1))
                    for d in shape)
    return (_field_bytes(1, name.encode())
            + _field_varint(2, dt)
            + _field_bytes(3, dims))


def _decode_tensor_info(buf: bytes) -> Dict[str, object]:
    info: Dict[str, object] = {"name": "", "dtype": 0, "shape": []}
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _LEN:
            info["name"] = bytes(value).decode()
        elif field == 2 and wire_type == _VARINT:
            info["dtype"] = int(value)
        elif field == 3 and wire_type == _LEN:
            dims: List[int] = []
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 2 and wt2 == _LEN:
                    for f3, wt3, v3 in _iter_fields(v2):
                        if f3 == 1 and wt3 == _VARINT:
                            size = int(v3)
                            dims.append(
                                size - (1 << 64) if size >= 1 << 63
                                else size)
            info["shape"] = dims
    return info


def encode_signature_def_map(signatures: Dict[str, Dict[str, object]]
                             ) -> bytes:
    """{sig_name: {"method": str, "inputs": {n: (dtype, shape)},
    "outputs": ...}} → SignatureDefMap bytes."""
    out = b""
    for sig_name, sig in signatures.items():
        body = b""
        for field_no, key in ((1, "inputs"), (2, "outputs")):
            for tensor_name, (dtype, shape) in sig[key].items():
                entry = (_field_bytes(1, tensor_name.encode())
                         + _field_bytes(2, _encode_tensor_info(
                             tensor_name, dtype, tuple(shape))))
                body += _field_bytes(field_no, entry)
        body += _field_bytes(
            3, f"tensorflow/serving/{sig['method']}".encode())
        entry = _field_bytes(1, sig_name.encode()) + _field_bytes(2, body)
        out += _field_bytes(1, entry)
    return out


def decode_signature_def_map(buf: bytes) -> Dict[str, Dict[str, object]]:
    sigs: Dict[str, Dict[str, object]] = {}
    for field, wire_type, value in _iter_fields(buf):
        if field != 1 or wire_type != _LEN:
            continue
        name = ""
        sig: Dict[str, object] = {"inputs": {}, "outputs": {},
                                  "method_name": ""}
        for f2, wt2, v2 in _iter_fields(value):
            if f2 == 1 and wt2 == _LEN:
                name = bytes(v2).decode()
            elif f2 == 2 and wt2 == _LEN:  # SignatureDef
                for f3, wt3, v3 in _iter_fields(v2):
                    if f3 in (1, 2) and wt3 == _LEN:
                        key = "inputs" if f3 == 1 else "outputs"
                        tname, tinfo = "", None
                        for f4, wt4, v4 in _iter_fields(v3):
                            if f4 == 1 and wt4 == _LEN:
                                tname = bytes(v4).decode()
                            elif f4 == 2 and wt4 == _LEN:
                                tinfo = _decode_tensor_info(v4)
                        if tname and tinfo is not None:
                            sig[key][tname] = tinfo
                    elif f3 == 3 and wt3 == _LEN:
                        sig["method_name"] = bytes(v3).decode()
        if name:
            sigs[name] = sig
    return sigs


def encode_get_model_metadata_response(
        model_name: str, version: Optional[int],
        signatures: Dict[str, Dict[str, object]]) -> bytes:
    """signatures in encode_signature_def_map's shape; packed into the
    response's metadata["signature_def"] google.protobuf.Any."""
    any_msg = (_field_bytes(1, SIGNATURE_DEF_TYPE_URL.encode())
               + _field_bytes(2, encode_signature_def_map(signatures)))
    entry = (_field_bytes(1, b"signature_def")
             + _field_bytes(2, any_msg))
    return (_field_bytes(1, encode_model_spec(model_name, version))
            + _field_bytes(2, entry))


def decode_get_model_metadata_response(buf: bytes):
    """→ (model_spec dict, {sig_name: signature dict}). Unpacks the
    signature_def Any; other metadata keys are ignored."""
    spec: Dict[str, object] = {"name": "", "version": None,
                               "signature_name": ""}
    sigs: Dict[str, Dict[str, object]] = {}
    for field, wire_type, value in _iter_fields(buf):
        if field == 1 and wire_type == _LEN:
            spec = decode_model_spec(value)
        elif field == 2 and wire_type == _LEN:  # metadata map entry
            key, type_url, packed = "", "", b""
            for f2, wt2, v2 in _iter_fields(value):
                if f2 == 1 and wt2 == _LEN:
                    key = bytes(v2).decode()
                elif f2 == 2 and wt2 == _LEN:  # Any
                    for f3, wt3, v3 in _iter_fields(v2):
                        if f3 == 1 and wt3 == _LEN:
                            type_url = bytes(v3).decode()
                        elif f3 == 2 and wt3 == _LEN:
                            packed = bytes(v3)
            if key == "signature_def":
                if type_url != SIGNATURE_DEF_TYPE_URL:
                    raise ValueError(
                        f"unexpected Any type_url {type_url!r}")
                sigs = decode_signature_def_map(packed)
    return spec, sigs


DT_TO_STR = {v: k for k, v in _DT_FROM_STR.items()}


# --- gRPC timeout header codec ---------------------------------------------
#
# gRPC carries the request deadline on the wire as the ``grpc-timeout``
# header/metadata: ASCII digits (max 8) plus a single unit letter
# (H hours, M minutes, S seconds, m milli, u micro, n nano). grpcio
# encodes/decodes it natively for the :9000 listener; the gRPC-Web
# bridge sees it as a plain HTTP header and needs this codec.

_GRPC_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0,
                       "m": 1e-3, "u": 1e-6, "n": 1e-9}


def parse_grpc_timeout(value: str) -> float:
    """``grpc-timeout`` header value → seconds. Raises ValueError on
    anything that isn't digits+unit (a deadline the server can't read
    must be rejected, not silently served unbounded)."""
    value = value.strip()
    if len(value) < 2 or value[-1] not in _GRPC_TIMEOUT_UNITS:
        raise ValueError(f"malformed grpc-timeout {value!r}")
    digits = value[:-1]
    if not digits.isdigit() or len(digits) > 8:
        raise ValueError(f"malformed grpc-timeout {value!r}")
    return int(digits) * _GRPC_TIMEOUT_UNITS[value[-1]]


def format_grpc_timeout(seconds: float) -> str:
    """Seconds → ``grpc-timeout`` value, finest unit that fits the
    8-digit budget (sub-millisecond budgets round up to 1m: a 0 would
    mean 'already expired' at the receiver, which is the sender's
    call, not a formatting artifact)."""
    if seconds <= 0:
        return "0m"
    for unit, scale in (("m", 1e-3), ("S", 1.0), ("M", 60.0), ("H", 3600.0)):
        count = max(1, int(-(-seconds // scale)))  # ceil
        if count < 10 ** 8:
            return f"{count}{unit}"
    raise ValueError(f"timeout {seconds}s too large for grpc-timeout")


# --- gRPC / gRPC-Web framing -----------------------------------------------

GRPC_WEB_CONTENT_TYPES = (
    "application/grpc-web+proto",
    "application/grpc-web",
    "application/grpc+proto",
    "application/grpc",
)


def frame_message(message: bytes, *, trailers: bool = False) -> bytes:
    """One gRPC length-prefixed frame: flags(1) + len(4, BE) + body."""
    flags = 0x80 if trailers else 0x00
    return struct.pack(">BI", flags, len(message)) + message


def unframe_messages(body: bytes) -> List[Tuple[int, bytes]]:
    """→ [(flags, message_bytes)] (data frames and trailer frames)."""
    frames = []
    pos = 0
    while pos + 5 <= len(body):
        flags, length = struct.unpack(">BI", body[pos:pos + 5])
        pos += 5
        frames.append((flags, body[pos:pos + length]))
        pos += length
    return frames


def trailers_frame(status: int = 0, message: str = "") -> bytes:
    text = f"grpc-status:{status}\r\n"
    if message:
        text += f"grpc-message:{message}\r\n"
    return frame_message(text.encode(), trailers=True)


# --- Server-sent events (SSE) -----------------------------------------------
#
# The REST streaming-generate wire (WHATWG EventSource framing): each
# event is an optional ``event:`` line, one ``data:`` line of JSON,
# and a blank terminator. Used by serving/server.py (producer),
# http_proxy.py (chunk passthrough) and serving/client.py --stream
# (consumer); tests/test_streaming_wire.py pins the framing.

SSE_CONTENT_TYPE = "text/event-stream"

#: Streaming-generate event names: ``token`` (one sampled token),
#: ``error`` (a row failed mid-stream; carries ``code``), ``done``
#: (terminal; carries the per-row token arrays). Engine streams asked
#: for it (``emit_resume`` in the request body — the proxy asks, and
#: strips the event before the client sees it) additionally lead with
#: one ``resume`` event per row carrying the opaque resume blob.
SSE_EVENTS = ("token", "error", "done")

#: SSE comment frame emitted during long inter-token gaps: comments
#: are invisible to EventSource consumers (``iter_sse_events`` skips
#: them) but keep intermediaries' idle
#: timers fed and give the proxy's inter-chunk-gap tracker a bounded
#: healthy ceiling — a gap well past the keepalive cadence now means
#: a WEDGED stream, not a slow decode.
SSE_KEEPALIVE = b": keepalive\n\n"


def format_sse_event(data, event: Optional[str] = None) -> bytes:
    """One SSE frame. ``data`` is JSON-encoded onto a single ``data:``
    line (json.dumps never emits raw newlines, which would otherwise
    split the frame)."""
    import json

    out = b""
    if event:
        if any(c in event for c in "\r\n"):
            raise ValueError(f"SSE event name {event!r} contains a "
                             f"newline")
        out += f"event: {event}\n".encode()
    out += b"data: " + json.dumps(data).encode() + b"\n\n"
    return out


def iter_sse_events(line_iter) -> Iterator[Tuple[str, dict]]:
    """Parse an SSE byte-line stream → (event_name, data) pairs.
    ``line_iter`` yields ``bytes`` lines (an ``http.client``
    response works directly); event name defaults to ``message`` per
    the EventSource spec. Multi-``data:``-line events are joined with
    newlines before JSON decoding."""
    import json

    event = None
    data_lines: List[str] = []
    for raw in line_iter:
        line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
        if line.startswith(":"):
            continue  # comment / keep-alive
        if line == "":
            if data_lines:
                yield (event or "message",
                       json.loads("\n".join(data_lines)))
            event = None
            data_lines = []
            continue
        key, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if key == "event":
            event = value
        elif key == "data":
            data_lines.append(value)
    if data_lines:  # stream ended without the trailing blank line
        yield (event or "message", json.loads("\n".join(data_lines)))


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
                        max_new_tokens: int,
                        prompt_len: Optional[int] = None) -> bytes:
    """Serialize one stream's resume context: the full context ids and
    the ORIGINAL per-token sampling schedule (re-deriving it with
    another budget would fork the sampled sequence). No cache: the
    replica that held the pages is the one that died, and the peer
    re-prefills the context.

    ``prompt_len`` is the length of the original prompt inside
    ``prompt_tokens``. It is written, as one extra key, only when the
    context is longer than that: a stream that was itself resumed
    holds its first life's emitted tokens in its context, and the
    next replica needs the split to replay them on the decode route.
    A first-life token carries no such key and is byte-equal to the
    reference's; the reference's decoder reads named keys only, so it
    accepts either."""
    doc = {
        "format": np.int32(RESUME_TOKEN_FORMAT),
        "kind": "resume",
        "model": model,
        "version": np.int32(version),
        "prompt_tokens": np.asarray(prompt_tokens, np.int32),
        "step_keys": np.asarray(step_keys, np.uint32),
        "max_new_tokens": np.int32(max_new_tokens),
    }
    if prompt_len is not None and \
            int(prompt_len) < doc["prompt_tokens"].size:
        doc["prompt_len"] = np.int32(prompt_len)
    return flax_msgpack.dumps(doc)


def decode_resume_token(data: bytes, *, model: str,
                        version: Optional[int] = None) -> Dict[str, object]:
    """Parse and validate a resume token against the resuming replica's
    (model, version). Returns ``{"model", "version", "prompt_tokens",
    "step_keys", "max_new_tokens"}``, plus ``"prompt_len"`` where the
    token carries it (:func:`encode_resume_token`). Raises ValueError on any mismatch
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
    prompt = np.asarray(doc["prompt_tokens"], np.int32)
    out = {
        "model": str(doc["model"]),
        "version": int(doc["version"]),
        "prompt_tokens": prompt,
        "step_keys": keys,
        "max_new_tokens": int(doc["max_new_tokens"]),
    }
    if doc.get("prompt_len") is not None:
        prompt_len = int(doc["prompt_len"])
        if not 1 <= prompt_len <= prompt.size:
            raise ValueError(
                f"resume token prompt_len {prompt_len} outside [1, "
                f"{prompt.size}] (its context)")
        out["prompt_len"] = prompt_len
    return out


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
