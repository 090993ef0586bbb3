"""Hand-rolled protobuf wire encoding for the gRPC ModelInfer hot response.

A copy of the JAX package's serving/pb_wire.py, bytes included: the
generic-handler gRPC stack costs three full copies of the OUTPUT0 payload
per response (ndarray.tobytes -> message bytes field -> SerializeToString)
plus the message build; this writer frames the response straight from the
output buffer (one bytearray append + the bytes() conversion cygrpc
demands) and the method handler's response_serializer passes the bytes
through untouched.

The repeated ``InferOutputTensor.shape`` is written unpacked (one tag per
element), as the JAX package writes it; proto3 parsers accept both forms,
and keeping the reference's bytes lets a test compare the two packages'
responses byte for byte (ROADMAP queue C lists this as a fault of the
reference).

Field numbers from serving/kserve_v2.proto (ModelInferResponse:111-125;
InferOutputTensor name/datatype/shape/..; InferParameter oneof):
exactness vs the protoc-generated serializer is pinned by a round trip
through the generated pb2 in tests/test_torch_grpc.py.
"""

from __future__ import annotations


def _varint(buf: bytearray, v: int) -> None:
    # Negative ints would loop forever under Python's arithmetic shift;
    # encode two's-complement like protobuf does.
    v &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _tag(buf: bytearray, field: int, wire_type: int) -> None:
    _varint(buf, (field << 3) | wire_type)


def _string(buf: bytearray, field: int, s: bytes) -> None:
    if s:
        _tag(buf, field, 2)
        _varint(buf, len(s))
        buf += s


def _int64_param_entry(field: int, key: bytes, value: int) -> bytearray:
    """One parameters map entry: map<string, InferParameter{int64_param}>."""
    val = bytearray()  # InferParameter: int64_param = field 2, varint
    _tag(val, 2, 0)
    _varint(val, value & 0xFFFFFFFFFFFFFFFF)
    entry = bytearray()  # MapEntry: key = 1 (string), value = 2 (message)
    _string(entry, 1, key)
    _tag(entry, 2, 2)
    _varint(entry, len(val))
    entry += val
    out = bytearray()
    _tag(out, field, 2)
    _varint(out, len(entry))
    out += entry
    return out


def infer_response_bytes(
    model_name: str,
    model_version: str,
    request_id: str,
    int64_params: "dict[str, int]",
    output_name: str,
    datatype: str,
    shape: "list[int]",
    raw,  # buffer-protocol object (np array / memoryview / bytes)
) -> bytes:
    """Serialized ModelInferResponse with ONE raw output tensor.

    Two payload copies total: the bytearray append from ``raw``'s buffer
    and the final bytes() conversion — grpc's cygrpc layer REQUIRES a
    bytes message (returning the bytearray raises TypeError in
    SendMessageOperation; verified against grpcio). Still replaces the
    generated path's three copies plus message build + SerializeToString."""
    mv = memoryview(raw).cast("B")
    buf = bytearray()
    _string(buf, 1, model_name.encode())
    _string(buf, 2, model_version.encode())
    if request_id:
        _string(buf, 3, request_id.encode())
    for k, v in int64_params.items():
        buf += _int64_param_entry(4, k.encode(), int(v))
    # outputs[0]: InferOutputTensor{name, datatype, shape}
    tensor = bytearray()
    _string(tensor, 1, output_name.encode())
    _string(tensor, 2, datatype.encode())
    for d in shape:
        _tag(tensor, 3, 0)
        _varint(tensor, int(d) & 0xFFFFFFFFFFFFFFFF)
    _tag(buf, 5, 2)
    _varint(buf, len(tensor))
    buf += tensor
    # raw_output_contents[0]
    _tag(buf, 6, 2)
    _varint(buf, mv.nbytes)
    buf += mv
    return bytes(buf)
