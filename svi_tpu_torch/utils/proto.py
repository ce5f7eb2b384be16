"""Protocol-buffer wire format: the two readers the sentencepiece tokenizer
needs to parse a `spiece.model` ModelProto (a copy of svi_tpu's helpers in
`utils/onnx_jax.py`, so the port reads no module of the JAX package)."""

from __future__ import annotations


def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a serialized message.
    value: int for varint(0), bytes for fixed(1, 5), memoryview for
    length-delimited(2)."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:  # wire types 3/4 (groups) appear in no message read here
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, val
