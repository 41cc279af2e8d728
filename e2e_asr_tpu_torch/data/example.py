"""Minimal protobuf wire-format codec for tf.train.SequenceExample: a copy
of e2e_asr_tpu/data/example.py (the port imports nothing of the JAX
package).

Implements exactly the message shapes of the corpus schema:

    Feature        { BytesList bytes_list=1; FloatList float_list=2;
                     Int64List int64_list=3 }   (each: repeated value=1)
    Features       { map<string, Feature> feature=1 }
    FeatureList    { repeated Feature feature=1 }
    FeatureLists   { map<string, FeatureList> feature_list=1 }
    SequenceExample{ Features context=1; FeatureLists feature_lists=2 }

Packed floats/ints decode via numpy frombuffer (fast path); unpacked repeated
fields are also handled. No protobuf runtime dependency.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


# ---------------------------------------------------------------------------
# Varint / wire primitives
# ---------------------------------------------------------------------------

def write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag_decode_signed(value: int) -> int:
    """int64 fields are stored as two's-complement varints (not zigzag)."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    write_varint(out, _tag(field, _WIRE_LEN))
    write_varint(out, len(payload))
    out += payload


def iter_fields(data: bytes) -> Iterator[tuple[int, int, object, int]]:
    """Yield (field_number, wire_type, value, end_pos) over a message."""
    pos, end = 0, len(data)
    while pos < end:
        tag, pos = read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            value, pos = read_varint(data, pos)
        elif wire == _WIRE_LEN:
            length, pos = read_varint(data, pos)
            value = data[pos:pos + length]
            pos += length
        elif wire == _WIRE_64BIT:
            value = data[pos:pos + 8]
            pos += 8
        elif wire == _WIRE_32BIT:
            value = data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value, pos


# ---------------------------------------------------------------------------
# Feature encode/decode
# ---------------------------------------------------------------------------

def encode_bytes_feature(value: bytes) -> bytes:
    inner = bytearray()
    write_len_delimited(inner, 1, value)          # BytesList.value
    out = bytearray()
    write_len_delimited(out, 1, bytes(inner))     # Feature.bytes_list
    return bytes(out)


def encode_float_feature(values: np.ndarray) -> bytes:
    payload = np.asarray(values, dtype="<f4").tobytes()
    inner = bytearray()
    write_len_delimited(inner, 1, payload)        # FloatList.value (packed)
    out = bytearray()
    write_len_delimited(out, 2, bytes(inner))     # Feature.float_list
    return bytes(out)


def encode_int64_feature(values) -> bytes:
    inner = bytearray()
    packed = bytearray()
    for v in np.asarray(values, dtype=np.int64).tolist():
        write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
    write_len_delimited(inner, 1, bytes(packed))  # Int64List.value (packed)
    out = bytearray()
    write_len_delimited(out, 3, bytes(inner))     # Feature.int64_list
    return bytes(out)


def decode_feature(data: bytes):
    """Feature -> bytes | np.ndarray(float32) | np.ndarray(int64)."""
    for field, wire, value, _ in iter_fields(data):
        if field == 1:   # bytes_list
            for f2, _, v2, _ in iter_fields(value):
                if f2 == 1:
                    return v2
            return b""
        if field == 2:   # float_list
            floats = []
            for f2, w2, v2, _ in iter_fields(value):
                if f2 == 1:
                    if w2 == _WIRE_LEN:  # packed
                        floats.append(np.frombuffer(v2, dtype="<f4"))
                    else:                # unpacked 32-bit
                        floats.append(np.frombuffer(v2, dtype="<f4"))
            return (np.concatenate(floats) if floats
                    else np.zeros(0, np.float32))
        if field == 3:   # int64_list
            ints = []
            for f2, w2, v2, _ in iter_fields(value):
                if f2 == 1:
                    if w2 == _WIRE_LEN:  # packed varints
                        pos = 0
                        while pos < len(v2):
                            raw, pos = read_varint(v2, pos)
                            ints.append(_zigzag_decode_signed(raw))
                    else:
                        ints.append(_zigzag_decode_signed(v2))
            return np.asarray(ints, dtype=np.int64)
    return None


# ---------------------------------------------------------------------------
# SequenceExample
# ---------------------------------------------------------------------------

def encode_sequence_example(context: dict[str, bytes],
                            feature_lists: dict[str, list[bytes]]) -> bytes:
    """context: name -> encoded Feature; feature_lists: name -> [Feature...]."""
    ctx = bytearray()
    for name, feat in context.items():
        entry = bytearray()
        write_len_delimited(entry, 1, name.encode())
        write_len_delimited(entry, 2, feat)
        write_len_delimited(ctx, 1, bytes(entry))   # Features.feature map entry

    fls = bytearray()
    for name, feats in feature_lists.items():
        fl = bytearray()
        for feat in feats:
            write_len_delimited(fl, 1, feat)        # FeatureList.feature
        entry = bytearray()
        write_len_delimited(entry, 1, name.encode())
        write_len_delimited(entry, 2, bytes(fl))
        write_len_delimited(fls, 1, bytes(entry))   # FeatureLists map entry

    out = bytearray()
    write_len_delimited(out, 1, bytes(ctx))         # SequenceExample.context
    write_len_delimited(out, 2, bytes(fls))         # .feature_lists
    return bytes(out)


def decode_sequence_example(data: bytes) -> tuple[dict, dict]:
    """Returns (context: name -> decoded value,
                feature_lists: name -> list of decoded values)."""
    context: dict = {}
    feature_lists: dict = {}
    for field, _, value, _ in iter_fields(data):
        if field == 1:      # context: Features
            for f2, _, entry, _ in iter_fields(value):
                if f2 != 1:
                    continue
                name, feat = None, None
                for f3, _, v3, _ in iter_fields(entry):
                    if f3 == 1:
                        name = v3.decode()
                    elif f3 == 2:
                        feat = decode_feature(v3)
                if name is not None:
                    context[name] = feat
        elif field == 2:    # feature_lists
            for f2, _, entry, _ in iter_fields(value):
                if f2 != 1:
                    continue
                name, feats = None, []
                for f3, _, v3, _ in iter_fields(entry):
                    if f3 == 1:
                        name = v3.decode()
                    elif f3 == 2:
                        for f4, _, v4, _ in iter_fields(v3):
                            if f4 == 1:
                                feats.append(decode_feature(v4))
                if name is not None:
                    feature_lists[name] = feats
    return context, feature_lists
