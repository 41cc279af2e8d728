"""TFRecord container format: read / write without TensorFlow (a copy of
e2e_asr_tpu/data/tfrecord.py, with a faster CRC of the same value).

The on-disk framing of the corpus files:

    [uint64 length (LE)] [uint32 masked_crc32c(length)] [data]
    [uint32 masked_crc32c(data)]

CRC32C is the Castagnoli polynomial (reflected 0x82F63B78) with TFRecord's
masking: rotate-right-15 + 0xa282ead8. The CRC register update is linear
over GF(2), so a long record is cut into lanes of _LANE bytes whose
registers numpy advances together, and the lanes are then chained with the
linear map "advance the register over _LANE zero bytes" (crc32c_combine):
the same value as the byte-by-byte loop at a fraction of its cost, which
matters when a corpus of full-size utterances is written.
"""
from __future__ import annotations

import functools
import os
import struct
from typing import Iterator

import numpy as np

_MASK_DELTA = 0xA282EAD8


def _make_crc32c_table() -> np.ndarray:
    poly = 0x82F63B78
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_crc32c_table()
_TABLE_LIST = [int(v) for v in _TABLE]
_LANE = 256   # bytes per lane of the vectorized CRC


def _advance(data: bytes, reg: int) -> int:
    """The raw CRC register after `data`, byte by byte."""
    table = _TABLE_LIST
    for b in data:
        reg = (reg >> 8) ^ table[(reg ^ b) & 0xFF]
    return reg


@functools.cache
def _zeros_tables(n: int) -> tuple:
    """The linear map "advance the register over n zero bytes" as four
    tables, one per byte of the register."""
    cols = [_advance(bytes(n), 1 << k) for k in range(32)]
    tables = []
    for byte in range(4):
        t = []
        for v in range(256):
            acc = 0
            for bit in range(8):
                if v >> bit & 1:
                    acc ^= cols[8 * byte + bit]
            t.append(acc)
        tables.append(t)
    return tuple(tables)


def crc32c(data: bytes) -> int:
    """CRC32C of `data`: lanes of _LANE bytes advanced together by numpy
    from a zero register, chained in order, the tail byte by byte."""
    n = len(data) // _LANE
    reg = 0xFFFFFFFF
    if n >= 2:
        lanes = np.frombuffer(data, np.uint8, count=n * _LANE).reshape(
            n, _LANE)
        regs = np.zeros(n, np.uint32)
        for j in range(_LANE):
            regs = (regs >> 8) ^ _TABLE[(regs ^ lanes[:, j]) & 0xFF]
        t0, t1, t2, t3 = _zeros_tables(_LANE)
        for r in regs.tolist():
            reg = (t0[reg & 0xFF] ^ t1[(reg >> 8) & 0xFF]
                   ^ t2[(reg >> 16) & 0xFF] ^ t3[reg >> 24] ^ r)
        data = data[n * _LANE:]
    return _advance(data, reg) ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def write_records(path: str, records: Iterator[bytes]) -> int:
    """Write records to a TFRecord file. Returns the count."""
    n = 0
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc(rec)))
            n += 1
    os.replace(tmp, path)
    return n


def read_records(path: str, *, verify: bool = False) -> Iterator[bytes]:
    """Iterate raw records from a TFRecord file."""
    with open(path, "rb") as f:
        data = f.read()
    pos, end = 0, len(data)
    while pos < end:
        if pos + 12 > end:
            raise ValueError(f"truncated record header in {path} @ {pos}")
        (length,) = struct.unpack_from("<Q", data, pos)
        if verify:
            (len_crc,) = struct.unpack_from("<I", data, pos + 8)
            if masked_crc(data[pos:pos + 8]) != len_crc:
                raise ValueError(f"length CRC mismatch in {path} @ {pos}")
        pos += 12
        if pos + length + 4 > end:
            raise ValueError(f"truncated record body in {path} @ {pos}")
        rec = data[pos:pos + length]
        if verify:
            (rec_crc,) = struct.unpack_from("<I", data, pos + length)
            if masked_crc(rec) != rec_crc:
                raise ValueError(f"data CRC mismatch in {path} @ {pos}")
        pos += length + 4
        yield rec
