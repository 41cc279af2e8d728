"""Minimal TensorBoard event-file writer (no TF dependency; a copy of
e2e_asr_tpu/core/summary.py, on the port's own protobuf and TFRecord
helpers).

Writes tfevents files readable by TensorBoard: a TFRecord stream of Event
protos carrying scalar Summary values — the equivalent of the reference's
tf.summary.FileWriter + manual scalar summaries (train.py:219-220,
tf_utils.py:14-15).

Wire format (field numbers from tensorflow/core/util/event.proto):
    Event  { double wall_time=1; int64 step=2; Summary summary=5 }
    Summary{ repeated Value value=1 }
    Value  { string tag=1; float simple_value=2 }
"""
from __future__ import annotations

import os
import socket
import struct
import time

from e2e_asr_tpu_torch.data import example as pb
from e2e_asr_tpu_torch.data.tfrecord import masked_crc


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(logdir, fname), "ab")
        # TensorBoard expects a leading file-version event.
        self._write_event(self._encode_event(
            wall_time=time.time(), step=0, file_version=b"brain.Event:2"))

    def _encode_event(self, wall_time: float, step: int,
                      summary: bytes | None = None,
                      file_version: bytes | None = None) -> bytes:
        out = bytearray()
        pb.write_varint(out, (1 << 3) | 1)            # wall_time, 64-bit
        out += struct.pack("<d", wall_time)
        pb.write_varint(out, (2 << 3) | 0)            # step, varint
        pb.write_varint(out, step & 0xFFFFFFFFFFFFFFFF)
        if file_version is not None:
            pb.write_len_delimited(out, 3, file_version)
        if summary is not None:
            pb.write_len_delimited(out, 5, summary)
        return bytes(out)

    def scalar(self, tag: str, value: float, step: int) -> None:
        val = bytearray()
        pb.write_len_delimited(val, 1, tag.encode())
        pb.write_varint(val, (2 << 3) | 5)            # simple_value, 32-bit
        val += struct.pack("<f", float(value))
        summary = bytearray()
        pb.write_len_delimited(summary, 1, bytes(val))
        self._write_event(self._encode_event(time.time(), step, bytes(summary)))

    def _write_event(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc(payload)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class NullWriter:
    """Drop-in no-op SummaryWriter for a process that does not own the run
    directory's event files (the JAX package's multi-host Trainer gives
    one to every process but the first)."""

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def close(self) -> None:
        pass
