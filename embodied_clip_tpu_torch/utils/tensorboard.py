"""Minimal, dependency-free TensorBoard event writer (a copy of
`embodied_clip_tpu/utils/tensorboard.py`, which is pure Python).

The reference logs scalars via pytorch-lightning's TensorBoardLogger keyed
`{prediction_type}/{embedding_type}` (train.py:139-143) and documents
`tensorboard --logdir logs` as the dashboard (readme_files/primitive_probing.md:57).
This writer emits the same on-disk format (TFRecord-framed Event protos with masked
crc32c) using hand-rolled protobuf wire encoding — no tensorflow/tensorboard dep.
"""

from __future__ import annotations

import os
import struct
import time

__all__ = ["SummaryWriter"]


# ---------------------------------------------------------------- crc32c (Castagnoli)

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf wire encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_str(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode("utf-8"))


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    return _pb_str(1, tag) + _pb_float(2, float(value))


def _event(step: int, tag: str, value: float, wall_time: float) -> bytes:
    # Event: wall_time=1 (double), step=2 (int64), summary=5 (Summary)
    summary = _pb_bytes(1, _summary_value(tag, value))  # Summary.value = field 1
    return _pb_double(1, wall_time) + _pb_int64(2, step) + _pb_bytes(5, summary)


class SummaryWriter:
    """Writes `events.out.tfevents.*` files readable by TensorBoard."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.uname().nodename}"
        self._f = open(os.path.join(log_dir, fname), "ab")
        # file_version header event
        header = _pb_double(1, time.time()) + _pb_str(3, "brain.Event:2")
        self._write_record(header)

    def _write_record(self, data: bytes):
        length = struct.pack("<Q", len(data))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int, wall_time: float | None = None):
        self._write_record(_event(step, tag, value, wall_time or time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.flush()
        self._f.close()
