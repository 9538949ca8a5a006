"""Minimal TensorBoard event-file writer with no TensorFlow or
TensorBoard dependency; the port's copy of ``nhans_tpu/utils/tb_events.py``.

Scalar summaries are written as standard ``events.out.tfevents`` files
that ``tensorboard --logdir`` renders; the JSONL file of
``train/metrics.py`` stays the machine-readable record.

The format is hand-encoded (the two protos involved are tiny and frozen):

* TFRecord framing: ``uint64 len | uint32 masked_crc32c(len) | data |
  uint32 masked_crc32c(data)``; CRC32C (Castagnoli), masked as
  ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``.
* ``Event`` proto: field 1 ``wall_time`` (double), field 2 ``step``
  (int64), field 3 ``file_version`` (string, first record only),
  field 5 ``summary`` (message).
* ``Summary`` proto: repeated field 1 ``value``; ``Summary.Value``:
  field 1 ``tag`` (string), field 2 ``simple_value`` (float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

# ---------------------------------------------------------------- CRC32C
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reversed Castagnoli polynomial
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negatives (int64 semantics)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def _event(wall_time: float, step: int = 0, file_version: str = "",
           scalars: Dict[str, float] = None) -> bytes:
    msg = _field_double(1, wall_time) + _field_varint(2, step)
    if file_version:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode())
                         + _field_float(2, float(v)))
            for tag, v in scalars.items())
        msg += _field_bytes(5, summary)
    return msg


# --------------------------------------------------------------- writer
class EventFileWriter:
    """Append-only scalar-summary writer, one events file per run."""

    def __init__(self, logdir: str, name_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "host"
        # <ts>.<host>.<pid> matches TF's convention and keeps two runs
        # started within the same second from appending to one file
        fname = (f"events.out.tfevents.{int(time.time())}.{host}"
                 f".{os.getpid()}"
                 f"{('.' + name_suffix) if name_suffix else ''}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), 0, file_version="brain.Event:2"))
        self._f.flush()

    def _record(self, data: bytes) -> None:
        hdr = struct.pack("<Q", len(data))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        clean = {k: float(v) for k, v in scalars.items()
                 if isinstance(v, (int, float))}
        if not clean:
            return
        self._record(_event(time.time(), int(step), scalars=clean))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
