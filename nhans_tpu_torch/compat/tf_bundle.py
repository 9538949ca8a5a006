"""Minimal pure-Python reader for TensorFlow's tensor-bundle checkpoint
format (the ``tf.train.Saver`` V2 format used by the reference's
``trained_model/`` triplets, reference main.py:427-434).

A bundle is ``prefix.index`` (a LevelDB-table/SSTable mapping tensor names
to serialized BundleEntryProto) plus ``prefix.data-XXXXX-of-YYYYY`` shard
files holding raw little-endian tensor bytes.  We hand-parse both — the
wire formats are small and stable — so the published N-HANS weights can be
imported without a TensorFlow install.

Format references (public): tensorflow/core/util/tensor_bundle and
leveldb's table_format.md.

The port's copy of ``nhans_tpu/compat/tf_bundle.py``: numpy only, kept
here because importing any ``nhans_tpu`` module imports JAX.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Tuple

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

# tensorflow DataType enum -> numpy (subset that appears in checkpoints)
_TF_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 14: np.dtype("bfloat16")
    if hasattr(np, "bfloat16") else np.uint16, 17: np.uint16,
    19: np.float16, 22: np.uint32, 23: np.uint64,
}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


class _Proto:
    """Tiny protobuf wire-format walker: yields (field_number, wire_type,
    value) where value is int (varint), bytes (length-delimited) or raw."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def fields(self) -> Iterator[Tuple[int, int, object]]:
        buf, pos = self.buf, 0
        while pos < len(buf):
            tag, pos = _varint(buf, pos)
            field, wtype = tag >> 3, tag & 7
            if wtype == 0:
                val, pos = _varint(buf, pos)
            elif wtype == 1:
                val = struct.unpack("<Q", buf[pos:pos + 8])[0]
                pos += 8
            elif wtype == 2:
                ln, pos = _varint(buf, pos)
                val = buf[pos:pos + ln]
                pos += ln
            elif wtype == 5:
                val = struct.unpack("<I", buf[pos:pos + 4])[0]
                pos += 4
            else:
                raise ValueError(f"unsupported wire type {wtype}")
            yield field, wtype, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated Dim (field 2) { int64 size (field 1) }."""
    dims = []
    for field, _, val in _Proto(buf).fields():
        if field == 2:
            for f2, _, v2 in _Proto(val).fields():
                if f2 == 1:
                    # zigzag is NOT used; size is a plain varint (int64)
                    dims.append(int(v2))
    return tuple(dims)


class BundleEntry:
    __slots__ = ("dtype", "shape", "shard_id", "offset", "size")

    def __init__(self, buf: bytes):
        self.dtype = np.float32
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        for field, _, val in _Proto(buf).fields():
            if field == 1:
                self.dtype = _TF_DTYPES.get(int(val), np.float32)
            elif field == 2:
                self.shape = _parse_shape(val)
            elif field == 3:
                self.shard_id = int(val)
            elif field == 4:
                self.offset = int(val)
            elif field == 5:
                self.size = int(val)


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """A table block: payload + 1-byte type + 4-byte crc.  Type 0 = raw;
    type 1 = snappy (not produced for .index files by TF)."""
    block = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return block
    if ctype == 1:
        try:
            import snappy  # pragma: no cover
            return snappy.uncompress(block)
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("snappy-compressed index block") from e
    raise ValueError(f"unknown block compression {ctype}")


def _iter_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Prefix-compressed key/value entries (leveldb block format)."""
    if len(block) < 4:
        return
    num_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * num_restarts
    pos, key = 0, b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        value = block[pos:pos + vlen]
        pos += vlen
        yield key, value


class TFBundleReader:
    """Read tensors from a TF bundle given its path prefix
    (e.g. ``.../trained_model/81448_0-1000000``)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index_path = prefix + ".index"
        with open(index_path, "rb") as f:
            data = f.read()
        footer = data[-48:]
        magic = struct.unpack("<Q", footer[-8:])[0]
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{index_path}: not a TF bundle index "
                             f"(bad magic {magic:#x})")
        # footer: metaindex handle (varint offset,size), index handle
        mo, p = _varint(footer, 0)
        ms, p = _varint(footer, p)
        io_, p = _varint(footer, p)
        is_, p = _varint(footer, p)
        index_block = _read_block(data, io_, is_)
        self.entries: Dict[str, BundleEntry] = {}
        for _key, handle in _iter_block_entries(index_block):
            off, q = _varint(handle, 0)
            sz, q = _varint(handle, q)
            for key, value in _iter_block_entries(_read_block(data, off, sz)):
                name = key.decode("utf-8", errors="replace")
                if name == "":
                    continue  # BundleHeaderProto
                self.entries[name] = BundleEntry(value)
        self._shards: Dict[int, "np.memmap"] = {}
        self._num_shards = self._detect_num_shards()

    def _detect_num_shards(self) -> int:
        d = os.path.dirname(self.prefix) or "."
        base = os.path.basename(self.prefix)
        n = 1
        for f in os.listdir(d):
            if f.startswith(base + ".data-"):
                n = int(f.split("-of-")[-1])
        return n

    # -------------------------------------------------------------- #

    def keys(self):
        return self.entries.keys()

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.entries[name].shape

    def has_payload(self, name: str) -> bool:
        """False for LFS-stub data files (reference mount strips payloads,
        .MISSING_LARGE_BLOBS)."""
        e = self.entries[name]
        path = self._shard_path(e.shard_id)
        try:
            return os.path.getsize(path) >= e.offset + e.size
        except OSError:
            return False

    def _shard_path(self, shard_id: int) -> str:
        return f"{self.prefix}.data-{shard_id:05d}-of-{self._num_shards:05d}"

    def read(self, name: str) -> np.ndarray:
        e = self.entries[name]
        path = self._shard_path(e.shard_id)
        with open(path, "rb") as f:
            f.seek(e.offset)
            raw = f.read(e.size)
        if len(raw) != e.size:
            raise IOError(
                f"{path}: truncated tensor {name!r} (LFS stub? wanted "
                f"{e.size} bytes at {e.offset}, got {len(raw)})")
        arr = np.frombuffer(raw, dtype=e.dtype)
        return arr.reshape(e.shape)


# ---------------------------------------------------------------------- #
# Writer: emit a single-shard TF tensor bundle (the tf.train.Saver v2
# on-disk format the reader above parses).  Used by the full-checkpoint
# import round-trip test — the reference's shipped payloads are
# LFS-stripped (.MISSING_LARGE_BLOBS), so end-to-end import can only be
# proven against a synthetically written bundle with the REAL index's
# names/shapes — and usable to export trained weights TF-side.

def _varint_enc(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _proto_bytes(field: int, payload: bytes) -> bytes:
    return _varint_enc((field << 3) | 2) + _varint_enc(len(payload)) + payload


def _proto_varint(field: int, v: int) -> bytes:
    return _varint_enc(field << 3) + _varint_enc(v)


_NP_TO_TF = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
             np.dtype(np.int32): 3, np.dtype(np.int64): 9}


def _block(entries) -> bytes:
    """leveldb block: entries with no prefix compression + one restart."""
    body = b""
    for key, val in entries:
        body += (_varint_enc(0) + _varint_enc(len(key))
                 + _varint_enc(len(val)) + key + val)
    body += struct.pack("<I", 0) + struct.pack("<I", 1)
    return body


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write ``tensors`` as ``<prefix>.index`` + ``.data-00000-of-00001``.

    Keys are written in sorted order (table invariant); payloads are laid
    out sequentially in the single data shard."""
    names = sorted(tensors)
    payload, offset = [], 0
    entries = []
    for name in names:
        arr = np.ascontiguousarray(tensors[name])
        dt = _NP_TO_TF.get(arr.dtype)
        if dt is None:
            raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
        shape = b"".join(_proto_bytes(2, _proto_varint(1, d))
                         for d in arr.shape)
        entry = (_proto_varint(1, dt) + _proto_bytes(2, shape)
                 + _proto_varint(3, 0) + _proto_varint(4, offset)
                 + _proto_varint(5, arr.nbytes))
        entries.append((name.encode(), entry))
        payload.append(arr)
        offset += arr.nbytes

    data_block = _block(entries)
    out = data_block + b"\x00" + struct.pack("<I", 0)
    handle = _varint_enc(0) + _varint_enc(len(data_block))
    index_block = _block([(names[-1].encode() if names else b"",
                           handle)])
    index_off = len(out)
    out += index_block + b"\x00" + struct.pack("<I", 0)
    footer = (_varint_enc(0) + _varint_enc(0)
              + _varint_enc(index_off) + _varint_enc(len(index_block)))
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(out + footer)
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        for arr in payload:  # one write each: no 100 MB concatenation
            f.write(arr.tobytes())
