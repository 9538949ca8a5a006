"""Reader and writer of the Orbax checkpoints the JAX package writes
(``nhans_tpu/train/checkpoint.py``: ``save_variables`` and the
``Checkpointer``'s ``<step>/default``), with numpy, the standard library
and the system's zstd (``utils/zstd.py``): no orbax, tensorstore or JAX.

A checkpoint directory holds

* ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's path (its
  ``key_metadata``: dict keys, ``key_type`` 2, and sequence indices,
  ``key_type`` 1) to its ``value_type``, ``"None"`` for an empty node
  such as an optax ``EmptyState``; and the layout, ``use_ocdbt`` and
  ``use_zarr3``.
* With ``use_ocdbt``, one OCDBT key-value store (tensorstore's
  "optionally-cooperative distributed B+tree"): ``manifest.ocdbt`` and
  ``d/<id>`` at the root, which is what Orbax reads, and the store each
  process wrote under ``ocdbt.process_<i>/`` before they were merged
  into it.  The root's values point into those files.  Without a root
  manifest the per-process stores are read and joined.
* Without it (older Orbax), one directory per array.

Either way each leaf is a zarr v2 array named by its path joined with
``.``: ``<name>/.zarray`` (JSON) and its chunks ``<name>/<i>.<j>``, each
zstd-compressed.

The OCDBT files (manifests and B-tree nodes) are a 14-byte header (a
big-endian magic, ``0x0cdb3a2a`` in a manifest and ``0x0cdb20de`` in a
node, the file's length as a little-endian uint64, a varint version 0
and a varint compression, 0 none or 1 zstd), a body and a little-endian
CRC-32C of all that precedes it.  Integers in a body are LEB128 varints,
and its tables are stored a column at a time:

* manifest: the config (a 16-byte uuid, the manifest kind, 0 single;
  the largest inline value and decoded node; the version tree's arity
  as log2, one byte; the node compression, 1 zstd followed by its level
  as an int32), then the version tree's newest leaf: a data-file table,
  the count of versions and, per version, its generation, root height
  (one byte), root location (file, offset, length), key, node and
  value-byte counts and commit time (a uint64), and last the references
  to the version tree's older nodes;
* B-tree node: its height (one byte), a data-file table and its entries'
  keys, each sharing a prefix with the one before.  A leaf's entries
  carry a value length and kind (0 inline, 1 in a data file at an
  offset); an inner node's carry the length of the prefix its whole
  subtree shares, which its child's keys leave out, and the child's
  location and counts;
* data-file table: each file's path, sharing a prefix with the one
  before, as a base path and a path relative to it.

Whatever else a file holds (another magic, version, compression,
manifest kind, zarr format, compressor, filter, order or dtype) is
refused with an error that names the field, and a short or corrupt file
with one that names the file.

``write`` writes what Orbax 0.11 writes for a tree of host arrays, in
the encoding above: ``_METADATA``, and one OCDBT store at the root (no
per-process stores: one process writes it) whose single version's root
is one B-tree leaf, with Orbax's configuration (values of up to 1024
bytes inline, the rest in the one data file ``d/<id>``, which also holds
the leaf).  Each array is one zarr v2 array as tensorstore writes it for
Orbax: zstd level 1, a null fill value, and one chunk unless it holds
more than 2 GiB (``chunk_shape``).  ``write_checkpoint_metadata`` writes
the ``_CHECKPOINT_METADATA`` of a variables or a step directory.
"""

from __future__ import annotations

import json
import math
import os
import struct
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from nhans_tpu_torch.utils import zstd

METADATA = "_METADATA"
MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 14
_MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root
# zarr v2 dtypes of what the JAX package saves: float32 arrays, int32
# step and counts, int64 where x64 is on
_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32,
           "<i8": np.int64}
# what Orbax writes: its OCDBT configuration, the level of its zarr
# chunks, the size above which it cuts an array into several chunks (the
# default target size of an OCDBT data file) and the handler it records
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
ZARR_ZSTD_LEVEL = 1
CHUNK_TARGET_BYTES = 1 << 31
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of OCDBT's files."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Body:
    """A cursor over a decoded body; errors name ``what``."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str):
        raise ValueError(f"{self.what}: {msg}")

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]

    def varint(self) -> int:
        result = shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes past the end of "
                      "its content")


def _decode(data: bytes, magic: int, what: str, limit: int) -> _Body:
    """The body of an OCDBT manifest or node: header, checksum and
    compression checked."""
    if len(data) < _HEADER + 4:
        raise ValueError(f"{what}: {len(data)} bytes, shorter than an "
                         "OCDBT header")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{what}: header says {length} bytes, the file "
                         f"holds {len(data)} (truncated?)")
    crc = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch (corrupt)")
    head = _Body(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: unknown OCDBT version {version}")
    compression = head.varint()
    body = data[12 + head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body, limit=limit, what=what)
    elif compression != 0:
        raise ValueError(f"{what}: unknown OCDBT compression {compression}")
    return _Body(body, what)


def _data_files(body: _Body) -> List[str]:
    """A data-file table: each file's path relative to the store's root
    (its base path and its own path joined)."""
    n = body.varint()
    shared = [0] + body.varints(max(n - 1, 0))
    lengths = body.varints(n)
    bases = body.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            body.fail("data-file table: prefix longer than the path before")
        prev = prev[:shared[i]] + body.raw(lengths[i])
        if bases[i] > len(prev):
            body.fail("data-file table: base path longer than the path")
        paths.append(prev.decode())
    return paths


def _keys(body: _Body, n: int) -> Tuple[List[int], List[int]]:
    """The first two columns of ``n`` prefix-compressed keys: the length
    each shares with the key before and the length of the rest.  Their
    bytes come later (``_key_bytes``): an inner node puts a column of its
    own between."""
    shared = [0] + body.varints(max(n - 1, 0))
    return shared, body.varints(n)


def _key_bytes(body: _Body, shared, lengths) -> List[bytes]:
    keys, prev = [], b""
    for s, n in zip(shared, lengths):
        if s > len(prev):
            body.fail("key prefix longer than the key before")
        prev = prev[:s] + body.raw(n)
        keys.append(prev)
    return keys


class _Location:
    __slots__ = ("file", "offset", "length")

    def __init__(self, file: str, offset: int, length: int):
        self.file, self.offset, self.length = file, offset, length


class OcdbtStore:
    """The keys and values of the OCDBT store at ``root`` (its newest
    version), read at construction; ``root`` holds ``manifest.ocdbt``
    (or, unmerged, ``ocdbt.process_<i>/manifest.ocdbt``).  ``heights``
    holds each B-tree's height (0: its root is a leaf) and ``indirect``
    the count of values kept in data files rather than in the leaves."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        # key -> inline bytes or the location of the value
        self._values: Dict[bytes, object] = {}
        self.heights: List[int] = []
        self.indirect = 0
        manifests = [MANIFEST]
        if not os.path.isfile(os.path.join(self.root, MANIFEST)):
            manifests = sorted(
                os.path.join(d, MANIFEST) for d in os.listdir(self.root)
                if d.startswith("ocdbt.process_")
                and os.path.isfile(os.path.join(self.root, d, MANIFEST)))
            if not manifests:
                raise FileNotFoundError(f"{self.root}: no {MANIFEST}")
        for manifest in manifests:
            self._read_manifest(manifest)

    # -- files ---------------------------------------------------------------

    def _path(self, rel: str, where: str) -> str:
        path = os.path.normpath(os.path.join(self.root, rel))
        if os.path.commonpath([path, self.root]) != self.root:
            raise ValueError(f"{where}: data file {rel!r} lies outside "
                             f"{self.root}")
        return path

    def _read(self, loc: _Location) -> bytes:
        with open(loc.file, "rb") as f:
            f.seek(loc.offset)
            data = f.read(loc.length)
        if len(data) != loc.length:
            raise ValueError(
                f"{loc.file}: {loc.length} bytes at offset {loc.offset} "
                f"lie past its end ({os.path.getsize(loc.file)} bytes; "
                "truncated)")
        return data

    # -- manifest and version tree --------------------------------------------

    def _read_manifest(self, rel: str) -> None:
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            body = _decode(f.read(), MANIFEST_MAGIC, path, 1 << 30)
        body.raw(16)  # uuid
        kind = body.varint()
        if kind != 0:
            body.fail(f"manifest_kind {kind} (numbered manifests) is not "
                      "read; only a single manifest")
        body.varint()  # max_inline_value_bytes
        self._max_node = body.varint()
        body.byte()  # version_tree_arity_log2
        compression = body.varint()
        if compression == 1:
            body.raw(4)  # zstd level
        elif compression != 0:
            body.fail(f"unknown config compression {compression}")
        files = _data_files(body)
        n = body.varint()
        generations = body.varints(n)
        heights = list(body.raw(n))
        ids, offsets, lengths = (body.varints(n), body.varints(n),
                                 body.varints(n))
        body.varints(3 * n)  # keys, tree bytes and indirect bytes
        body.raw(8 * n)  # commit times
        # references to the version tree's older nodes: generation,
        # location, generations covered, commit time and height
        m = body.varint()
        body.varints(5 * m)
        body.raw(9 * m)
        body.end()
        if not n:
            return
        newest = int(np.argmax(generations))
        if offsets[newest] == _MISSING:
            return  # an empty store
        base = os.path.dirname(rel)
        self.heights.append(heights[newest])
        self._walk(self._location(files, ids[newest], offsets[newest],
                                  lengths[newest], path, base),
                   heights[newest], b"", base)

    def _location(self, files, file_id, offset, length, where,
                  base) -> _Location:
        if file_id >= len(files):
            raise ValueError(f"{where}: data file {file_id} of "
                             f"{len(files)}")
        return _Location(self._path(os.path.join(base, files[file_id]),
                                     where), offset, length)

    # -- B-tree ---------------------------------------------------------------

    def _walk(self, loc: _Location, height: int, prefix: bytes,
              base: str) -> None:
        what = f"{loc.file} (node at {loc.offset})"
        body = _decode(self._read(loc), NODE_MAGIC, what, self._max_node)
        got = body.byte()
        if got != height:
            body.fail(f"node height {got}, its parent says {height}")
        files = _data_files(body)
        n = body.varint()
        shared, lengths = _keys(body, n)
        if height == 0:
            keys = _key_bytes(body, shared, lengths)
            sizes = body.varints(n)
            kinds = list(body.varints(n))
            if any(k not in (0, 1) for k in kinds):
                body.fail(f"unknown value kind {max(kinds)}")
            indirect = [i for i in range(n) if kinds[i] == 1]
            ids = body.varints(len(indirect))
            offsets = body.varints(len(indirect))
            self.indirect += len(indirect)
            for j, i in enumerate(indirect):
                self._values[prefix + keys[i]] = self._location(
                    files, ids[j], offsets[j], sizes[i], what, base)
            for i in range(n):
                if kinds[i] == 0:
                    self._values[prefix + keys[i]] = body.raw(sizes[i])
            body.end()
            return
        common = body.varints(n)
        keys = _key_bytes(body, shared, lengths)
        ids, offsets, sizes = body.varints(n), body.varints(n), body.varints(n)
        body.varints(3 * n)  # keys, tree bytes and indirect bytes
        body.end()
        for i in range(n):
            if common[i] > len(keys[i]):
                body.fail("subtree prefix longer than its key")
            self._walk(self._location(files, ids[i], offsets[i], sizes[i],
                                      what, base),
                       height - 1, prefix + keys[i][:common[i]], base)

    # -- access ---------------------------------------------------------------

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def get(self, key: bytes) -> Optional[bytes]:
        """The value of ``key``, or None where the store has none."""
        value = self._values.get(key)
        if isinstance(value, _Location):
            return self._read(value)
        return value


def _zarr_array(name: str, get: Callable[[str], Optional[bytes]],
                where: str) -> np.ndarray:
    """The zarr v2 array ``name`` of a store read by ``get`` (a key ->
    bytes or None): chunk by chunk, a missing chunk filled with the
    array's ``fill_value`` (0 where it is null, as tensorstore reads it)."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"{where}: array {name!r} has no .zarray")
    meta = json.loads(raw)
    what = f"{where}: {name}/.zarray"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{what}: order {meta['order']!r} (only C)")
    if meta.get("filters"):
        raise ValueError(f"{what}: filters {meta['filters']!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{what}: unknown compressor {compressor!r}")
    if meta.get("dtype") not in _DTYPES:
        raise ValueError(f"{what}: unknown dtype {meta.get('dtype')!r}")
    dtype = np.dtype(_DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{what}: chunks {list(chunks)} for shape "
                         f"{list(shape)}")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = sep.join(map(str, index)) if index else "0"
        data = get(f"{name}/{key}")
        if data is None:
            continue
        if compressor is not None:
            data = zstd.decompress(data, size=nbytes,
                                   what=f"{where}: chunk {name}/{key}")
        elif len(data) != nbytes:
            raise ValueError(f"{where}: chunk {name}/{key} holds "
                             f"{len(data)} bytes, expected {nbytes}")
        block = np.frombuffer(data, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


def is_checkpoint(path: str) -> bool:
    """Whether ``path`` is an Orbax checkpoint directory (it holds
    ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, METADATA))


def _metadata(path: str) -> dict:
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path}: not an Orbax checkpoint the port reads "
                         f"(no {METADATA})")
    with open(meta_path) as f:
        try:
            meta = json.load(f)
        except json.JSONDecodeError as err:
            raise ValueError(f"{meta_path}: {err}") from err
    if meta.get("use_zarr3"):
        raise ValueError(f"{meta_path}: use_zarr3 is true; the port reads "
                         "zarr v2 arrays only")
    if "tree_metadata" not in meta:
        raise ValueError(f"{meta_path}: no tree_metadata")
    return meta


def _leaves(meta: dict, where: str) -> List[Tuple[Tuple[str, ...], bool]]:
    """(path, whether it holds an array) of each leaf of the tree."""
    out = []
    for entry in meta["tree_metadata"].values():
        path = []
        for k in entry["key_metadata"]:
            if k.get("key_type") not in (1, 2):
                raise ValueError(f"{where}: unknown key_type "
                                 f"{k.get('key_type')!r} in {k!r}")
            path.append(str(k["key"]))
        value_type = entry["value_metadata"].get("value_type")
        out.append((tuple(path), value_type != "None"))
    return out


def top_level_keys(path: str) -> frozenset:
    """The tree's top-level keys, from ``_METADATA`` alone."""
    meta = _metadata(path)
    return frozenset(p[0] for p, _ in _leaves(meta, path) if p)


def read(path: str, keep: Optional[Iterable[str]] = None
         ) -> Dict[str, np.ndarray]:
    """The arrays of the checkpoint directory ``path`` as a flat dict
    keyed by their tree paths joined with ``/`` (``params/a/kernel``);
    empty nodes hold none.  With ``keep``, only the leaves under those
    top-level keys are read."""
    path = os.path.abspath(path)
    meta = _metadata(path)
    leaves = [p for p, has in _leaves(meta, path) if has
              and (keep is None or p[0] in keep)]
    if meta.get("use_ocdbt", True):
        store = OcdbtStore(path)

        def get(key: str) -> Optional[bytes]:
            return store.get(key.encode())
    else:
        def get(key: str) -> Optional[bytes]:
            file = os.path.join(path, *key.split("/"))
            if not os.path.isfile(file):
                return None
            with open(file, "rb") as f:
                return f.read()
    return {"/".join(p): _zarr_array(".".join(p), get, path)
            for p in leaves}


# -- the writer ---------------------------------------------------------------

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


def _varints(ns: Iterable[int]) -> bytes:
    return b"".join(_varint(n) for n in ns)


def _shared(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _prefixed(items: List[bytes]) -> Tuple[bytes, bytes]:
    """The shared-prefix and suffix-length columns of ``items`` and
    their suffix bytes."""
    shared = [_shared(items[i - 1], items[i]) for i in range(1, len(items))]
    cut = [0] + shared
    return (_varints(shared) + _varints(len(x) - c for x, c in
                                        zip(items, cut)),
            b"".join(x[c:] for x, c in zip(items, cut)))


def _file_table(paths: List[str]) -> bytes:
    """A data-file table of paths relative to the store's root (each an
    empty base path and its own path)."""
    enc = [p.encode() for p in paths]
    columns, suffixes = _prefixed(enc)
    return (_varint(len(enc)) + columns + _varints([0] * len(enc))
            + suffixes)


def _encode(body: bytes, magic: int) -> bytes:
    """An OCDBT file: header (version 0, zstd), body and CRC-32C."""
    body = zstd.compress(body, 0)
    size = _HEADER + len(body) + 4
    data = (struct.pack(">I", magic) + struct.pack("<Q", size)
            + _varint(0) + _varint(1) + body)
    return data + struct.pack("<I", crc32c(data))


def _leaf(items: List[Tuple[bytes, bytes]], data_file: str,
          offsets: Dict[bytes, int]) -> bytes:
    """The body of a B-tree leaf of the sorted ``items`` (key, value);
    the values at ``offsets`` lie in ``data_file``, the others inline."""
    keys = [k for k, _ in items]
    columns, suffixes = _prefixed(keys)
    indirect = [k for k in keys if k in offsets]
    return (bytes([0]) + _file_table([data_file] if indirect else [])
            + _varint(len(keys)) + columns + suffixes
            + _varints(len(v) for _, v in items)
            + _varints(int(k in offsets) for k in keys)
            + _varints([0] * len(indirect))
            + _varints(offsets[k] for k in indirect)
            + b"".join(v for k, v in items if k not in offsets))


def write_store(root: str, values: Dict[bytes, bytes]) -> None:
    """An OCDBT store at ``root`` holding ``values`` (key -> bytes):
    ``manifest.ocdbt`` and one data file ``d/<id>`` with the values too
    large to sit inline and the B-tree's single leaf after them."""
    items = sorted(values.items())
    data_file = f"d/{os.urandom(16).hex()}"
    offsets, blobs, pos = {}, [], 0
    for key, value in items:
        if len(value) > MAX_INLINE_VALUE_BYTES:
            offsets[key] = pos
            blobs.append(value)
            pos += len(value)
    leaf = _leaf(items, data_file, offsets)
    if len(leaf) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"{root}: {len(items)} keys make a B-tree leaf of "
                         f"{len(leaf)} bytes, more than "
                         f"{MAX_DECODED_NODE_BYTES}; the writer makes one "
                         "leaf only")
    node = _encode(leaf, NODE_MAGIC)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, data_file), "wb") as f:
        f.writelines(blobs)
        f.write(node)
    manifest = (os.urandom(16) + _varint(0)
                + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES)
                + bytes([VERSION_TREE_ARITY_LOG2])
                + _varint(1) + struct.pack("<i", 0)
                # the version tree's leaf: generation 1, its root a leaf
                + _file_table([data_file]) + _varint(1) + _varint(1)
                + bytes([0]) + _varints([0, pos, len(node), len(items),
                                          len(node), pos])
                + struct.pack("<Q", time.time_ns()) + _varint(0))
    with open(os.path.join(root, MANIFEST), "wb") as f:
        f.write(_encode(manifest, MANIFEST_MAGIC))


def chunk_shape(shape: Tuple[int, ...], itemsize: int,
                target: int = CHUNK_TARGET_BYTES) -> Tuple[int, ...]:
    """The zarr chunk shape Orbax gives an array of ``shape`` written by
    one process: the shape itself (a zero extent as 1) where it holds at
    most ``target`` bytes, else the largest extent of the chunk stepped
    down through its divisors until a chunk does (orbax's
    ``subchunking.choose_chunk_shape``)."""
    if math.prod(shape) * itemsize <= target:
        return tuple(max(1, d) for d in shape)
    divisors = [[d for d in range(1, s + 1) if s % d == 0] for s in shape]
    while math.prod(d[-1] for d in divisors) > target // itemsize:
        largest = max(range(len(shape)), key=lambda i: (divisors[i][-1], -i))
        if divisors[largest][-1] == 1:
            break
        divisors[largest].pop()
    return tuple(d[-1] for d in divisors)


def _zarray(arr: np.ndarray, chunks: Tuple[int, ...]) -> bytes:
    """The ``.zarray`` tensorstore writes for Orbax: keys sorted, no
    spaces."""
    return json.dumps({
        "chunks": list(chunks),
        "compressor": {"id": "zstd", "level": ZARR_ZSTD_LEVEL},
        "dimension_separator": ".", "dtype": arr.dtype.str,
        "fill_value": None, "filters": None, "order": "C",
        "shape": list(arr.shape), "zarr_format": 2},
        sort_keys=True, separators=(",", ":")).encode()


def _array_values(name: str, arr: np.ndarray) -> Dict[bytes, bytes]:
    """The keys and values of one zarr v2 array: its ``.zarray`` and its
    chunks, each zstd-compressed (edge chunks padded with zeros)."""
    if arr.dtype.str not in _DTYPES:
        raise ValueError(f"{name}: dtype {arr.dtype} is not one the JAX "
                         f"package saves ({sorted(_DTYPES)})")
    chunks = chunk_shape(arr.shape, arr.itemsize)
    out = {f"{name}/.zarray".encode(): _zarray(arr, chunks)}
    grid = [-(-s // c) for s, c in zip(arr.shape, chunks)]
    for index in np.ndindex(*grid):
        region = tuple(slice(i * c, (i + 1) * c)
                       for i, c in zip(index, chunks))
        block = arr[region]
        if block.shape != chunks:
            block = np.pad(block, [(0, c - b) for b, c in
                                   zip(block.shape, chunks)])
        key = ".".join(map(str, index)) if index else "0"
        out[f"{name}/{key}".encode()] = zstd.compress(
            np.ascontiguousarray(block).tobytes(), ZARR_ZSTD_LEVEL)
    return out


def write(path: str, flat: Dict[str, Optional[np.ndarray]],
          sequences: Iterable[str] = ()) -> None:
    """Write the tree ``flat`` as the Orbax checkpoint directory
    ``path`` (made if need be; it should be empty): ``_METADATA`` and an
    OCDBT store of one zarr array per leaf.  ``flat`` maps each leaf's
    path, joined with ``/``, to a numpy array, or to None for an empty
    node (an optax ``EmptyState``), in the order the tree flattens;
    ``sequences`` names the nodes (joined paths) whose children are
    sequence indices, recorded as ``key_type`` 1 (dict keys are 2)."""
    sequences = set(sequences)
    tree, values = {}, {}
    for key, value in flat.items():
        parts = key.split("/")
        tree[str(tuple(parts))] = {
            "key_metadata": [
                {"key": p, "key_type": 1 if "/".join(parts[:i]) in sequences
                 else 2} for i, p in enumerate(parts)],
            "value_metadata": (
                {"value_type": "None", "skip_deserialize": True}
                if value is None else
                {"value_type": "np.ndarray", "skip_deserialize": False})}
        if value is not None:
            values.update(_array_values(".".join(parts), np.asarray(value)))
    os.makedirs(path, exist_ok=True)
    write_store(path, values)
    with open(os.path.join(path, METADATA), "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)


def write_checkpoint_metadata(path: str, step: bool,
                              init_ns: int) -> None:
    """``path``'s ``_CHECKPOINT_METADATA``: a ``save_variables``
    directory's (``step`` False) or a ``Checkpointer`` step's, whose tree
    lies under ``default/``; ``init_ns`` is when the save began."""
    with open(os.path.join(path, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": {"default": HANDLER} if step
                   else HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": init_ns,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
