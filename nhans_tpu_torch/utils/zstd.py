"""zstd through the system's ``libzstd.so.1``, bound with ctypes (no
Python package): the codec of Orbax's OCDBT nodes and of its zarr chunks
(``compat/orbax.py``), both ways.

``ZSTD_decompressStream`` is used rather than ``ZSTD_decompress``
because a frame need not record its content size (tensorstore writes
none).  The library is loaded on the first call; where it is missing,
that call raises ``RuntimeError`` naming it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

LIBRARY = "libzstd.so.1"


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            names = [LIBRARY]
            found = ctypes.util.find_library("zstd")
            if found and found != LIBRARY:
                names.append(found)
            for name in names:
                try:
                    lib = ctypes.CDLL(name)
                    break
                except OSError:
                    continue
            else:
                raise RuntimeError(
                    f"{LIBRARY} (the zstd library) was not found; it is "
                    "needed to read and write Orbax checkpoints")
            lib.ZSTD_createDStream.restype = ctypes.c_void_p
            lib.ZSTD_createDStream.argtypes = []
            lib.ZSTD_freeDStream.restype = ctypes.c_size_t
            lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
            lib.ZSTD_initDStream.restype = ctypes.c_size_t
            lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
            lib.ZSTD_decompressStream.restype = ctypes.c_size_t
            lib.ZSTD_decompressStream.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
                ctypes.POINTER(_InBuffer)]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
            lib.ZSTD_compress.restype = ctypes.c_size_t
            lib.ZSTD_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_int]
            _lib = lib
    return _lib


def decompress(data: bytes, size: Optional[int] = None,
               limit: int = 1 << 34, what: str = "zstd data") -> bytes:
    """The decompressed bytes of one or more whole zstd frames.  With
    ``size``, the output must be exactly that long; without it, it may
    not exceed ``limit``.  A truncated or corrupt input raises
    ``ValueError`` naming ``what``."""
    lib = _load()
    src = ctypes.create_string_buffer(bytes(data), len(data))
    # one byte more than expected, so that a frame that fits exactly
    # ends with room to spare and a longer one shows
    cap = size + 1 if size is not None else max(4 * len(data), 1 << 16)
    dst = ctypes.create_string_buffer(cap)
    inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    outb = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), cap, 0)
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        lib.ZSTD_initDStream(stream)
        ret = 0
        while True:
            ret = lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                            ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                raise ValueError(f"{what}: zstd: "
                                 f"{lib.ZSTD_getErrorName(ret).decode()}")
            if inb.pos == inb.size and (ret == 0 or outb.pos < outb.size):
                break
            if outb.pos == outb.size:
                if size is not None:
                    break
                if cap >= limit:
                    raise ValueError(f"{what}: decompresses to more than "
                                     f"{limit} bytes")
                cap = min(2 * cap, limit)
                grown = ctypes.create_string_buffer(cap)
                ctypes.memmove(grown, dst, outb.pos)
                dst = grown
                outb.dst = ctypes.cast(dst, ctypes.c_void_p)
                outb.size = cap
    finally:
        lib.ZSTD_freeDStream(stream)
    if size is not None and outb.pos > size:
        raise ValueError(f"{what}: decompresses to more than the {size} "
                         "bytes expected")
    if ret != 0:
        raise ValueError(f"{what}: truncated zstd frame")
    if size is not None and outb.pos != size:
        raise ValueError(f"{what}: decompressed to {outb.pos} bytes, "
                         f"expected {size}")
    return ctypes.string_at(dst, outb.pos)


def compress(data: bytes, level: int) -> bytes:
    """One zstd frame of ``data`` at ``level`` (0: the library's
    default); a library error raises ``ValueError``."""
    lib = _load()
    data = bytes(data)
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(dst, cap, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(n).decode()}")
    return ctypes.string_at(dst, n)
