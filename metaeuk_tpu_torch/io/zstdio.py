# Copy of metaeuk_tpu/io/zstdio.py; only the imports differ.
"""libzstd ctypes bindings for the MMseqs compressed-DB entry framing.

The reference writes compressed DBs one zstd stream per entry
(DBWriter::writeAdd/writeEnd, lib/mmseqs/src/commons/DBWriter.cpp:283-401):

  data entry  = [u32 compressed_size][zstd frame][0x00]
  small entry = [u32 raw_size][raw bytes][0xFF]          (payload < 60 B)

The .index length column keeps the UNCOMPRESSED size (+1 for the
terminator byte); the .dbtype sets bit 31. Frames are produced with the
streaming API (no content-size header), so decompression must stream
too (DBReader::getDataCompressed, DBReader.cpp:560-585).
"""

import ctypes
import ctypes.util

_lib = None


class _ZBuf(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p),
                ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _zstd():
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    lib = ctypes.CDLL(name)
    for fn, res, args in (
            ("ZSTD_createCCtx", ctypes.c_void_p, []),
            ("ZSTD_freeCCtx", ctypes.c_size_t, [ctypes.c_void_p]),
            ("ZSTD_createDCtx", ctypes.c_void_p, []),
            ("ZSTD_freeDCtx", ctypes.c_size_t, [ctypes.c_void_p]),
            ("ZSTD_CCtx_setParameter", ctypes.c_size_t,
             [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]),
            ("ZSTD_compressStream2", ctypes.c_size_t,
             [ctypes.c_void_p, ctypes.POINTER(_ZBuf), ctypes.POINTER(_ZBuf),
              ctypes.c_int]),
            ("ZSTD_decompressStream", ctypes.c_size_t,
             [ctypes.c_void_p, ctypes.POINTER(_ZBuf), ctypes.POINTER(_ZBuf)]),
            ("ZSTD_compressBound", ctypes.c_size_t, [ctypes.c_size_t]),
            ("ZSTD_isError", ctypes.c_uint, [ctypes.c_size_t]),
    ):
        f = getattr(lib, fn)
        f.restype = res
        f.argtypes = args
    _lib = lib
    return lib


_ZSTD_c_compressionLevel = 100
_ZSTD_e_end = 2


def compress(data, level=3):
    """One zstd frame equivalent to the reference's per-entry stream
    (ZSTD_initCStream level 3 + compressStream + endStream): produced
    with the streaming API so the frame header carries no content size,
    exactly like DBWriter's output."""
    z = _zstd()
    cctx = z.ZSTD_createCCtx()
    try:
        z.ZSTD_CCtx_setParameter(cctx, _ZSTD_c_compressionLevel, level)
        src = ctypes.create_string_buffer(bytes(data), len(data))
        cap = z.ZSTD_compressBound(len(data)) + 16
        dst = ctypes.create_string_buffer(cap)
        inb = _ZBuf(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        outb = _ZBuf(ctypes.cast(dst, ctypes.c_void_p), cap, 0)
        while True:
            rem = z.ZSTD_compressStream2(cctx, ctypes.byref(outb),
                                         ctypes.byref(inb), _ZSTD_e_end)
            if z.ZSTD_isError(rem):
                raise RuntimeError("ZSTD_compressStream2 error")
            if rem == 0:
                break
        return dst.raw[:outb.pos]
    finally:
        z.ZSTD_freeCCtx(cctx)


def decompress(data, expected_size):
    """Streaming decompress of one entry frame (content size unknown)."""
    z = _zstd()
    dctx = z.ZSTD_createDCtx()
    try:
        src = ctypes.create_string_buffer(bytes(data), len(data))
        cap = max(expected_size, 64) + 16
        dst = ctypes.create_string_buffer(cap)
        inb = _ZBuf(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        total = 0
        while inb.pos < inb.size:
            outb = _ZBuf(ctypes.c_void_p(ctypes.addressof(dst) + total),
                         cap - total, 0)
            r = z.ZSTD_decompressStream(dctx, ctypes.byref(outb),
                                        ctypes.byref(inb))
            if z.ZSTD_isError(r):
                raise RuntimeError("ZSTD_decompressStream error")
            total += outb.pos
            if outb.pos == 0 and r == 0:
                break
        return dst.raw[:total]
    finally:
        z.ZSTD_freeDCtx(dctx)
