"""Native (C++) streaming IO, built on first use with the system g++ (port
of soc_tpu.native).

`io_stream.cpp`: a double-buffered reader and a background writer of the
[CELLS, NFREQ] cell-frequency files (absorbed.data / emitted.data): the
reader's prefetch thread overlaps disk IO with the solve, and neither file
has to fit in host memory.

The library is built into ``soc_tpu_torch/_build/`` (listed in
.gitignore) as ``libsocio_<hash>.so``, named by the hash of the source
and the flags: a changed source builds anew, an unchanged one loads at
once. Each builder compiles into its own per-pid temporary file and
renames it into place, so concurrent builders (test workers, CLI runs)
race only on the atomic rename. A failed build raises; nothing falls back
to a Python reader.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_LIB = None


def _build():
    """Path of the built library, compiling io_stream.cpp if needed."""
    src = os.path.join(_DIR, "io_stream.cpp")
    h = hashlib.sha256()
    with open(src, "rb") as fp:
        h.update(fp.read())
    h.update(" ".join(GXX_FLAGS).encode())
    out = os.path.join(BUILD_DIR, "libsocio_%s.so" % h.hexdigest()[:16])
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (out, os.getpid())
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("g++ failed on %s:\n%s"
                                   % (src, proc.stdout + proc.stderr))
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def lib():
    """ctypes handle of the IO library, built and typed on first use."""
    global _LIB
    with _lock:
        if _LIB is None:
            L = ctypes.CDLL(_build())
            L.socio_reader_open.restype = ctypes.c_void_p
            L.socio_reader_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            L.socio_reader_next.restype = ctypes.c_int64
            L.socio_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            L.socio_reader_close.restype = None
            L.socio_reader_close.argtypes = [ctypes.c_void_p]
            L.socio_writer_open.restype = ctypes.c_void_p
            L.socio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                            ctypes.c_int64]
            L.socio_writer_put.restype = None
            L.socio_writer_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int64]
            L.socio_writer_close.restype = None
            L.socio_writer_close.argtypes = [ctypes.c_void_p]
            _LIB = L
        return _LIB


class StreamReader:
    """Iterate a cell-frequency file in prefetched chunks of ``batch`` rows
    (float32 [rows, cols] host arrays)."""

    def __init__(self, path, batch):
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        self._h = lib().socio_reader_open(
            str(path).encode(), int(batch), ctypes.byref(rows),
            ctypes.byref(cols))
        if not self._h:
            raise IOError("cannot open %s" % path)
        self.rows = rows.value
        self.cols = cols.value
        self.batch = int(batch)

    def __iter__(self):
        buf = np.empty((self.batch, self.cols), np.float32)
        while True:
            got = lib().socio_reader_next(
                self._h, buf.ctypes.data_as(ctypes.c_void_p))
            if got <= 0:
                break
            yield buf[:got].copy()

    def close(self):
        if self._h:
            lib().socio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamWriter:
    """Background-threaded writer of a cell-frequency file of ``rows`` x
    ``cols`` float32 (the int32 header first)."""

    def __init__(self, path, rows, cols):
        self._h = lib().socio_writer_open(str(path).encode(), int(rows),
                                          int(cols))
        if not self._h:
            raise IOError("cannot open %s" % path)
        self.cols = int(cols)

    def put(self, chunk):
        """Queue a [n, cols] chunk (copied before the call returns)."""
        chunk = np.ascontiguousarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[1] != self.cols:
            raise ValueError("chunk of shape %s for a file of %d columns"
                             % (chunk.shape, self.cols))
        lib().socio_writer_put(
            self._h, chunk.ctypes.data_as(ctypes.c_void_p),
            chunk.shape[0])

    def close(self):
        if self._h:
            lib().socio_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
