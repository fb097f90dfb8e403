"""Native (C) runtime components.

The reference's only native dependency is OpenMPI (reached via mpi4py);
its equivalent here is the XLA runtime itself.  The one runtime
component this framework adds in C is the data-loader block reader
(blockio.c): GIL-free strided pread of a single grid block from .npy files,
replacing the reference's read-everything-then-slice loader
(pyDNMFk/data_io.py:92-105).

Compiled lazily with the system C compiler; everything degrades to the
numpy mmap path if a toolchain is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "_blockio.so")
_SRC = os.path.join(_HERE, "blockio.c")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", _SRC, "-o", _SO],
                capture_output=True, timeout=60)
            if r.returncode == 0:
                return True
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
    return False


def get_lib():
    """ctypes handle to the block reader, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = (not os.path.exists(_SO)
                 or (os.path.exists(_SRC)
                     and os.path.getmtime(_SO) < os.path.getmtime(_SRC)))
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.read_block.restype = ctypes.c_int
            lib.read_block.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def _parse_npy_header(path: str):
    """(dtype, shape, data_offset) for a C-order little-endian .npy file,
    or None if the layout is unsupported (fortran order, objects...)."""
    import ast
    with open(path, "rb") as f:
        magic = f.read(6)
        if magic != b"\x93NUMPY":
            return None
        major, _minor = f.read(2)
        if major == 1:
            (hlen,) = np.frombuffer(f.read(2), "<u2")
        else:
            (hlen,) = np.frombuffer(f.read(4), "<u4")
        header = f.read(int(hlen)).decode("latin1")
        offset = f.tell()
    d = ast.literal_eval(header)
    if d.get("fortran_order"):
        return None
    dt = np.dtype(d["descr"])
    if dt.hasobject or (dt.byteorder == ">"):
        return None
    return dt, tuple(d["shape"]), offset


def read_npy_block(path: str, row_start: int, row_stop: int,
                   col_start: int, col_stop: int):
    """Read rows [row_start,row_stop) x cols [col_start,col_stop) of a 2D
    .npy matrix, touching only the needed bytes.  Returns None when the
    native reader can't handle the file (caller falls back to numpy)."""
    lib = get_lib()
    info = _parse_npy_header(path)
    if lib is None or info is None:
        return None
    dt, shape, offset = info
    if len(shape) != 2:
        return None
    m, n = shape
    row_stop = min(row_stop, m)
    col_stop = min(col_stop, n)
    nrows = row_stop - row_start
    ncols = col_stop - col_start
    out = np.empty((nrows, ncols), dtype=dt)
    itemsize = dt.itemsize
    offset0 = offset + (row_start * n + col_start) * itemsize
    rc = lib.read_block(path.encode(), offset0, n * itemsize,
                        ncols * itemsize, nrows,
                        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return None
    return out
