"""ctypes bindings for the native IO tier, built at first use.

The port's own copy of ``fastio.cpp`` (beside this file) is compiled with
the system C++ compiler into
``composablestatespacemodels_torch/_build/fastio-<hash>/libcssm_fastio.so``,
keyed by a hash of the source and flags as ``ops/_build.py`` keys the
kernels, and loaded with ctypes (no pybind11, no build system).  Nothing is
built when the module is imported.  Where no compiler can build it, every
function here returns None / False and :mod:`..utils.io` parses and writes
in pure Python, as the JAX package does; :func:`available` says which tier
runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "fastio.cpp"
_LIB_NAME = "libcssm_fastio.so"
_FLAGS = ["-O3", "-shared", "-fPIC"]
BUILD_ROOT = _HERE.parent / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _TsData(ctypes.Structure):
    _fields_ = [("ts", ctypes.POINTER(ctypes.c_double)),
                ("ys", ctypes.POINTER(ctypes.c_double)),
                ("mask", ctypes.POINTER(ctypes.c_ubyte)),
                ("n", ctypes.c_long),
                ("capacity", ctypes.c_long)]


def library_path() -> pathlib.Path:
    """``_build/fastio-<hash of source and flags>/libcssm_fastio.so``."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_ROOT / f"fastio-{h.hexdigest()[:16]}" / _LIB_NAME


def _build(target: pathlib.Path) -> bool:
    """Compile to a temporary file and rename it into place: a fresh inode
    means a later ``dlopen`` is not served a stale cached handle (glibc
    dedupes by pathname/inode), an in-place rewrite cannot corrupt the
    mapping of another live process, and two concurrent builds resolve to
    whichever rename lands last."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    for cc in ("g++", "c++", "clang++"):
        try:
            subprocess.run([cc, *_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, target)
            return True
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        lib.cssm_parse_timeseries_csv.restype = ctypes.POINTER(_TsData)
        lib.cssm_parse_timeseries_csv.argtypes = [ctypes.c_char_p]
        lib.cssm_parse_timeseries_json.restype = ctypes.POINTER(_TsData)
        lib.cssm_parse_timeseries_json.argtypes = [ctypes.c_char_p]
        lib.cssm_free_tsdata.restype = None
        lib.cssm_free_tsdata.argtypes = [ctypes.POINTER(_TsData)]
        lib.cssm_write_timeseries_csv.restype = ctypes.c_int
        lib.cssm_write_timeseries_csv.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_long]
        lib.cssm_write_matrix_csv.restype = ctypes.c_int
        lib.cssm_write_matrix_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long]
        _lib = lib
    return _lib


def available() -> bool:
    """True if the native tier compiled and loaded."""
    return _load() is not None


def _extract(lib, ptr):
    d = ptr.contents
    n = int(d.n)
    ts = np.ctypeslib.as_array(d.ts, shape=(n,)).copy()
    ys = np.ctypeslib.as_array(d.ys, shape=(n,)).copy()
    mask = np.ctypeslib.as_array(d.mask, shape=(n,)).astype(bool)
    lib.cssm_free_tsdata(ptr)
    return ts, ys, mask


def _parse(entry: str, path: str):
    lib = _load()
    if lib is None:
        return None
    ptr = getattr(lib, entry)(str(path).encode())
    if not ptr:
        return None
    return _extract(lib, ptr)


def parse_timeseries_csv(path: str):
    """Native CSV parse -> ``(ts, ys, mask)`` float64 / float64 / bool numpy
    arrays, or None if the native tier is unavailable or the file cannot
    be opened.  Lenient: a line whose time does not parse is skipped."""
    return _parse("cssm_parse_timeseries_csv", path)


def parse_timeseries_json(path: str):
    """Native line-delimited JSON parse, as :func:`parse_timeseries_csv`."""
    return _parse("cssm_parse_timeseries_json", path)


def write_timeseries_csv(path: str, ts, ys, mask) -> bool:
    """Rows ``t,y`` (``%.17g``; an empty field where ``mask`` is False);
    False if the native tier is unavailable or the write failed."""
    lib = _load()
    if lib is None:
        return False
    ts = np.ascontiguousarray(np.asarray(ts, dtype=np.float64))
    ys = np.ascontiguousarray(np.asarray(ys, dtype=np.float64))
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    return lib.cssm_write_timeseries_csv(str(path).encode(), ts, ys, mask,
                                         len(ts)) == 0


def write_matrix_csv(path: str, header: str, vals) -> bool:
    """Dense matrix CSV writer for posterior chains (the hot path of the
    reference JsonToCSV app, DetermineParameters.scala:90-101): a header
    line, then ``%.17g`` cells; False if unavailable or the write failed."""
    lib = _load()
    if lib is None:
        return False
    vals = np.ascontiguousarray(np.asarray(vals, dtype=np.float64))
    rows, cols = vals.shape
    return lib.cssm_write_matrix_csv(str(path).encode(), header.encode(),
                                     vals, rows, cols) == 0
