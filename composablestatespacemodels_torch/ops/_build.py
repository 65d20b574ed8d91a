"""Build and load the hand-written Hopper kernels in ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (a source
that includes PyTorch's headers takes minutes to build; this takes
seconds).  The library goes into ``composablestatespacemodels_torch/_build/
<hash>/``, keyed by a hash of the sources and flags, so an unchanged tree
does not rebuild.  Nothing here runs at import time.

Every C entry takes device pointers and the CUDA stream as ``void*``, the
sizes as integers, and returns ``cudaGetLastError()``; :func:`check`
raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
# entry name -> argtypes (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    "cssm_systematic_counts": [_P, _P, _P, _P, _P, _P, ctypes.c_int64,
                               ctypes.c_int, _P],
    "cssm_resample_propagate": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of composablestatespacemodels_torch "
        "are compiled at first use with nvcc (put it on PATH or set "
        "CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """``_build/<hash of sources and flags>/libcssm_kernels.so``."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libcssm_kernels.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    The compiler's output (``-Xptxas -v``: registers, spills) is kept in
    ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    cus, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, cus)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def cuda_stream(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
