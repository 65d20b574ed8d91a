"""Build and load the hand-written Hopper kernels in ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes`` (a source that
includes PyTorch's headers takes minutes to build; this takes seconds).
The library goes into ``composablestatespacemodels_torch/_build/<hash>/``,
keyed by a hash of the sources and flags, so an unchanged tree
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
# entry name -> argtypes (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    "cssm_systematic_counts": [_P, _P, _P, _P, _P, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
                               _P],
    "cssm_systematic_counts_batched": [_P, _P, _P, _P, _P, _P, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int, _P],
    "cssm_resample_propagate": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                _P],
    "cssm_prefix_sum": [_P, _P, _P, ctypes.c_int64, ctypes.c_uint64,
                        ctypes.c_int, _P],
    "cssm_cummax_int32": [_P, _P, _P, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_uint64, ctypes.c_int, _P],
    "cssm_gather": [_P, _P, _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                    _P],
    "cssm_propagate_weights": [_P, _P, _P, _P, _P, _P, ctypes.c_int,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               _P],
    "cssm_pf_sweep_chains": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_float, ctypes.c_int,
                             ctypes.c_int, _P],
    "cssm_pf_sweep_occupancy": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _P],
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
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, all running at once, then one link.  The
    compilers' output (``-Xptxas -v``: registers, spills) is kept in
    ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    cus, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [Path(tmpdir) / (cu.stem + ".o") for cu in cus]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
                for cu, obj in zip(cus, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [p.communicate()[0] for p in procs]
        lib_tmp = Path(tmpdir) / out.name
        link = [nvcc, "-shared", "-o", str(lib_tmp), *map(str, objs)]
        failed = [(cmd, log) for cmd, log, p in zip(cmds, logs, procs)
                  if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                failed = [(link, proc.stdout + proc.stderr)]
        (out.parent / "build.log").write_text("".join(
            " ".join(cmd) + "\n" + log for cmd, log in zip(cmds, logs)))
        if failed:
            cmd, log = failed[0]
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log[-4000:]}")
        os.replace(lib_tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
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
    """The raw handle of the current CUDA stream of ``device`` (a
    ``torch.device`` or its index)."""
    import torch
    index = device if isinstance(device, int) else device.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:         # the handle alone, without a Stream object
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream
