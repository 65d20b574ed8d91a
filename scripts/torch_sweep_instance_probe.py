#!/usr/bin/env python3
"""K8 with and without its one-warp scan instance, on one CUDA card.

    python3 scripts/torch_sweep_instance_probe.py

Builds ``composablestatespacemodels_torch/csrc/sweep.cu`` twice with the
port's nvcc flags: as it is (A), and with the one-warp branch of the scan
dispatch taken out (B), so that every warp count runs the instance that
reads the count at run time, ``sweep_scan<false>``.  Holds B's ll and
x_final bit for bit to A's, then times both through ``pf_sweep_chains`` at
(B, N) = (1, 100), (256, 100), (1, 512), d = 7, T = 400 (Poisson), with
CUDA events, 10 calls a round, in the rounds A, B, B, A.  Prints ptxas's
registers and spills of each build, the card's name and power limit, and
last one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = ((1, 100), (256, 100), (1, 512))
ONE_WARP_BRANCH = "if (scan_warps == 1) {"


def _build_pair(tmp: Path):
    """Build A and B side by side; return {variant: (library, ptxas)}."""
    from chip_smoke import _ptxas_summary
    from composablestatespacemodels_torch.ops import _build

    src = (_build.CSRC / "sweep.cu").read_text()
    if src.count(ONE_WARP_BRANCH) != 1:
        raise SystemExit(f"sweep.cu has no single {ONE_WARP_BRANCH!r}")
    variant = tmp / "sweep_runtime_warps.cu"
    variant.write_text(src.replace(ONE_WARP_BRANCH, "if (false) {"))
    sources = {"A": _build.CSRC / "sweep.cu", "B": variant}
    nvcc = _build._nvcc()
    procs = {k: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", str(cu),
         "-o", str(tmp / f"{k}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, cu in sources.items()}
    out = {}
    for k, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {k}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(tmp / f"{k}.so"))
        lib.cssm_pf_sweep_chains.argtypes = (
            _build._SIGNATURES["cssm_pf_sweep_chains"])
        lib.cssm_pf_sweep_chains.restype = ctypes.c_int
        out[k] = (lib, [ln for ln in _ptxas_summary(log.splitlines())
                        if ln.startswith("sweep_kernel<1>")])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from chip_smoke import _device_line, _sweep_case
    from composablestatespacemodels_torch.ops import _build
    from composablestatespacemodels_torch.ops.sweep_kernel import (
        pf_sweep_chains)

    dev = torch.device("cuda", 0)
    device_line = _device_line()
    print(device_line, flush=True)
    result = {"device": device_line, "registers": {}, "ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_pair(Path(tmp))
        for k, (_, ptxas) in libs.items():
            result["registers"][k] = ptxas
            print(f"{k}: {ptxas}", flush=True)
        gen = torch.Generator(device=dev).manual_seed(27)
        for b, n in SHAPES:
            args = _sweep_case(gen, dev, n, 7, b, 400, "Poisson")

            def run(key, calls):
                _build._lib = libs[key][0]
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(calls):
                    got = pf_sweep_chains(*args)
                end.record()
                torch.cuda.synchronize()
                return got, start.elapsed_time(end) / calls

            (lla, xa), _ = run("A", 1)
            (llb, xb), _ = run("B", 1)
            if not (torch.equal(lla, llb) and torch.equal(xa, xb)):
                raise AssertionError(f"A and B differ at (B, N) = ({b}, {n})")
            rounds = {"A": [], "B": []}
            for key in ("A", "B", "B", "A"):
                rounds[key].append(run(key, 10)[1])
            result["ms"][f"B={b} N={n}"] = rounds
            print(f"(B, N) = ({b}, {n}): A {rounds['A']} ms, "
                  f"B {rounds['B']} ms", flush=True)
    _build._lib = None
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
