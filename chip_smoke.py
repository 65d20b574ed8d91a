#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels of ``composablestatespacemodels_torch`` from
``composablestatespacemodels_torch/csrc/`` with nvcc, holds each kernel
against its plain PyTorch version on the card, drives the main path --
``log_likelihood(..., resample="systematic-fused")`` on the flagship
``poisson(ou(1)) + seasonal(24, 3, ou(6))`` at N = 2^20, T = 1000 -- and
checks the fused filter against the Kalman oracle.  Every check raises on
failure.  Prints one line per phase, then a JSON line of per-kernel
results, and last ``{"ok": true, "device": {...}}``.  Needs one CUDA
device; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

N_MAIN = 2 ** 20
T_MAIN = 1000
N_ORACLE = 2 ** 18
T_ORACLE = 200


def _device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _weights(regime: str, n: int, gen, dev):
    import torch
    z = torch.randn(n, generator=gen, device=dev)
    if regime == "uniform":
        raw = torch.ones(n, device=dev)
    elif regime == "mild":
        raw = torch.exp(0.5 * z)
    elif regime == "heavy":
        raw = torch.exp(z) ** 4
    else:  # degenerate: one spike
        raw = torch.full((n,), 1e-12, device=dev)
        raw[n // 3] = 1.0
    return raw / raw.sum()


def phase_counts(gen, dev, n: int):
    """[3] K1 against its plain version in four weight regimes."""
    import torch

    from composablestatespacemodels_torch.inference import resampling as rs
    from composablestatespacemodels_torch.ops.scan_kernel import (
        systematic_counts_fused, systematic_counts_fused_ref)

    max_err, report, keep = 0, [], None
    for regime in ("uniform", "mild", "heavy", "degenerate"):
        w = _weights(regime, n, gen, dev)
        total = w.sum()
        u = torch.rand((), generator=gen, device=dev)
        ck = systematic_counts_fused(w, total, u)
        cp = systematic_counts_fused_ref(w, total, u)
        torch.cuda.synchronize()
        for name, c in (("kernel", ck), ("plain", cp)):
            if not bool((torch.diff(c) >= 0).all()) or int(c[-1]) != n:
                raise AssertionError(f"K1 {regime}: {name} counts are not "
                                     f"monotone with counts[-1] == N")
        diff = (ck.long() - cp.long())
        bad = diff != 0
        n_bad = int(bad.sum())
        if n_bad:
            v = n * rs._cumsum(w / total) - u
            gap = (v - torch.round(v)).abs()
            ulp = torch.nextafter(v.abs(), torch.tensor(math.inf,
                                                        device=dev)) - v.abs()
            if int(diff.abs().max()) > 1 or not bool(
                    (gap[bad] <= 2 * ulp[bad]).all()):
                raise AssertionError(
                    f"K1 {regime}: {n_bad} mismatches, not all +-1 at ulp "
                    "ties of n*cdf - u")
        max_err = max(max_err, int(diff.abs().max()))
        report.append(f"{regime}={n_bad}")
        if regime == "mild":
            keep = (w, total, u, ck)
    print(f"[3] K1 counts vs plain at N={n}: mismatches {' '.join(report)} "
          "(allowed: +-1 within 2 ulp of an integer); both monotone, "
          "counts[-1]=N", flush=True)
    return max_err, keep


def phase_resample(gen, dev, counts, n: int, d: int = 7):
    """[4] K2 (+K3) against its plain version, identical counts and seed."""
    import torch

    from composablestatespacemodels_torch.inference.resampling import (
        _ancestors_from_counts)
    from composablestatespacemodels_torch.models.observation import (
        KERNEL_CONSTS, Gaussian, Poisson)
    from composablestatespacemodels_torch.ops.resample_kernel import (
        resample_propagate, resample_propagate_ref)

    x = torch.randn((d, n), generator=gen, device=dev) * 0.3
    a = 0.5 + 0.5 * torch.rand(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    design = 0.5 + torch.rand(d, generator=gen, device=dev)
    seed = torch.tensor(123456789, dtype=torch.int32, device=dev)
    anc = _ancestors_from_counts(counts, n).long()
    max_err, lines, keep = 0.0, [], None
    for fam, yobs, scale in ((Poisson(), 3.0, 1.0), (Gaussian(), 0.7, 0.4)):
        make_consts, fid = fam.kernel_log_density()
        consts = torch.zeros(KERNEL_CONSTS, device=dev)
        c = make_consts(torch.tensor(yobs, device=dev),
                        torch.tensor(scale, device=dev))
        consts[:c.shape[-1]] = c
        for s_val in (0.0, 0.3):
            s = torch.full((d,), s_val, device=dev)
            coef = torch.stack([a, b, s, design], dim=1).contiguous()
            yk, lk = resample_propagate(x, counts, coef, consts, seed, fid)
            yp, lp = resample_propagate_ref(x, counts, coef, consts, seed, fid)
            torch.cuda.synchronize()
            if s_val == 0.0:
                if not torch.equal(yk, a[:, None] * x[:, anc] + b[:, None]):
                    raise AssertionError(f"K2 {type(fam).__name__} s=0: y is "
                                         "not a*x[:, anc] + b bit for bit")
            else:
                torch.testing.assert_close(yk, yp, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(lk, lp, rtol=2e-5, atol=1e-5)
            ey = float((yk - yp).abs().max())
            el = float((lk - lp).abs().max())
            max_err = max(max_err, ey, el)
            lines.append(f"{type(fam).__name__}/s={s_val}: y {ey:.3g} "
                         f"logw {el:.3g}")
            if isinstance(fam, Poisson) and s_val:
                keep = (x, counts, coef, consts, seed, fid)
    print(f"[4] K2+K3 vs plain at d={d} N={n}: max abs err "
          f"{'; '.join(lines)}; s=0 bit-exact to a*x[:, anc] + b",
          flush=True)
    return max_err, keep


def flagship():
    import composablestatespacemodels_torch as ct
    model = (ct.poisson(ct.ou_process(1))
             + ct.seasonal(24, 3, ct.ou_process(6)))
    params = ct.branch(
        ct.leaf(ct.param_node(None, ct.ou_params(1.0, 0.2, 0.3, 1.0, 0.3))),
        ct.leaf(ct.param_node(None, ct.ou_params(0.2, 0.2, 0.25, 0.2, 0.2))))
    return model, params


def phase_main(dev, device_line: str):
    """[5] the main path at full width through log_likelihood."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.ops.resample_kernel import (
        resample_propagate)
    from composablestatespacemodels_torch.ops.scan_kernel import (
        systematic_counts_fused)

    model, params = flagship()
    sim = ct.simulate_regular(model, params,
                              torch.Generator(device=dev).manual_seed(0),
                              T_MAIN, dt=1.0)
    data = sim.to_timeseries()
    if not bool(torch.isfinite(data.ys).all()):
        raise AssertionError("simulated flagship series is not finite")
    n_resample = int(data.mask.sum())

    def run(seed):
        return ct.log_likelihood(model, params, data, N_MAIN,
                                 torch.Generator(device=dev).manual_seed(seed),
                                 resample="systematic-fused")

    float(run(100))  # warm-up
    torch.cuda.synchronize()
    systematic_counts_fused.launches = 0
    resample_propagate.launches = 0
    ms, host_s, lls = [], [], []
    for r in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        ll = run(101 + r)
        end.record()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        ms.append(start.elapsed_time(end))
        lls.append(float(ll))
    launches = {"K1": systematic_counts_fused.launches,
                "K2": resample_propagate.launches}
    if not all(math.isfinite(v) for v in lls):
        raise AssertionError(f"flagship ll not finite: {lls}")
    for k, v in launches.items():
        if v != 3 * n_resample:
            raise AssertionError(f"{k} launched {v} times over 3 runs, "
                                 f"expected {3 * n_resample}")
    med = statistics.median(ms)
    print(f"[5] flagship d={model.dim} N={N_MAIN} T={T_MAIN}: ll {lls}; "
          f"{med:.1f} ms/run (CUDA events; runs {[round(m, 1) for m in ms]},"
          f" host {[round(h, 3) for h in host_s]} s), "
          f"{med / T_MAIN:.4f} ms/step, "
          f"{N_MAIN * T_MAIN / (med / 1e3):.4g} particle-steps/s; "
          f"launches K1={launches['K1']} K2={launches['K2']} over 3 runs "
          f"({n_resample} resampling steps each); {device_line}", flush=True)
    return launches


def phase_oracle(dev):
    """[6] fused filter (Gaussian K3) against the Kalman oracle."""
    import torch

    import composablestatespacemodels_torch as ct

    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    data = ct.simulate_regular(
        model, params, torch.Generator(device=dev).manual_seed(7),
        T_ORACLE).to_timeseries()
    kf = float(ct.kalman_filter(model, params, data).ll)
    lls = [float(ct.log_likelihood(
        model, params, data, N_ORACLE,
        torch.Generator(device=dev).manual_seed(200 + r),
        resample="systematic-fused")) for r in range(8)]
    mean = statistics.fmean(lls)
    se = statistics.stdev(lls) / math.sqrt(len(lls))
    print(f"[6] oracle linear(brownian(1)) T={T_ORACLE} N={N_ORACLE}: "
          f"PF mean ll {mean:.4f} (se {se:.4f}, 8 runs) vs Kalman {kf:.4f}: "
          f"{abs(mean - kf) / se:.2f} se", flush=True)
    if not abs(mean - kf) <= 4 * se:
        raise AssertionError("fused filter disagrees with the Kalman oracle "
                             "by more than 4 standard errors")


def phase_timing(counts_in, prop_in):
    """[7] each kernel alone against its plain version at N = 2^20."""
    from composablestatespacemodels_torch.ops.resample_kernel import (
        resample_propagate, resample_propagate_ref)
    from composablestatespacemodels_torch.ops.scan_kernel import (
        systematic_counts_fused, systematic_counts_fused_ref)

    times = {}
    # plain, kernel, kernel, plain: compare within one call, in turns
    for name, kern, ref, args in (
            ("K1", systematic_counts_fused, systematic_counts_fused_ref,
             counts_in),
            ("K2", resample_propagate, resample_propagate_ref, prop_in)):
        p1 = _cuda_ms(lambda: ref(*args), 10)
        k1 = _cuda_ms(lambda: kern(*args), 100)
        k2 = _cuda_ms(lambda: kern(*args), 100)
        p2 = _cuda_ms(lambda: ref(*args), 10)
        times[name] = (min(k1, k2), min(p1, p2))
    print(f"[7] kernel alone vs plain at N={N_MAIN}: "
          + "; ".join(f"{k} {v[0]:.4f} ms vs {v[1]:.4f} ms"
                      for k, v in times.items()), flush=True)
    return times


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    from composablestatespacemodels_torch.ops import _build

    dev = torch.device("cuda", 0)
    device_line = _device_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    print(device_line, flush=True)

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log = (path.parent / "build.log").read_text().splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    print(f"[2] built {path.relative_to(_build.BUILD_ROOT.parent.parent)} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(1234)
    k1_err, counts_in = phase_counts(gen, dev, N_MAIN)
    k2_err, prop_in = phase_resample(gen, dev, counts_in[3], N_MAIN)
    launches = phase_main(dev, device_line)
    phase_oracle(dev)
    times = phase_timing(counts_in[:3], prop_in)

    src = "composablestatespacemodels_torch/csrc/"
    kernels = [
        {"name": "K1 systematic_counts_fused", "route": "cuda",
         "source": src + "counts.cu",
         "replaces": "composablestatespacemodels_tpu/ops/scan_kernel.py:550",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "K2+K3 resample_propagate (Poisson/Gaussian log-density)",
         "route": "cuda", "source": src + "resample_propagate.cu",
         "replaces":
             "composablestatespacemodels_tpu/ops/resample_kernel.py:667",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
