#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels of ``composablestatespacemodels_torch`` from
``composablestatespacemodels_torch/csrc/`` with nvcc, holds each kernel
against its plain PyTorch version on the card, and drives the port's
paths on the flagship ``poisson(ou(1)) + seasonal(24, 3, ou(6))`` at
N = 2^20, T = 1000: ``log_likelihood(..., resample="systematic-fused")``
(K1, K2) and ``bootstrap_filter(..., store="summary")`` under
``"systematic-pallas"`` (K1, K4) and ``"systematic-pallas-fused"`` (K1,
K4, K5), each with its launch counters set to 0 just before and read just
after.  Checks the filters against the Kalman oracle, stratified
(K7a, K7b, K4) included, and times each kernel against its plain version.
Then PMMH (slice 3): K1 and K4 at the single chain's N = 100, K6 batched
and K8 against their plain versions bit for bit (K8 also on the inputs
each fused tier hands it at T = 400), K8 against the Kalman oracle and
against ``log_likelihood``, and
the five PMMH tiers of the JAX bench on the flagship at N = 100, T = 400
(``pmmh`` with ``make_pf_loglik`` -- K1, K4 --, with ``fused_sweep=True``
-- K8 --, at N = 512, and ``pmmh_chains`` over 256 chains on the chain
axis -- K6 batched -- and with ``pf_ll_chains`` -- K8), each rate the best
of 3 beside the card's name and power limit, launch counters read around
the timed runs.  Then the observation families and schemes: the
K3 device function of each of the seven pointwise families inside K2, K5
and K8 against its torch twin, bit for bit; each family leftmost in the
flagship's shape at full width through the fused ``log_likelihood`` and
the fused summary filter, against the generic ``"systematic"`` route; the
``"systematic"``, ``"stratified"``, ``"multinomial"`` and ``"residual"``
schemes against Kalman; ``forecast_times``; fused PMMH for the negative
binomial; and one PyTorch call per kernel function where one exists.
K1 is held to its plain version also on weights whose negative runs make
the counts fall across tiles (the running-max carry); K2 and K4 on the
counts of four weight regimes and of two spikes, at N = 100, 2^20 and
2^20 + 5 (K4 also at d = 1 and 13 and on a misaligned counts view), and
timed on each; K7a bit for bit from N = 1 to 2^22 + 3 and over 200
back-to-back calls; K6 batched bit for bit on rows of 1 to 4097 (and 2^17)
weights, B = 1, 3, 256, and K8 at n = 1 to 1024, d = 1, 7, 13, B = 1, 3,
256, every family.  Then each kernel's device time per call from
``torch.profiler``, with K1, K4, K7a, K7b, K6 batched and K8 held to one
CUDA kernel per call, K8's at three (B, N), ptxas's registers for K6
batched and K8, and the blocks of K8 an SM holds at N = 100 (CUDA
runtime), with the waves that 256 chains take.  Last, slice 8: K7b bit
for bit against ``torch.cummax`` at its edge sizes, misaligned, on float
bits and between K7a and K1 calls; ``interpolation_filter`` on the
flagship at T = 1000 with a 100-step gap (``store="summary"`` at N = 2^20
under ``"systematic"`` -- K1, K4 -- and ``"stratified"`` -- K7a, K7b, K4
--, ``store="path"`` at N = 2^18, the two tiers equal on one seed), on the
Kalman oracle and under every other scheme and a callable;
``lgcp_filter`` at the JAX bench's shape (N = 2^17, events simulated by
``simulate_lgcp`` over [0, 20]) under both schemes, with its
particle-slot-steps/s; and the new paths' device time per step.
Every check raises on failure.  Prints one line per phase, a JSON line
of the new paths' rates, then a JSON line of per-kernel results (with
each kernel's bound from this run's shapes, ``ms`` the back-to-back time
per call and ``device_ms`` the profiler's), and last ``{"ok": true,
"device": {...}}``.
Needs one CUDA device; without one it exits non-zero and prints no result.
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
# PMMH at the JAX bench's shapes (bench.py:250-460); iterations per timed
# run cut from its 500 / 200 / 300 / 100 / 100
N_PMMH, T_PMMH, CHAINS = 100, 400, 256
PMMH_ITERS = {"single": 40, "chains": 20, "fused": 300,
              "chains_fused": 100, "fused_n512": 100}
# the seven pointwise observation families (K3): observations for the
# constants of K2 and K5 (both branches of ZIP and Bernoulli) and the
# constrained scale
K3_CASES = {"Gaussian": ((0.7,), 0.4), "Poisson": ((3.0,), 1.0),
            "ZeroInflatedPoisson": ((0.0, 3.0), 0.3),
            "NegativeBinomial": ((5.0,), 3.0), "Bernoulli": ((0.0, 1.0), 1.0),
            "StudentsT": ((1.2,), 0.4), "Beta": ((0.3,), 2.0)}
# largest float32 ulp distance allowed between a K3 device function and its
# torch twin on the card (0: bit-equal)
K3_ULPS = {name: 0 for name in K3_CASES}
# runs per route of the full-width families' statistical gate, at N = 2^18
FAMILY_RUNS, N_FAMILY_GATE = 10, 2 ** 18
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 outside
# the tensor cores; bound_ms is the larger of bytes and operations over them
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# operations counted per Philox4x32-10 + Box-Muller normal (10 rounds of two
# 32-bit multiplies and four xors for four normals, then a log, a sqrt and a
# sine or cosine) and per K3 log-density
OPS_NORMAL, OPS_K3 = 40, 20


def _family(name: str):
    from composablestatespacemodels_torch.models import observation
    return getattr(observation, name)()


def _bound(bytes_moved: float, ops: float):
    """``(bound_ms, bound_by)``: the least time the card could take."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ulps(a, b) -> int:
    """The largest distance in float32 ulps between ``a`` and ``b`` (0 for
    bit-equal tensors; NaN and infinities count by their bits)."""
    import torch
    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    ma = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    mb = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ma - mb).abs().max())


def _ptxas_summary(log_lines) -> list:
    """``name<template args>: R regs, S B spills`` for every kernel in a
    build log of ``nvcc -Xptxas -v`` (names read from the mangled ones)."""
    import re
    out, name, spill = [], None, 0
    for ln in log_lines:
        m = re.search(r"Compiling entry function '(_Z\w+)'", ln)
        if m:
            mangled = m.group(1)
            k = re.match(r"_Z(?:N4cssm)?(\d+)", mangled)
            start = k.end()
            name = mangled[start:start + int(k.group(1))]
            t = re.match(r"I((?:Li\d+E)+)E",
                         mangled[start + int(k.group(1)):])
            if t:
                args = re.findall(r"Li(\d+)E", t.group(1))
                name += "<" + ",".join(args) + ">"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill} B spills")
            name, spill = None, 0
    return out


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


def _profile(fn, iters: int = 20, expect=None):
    """``(device ms per call, CUDA kernels per call, their names)`` of
    ``fn()`` from ``torch.profiler``: the device time of every CUDA kernel
    that ``iters`` calls launched, summed and divided by ``iters``; None
    for the time when the profiler saw no device activity.  With
    ``expect`` (the kernels one call launches), a window that saw another
    count is taken again, up to three windows in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if expect is None or len(kernels) == expect * iters:
            break
    if not kernels:
        return None, 0.0, []
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return us / iters / 1e3, len(kernels) / iters, sorted(
        {e.name for e in kernels})


def _host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn()`` over ``calls`` calls made
    back to back with no synchronisation (the device's queue absorbs
    them), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def _weights(regime: str, n: int, gen, dev):
    import torch
    z = torch.randn(n, generator=gen, device=dev)
    if regime == "uniform":
        raw = torch.ones(n, device=dev)
    elif regime == "mild":
        raw = torch.exp(0.5 * z)
    elif regime == "heavy":
        raw = torch.exp(z) ** 4
    elif regime == "carry":
        raw = _carry_weights(z)
    else:  # degenerate: one spike
        raw = torch.full((n,), 1e-12, device=dev)
        raw[n // 3] = 1.0
    return raw / raw.sum()


# K1's tile (csrc/scan.cuh: kTile)
K1_TILE = 4096


def _carry_weights(z):
    """Mild weights with negative runs across tile boundaries (every 16th
    boundary, and one run over two whole boundaries), so the cdf, and the
    counts before their running max, fall from one tile into the next: the
    running-max carry across tiles has work to do.  Below two tiles one
    run in the middle."""
    raw = (0.5 * z).exp()
    n = raw.shape[0]
    half = min(300, n // 10)
    for edge in range(K1_TILE, n, 16 * K1_TILE) if n > K1_TILE else [n // 2]:
        raw[edge - half:edge + half] = -3.0
    if n > 6 * K1_TILE:
        raw[3 * K1_TILE - half:5 * K1_TILE + half] = -0.5
    return raw


def _carried(w, total, u, n: int) -> int:
    """Entries of the plain counts before their running max that lie below
    the maximum of the earlier tiles: what the carry across tiles lifts."""
    import torch

    from composablestatespacemodels_torch.inference import resampling as rs
    c0 = torch.clamp(torch.ceil(n * rs._cumsum_ref(w / total) - u), 0,
                     n).to(torch.int32)
    c0[-1] = n
    start = torch.arange(n, device=w.device) // K1_TILE * K1_TILE
    before = torch.cummax(c0, 0).values[(start - 1).clamp(min=0)]
    return int(((start > 0) & (c0 < before)).sum())


def phase_counts(gen, dev, n: int):
    """[3] K1 against its plain version in four weight regimes and on
    weights with negative runs across tile boundaries (the carry case)."""
    import torch

    from composablestatespacemodels_torch.inference import resampling as rs
    from composablestatespacemodels_torch.ops.scan_kernel import (
        systematic_counts_fused, systematic_counts_fused_ref)

    max_err, report, keep, carried = 0, [], None, 0
    for regime in ("uniform", "mild", "heavy", "degenerate", "carry"):
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
        if regime == "carry":
            carried = _carried(w, total, u, n)
            if n > K1_TILE and not carried:
                raise AssertionError("K1 carry case: no count falls across "
                                     "a tile boundary")
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
          f"counts[-1]=N; the carry case lifts {carried} counts across tile "
          "boundaries", flush=True)
    return max_err, keep


# the counts K2 is held and timed on: K1's on the four weight regimes, and
# two spikes at 0 and N - 1 with N - 2 zero-offspring particles between
K2_REGIMES = ("uniform", "mild", "heavy", "degenerate", "spikes")


def _regime_counts(regime: str, n: int, gen, dev):
    import torch

    from composablestatespacemodels_torch.ops.scan_kernel import (
        systematic_counts_fused)

    if regime == "spikes":
        c = torch.full((n,), n // 2, dtype=torch.int32, device=dev)
        c[-1] = n
        return c
    w = _weights(regime, n, gen, dev)
    return systematic_counts_fused(
        w, w.sum(), torch.rand((), generator=gen, device=dev))


def phase_resample(gen, dev):
    """[4] K2 (+K3) against its plain version, identical counts and seed,
    on the counts of every K2 regime at d = 7 and N = 100, 2^20 and
    2^20 + 5, and at d = 13 (rows past K2's eight preloaded ones) on the
    mild and spike counts at N = 100 and 2^20 + 5; with s = 0, y bit for
    bit a*x[:, anc] + b.  Returns the largest error, the mild Poisson case
    at d = 7, N = 2^20 and every regime's counts there."""
    import torch

    from composablestatespacemodels_torch.inference.resampling import (
        _ancestors_from_counts)
    from composablestatespacemodels_torch.models.observation import (
        KERNEL_CONSTS, Gaussian, Poisson)
    from composablestatespacemodels_torch.ops.resample_kernel import (
        resample_propagate, resample_propagate_ref)

    max_err, cases, keep, regime_counts = 0.0, 0, None, {}
    wide = ("mild", "spikes")
    for d, n, regimes in ((7, N_PMMH, K2_REGIMES), (7, N_MAIN, K2_REGIMES),
                          (7, N_MAIN + 5, K2_REGIMES), (13, N_PMMH, wide),
                          (13, N_MAIN + 5, wide)):
        x = torch.randn((d, n), generator=gen, device=dev) * 0.3
        a = 0.5 + 0.5 * torch.rand(d, generator=gen, device=dev)
        b = 0.1 * torch.randn(d, generator=gen, device=dev)
        design = 0.5 + torch.rand(d, generator=gen, device=dev)
        seed = torch.tensor(123456789, dtype=torch.int32, device=dev)
        for regime in regimes:
            counts = _regime_counts(regime, n, gen, dev)
            if n == N_MAIN:
                regime_counts[regime] = counts
            anc = _ancestors_from_counts(counts, n).long()
            for fam, yobs, scale in ((Poisson(), 3.0, 1.0),
                                     (Gaussian(), 0.7, 0.4)):
                make_consts, fid = fam.kernel_log_density()
                consts = torch.zeros(KERNEL_CONSTS, device=dev)
                c = make_consts(torch.tensor(yobs, device=dev),
                                torch.tensor(scale, device=dev))
                consts[:c.shape[-1]] = c
                for s_val in (0.0, 0.3):
                    s = torch.full((d,), s_val, device=dev)
                    coef = torch.stack([a, b, s, design], dim=1).contiguous()
                    args = (x, counts, coef, consts, seed, fid)
                    yk, lk = resample_propagate(*args)
                    yp, lp = resample_propagate_ref(*args)
                    torch.cuda.synchronize()
                    what = (f"K2 {type(fam).__name__} {regime} d={d} N={n} "
                            f"s={s_val}")
                    if s_val == 0.0 and not torch.equal(
                            yk, a[:, None] * x[:, anc] + b[:, None]):
                        raise AssertionError(f"{what}: y is not "
                                             "a*x[:, anc] + b bit for bit")
                    torch.testing.assert_close(yk, yp, rtol=1e-5, atol=1e-6,
                                               msg=what)
                    torch.testing.assert_close(lk, lp, rtol=2e-5, atol=1e-5,
                                               msg=what)
                    max_err = max(max_err, float((yk - yp).abs().max()),
                                  float((lk - lp).abs().max()))
                    cases += 1
                    if (n == N_MAIN and regime == "mild"
                            and isinstance(fam, Poisson) and s_val):
                        keep = args
    print(f"[4] K2+K3 vs plain at d=7, N in {{{N_PMMH}, {N_MAIN}, "
          f"{N_MAIN + 5}}} on the counts of {', '.join(K2_REGIMES)}, and at "
          f"d=13, N in {{{N_PMMH}, {N_MAIN + 5}}} on {', '.join(wide)} "
          f"(Poisson and Gaussian, s in {{0, 0.3}}; {cases} cases): max abs "
          f"err {max_err:.3g}; s=0 bit-exact to a*x[:, anc] + b", flush=True)
    return max_err, keep, regime_counts


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


def phase_main_device(dev):
    """[28] the device time per step of phase 5's path: every CUDA kernel
    of one more fused log_likelihood run under torch.profiler, by name
    (last, since a window of ~25,000 kernels can cost later windows
    records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import composablestatespacemodels_torch as ct

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_MAIN, dt=1.0).to_timeseries()
    gen = torch.Generator(device=dev).manual_seed(104)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(ct.log_likelihood(model, params, data, N_MAIN, gen,
                                resample="systematic-fused"))
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), k + 1)
    dev_us = sum(t for t, _ in by_name.values()) / T_MAIN
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"[28] flagship log_likelihood d={model.dim} N={N_MAIN} "
          f"T={T_MAIN}, device time (torch.profiler, one run): "
          f"{dev_us:.1f} us/step in "
          f"{sum(k for _, k in by_name.values()) / T_MAIN:.1f} kernels/step;"
          " largest " + ", ".join(f"{name[:40]} {t / T_MAIN:.1f} us/step"
                                  for name, (t, _) in top), flush=True)
    return dev_us


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


def _time_k2_regimes(prop_in, regime_counts):
    """K2 alone (100 back-to-back calls, the better of two) on the counts of
    every K2 regime, the other inputs those of the mild case."""
    from composablestatespacemodels_torch.ops.resample_kernel import (
        resample_propagate)

    x, _, coef, consts, seed, fid = prop_in
    out = {}
    for regime, counts in regime_counts.items():
        out[regime] = min(_cuda_ms(lambda: resample_propagate(
            x, counts, coef, consts, seed, fid), 100) for _ in range(2))
    return out


def phase_timing(counts_in, prop_in, regime_counts):
    """[7] each kernel alone against its plain version at N = 2^20; K2 on
    every regime's counts."""
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
    k2_regimes = _time_k2_regimes(prop_in, regime_counts)
    print(f"[7] kernel alone vs plain at N={N_MAIN}: "
          + "; ".join(f"{k} {v[0]:.4f} ms vs {v[1]:.4f} ms"
                      for k, v in times.items())
          + "; K2 by counts regime: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in k2_regimes.items()), flush=True)
    return times, k2_regimes


def _counters():
    from composablestatespacemodels_torch.ops import resample_kernel as rk
    from composablestatespacemodels_torch.ops import scan_kernel as sk
    from composablestatespacemodels_torch.ops import sweep_kernel as swk
    return {"K1": sk.systematic_counts_fused, "K2": rk.resample_propagate,
            "K4": rk.sorted_gather_resample_t, "K5": rk.propagate_weights_t,
            "K7a": sk.prefix_sum, "K7b": sk.cummax_int32,
            "K6b": sk.systematic_counts_batched, "K8": swk.pf_sweep_chains}


def _reset_counters():
    for fn in _counters().values():
        fn.launches = 0


def _read_counters():
    return {k: fn.launches for k, fn in _counters().items()}


K4_SIZES, K4_WIDTHS = (N_PMMH, N_MAIN, N_MAIN + 5), (1, 7, 13)


def phase_gather(gen, dev):
    """[8] K4 against its plain version, bit for bit, on the counts of
    every K2 regime at every N of K4_SIZES and d of K4_WIDTHS, and on a
    counts view that is not 16-byte aligned (the merge's 4-byte cp.async
    path).  Returns the mild case at d = 7, N = 2^20."""
    import torch

    from composablestatespacemodels_torch.ops import _build
    from composablestatespacemodels_torch.ops.resample_kernel import (
        sorted_gather_resample_t, sorted_gather_resample_t_ref)

    src = (_build.CSRC / "gather.cu").read_text()
    if "merge_path_ancestors" not in src or "upper_bound" in src:
        raise AssertionError("gather.cu does not find its ancestors by the "
                             "merge path")
    keep, cases = None, 0
    for n in K4_SIZES:
        xs = {d: torch.randn((d, n), generator=gen, device=dev)
              for d in K4_WIDTHS}
        for regime in K2_REGIMES:
            counts = _regime_counts(regime, n, gen, dev)
            buf = torch.empty(n + 1, dtype=torch.int32, device=dev)
            buf[1:] = counts
            for d, x in xs.items():
                views = (("", counts), (" misaligned", buf[1:]))
                for what, c in views if d == 7 else views[:1]:
                    yk = sorted_gather_resample_t(x, c)
                    yp = sorted_gather_resample_t_ref(x, counts)
                    torch.cuda.synchronize()
                    if not torch.equal(yk, yp):
                        raise AssertionError(
                            f"K4 {regime}{what} d={d} N={n}: "
                            f"{int((yk != yp).sum())} entries differ from "
                            "x[:, ancestors(counts)]")
                    cases += 1
            if n == N_MAIN and regime == "mild":
                keep = (xs[7], counts)
    print(f"[8] K4 gather vs plain: bit-equal at N in {K4_SIZES}, d in "
          f"{K4_WIDTHS} on the counts of {', '.join(K2_REGIMES)}, and on a "
          f"misaligned counts view at d=7 ({cases} cases)", flush=True)
    return 0.0, keep


def phase_propagate(gen, dev, n: int, d: int = 7):
    """[9] K5 (+K3) against its plain version, same seed."""
    import torch

    from composablestatespacemodels_torch.models.observation import (
        KERNEL_CONSTS, Gaussian, Poisson)
    from composablestatespacemodels_torch.ops.resample_kernel import (
        propagate_weights_t, propagate_weights_t_ref)

    x = torch.randn((d, n), generator=gen, device=dev) * 0.3
    a = 0.5 + 0.5 * torch.rand(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    design = 0.5 + torch.rand(d, generator=gen, device=dev)
    seed = torch.tensor(987654321, dtype=torch.int32, device=dev)
    max_err, lines, keep = 0.0, [], None
    for fam, yobs, scale in ((Poisson(), 3.0, 1.0), (Gaussian(), 0.7, 0.4),
                             (None, 0.0, 0.0)):
        name = "unweighted" if fam is None else type(fam).__name__
        consts, fid = None, None
        if fam is not None:
            make_consts, fid = fam.kernel_log_density()
            consts = torch.zeros(KERNEL_CONSTS, device=dev)
            c = make_consts(torch.tensor(yobs, device=dev),
                            torch.tensor(scale, device=dev))
            consts[:c.shape[-1]] = c
        for s_val in (0.0, 0.3):
            cols = [a, b, torch.full((d,), s_val, device=dev)]
            if fam is not None:
                cols.append(design)
            coef = torch.stack(cols, dim=1).contiguous()
            yk, lk = propagate_weights_t(x, coef, consts, seed, fid)
            yp, lp = propagate_weights_t_ref(x, coef, consts, seed, fid)
            torch.cuda.synchronize()
            if s_val == 0.0:
                if not torch.equal(yk, a[:, None] * x + b[:, None]):
                    raise AssertionError(f"K5 {name} s=0: y is not a*x + b "
                                         "bit for bit")
            else:
                torch.testing.assert_close(yk, yp, rtol=1e-5, atol=1e-6)
            ey = float((yk - yp).abs().max())
            el = 0.0
            if fam is not None:
                torch.testing.assert_close(lk, lp, rtol=2e-5, atol=1e-5)
                el = float((lk - lp).abs().max())
            max_err = max(max_err, ey, el)
            lines.append(f"{name}/s={s_val}: y {ey:.3g} logw {el:.3g}")
            if isinstance(fam, Poisson) and s_val:
                keep = (x, coef, consts, seed, fid)
    print(f"[9] K5+K3 vs plain at d={d} N={n}: max abs err "
          f"{'; '.join(lines)}; s=0 bit-exact to a*x + b", flush=True)
    return max_err, keep


# K7a's sizes in phase 10: one element, a tile and one, the oracle's and
# the main path's N, and more than 1024 tiles (each thread of the offset sum
# then adds two tile sums); and its repeated calls at N = 2^20
K7A_SIZES = (1, 4097, 2 ** 18, 2 ** 20, 2 ** 22 + 3)
K7A_REPEATS = 200


def phase_scans(gen, dev, n: int):
    """[10] K7a against its plain version bit for bit at every K7A_SIZES
    size in four weight regimes, on a view whose data is not 16-byte
    aligned, and over K7A_REPEATS calls at N = 2^20 on distinct inputs,
    launched back to back before any is compared (a tile sum read before
    its flag would show as a difference); K7b and the kernel-built
    stratified counts against theirs at N = 2^20."""
    import torch

    from composablestatespacemodels_torch.inference import resampling as rs
    from composablestatespacemodels_torch.ops.scan_kernel import (
        cummax_int32, cummax_int32_ref, prefix_sum, prefix_sum_ref)

    def same(what, k, p):
        if not torch.equal(k, p):
            raise AssertionError(f"{what}: {int((k != p).sum())} entries "
                                 "differ from the plain version")

    for size in K7A_SIZES:
        for regime in ("uniform", "mild", "heavy", "degenerate"):
            w = _weights(regime, size, gen, dev)
            same(f"K7a {regime} N={size}", prefix_sum(w), prefix_sum_ref(w))
    buf = torch.randn(n + 1, generator=gen, device=dev)
    same("K7a on a misaligned view", prefix_sum(buf[1:]),
         prefix_sum_ref(buf[1:]))
    ins = [torch.rand(n, generator=gen, device=dev) - 0.25
           for _ in range(K7A_REPEATS)]
    outs = [prefix_sum(w) for w in ins]
    for r, (w, o) in enumerate(zip(ins, outs)):
        same(f"K7a repeat {r}", o, prefix_sum_ref(w))
    del ins, outs
    keep = None
    for regime in ("uniform", "mild", "heavy", "degenerate"):
        w = _weights(regime, n, gen, dev)
        c = torch.randint(-1000, n, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        u = torch.rand(n, generator=gen, device=dev)
        sk = rs.stratified_counts(w, u)
        sp = torch.cummax(rs._stratified_from_cdf(
            rs._cumsum_ref(w / w.sum()), u, n), dim=0).values
        same(f"K7b cummax_int32 {regime}", cummax_int32(c),
             cummax_int32_ref(c))
        same(f"stratified counts {regime}", sk, sp)
        if not bool((torch.diff(sk) >= 0).all()) or int(sk[-1]) != n:
            raise AssertionError(f"stratified counts {regime}: not monotone "
                                 "with counts[-1] == N")
        if regime == "heavy":
            keep = (w, c)
    print(f"[10] K7a prefix_sum vs plain: bit-equal at N in {K7A_SIZES} in "
          "the uniform, mild, heavy and degenerate regimes, on a misaligned "
          f"view, and over {K7A_REPEATS} back-to-back calls at N={n} on "
          "distinct inputs; K7b cummax_int32 and the kernel-built stratified "
          f"counts vs plain at N={n}: bit-equal in four weight regimes",
          flush=True)
    return 0.0, keep


def _check_summary(res, t_len: int, d: int, what: str):
    import torch
    s = res.summary
    for name in ("eta_mean", "eta_lower", "eta_upper"):
        v = getattr(s, name)
        if tuple(v.shape) != (t_len,) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: summary.{name} is not finite [T]")
    for name in ("state_mean", "state_lower", "state_upper"):
        v = getattr(s, name)
        if (tuple(v.shape) != (t_len, d)
                or not bool(torch.isfinite(v).all())):
            raise AssertionError(f"{what}: summary.{name} is not finite "
                                 "[T, d]")
    if not (bool((s.state_lower <= s.state_upper).all())
            and bool((s.eta_lower <= s.eta_upper).all())):
        raise AssertionError(f"{what}: a lower bound exceeds its upper bound")


def phase_summary(dev, device_line: str, runs: int = 2):
    """[11] bootstrap_filter(store="summary") at full width on both routes,
    launch counters read around the timed runs."""
    import torch

    import composablestatespacemodels_torch as ct

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_MAIN, dt=1.0).to_timeseries()
    n_obs = int(data.mask.sum())
    out = {}
    for route in ("systematic-pallas", "systematic-pallas-fused"):
        def run(seed):
            return ct.bootstrap_filter(
                model, params, data, N_MAIN,
                torch.Generator(device=dev).manual_seed(seed),
                resample=route, store="summary")

        _check_summary(run(300), T_MAIN, model.dim, route)  # warm-up
        torch.cuda.synchronize()
        _reset_counters()
        ms, lls = [], []
        for r in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = run(301 + r)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            lls.append(float(res.ll))
            _check_summary(res, T_MAIN, model.dim, route)
        launches = _read_counters()
        fused = route.endswith("fused")
        want = {"K1": runs * n_obs, "K2": 0, "K4": runs * n_obs,
                "K5": runs * T_MAIN if fused else 0, "K7a": 0, "K7b": 0,
                "K6b": 0, "K8": 0}
        if launches != want:
            raise AssertionError(f"{route}: launches {launches}, expected "
                                 f"{want}")
        if not all(math.isfinite(v) for v in lls):
            raise AssertionError(f"{route}: ll not finite: {lls}")
        med = statistics.median(ms)
        print(f"[11] flagship store=summary {route} d={model.dim} N={N_MAIN} "
              f"T={T_MAIN}: ll {lls}; {med:.1f} ms/run (CUDA events; runs "
              f"{[round(m, 1) for m in ms]}), {med / T_MAIN:.4f} ms/step, "
              f"{N_MAIN * T_MAIN / (med / 1e3):.4g} particle-steps/s; "
              f"launches {launches} over {runs} runs ({n_obs} resampling "
              f"steps each); {device_line}", flush=True)
        out[route] = launches
    return out


def phase_oracle_summary(dev, runs: int = 8):
    """[12] systematic-pallas and stratified-pallas against the Kalman
    oracle: ll within 4 se, and the Kalman mean inside the state interval
    at every step."""
    import torch

    import composablestatespacemodels_torch as ct

    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    data = ct.simulate_regular(
        model, params, torch.Generator(device=dev).manual_seed(7),
        T_ORACLE).to_timeseries()
    kf = ct.kalman_filter(model, params, data)
    kf_ll = float(kf.ll)
    n_obs = int(data.mask.sum())
    launches = {}
    for route in ("systematic-pallas", "stratified-pallas"):
        _reset_counters()
        lls = []
        for r in range(runs):
            res = ct.bootstrap_filter(
                model, params, data, N_ORACLE,
                torch.Generator(device=dev).manual_seed(400 + r),
                resample=route, store="summary")
            lls.append(float(res.ll))
            _check_summary(res, T_ORACLE, 1, route)
            s = res.summary
            if not bool(((s.state_lower <= kf.means)
                         & (kf.means <= s.state_upper)).all()):
                raise AssertionError(f"{route}: the Kalman mean leaves the "
                                     "filter's state interval")
        launches[route] = _read_counters()
        if route == "stratified-pallas":
            want = {"K1": 0, "K2": 0, "K4": runs * n_obs, "K5": 0,
                    "K7a": runs * n_obs, "K7b": runs * n_obs, "K6b": 0,
                    "K8": 0}
        else:
            want = {"K1": runs * n_obs, "K2": 0, "K4": runs * n_obs,
                    "K5": 0, "K7a": 0, "K7b": 0, "K6b": 0, "K8": 0}
        if launches[route] != want:
            raise AssertionError(f"{route}: launches {launches[route]}, "
                                 f"expected {want}")
        mean = statistics.fmean(lls)
        se = statistics.stdev(lls) / math.sqrt(len(lls))
        print(f"[12] oracle {route} store=summary T={T_ORACLE} "
              f"N={N_ORACLE}: PF mean ll {mean:.4f} (se {se:.4f}, {runs} "
              f"runs) vs Kalman {kf_ll:.4f}: {abs(mean - kf_ll) / se:.2f} "
              "se; Kalman mean inside [state_lower, state_upper] at every "
              f"step; launches {launches[route]}", flush=True)
        if not abs(mean - kf_ll) <= 4 * se:
            raise AssertionError(f"{route} disagrees with the Kalman oracle "
                                 "by more than 4 standard errors")
    return launches["stratified-pallas"]


def phase_selection(gen, dev, n: int, rows: int = 8):
    """[13] the summary's bisection selection against torch.kthvalue and
    torch.sort at [rows, n]."""
    import torch

    from composablestatespacemodels_torch.ops.selection import (
        kth_smallest_bits)

    vals = torch.randn((rows, n), generator=gen, device=dev)
    k_lo, k_hi = n - math.floor(n * 0.975) - 1, math.floor(n * 0.975) - 1
    ks = torch.tensor([[k_lo, k_hi]] * rows, dtype=torch.int32, device=dev)
    got = kth_smallest_bits(vals, ks)
    want = torch.sort(vals, dim=1).values[:, [k_lo, k_hi]]
    kth = torch.stack([torch.kthvalue(vals, k + 1, dim=1).values
                       for k in (k_lo, k_hi)], dim=1)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(kth, want)):
        raise AssertionError("bisection selection differs from sort(row)[k]")
    bits = _cuda_ms(lambda: kth_smallest_bits(vals, ks), 5)
    kthv = _cuda_ms(lambda: [torch.kthvalue(vals, k + 1, dim=1)
                             for k in (k_lo, k_hi)], 5)
    srt = _cuda_ms(lambda: torch.sort(vals, dim=1), 5)
    print(f"[13] order statistics of [{rows}, {n}] (2 per row): bisection "
          f"{bits:.4f} ms, torch.kthvalue {kthv:.4f} ms, torch.sort "
          f"{srt:.4f} ms; all three bit-equal", flush=True)
    return {"bisection": bits, "kthvalue": kthv, "sort": srt}


def phase_ess_sync(dev, pairs: int = 6):
    """[14] the host read of the ESS trigger: store="ll",
    systematic-pallas, always resampling, with and without the trigger
    (ess_threshold=2.0 resamples at every step too), in alternating
    pairs; the host clock spreads between runs, so the paired differences
    are reported with their quartiles."""
    import torch

    import composablestatespacemodels_torch as ct

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_MAIN, dt=1.0).to_timeseries()

    def run(thr, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ll = float(ct.log_likelihood(
            model, params, data, N_MAIN,
            torch.Generator(device=dev).manual_seed(seed),
            resample="systematic-pallas", ess_threshold=thr))
        if not math.isfinite(ll):
            raise AssertionError(f"ess_threshold={thr}: ll not finite")
        return (time.perf_counter() - t0) / T_MAIN * 1e6   # us/step

    run(None, 500)
    run(2.0, 501)
    plain, trig = [], []
    for r in range(pairs):
        order = (None, 2.0) if r % 2 == 0 else (2.0, None)
        got = {thr: run(thr, 510 + 2 * r + i) for i, thr in enumerate(order)}
        plain.append(got[None])
        trig.append(got[2.0])
    diff = [t - p for t, p in zip(trig, plain)]
    q1, med, q3 = statistics.quantiles(diff, n=4)
    print(f"[14] ESS trigger at N={N_MAIN} T={T_MAIN} (store=ll, "
          "systematic-pallas, resampling every step; host clock, "
          f"{pairs} alternating pairs): without "
          f"{statistics.median(plain):.1f} us/step "
          f"(runs {[round(v, 1) for v in plain]}), with the host read "
          f"{statistics.median(trig):.1f} us/step "
          f"(runs {[round(v, 1) for v in trig]}); paired difference median "
          f"{med:.1f} us/step, quartiles {q1:.1f} .. {q3:.1f}", flush=True)
    return med


def _time_k4_regimes(x, regime_counts):
    """K4 alone (100 back-to-back calls, the better of two) on the counts of
    every K2 regime."""
    from composablestatespacemodels_torch.ops.resample_kernel import (
        sorted_gather_resample_t)

    return {regime: min(_cuda_ms(lambda: sorted_gather_resample_t(x, c), 100)
                        for _ in range(2))
            for regime, c in regime_counts.items()}


def phase_timing_new(gather_in, prop_in, scan_in, k2_in, regime_counts):
    """[15] each slice-2 kernel alone against its plain version at
    N = 2^20; K2 again and K4 on every regime's counts."""
    from composablestatespacemodels_torch.ops.resample_kernel import (
        propagate_weights_t, propagate_weights_t_ref,
        sorted_gather_resample_t, sorted_gather_resample_t_ref)
    from composablestatespacemodels_torch.ops.scan_kernel import (
        cummax_int32, cummax_int32_ref, prefix_sum, prefix_sum_ref)

    w, c = scan_in
    times = {}
    for name, kern, ref, args in (
            ("K4", sorted_gather_resample_t, sorted_gather_resample_t_ref,
             gather_in),
            ("K5", propagate_weights_t, propagate_weights_t_ref, prop_in),
            ("K7a", prefix_sum, prefix_sum_ref, (w,)),
            ("K7b", cummax_int32, cummax_int32_ref, (c,))):
        p1 = _cuda_ms(lambda: ref(*args), 10)
        k1 = _cuda_ms(lambda: kern(*args), 100)
        k2 = _cuda_ms(lambda: kern(*args), 100)
        p2 = _cuda_ms(lambda: ref(*args), 10)
        times[name] = (min(k1, k2), min(p1, p2))
    k2_regimes = _time_k2_regimes(k2_in, regime_counts)
    k4_regimes = _time_k4_regimes(gather_in[0], regime_counts)
    print(f"[15] kernel alone vs plain at N={N_MAIN}: "
          + "; ".join(f"{k} {v[0]:.4f} ms vs {v[1]:.4f} ms"
                      for k, v in times.items())
          + "; K2 by counts regime: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in k2_regimes.items())
          + "; K4 by counts regime (d=7): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in k4_regimes.items()), flush=True)
    return times, k2_regimes, k4_regimes


# K6 batched's row lengths in phase 16: one warp (1, 31, 32, 100, 127,
# 128), two warps (129), four (512), a whole tile (4096), and past one tile
# (4097, 2^17: the three passes)
K6B_NS = (1, 31, 32, 100, 127, 128, 129, 512, 4096, 4097)


def phase_counts_batched(gen, dev):
    """[16] K6 batched against its plain version and against K1 row by
    row, bit for bit, in four weight regimes, at every N of ``K6B_NS`` with
    B = 1, 3, 256, and at [4, 2^17].  Returns the mild inputs at [256, 100]
    and [256, 512]."""
    import torch

    from composablestatespacemodels_torch.ops.scan_kernel import (
        systematic_counts_batched, systematic_counts_batched_ref,
        systematic_counts_fused)

    keep, cases = {}, 0
    shapes = [(b, n) for n in K6B_NS for b in (1, 3, CHAINS)] + [(4, 2 ** 17)]
    for b, n in shapes:
        for regime in ("uniform", "mild", "heavy", "degenerate"):
            w = torch.stack([_weights(regime, n, gen, dev) for _ in range(b)])
            total = w.sum(dim=-1)
            u = torch.rand(b, generator=gen, device=dev)
            ck = systematic_counts_batched(w, total, u)
            cp = systematic_counts_batched_ref(w, total, u)
            rows = torch.stack([systematic_counts_fused(
                w[i], total[i].clone(), u[i].clone()) for i in range(b)])
            torch.cuda.synchronize()
            for name, other in (("plain", cp), ("K1 row by row", rows)):
                if not torch.equal(ck, other):
                    raise AssertionError(
                        f"K6 batched {regime} [{b}, {n}]: "
                        f"{int((ck != other).sum())} counts differ from "
                        f"{name}")
            cases += 1
            if regime == "mild" and b == CHAINS and n in (N_PMMH, 512):
                keep[n] = (w, total, u)
    print(f"[16] K6 batched counts vs plain and vs K1 row by row: bit-equal "
          f"in the uniform, mild, heavy and degenerate regimes at N in "
          f"{list(K6B_NS)} x B in (1, 3, {CHAINS}) and at [4, {2 ** 17}] "
          f"({cases} cases)", flush=True)
    return 0, keep[N_PMMH], keep[512]


def _sweep_case(gen, dev, n, d, b, t_len, family):
    """K8 inputs: random clouds and coefficients, a masked step (its
    observation 0, as the path's ``y_safe``), the family's constants per
    (step, chain) from observations drawn from the family at gamma = 0.5
    and scales around its ``K3_CASES`` scale."""
    import torch

    x0 = torch.randn((b, d, n), generator=gen, device=dev)
    coef = torch.stack([
        0.9 + 0.1 * torch.rand((t_len, b, d), generator=gen, device=dev),
        0.1 * torch.randn((t_len, b, d), generator=gen, device=dev),
        0.3 * torch.rand((t_len, b, d), generator=gen, device=dev)],
        dim=-1).contiguous()
    design = (0.5 * torch.randn((t_len, d), generator=gen,
                                device=dev)).contiguous()
    fam = _family(family)
    make_consts, fid = fam.kernel_log_density()
    scale = K3_CASES[family][1] * (0.75 + 0.5 * torch.rand(
        b, generator=gen, device=dev))
    y = fam.sample(gen, torch.full((t_len, 1), 0.5, device=dev),
                   scale[0])
    mask = torch.ones(t_len, dtype=torch.int32, device=dev)
    mask[t_len // 3] = 0
    y[t_len // 3] = 0.0
    wconsts = make_consts(y, scale).contiguous()
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    return (x0, coef, design, wconsts, mask, seed, fid)


# K8's cases in phase 17: every n of the block sizes (one warp, 4, 5, 16
# and 32 warps, one scan warp or several) at d = 1, 7 and 13, B = 1, 3 and
# 256 in turn, the families in turn
K8_NS = (1, 100, 128, 129, 512, 1000, 1024)
K8_FAMILIES = ("Poisson", "Gaussian", "ZeroInflatedPoisson",
               "NegativeBinomial", "Bernoulli", "StudentsT", "Beta")


def phase_sweep(gen, dev):
    """[17] K8 against its plain version, ll and x_final bit for bit, at
    every n of ``K8_NS`` and d = 1, 7, 13 (all within the shared-memory
    limit), B = 1, 3, 256 and the seven families in turn, each case with a
    masked step; then the seed's streams."""
    import torch

    from composablestatespacemodels_torch.ops.sweep_kernel import (
        MAX_SHARED_BYTES, pf_sweep_chains, pf_sweep_chains_ref)

    cases = []
    shapes = [(n, d, b) for n in K8_NS for d in (1, 7, 13)
              for b in (1, 3, CHAINS) if (2 * d + 2) * n * 4 <= MAX_SHARED_BYTES]
    for i, (n, d, b) in enumerate(shapes):
        fam = K8_FAMILIES[i % len(K8_FAMILIES)]
        t_len = 60 if b * n * d <= 3 * 1024 * 13 else 30
        args = _sweep_case(gen, dev, n, d, b, t_len, fam)
        llk, xk = pf_sweep_chains(*args)
        llp, xp = pf_sweep_chains_ref(*args)
        torch.cuda.synchronize()
        if not (torch.equal(llk, llp) and torch.equal(xk, xp)):
            raise AssertionError(
                f"K8 (n, d, B) = ({n}, {d}, {b}) {fam}: max |ll - plain| "
                f"{float((llk - llp).abs().max())}, max |x - plain| "
                f"{float((xk - xp).abs().max())}")
        if not bool(torch.isfinite(llk).all()):
            raise AssertionError(f"K8 ({n}, {d}, {b}): ll not finite")
        cases.append(fam)
    # determinism and streams: the same seed, another seed, identical chains
    x0, coef, design, wconsts, mask, seed, fid = _sweep_case(
        gen, dev, N_PMMH, 7, 8, 50, "Poisson")
    x0, coef, wconsts = (t[:, :1].expand_as(t).contiguous() if t is not x0
                         else t[:1].expand_as(t).contiguous()
                         for t in (x0, coef, wconsts))
    a, _ = pf_sweep_chains(x0, coef, design, wconsts, mask, seed, fid)
    a2, _ = pf_sweep_chains(x0, coef, design, wconsts, mask, seed, fid)
    c, _ = pf_sweep_chains(x0, coef, design, wconsts, mask, seed + 1, fid)
    torch.cuda.synchronize()
    distinct = len(set(a.tolist()))
    if not torch.equal(a, a2) or torch.equal(a, c) or distinct <= 4:
        raise AssertionError(f"K8 streams: same seed equal "
                             f"{torch.equal(a, a2)}, other seed equal "
                             f"{torch.equal(a, c)}, "
                             f"{distinct} distinct lls of 8 identical chains")
    print(f"[17] K8 vs plain at (n, d, B) = every n in {list(K8_NS)} x d in "
          f"(1, 7, 13) x B in (1, 3, {CHAINS}) ({len(cases)} cases, T = 60, "
          "30 for the largest; each family in "
          f"{min(cases.count(f) for f in K8_FAMILIES)} or more), one masked "
          "step each: ll and x_final bit-equal; the same seed repeats its "
          "bits, another differs, 8 identical chains give "
          f"{distinct} distinct lls", flush=True)
    return 0


def phase_sweep_path(dev):
    """[17b] K8 against its plain version, ll and x_final bit for bit, on
    the inputs the PMMH tiers hand it: the flagship at T = 400 with
    perturb(0.05) parameters, for one chain at N = 100 and N = 512 and for
    256 chains at N = 100 (``make_pf_loglik_chains(...).sweep_inputs``)."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.models import perturb
    from composablestatespacemodels_torch.models.params import params_to
    from composablestatespacemodels_torch.models.tree import tree_map
    from composablestatespacemodels_torch.ops.sweep_kernel import (
        pf_sweep_chains, pf_sweep_chains_ref)

    model, params = flagship()
    params = params_to(params, dev)
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_PMMH, dt=1.0).to_timeseries()
    gen = torch.Generator(device=dev).manual_seed(31)
    lines = []
    for n, b in ((N_PMMH, 1), (512, 1), (N_PMMH, CHAINS)):
        params_b = perturb(0.05)(gen, tree_map(
            lambda t: t.expand((b,) + t.shape).contiguous(), params))
        args = ct.make_pf_loglik_chains(model, data, n).sweep_inputs(
            gen, params_b)
        llk, xk = pf_sweep_chains(*args)
        llp, xp = pf_sweep_chains_ref(*args)
        torch.cuda.synchronize()
        if not (torch.equal(llk, llp) and torch.equal(xk, xp)):
            raise AssertionError(
                f"K8 on the PMMH path's inputs (n, B) = ({n}, {b}), "
                f"T={T_PMMH}: max |ll - plain| "
                f"{float((llk - llp).abs().max())}, max |x - plain| "
                f"{float((xk - xp).abs().max())}")
        if not bool(torch.isfinite(llk).all()):
            raise AssertionError(f"K8 path inputs ({n}, {b}): ll not finite")
        lines.append(f"(N, B) = ({n}, {b})")
    print(f"[17b] K8 vs plain on the PMMH tiers' own inputs (flagship d=7, "
          f"T={T_PMMH}, {int(data.mask.sum())} observed, perturb(0.05)): "
          f"{'; '.join(lines)}: ll and x_final bit-equal", flush=True)


def phase_sweep_stats(dev):
    """[18] K8 against the Kalman oracle (linear-Gaussian, T = 120) and
    against the port's log_likelihood on the flagship (N = 100, T = 100):
    the gates of tests_tpu/test_sweep_chip.py."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.models.tree import tree_map

    def chains(params, b):
        return tree_map(lambda t: t.expand((b,) + t.shape).contiguous(),
                        params)

    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(21),
                               120).to_timeseries()
    kf = float(ct.kalman_filter(model, params, data).ll)
    lines = []
    for n, b in ((128, 64), (256, 32), (512, 16)):
        lls = ct.make_pf_loglik_chains(model, data, n)(
            torch.Generator(device=dev).manual_seed(n), chains(params, b))
        mean = float(lls.mean())
        se = float(lls.std()) / math.sqrt(b)
        if not abs(mean - kf) < max(4 * se, 0.5):
            raise AssertionError(f"K8 N={n} B={b}: mean ll {mean} vs Kalman "
                                 f"{kf} (se {se})")
        lines.append(f"N={n} B={b}: {mean:.4f} (se {se:.4f})")
    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(22),
                               100, dt=1.0).to_timeseries()
    k8 = ct.make_pf_loglik_chains(model, data, N_PMMH)(
        torch.Generator(device=dev).manual_seed(23), chains(params, 64))
    ref = torch.stack([ct.log_likelihood(
        model, params, data, N_PMMH,
        torch.Generator(device=dev).manual_seed(300 + r),
        resample="systematic-fused") for r in range(8)])
    diff = float(k8.mean() - ref.mean())
    joint = math.hypot(float(k8.std()) / 8.0, float(ref.std()) / math.sqrt(8))
    if not abs(diff) < max(4 * joint, 1.0):
        raise AssertionError(f"K8 flagship: mean ll {float(k8.mean())} vs "
                             f"log_likelihood {float(ref.mean())} (joint sd "
                             f"{joint})")
    print(f"[18] K8 vs Kalman ({kf:.4f}) on linear(brownian(1)) T=120: "
          f"{'; '.join(lines)}; flagship N={N_PMMH} T=100: K8 (64 chains) "
          f"{float(k8.mean()):.4f} vs log_likelihood (8 runs) "
          f"{float(ref.mean()):.4f}, difference {diff:.4f} (joint sd "
          f"{joint:.4f})", flush=True)


def phase_pmmh(dev, device_line: str):
    """[19] the five PMMH tiers of the JAX bench on the flagship, N = 100,
    T = 400, perturb(0.05): best of 3 timed runs each, launch counters set
    to 0 just before the timed runs and read just after."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.models import perturb

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_PMMH, dt=1.0).to_timeseries()
    n_obs = int(data.mask.sum())
    prop = perturb(0.05)
    pf = ct.make_pf_loglik(model, data, N_PMMH)
    pf_fused = ct.make_pf_loglik(model, data, N_PMMH, fused_sweep=True)
    pf_chains = ct.make_pf_loglik_chains(model, data, N_PMMH)
    pf_512 = ct.make_pf_loglik(model, data, 512, fused_sweep=True)
    it = PMMH_ITERS
    tiers = {
        "single": (lambda g, k: ct.pmmh(g, params, pf, prop, k), 1,
                   {"K1": n_obs, "K4": n_obs}),
        "fused": (lambda g, k: ct.pmmh(g, params, pf_fused, prop, k), 1,
                  {"K8": 1}),
        "chains": (lambda g, k: ct.pmmh_chains(g, params, pf, prop, k,
                                               CHAINS), CHAINS,
                   {"K6b": n_obs}),
        "chains_fused": (lambda g, k: ct.pmmh_chains(
            g, params, None, prop, k, CHAINS, pf_ll_chains=pf_chains),
            CHAINS, {"K8": 1}),
        "fused_n512": (lambda g, k: ct.pmmh(g, params, pf_512, prop, k), 1,
                       {"K8": 1}),
    }
    rates, launches = {}, {}
    for name, (run, chains, per_iter) in tiers.items():
        run(torch.Generator(device=dev).manual_seed(1), 2)   # warm-up
        torch.cuda.synchronize()
        _reset_counters()
        best, results = math.inf, []
        for r in range(3):
            g = torch.Generator(device=dev).manual_seed(10 + r)
            t0 = time.perf_counter()
            res = run(g, it[name])
            float(res.lls.sum())
            best = min(best, time.perf_counter() - t0)
            results.append(res)
        got = _read_counters()
        want = {k: 0 for k in got}
        want.update({k: 3 * it[name] * v for k, v in per_iter.items()})
        if got != want:
            raise AssertionError(f"PMMH {name}: launches {got}, expected "
                                 f"{want}")
        for res in results:
            rate = res.acceptance_rate()
            if not bool(torch.isfinite(res.lls).all()):
                raise AssertionError(f"PMMH {name}: an ll is not finite")
            if not (0.0 < float(rate.mean()) < 1.0):
                raise AssertionError(f"PMMH {name}: acceptance rate "
                                     f"{rate.tolist()} outside (0, 1)")
        rates[name] = chains * it[name] / best
        launches[name] = {k: v for k, v in got.items() if v}
        print(f"[19] PMMH {name}: {rates[name]:.1f} "
              f"{'aggregate chain-' if chains > 1 else ''}iters/s "
              f"(best of 3 runs of {it[name]} iterations"
              f"{f' x {chains} chains' if chains > 1 else ''}, "
              f"{best:.3f} s; acceptance "
              f"{float(results[0].acceptance_rate().mean()):.3f}); launches "
              f"{launches[name]}; {device_line}", flush=True)
    # approx: the fused single chain evaluates the current parameters too
    _reset_counters()
    res = ct.pmmh(torch.Generator(device=dev).manual_seed(5), params,
                  pf_fused, prop, 10, approx=True)
    float(res.lls.sum())
    if _read_counters()["K8"] != 20 or not bool(torch.isfinite(res.lls).all()):
        raise AssertionError(f"PMMH approx: K8 launched "
                             f"{_read_counters()['K8']} times for 10 "
                             "iterations, expected 20")
    print(f"[19] PMMH approx (fused, 10 iterations): K8 launched 20 times; "
          f"N={N_PMMH} T={T_PMMH} ({n_obs} observations), iterations per "
          f"timed run {it} (the JAX bench: 500 / 200 / 300 / 100 / 100)",
          flush=True)
    return rates, launches


def phase_timing_pmmh(counts_in):
    """[20] K6 batched and K8 alone against their plain versions at the
    PMMH shapes: [256, 100] counts; 256 chains x N = 100, d = 7, T = 400."""
    import torch

    from composablestatespacemodels_torch.ops.scan_kernel import (
        systematic_counts_batched, systematic_counts_batched_ref)
    from composablestatespacemodels_torch.ops.sweep_kernel import (
        pf_sweep_chains, pf_sweep_chains_ref)

    dev = counts_in[0].device
    gen = torch.Generator(device=dev).manual_seed(77)
    sweep_in = _sweep_case(gen, dev, N_PMMH, 7, CHAINS, T_PMMH, "Poisson")
    llk, xk = pf_sweep_chains(*sweep_in)
    llp, xp = pf_sweep_chains_ref(*sweep_in)
    torch.cuda.synchronize()
    if not (torch.equal(llk, llp) and torch.equal(xk, xp)):
        raise AssertionError(
            f"K8 {CHAINS} chains x N={N_PMMH}, T={T_PMMH}: max |ll - plain| "
            f"{float((llk - llp).abs().max())}, max |x - plain| "
            f"{float((xk - xp).abs().max())}")
    times = {}
    for name, kern, ref, args, k_it, p_it in (
            ("K6b", systematic_counts_batched, systematic_counts_batched_ref,
             counts_in, 100, 10),
            ("K8", pf_sweep_chains, pf_sweep_chains_ref, sweep_in, 5, 1)):
        p1 = _cuda_ms(lambda: ref(*args), p_it)
        k1 = _cuda_ms(lambda: kern(*args), k_it)
        k2 = _cuda_ms(lambda: kern(*args), k_it)
        p2 = _cuda_ms(lambda: ref(*args), p_it)
        times[name] = (min(k1, k2), min(p1, p2))
    print(f"[20] kernel alone vs plain: K6 batched [{CHAINS}, {N_PMMH}] "
          f"{times['K6b'][0]:.4f} ms vs {times['K6b'][1]:.4f} ms; K8 "
          f"{CHAINS} chains x N={N_PMMH}, d=7, T={T_PMMH} "
          f"{times['K8'][0]:.4f} ms vs {times['K8'][1]:.4f} ms (ll and "
          "x_final bit-equal on these inputs)", flush=True)
    return times, sweep_in


def phase_k3(gen, dev, counts, n: int = N_MAIN, d: int = 7):
    """[21] the K3 device function of each pointwise family inside K2 and
    K5 (d = 7, N = 2^20) and K8 ((N, B) = (100, 256), T = 400, a masked
    step) against the torch twins, in float32 ulps, on constants from the
    family's ``make_consts``; K2 and K5 timed per family."""
    import torch

    from composablestatespacemodels_torch.models.observation import (
        KERNEL_CONSTS)
    from composablestatespacemodels_torch.ops.resample_kernel import (
        propagate_weights_t, propagate_weights_t_ref, resample_propagate,
        resample_propagate_ref)
    from composablestatespacemodels_torch.ops.sweep_kernel import (
        pf_sweep_chains, pf_sweep_chains_ref)

    x = torch.randn((d, n), generator=gen, device=dev) * 0.3
    coef = torch.stack([
        0.5 + 0.5 * torch.rand(d, generator=gen, device=dev),
        0.1 * torch.randn(d, generator=gen, device=dev),
        torch.full((d,), 0.3, device=dev),
        0.5 + torch.rand(d, generator=gen, device=dev)], dim=1).contiguous()
    seed = torch.tensor(24681357, dtype=torch.int32, device=dev)
    out, bad = {}, []
    for name, (ys, scale) in K3_CASES.items():
        make_consts, fid = _family(name).kernel_log_density()
        ulps = {"K2": 0, "K5": 0, "K8": 0}
        err = {"K2": 0.0, "K5": 0.0, "K8": 0.0}
        for y in ys:
            consts = torch.zeros(KERNEL_CONSTS, device=dev)
            c = make_consts(torch.tensor(y, device=dev),
                            torch.tensor(scale, device=dev))
            consts[:c.shape[-1]] = c
            k2_in = (x, counts, coef, consts, seed, fid)
            k5_in = (x, coef, consts, seed, fid)
            for k, kern, ref, args in (
                    ("K2", resample_propagate, resample_propagate_ref, k2_in),
                    ("K5", propagate_weights_t, propagate_weights_t_ref,
                     k5_in)):
                yk, lk = kern(*args)
                yp, lp = ref(*args)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(lk).all()):
                    raise AssertionError(f"{k}+K3 {name} y={y}: a log-weight "
                                         "is not finite")
                ulps[k] = max(ulps[k], _ulps(yk, yp), _ulps(lk, lp))
                err[k] = max(err[k], float((yk - yp).abs().max()),
                             float((lk - lp).abs().max()))
        sweep_in = _sweep_case(gen, dev, N_PMMH, d, CHAINS, T_PMMH, name)
        llk, xk = pf_sweep_chains(*sweep_in)
        llp, xp = pf_sweep_chains_ref(*sweep_in)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(llk).all()):
            raise AssertionError(f"K8+K3 {name}: an ll is not finite (a "
                                 "masked step leaked its constants)")
        ulps["K8"] = max(_ulps(llk, llp), _ulps(xk, xp))
        err["K8"] = max(float((llk - llp).abs().max()),
                        float((xk - xp).abs().max()))
        times = {"K2": _cuda_ms(lambda: resample_propagate(*k2_in), 100),
                 "K5": _cuda_ms(lambda: propagate_weights_t(*k5_in), 100),
                 "K5 plain": _cuda_ms(
                     lambda: propagate_weights_t_ref(*k5_in), 3),
                 "K5 args": k5_in}
        out[name] = {"err": err, "ulps": ulps, **times}
        if max(ulps.values()) > K3_ULPS[name]:
            bad.append(name)
    pois = out["Poisson"]
    print(f"[21] K3 per family vs its torch twin (K2, K5 at d={d} N={n}; K8 "
          f"at (N, B) = ({N_PMMH}, {CHAINS}), T={T_PMMH}, a masked step), "
          "largest ulp gap and K2 / K5 alone [x Poisson]: " + "; ".join(
              f"{k} ulps {v['ulps']} err {max(v['err'].values()):.3g}, K2 "
              f"{v['K2']:.4f} ms "
              f"[{v['K2'] / pois['K2']:.2f}], K5 {v['K5']:.4f} ms "
              f"[{v['K5'] / pois['K5']:.2f}] (plain {v['K5 plain']:.3f})"
              for k, v in out.items()), flush=True)
    if bad:
        raise AssertionError(f"K3 over its ulp tolerance {K3_ULPS} for {bad}")
    return out


def family_model(name: str):
    """The flagship's shape with the family leftmost:
    ``family(ou(1)) + seasonal(24, 3, ou(6))``, d = 7; the leftmost OU and
    scale are the JAX package's end-to-end cases
    (``tests/test_families_end_to_end.py``), Poisson's the flagship's."""
    import composablestatespacemodels_torch as ct
    leaf, scale, ou = {
        "Gaussian": (ct.linear, math.log(0.5), (0.5, 0.2, 0.3, 0.5, 0.3)),
        "Poisson": (ct.poisson, None, (1.0, 0.2, 0.3, 1.0, 0.3)),
        "ZeroInflatedPoisson": (ct.zero_inflated_poisson, 0.0,
                                (1.0, 0.3, 0.3, 1.0, 0.3)),
        "NegativeBinomial": (ct.negative_binomial, math.log(3.0),
                             (1.0, 0.3, 0.3, 1.0, 0.3)),
        "Bernoulli": (ct.bernoulli, None, (0.0, 0.5, 0.3, 0.0, 0.5)),
        "StudentsT": (ct.students_t, math.log(0.4), (1.0, 0.3, 0.3, 1.0, 0.4)),
        "Beta": (ct.beta, math.log(2.0), (0.5, 0.2, 0.3, 0.5, 0.3)),
    }[name]
    model = leaf(ct.ou_process(1)) + ct.seasonal(24, 3, ct.ou_process(6))
    params = ct.branch(
        ct.leaf(ct.param_node(scale, ct.ou_params(*ou))),
        ct.leaf(ct.param_node(None, ct.ou_params(0.2, 0.2, 0.25, 0.2, 0.2))))
    return model, params


def _check_support(name: str, ys) -> None:
    """Simulated observations lie in the family's support."""
    import torch
    ok = bool(torch.isfinite(ys).all())
    if name in ("Poisson", "ZeroInflatedPoisson", "NegativeBinomial"):
        ok = ok and bool(((ys >= 0) & (ys == torch.round(ys))).all())
    elif name == "Bernoulli":
        ok = ok and bool(((ys == 0) | (ys == 1)).all())
    elif name == "Beta":
        ok = ok and bool(((ys > 0) & (ys < 1)).all())
    if not ok:
        raise AssertionError(f"{name}: simulated observations leave the "
                             "family's support")


def phase_families(dev, device_line: str):
    """[22] each family leftmost in the flagship's shape at full width
    (d = 7, N = 2^20, T = 1000): the fused ``log_likelihood`` (K1, K2+K3)
    and the fused summary filter (K1, K4, K5+K3), launch counters set to 0
    just before and read just after; then the fused ll against the generic
    ``"systematic"`` route (torch log_density, K1, K4), FAMILY_RUNS runs each
    at N = 2^18, within 4 joint standard errors."""
    import torch

    import composablestatespacemodels_torch as ct

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    out, bad = {}, []
    for name in K3_CASES:
        model, params = family_model(name)
        data = ct.simulate_regular(model, params, gen(0), T_MAIN,
                                   dt=1.0).to_timeseries()
        _check_support(name, data.ys)
        n_obs = int(data.mask.sum())
        torch.cuda.synchronize()
        _reset_counters()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ll = float(ct.log_likelihood(model, params, data, N_MAIN, gen(600),
                                     resample="systematic-fused"))
        ev[1].record()
        res = ct.bootstrap_filter(model, params, data, N_MAIN, gen(601),
                                  resample="systematic-pallas-fused",
                                  store="summary")
        ev[2].record()
        torch.cuda.synchronize()
        launches = _read_counters()
        want = {k: 0 for k in launches}
        want.update({"K1": 2 * n_obs, "K2": n_obs, "K4": n_obs,
                     "K5": T_MAIN})
        if launches != want:
            bad.append(f"{name}: launches {launches}, expected {want}")
        if not (math.isfinite(ll) and math.isfinite(float(res.ll))):
            raise AssertionError(f"{name}: ll not finite ({ll}, "
                                 f"{float(res.ll)})")
        _check_summary(res, T_MAIN, model.dim, name)
        lls = {route: [float(ct.log_likelihood(
            model, params, data, N_FAMILY_GATE, gen(610 + r),
            resample=route)) for r in range(FAMILY_RUNS)]
            for route in ("systematic-fused", "systematic")}
        mf, mg = (statistics.fmean(v) for v in lls.values())
        joint = math.hypot(*(statistics.stdev(v) / math.sqrt(FAMILY_RUNS)
                             for v in lls.values()))
        ms_ll, ms_sum = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        print(f"[22] {name}(ou(1)) + seasonal(24, 3, ou(6)) d={model.dim} "
              f"N={N_MAIN} T={T_MAIN}: fused ll {ll:.4f} "
              f"({ms_ll / T_MAIN:.4f} ms/step), summary ll "
              f"{float(res.ll):.4f} ({ms_sum / T_MAIN:.4f} ms/step); "
              f"launches {launches}; at N={N_FAMILY_GATE}, {FAMILY_RUNS} runs "
              f"each: fused {mf:.4f} vs systematic {mg:.4f}, "
              f"{abs(mf - mg) / joint:.2f} joint se; {device_line}",
              flush=True)
        if not abs(mf - mg) <= 4 * joint:
            bad.append(f"{name}: the fused ll disagrees with the systematic "
                       "route by more than 4 joint se")
        out[name] = launches
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def phase_schemes(dev, runs: int = 8):
    """[23] the generic schemes on the Kalman oracle (T = 200, N = 2^18):
    "systematic" with store="summary" (K1, K4), "stratified" (K7a, K7b,
    K4), "multinomial" (K7a, K7b twice: the cdf and the counts, K4) and
    "residual" (K7a, K7b twice, an index gather), launch counters per
    scheme; each ll within 4 se of Kalman, and its ms/step.  "identity"
    and a custom scheme once each.  Returns the systematic runs' final
    clouds."""
    import torch

    import composablestatespacemodels_torch as ct

    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    data = ct.simulate_regular(
        model, params, torch.Generator(device=dev).manual_seed(7),
        T_ORACLE).to_timeseries()
    kf = ct.kalman_filter(model, params, data)
    kf_ll = float(kf.ll)
    n_obs = int(data.mask.sum())
    clouds, lines, bad = [], [], []
    for scheme, store, per_step in (
            ("systematic", "summary", {"K1": 1, "K4": 1}),
            ("stratified", "ll", {"K7a": 1, "K7b": 1, "K4": 1}),
            ("multinomial", "ll", {"K7a": 1, "K7b": 2, "K4": 1}),
            ("residual", "ll", {"K7a": 1, "K7b": 2})):
        _reset_counters()
        lls, secs = [], []
        for r in range(runs):
            t0 = time.perf_counter()
            res = ct.bootstrap_filter(
                model, params, data, N_ORACLE,
                torch.Generator(device=dev).manual_seed(700 + r),
                resample=scheme, store=store)
            lls.append(float(res.ll))        # the host read ends the call
            secs.append(time.perf_counter() - t0)
            if store == "summary":
                _check_summary(res, T_ORACLE, 1, scheme)
                clouds.append(res.final_particles)
        got = _read_counters()
        want = {k: 0 for k in got}
        want.update({k: runs * n_obs * v for k, v in per_step.items()})
        if got != want:
            bad.append(f"{scheme}: launches {got}, expected {want}")
        mean = statistics.fmean(lls)
        se = statistics.stdev(lls) / math.sqrt(runs)
        lines.append(f"{scheme} {mean:.4f} (se {se:.4f}, "
                     f"{abs(mean - kf_ll) / se:.2f} se; "
                     f"{statistics.median(secs) * 1e3 / T_ORACLE:.4f} "
                     "ms/step, host clock, median of the runs; launches "
                     f"{ {k: v for k, v in got.items() if v} })")
        if not abs(mean - kf_ll) <= 4 * se:
            bad.append(f"{scheme} disagrees with the Kalman oracle by more "
                       "than 4 standard errors")

    def custom(g, w):   # a user's scheme: multinomial by torch.multinomial
        return torch.multinomial(w, w.shape[0], replacement=True, generator=g)

    for scheme in ("identity", custom):
        ll = float(ct.log_likelihood(
            model, params, data, N_ORACLE,
            torch.Generator(device=dev).manual_seed(720), resample=scheme))
        if not math.isfinite(ll):
            raise AssertionError(f"{scheme}: ll not finite")
        lines.append(f"{getattr(scheme, '__name__', scheme)} {ll:.4f}")
    print(f"[23] generic schemes on the oracle T={T_ORACLE} N={N_ORACLE}, "
          f"{runs} runs each, vs Kalman {kf_ll:.4f}: " + "; ".join(lines),
          flush=True)
    if bad:
        raise AssertionError("; ".join(bad))
    return clouds, kf


def phase_forecast(dev, clouds, kf, steps: int = 10):
    """[24] forecast_times from the oracle's final filtering clouds:
    the state mean over the runs within 4 se of the exact predictive mean
    (Brownian motion: the Kalman filtering mean at the last time); then 24
    steps on the flagship from a full-width cloud: finite, ordered
    bounds."""
    import torch

    import composablestatespacemodels_torch as ct

    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    t_last = float(T_ORACLE - 1)
    ts = t_last + torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    means = torch.stack([ct.forecast_times(
        model, params, c, t_last, ts,
        torch.Generator(device=dev).manual_seed(800 + r)).state_mean[:, 0]
        for r, c in enumerate(clouds)])                      # [runs, steps]
    exact = float(kf.means[-1, 0])
    se = means.std(dim=0) / math.sqrt(len(clouds))
    gap = float(((means.mean(dim=0) - exact).abs() / se).max())
    if not gap <= 4.0:
        raise AssertionError(f"forecast state mean {means.mean(0).tolist()} "
                             f"vs exact {exact}: {gap:.2f} se")
    fmodel, fparams = flagship()
    data = ct.simulate_regular(fmodel, fparams,
                               torch.Generator(device=dev).manual_seed(0),
                               T_MAIN, dt=1.0).to_timeseries()
    res = ct.bootstrap_filter(fmodel, fparams, data, N_MAIN,
                              torch.Generator(device=dev).manual_seed(810),
                              resample="systematic-fused", store="ll")
    t0 = time.perf_counter()
    fc = ct.forecast_times(
        fmodel, fparams, res.final_particles, data.ts[-1],
        data.ts[-1] + torch.arange(1, 25, dtype=torch.float32, device=dev),
        torch.Generator(device=dev).manual_seed(811))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for lo, mid, hi in (("obs_lower", "obs_mean", "obs_upper"),
                        ("eta_lower", "eta_mean", "eta_upper"),
                        ("state_lower", "state_mean", "state_upper")):
        vals = [getattr(fc, k) for k in (lo, mid, hi)]
        if not all(bool(torch.isfinite(v).all()) for v in vals):
            raise AssertionError(f"flagship forecast: {mid} not finite")
        if not bool((vals[0] <= vals[2]).all()):
            raise AssertionError(f"flagship forecast: {lo} > {hi}")
    print(f"[24] forecast_times on the oracle, {steps} steps from "
          f"{len(clouds)} final clouds (N={N_ORACLE}): state mean within "
          f"{gap:.2f} se of the exact predictive mean {exact:.4f}; flagship "
          f"24 steps at N={N_MAIN} in {secs:.3f} s: finite, lower <= upper "
          "(obs, eta, state)", flush=True)


def phase_pmmh_family(dev, device_line: str, iters: int = 100):
    """[25] fused PMMH (K8) for a family beyond Gaussian and Poisson:
    negative_binomial(ou(1)) + seasonal(24, 3, ou(6)), N = 100, T = 400,
    perturb(0.05); the acceptance rate in (0, 1), K8 once per
    iteration."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.models import perturb

    model, params = family_model("NegativeBinomial")
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_PMMH, dt=1.0).to_timeseries()
    pf = ct.make_pf_loglik(model, data, N_PMMH, fused_sweep=True)
    ct.pmmh(torch.Generator(device=dev).manual_seed(1), params, pf,
            perturb(0.05), 2)                                  # warm-up
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    res = ct.pmmh(torch.Generator(device=dev).manual_seed(2), params, pf,
                  perturb(0.05), iters)
    rate = float(res.acceptance_rate())
    secs = time.perf_counter() - t0
    launches = _read_counters()
    if launches["K8"] != iters or sum(launches.values()) != iters:
        raise AssertionError(f"NB PMMH: launches {launches}, expected K8 "
                             f"{iters}")
    if not (0.0 < rate < 1.0 and bool(torch.isfinite(res.lls).all())):
        raise AssertionError(f"NB PMMH: acceptance rate {rate}, lls finite "
                             f"{bool(torch.isfinite(res.lls).all())}")
    print(f"[25] PMMH fused_sweep NegativeBinomial(ou(1)) + seasonal(24, 3, "
          f"ou(6)) N={N_PMMH} T={T_PMMH}: {iters / secs:.1f} iters/s "
          f"({iters} iterations, {secs:.3f} s), acceptance {rate:.3f}, K8 "
          f"launched {launches['K8']} times; {device_line}", flush=True)
    return launches["K8"]


def phase_library(gather_in, scan_in):
    """[26] one PyTorch call that computes each kernel's function, where
    one exists, on the kernel's own inputs: K4 as ``repeat_interleave`` of
    the columns by their offspring (``diff(counts)``, made before the
    timing), K7a as ``torch.cumsum``, K7b as ``torch.cummax``.  Timed as a
    yardstick only; the port never calls them."""
    import torch

    from composablestatespacemodels_torch.ops.resample_kernel import (
        sorted_gather_resample_t_ref)

    x, counts = gather_in
    w, c = scan_in
    offspring = torch.diff(counts, prepend=counts.new_zeros(1))
    n = x.shape[1]
    if not torch.equal(torch.repeat_interleave(x, offspring, dim=1,
                                               output_size=n),
                       sorted_gather_resample_t_ref(x, counts)):
        raise AssertionError("repeat_interleave differs from K4's function")
    times = {
        "K4": _cuda_ms(lambda: torch.repeat_interleave(
            x, offspring, dim=1, output_size=n), 100),
        "K7a": _cuda_ms(lambda: torch.cumsum(w, 0), 100),
        "K7b": _cuda_ms(lambda: torch.cummax(c, 0), 100)}
    print("[26] one PyTorch call for the same function at N="
          f"{n}: K4 repeat_interleave {times['K4']:.4f} ms, K7a cumsum "
          f"{times['K7a']:.4f} ms, K7b cummax {times['K7b']:.4f} ms",
          flush=True)
    return times


# K7b's sizes in phase 29: one element, a tile less one, a tile, a tile and
# one, the main path's N and three past it (a ragged last tile)
K7B_SIZES = (1, 4095, 4096, 4097, 2 ** 20, 2 ** 20 + 3)
INT_MIN = -2 ** 31


def _k7b_inputs(gen, dev, n: int):
    """int32 inputs of K7b at n: uniform over the whole int32 range with
    INT_MIN planted, a descending run (every tile takes the carry), all
    INT_MIN, and small negatives (the counts' regime, where a running max
    plateaus)."""
    import torch
    full = torch.randint(INT_MIN, 2 ** 31 - 1, (n,), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    full[::97] = INT_MIN
    small = torch.randint(-1000, 50, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    return {"full range": full,
            "descending": torch.arange(n, 0, -1, dtype=torch.int32,
                                       device=dev) - 2 ** 30,
            "all INT_MIN": torch.full((n,), INT_MIN, dtype=torch.int32,
                                      device=dev),
            "small negatives": small}


def phase_k7b_edges(gen, dev):
    """[29] K7b bit-equal to torch.cummax at every K7B_SIZES size on four
    inputs, on a view that starts one element in (not 16-byte aligned),
    through the float-bits route (resampling._monotone_cdf), three calls in
    a row on one stream before any is compared, and with K7a and K1 calls
    between K7b calls on the shared workspace; one launch per call."""
    import torch

    from composablestatespacemodels_torch.inference import resampling as rs
    from composablestatespacemodels_torch.ops.scan_kernel import (
        cummax_int32, prefix_sum, prefix_sum_ref, systematic_counts_fused,
        systematic_counts_fused_ref)

    def same(what, k, c):
        want = torch.cummax(c, 0).values
        if not torch.equal(k, want):
            raise AssertionError(f"K7b {what}: {int((k != want).sum())} "
                                 "entries differ from torch.cummax")

    _reset_counters()
    calls = 0
    for n in K7B_SIZES:
        for name, c in _k7b_inputs(gen, dev, n).items():
            same(f"{name} N={n}", cummax_int32(c), c)
            buf = torch.empty(n + 1, dtype=torch.int32, device=dev)
            buf[1:] = c
            same(f"{name} N={n} misaligned", cummax_int32(buf[1:]), buf[1:])
            calls += 2
    # the float-bits route: a nonnegative cdf with dips, maxed as int32
    cdf = torch.cumsum(torch.rand(N_MAIN, generator=gen, device=dev), 0)
    cdf = (cdf / cdf[-1]).clamp(min=0.0)
    cdf[1000::4096] = 0.0
    got = rs._monotone_cdf(cdf)
    if not torch.equal(got, torch.cummax(cdf, 0).values):
        raise AssertionError("K7b on float bits differs from torch.cummax")
    calls += 1
    ins = [_k7b_inputs(gen, dev, N_MAIN)["full range"] for _ in range(3)]
    outs = [cummax_int32(c) for c in ins]               # back to back
    for r, (c, o) in enumerate(zip(ins, outs)):
        same(f"call {r} of three in a row", o, c)
    calls += 3
    # K7a and K1 between K7b calls, all on one stream and one workspace
    w = _weights("mild", N_MAIN, gen, dev)
    u = torch.rand((), generator=gen, device=dev)
    total = w.sum()
    mixed = []
    for r in range(3):
        c = ins[r]
        mixed.append(("K7b", cummax_int32(c), c))
        mixed.append(("K7a", prefix_sum(w), w))
        mixed.append(("K1", systematic_counts_fused(w, total, u), w))
    for what, out, inp in mixed:
        if what == "K7b":
            same("between K7a and K1 calls", out, inp)
        else:
            ref = (prefix_sum_ref(w) if what == "K7a" else
                   systematic_counts_fused_ref(w, total, u))
            if not torch.equal(out, ref):
                raise AssertionError(f"{what} between K7b calls differs from "
                                     "its plain version")
    calls += 3
    launches = _read_counters()
    if launches["K7b"] != calls:
        raise AssertionError(f"K7b launched {launches['K7b']} times for "
                             f"{calls} calls")
    print(f"[29] K7b cummax_int32 vs torch.cummax: bit-equal at N in "
          f"{K7B_SIZES} on {', '.join(_k7b_inputs(gen, dev, 1))} inputs, "
          "aligned and misaligned, on float bits (_monotone_cdf), three "
          "calls in a row, and between K7a and K1 calls on one stream "
          f"({calls} calls, launches {launches['K7b']})", flush=True)


def _check_interp(res, t_len: int, d: int, what: str):
    import torch
    if not math.isfinite(float(res.ll)):
        raise AssertionError(f"{what}: ll not finite")
    for name, shape in (("eta_mean", (t_len,)), ("eta_lower", (t_len,)),
                        ("eta_upper", (t_len,)), ("state_mean", (t_len, d)),
                        ("state_lower", (t_len, d)),
                        ("state_upper", (t_len, d))):
        v = getattr(res, name)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: {name} is not finite {shape}")
    if not (bool((res.state_lower <= res.state_upper).all())
            and bool((res.eta_lower <= res.eta_upper).all())):
        raise AssertionError(f"{what}: a lower bound exceeds its upper bound")


def _tiers_agree(rp, rs, what: str):
    """The path tier's and the summary tier's results on one seed: ll,
    ESS and order statistics bit-equal, means within rtol 1e-6."""
    import torch
    for name in ("ll", "ess", "eta_lower", "eta_upper", "state_lower",
                 "state_upper"):
        if not torch.equal(getattr(rp, name), getattr(rs, name)):
            raise AssertionError(f"{what}: summary tier's {name} differs "
                                 "from the path tier's")
    for name in ("eta_mean", "state_mean"):
        torch.testing.assert_close(getattr(rs, name), getattr(rp, name),
                                   rtol=1e-6, atol=0)


# the flagship's knocked-out gap in phase 30 (100 steps at dt = 1)
INTERP_GAP = (400.0, 499.0)
N_INTERP_PATH = 2 ** 18


def phase_interpolation(dev, device_line: str):
    """[30] interpolation_filter on the flagship, T = 1000 with a 100-step
    gap: store="summary" at N = 2^20 under "systematic" (K1, K4) and
    "stratified" (K7a, K7b, K4), store="path" at N = 2^18 ("systematic"),
    and the summary tier at N = 2^18 on the path tier's seed, equal to it;
    launch counters around each run, ms/step."""
    import torch

    import composablestatespacemodels_torch as ct

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_MAIN, dt=1.0).to_timeseries()
    data = data.knock_out(*INTERP_GAP)
    n_obs = int(data.mask.sum())
    if n_obs != T_MAIN - 100:
        raise AssertionError(f"the gap knocked out {T_MAIN - n_obs} steps")
    # warm-up of both tiers at both N on the first 20 steps
    head = ct.TimeSeries(data.ts[:20], data.ys[:20], data.mask[:20])
    for n, store in ((N_MAIN, "summary"), (N_INTERP_PATH, "path")):
        float(ct.interpolation_filter(
            model, params, head, n, torch.Generator(device=dev).manual_seed(
                599), store=store).ll)
    out, lines = {}, []
    for what, n, scheme, store, seed, per_obs in (
            ("summary systematic", N_MAIN, "systematic", "summary", 600,
             {"K1": 1, "K4": 2}),
            ("summary stratified", N_MAIN, "stratified", "summary", 601,
             {"K7a": 1, "K7b": 1, "K4": 2}),
            ("path systematic", N_INTERP_PATH, "systematic", "path", 602,
             {"K1": 1, "K4": 1}),
            ("summary systematic", N_INTERP_PATH, "systematic", "summary",
             602, {"K1": 1, "K4": 2})):
        torch.cuda.synchronize()
        _reset_counters()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = ct.interpolation_filter(
            model, params, data, n, torch.Generator(device=dev).manual_seed(
                seed), resample=scheme, store=store)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        launches = _read_counters()
        want = {k: 0 for k in launches}
        want.update({k: v * n_obs for k, v in per_obs.items()})
        if launches != want:
            raise AssertionError(f"interpolation {what} N={n}: launches "
                                 f"{launches}, expected {want}")
        _check_interp(res, T_MAIN, model.dim, f"interpolation {what}")
        if (store == "path") != (res.paths is not None):
            raise AssertionError(f"interpolation {what}: paths")
        out[(store, scheme, n)] = (res, ms, launches)
        lines.append(f"{what} N={n}: ll {float(res.ll):.3f}, {ms:.1f} ms, "
                     f"{ms / T_MAIN:.4f} ms/step, launches "
                     f"{ {k: v for k, v in launches.items() if v} }")
    _tiers_agree(out[("path", "systematic", N_INTERP_PATH)][0],
                 out[("summary", "systematic", N_INTERP_PATH)][0],
                 "flagship")
    print(f"[30] interpolation_filter flagship d={model.dim} T={T_MAIN}, "
          f"gap {INTERP_GAP} ({n_obs} observed steps); CUDA events, one run "
          "each: " + "; ".join(lines) + f"; the summary tier at "
          f"N={N_INTERP_PATH} equals the path tier on its seed; "
          f"{device_line}", flush=True)
    return {f"{s} {sc} N={n}": {"ms_per_step": v[1] / T_MAIN,
                                "launches": v[2]}
            for (s, sc, n), v in out.items()}


def phase_interpolation_oracle(dev, runs: int = 8, n_schemes: int = 2 ** 16,
                               t_schemes: int = 50):
    """[31] interpolation_filter on the Kalman oracle (T = 200): the
    summary tier's ll at N = 2^18 ("systematic") within 4 se of Kalman over
    ``runs`` runs; then every other scheme name and a callable, both tiers
    at N = 2^16 on the first ``t_schemes`` steps, one seed each, the tiers
    equal."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.inference import resampling as rs

    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    data = ct.simulate_regular(
        model, params, torch.Generator(device=dev).manual_seed(7),
        T_ORACLE).to_timeseries()
    kf_ll = float(ct.kalman_filter(model, params, data).ll)
    lls = []
    for r in range(runs):
        res = ct.interpolation_filter(
            model, params, data, N_ORACLE,
            torch.Generator(device=dev).manual_seed(800 + r),
            store="summary")
        _check_interp(res, T_ORACLE, 1, "oracle")
        lls.append(float(res.ll))
    mean = statistics.fmean(lls)
    se = statistics.stdev(lls) / math.sqrt(runs)
    if not abs(mean - kf_ll) <= 4 * se:
        raise AssertionError("interpolation disagrees with the Kalman oracle "
                             "by more than 4 standard errors")

    def custom(g, w):
        # a user's scheme; it must draw the same ancestors from the same
        # generator state for the tiers to agree, which torch.multinomial
        # did not on the card (two runs from one seed gave different lls)
        return rs.stratified_indices(g, w)

    done = []
    head = ct.TimeSeries(data.ts[:t_schemes], data.ys[:t_schemes],
                         data.mask[:t_schemes])
    for scheme in ("stratified", "multinomial", "residual", "identity",
                   custom):
        name = getattr(scheme, "__name__", scheme)
        tiers = [ct.interpolation_filter(
            model, params, head, n_schemes,
            torch.Generator(device=dev).manual_seed(820), resample=scheme,
            store=store) for store in ("path", "summary")]
        for res in tiers:
            _check_interp(res, t_schemes, 1, f"oracle {name}")
        _tiers_agree(*tiers, f"oracle {name}")
        done.append(f"{name} {float(tiers[0].ll):.3f}")
    print(f"[31] interpolation_filter oracle T={T_ORACLE}: summary tier "
          f"N={N_ORACLE} mean ll {mean:.4f} (se {se:.4f}, {runs} runs) vs "
          f"Kalman {kf_ll:.4f}: {abs(mean - kf_ll) / se:.2f} se; both tiers "
          f"at N={n_schemes}, T={t_schemes}, equal, under "
          + ", ".join(done), flush=True)


# LGCP at the JAX bench's shape (bench.py:395-430): N, the fine grid's
# precision, runs per scheme
N_LGCP, LGCP_PRECISION, LGCP_RUNS = 2 ** 17, 1, 6


def lgcp_case(dev):
    """The JAX bench's LGCP: lgcp(brownian_motion(1)), events simulated by
    the port over [0, 20] at seed 2; returns the model, parameters, series
    and the fine grid's slots K."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.inference.lgcp import (
        _build_fine_grid)

    model = ct.lgcp(ct.brownian_motion(1))
    params = ct.parameters(None, ct.brownian_params(1.0, 0.05, 0.1))
    events, _ = ct.simulate_lgcp(model, params,
                                 torch.Generator(device=dev).manual_seed(2),
                                 0.0, 20.0)
    data = events.to_timeseries()
    k = len(_build_fine_grid(data.ts.cpu().double().numpy(),
                             LGCP_PRECISION)[0])
    return model, params, data, k


def phase_lgcp(dev, device_line: str):
    """[32] lgcp_filter at the JAX bench's shape under "systematic" (K1,
    K4) and "stratified" (K7a, K7b, K4): finite ll, ordered intervals,
    launch counters, the two schemes' lls within 4 joint se over
    LGCP_RUNS runs each; particle-slot-steps/s = N * K over the best run's
    seconds (host clock ending in the ll's host read, as the JAX bench)."""
    import torch

    import composablestatespacemodels_torch as ct

    model, params, data, k = lgcp_case(dev)
    n_obs = len(data)
    out, lines = {}, []
    for scheme, per_obs in (("systematic", {"K1": 1, "K4": 1}),
                            ("stratified", {"K7a": 1, "K7b": 1, "K4": 1})):
        def run(seed):
            return ct.lgcp_filter(
                model, params, data, N_LGCP,
                torch.Generator(device=dev).manual_seed(seed),
                precision=LGCP_PRECISION, resample=scheme)

        float(run(900).ll)                       # warm-up
        torch.cuda.synchronize()
        _reset_counters()
        lls, secs = [], []
        for r in range(LGCP_RUNS):
            t0 = time.perf_counter()
            res = run(901 + r)
            lls.append(float(res.ll))            # the host read ends the run
            secs.append(time.perf_counter() - t0)
            if not (bool((res.state_lower <= res.state_upper).all())
                    and bool((res.eta_lower <= res.eta_upper).all())
                    and bool(torch.isfinite(res.state_mean).all())):
                raise AssertionError(f"lgcp {scheme}: intervals")
        launches = _read_counters()
        want = {key: 0 for key in launches}
        want.update({key: v * n_obs * LGCP_RUNS
                     for key, v in per_obs.items()})
        if launches != want:
            raise AssertionError(f"lgcp {scheme}: launches {launches}, "
                                 f"expected {want}")
        if not all(math.isfinite(v) for v in lls):
            raise AssertionError(f"lgcp {scheme}: ll not finite: {lls}")
        rate = N_LGCP * k / min(secs)
        out[scheme] = {"lls": lls, "rate": rate, "launches": launches,
                       "ms_per_run": statistics.median(secs) * 1e3}
        lines.append(f"{scheme}: mean ll {statistics.fmean(lls):.4f} (se "
                     f"{statistics.stdev(lls) / math.sqrt(LGCP_RUNS):.4f}), "
                     f"best {min(secs) * 1e3:.2f} ms, median "
                     f"{statistics.median(secs) * 1e3:.2f} ms, {rate:.4g} "
                     "particle-slot-steps/s, launches "
                     f"{ {key: v for key, v in launches.items() if v} }")
    a, b = out["systematic"]["lls"], out["stratified"]["lls"]
    joint = math.hypot(statistics.stdev(a), statistics.stdev(b)) / math.sqrt(
        LGCP_RUNS)
    gap = abs(statistics.fmean(a) - statistics.fmean(b))
    print(f"[32] lgcp_filter lgcp(brownian(1)) N={N_LGCP} precision="
          f"{LGCP_PRECISION}, {n_obs} events, K={k} slots, {LGCP_RUNS} runs "
          "each: " + "; ".join(lines) + f"; schemes {gap / joint:.2f} joint "
          f"se apart; {device_line}", flush=True)
    if not gap <= 4 * joint:
        raise AssertionError("lgcp systematic and stratified disagree by more "
                             "than 4 joint standard errors")
    return out, k


def phase_new_paths_device(dev, t_len: int = 100):
    """[33] the device time per step of the new paths (torch.profiler, one
    run each, last for the same reason as phase 28): interpolation on the
    flagship's first ``t_len`` steps at N = 2^20 (summary, "systematic")
    and N = 2^18 (path), and one LGCP run at the bench's shape; per step,
    the kernels and the device time summed over them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import composablestatespacemodels_torch as ct

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               t_len, dt=1.0).to_timeseries()
    lg_model, lg_params, lg_data, k = lgcp_case(dev)
    runs = {
        f"interpolation summary N={N_MAIN}": (t_len, lambda g: float(
            ct.interpolation_filter(model, params, data, N_MAIN, g,
                                    store="summary").ll)),
        f"interpolation path N={N_INTERP_PATH}": (t_len, lambda g: float(
            ct.interpolation_filter(model, params, data, N_INTERP_PATH,
                                    g).ll)),
        f"lgcp N={N_LGCP} (per slot)": (k, lambda g: float(
            ct.lgcp_filter(lg_model, lg_params, lg_data, N_LGCP, g,
                           precision=LGCP_PRECISION).ll)),
    }
    out = {}
    for what, (steps, fn) in runs.items():
        fn(torch.Generator(device=dev).manual_seed(1))     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(torch.Generator(device=dev).manual_seed(2))
        wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            raise AssertionError(f"{what}: the profiler saw no CUDA kernel")
        us = sum(e.time_range.elapsed_us() for e in kernels)
        out[what] = {"device_us_per_step": us / steps,
                     "kernels_per_step": len(kernels) / steps,
                     "profiled_wall_ms_per_step": wall * 1e3 / steps}
    print(f"[33] device time per step (torch.profiler, one run each; "
          f"interpolation T={t_len}): " + "; ".join(
              f"{k_}: {v['device_us_per_step']:.1f} us in "
              f"{v['kernels_per_step']:.1f} kernels per step (profiled wall "
              f"{v['profiled_wall_ms_per_step']:.3f} ms/step)"
              for k_, v in out.items()), flush=True)
    return out


# CUDA kernels one call of each wrapper launches at its timing inputs (K6
# batched at N = 100: one tile); the kernels of ONE_KERNEL must launch one
KERNELS_PER_CALL = {"K1": 1, "K2": 1, "K4": 1, "K5": 1, "K7a": 1, "K7b": 1,
                    "K6b": 1, "K8": 1}
ONE_KERNEL = ("K1", "K4", "K7a", "K7b", "K6b", "K8")
# K8's device time is also taken at these (B, N), d = 7, T = T_PMMH
K8_DEVICE_SHAPES = ((1, N_PMMH), (CHAINS, N_PMMH), (1, 512))


def phase_device(inputs, scan_w, k3, k6b_512, ptxas):
    """[27] each kernel's device time per call from torch.profiler (the sum
    of its CUDA kernels' times, so a row whose back-to-back ``ms`` is bound
    by the host shows it) and its CUDA kernels per call, on the inputs it is
    timed on; K6 batched also at [256, 512] and K8 also at every (B, N) of
    ``K8_DEVICE_SHAPES``; for K1, K6 batched, K7a and ``torch.cumsum`` also
    the host microseconds per call, 1000 calls with no synchronisation; and
    ptxas's registers and spills for K6 batched and K8 (printed), and K8's
    registers, local memory and resident blocks per SM at N = 100, d = 7
    from the CUDA runtime, with the waves that 256 chains take on this
    card's SMs.  Fails if a kernel of ONE_KERNEL launches more than one CUDA
    kernel per call."""
    import torch

    from composablestatespacemodels_torch.ops.resample_kernel import (
        propagate_weights_t, resample_propagate, sorted_gather_resample_t)
    from composablestatespacemodels_torch.ops.scan_kernel import (
        cummax_int32, prefix_sum, systematic_counts_batched,
        systematic_counts_fused)
    from composablestatespacemodels_torch.ops.sweep_kernel import (
        pf_sweep_chains, sweep_occupancy)

    fns = {"K1": systematic_counts_fused, "K2": resample_propagate,
           "K4": sorted_gather_resample_t, "K5": propagate_weights_t,
           "K7a": prefix_sum, "K7b": cummax_int32,
           "K6b": systematic_counts_batched, "K8": pf_sweep_chains}
    out = {}
    for key, fn in fns.items():
        args = inputs[key]
        ms, per_call, names = _profile(lambda: fn(*args),
                                       5 if key == "K8" else 20,
                                       KERNELS_PER_CALL[key])
        out[key] = {"device_ms": ms, "device_kernels_per_call": per_call,
                    "device_kernels": names}
    k6b_512 = _profile(lambda: systematic_counts_batched(*k6b_512), 20, 1)
    out["K6b"].update(
        device_ms_at_512=k6b_512[0], device_kernels_per_call_at_512=k6b_512[1],
        host_us_per_call=_host_us(
            lambda: systematic_counts_batched(*inputs["K6b"])))
    gen = torch.Generator(device=scan_w.device).manual_seed(27)
    k8_shapes = {}
    for b, n in K8_DEVICE_SHAPES:
        args = _sweep_case(gen, scan_w.device, n, 7, b, T_PMMH, "Poisson")
        ms, per_call, _ = _profile(lambda: pf_sweep_chains(*args), 5, 1)
        if per_call not in (0.0, 1.0):
            raise AssertionError(f"K8 at (B, N) = ({b}, {n}) launched "
                                 f"{per_call} CUDA kernels per call")
        k8_shapes[f"B={b} N={n}"] = ms
    out["K8"]["device_ms_by_shape"] = k8_shapes
    k3_device = {name: _profile(lambda: propagate_weights_t(*v["K5 args"]),
                                20, 1)[0] for name, v in k3.items()}
    cum = _profile(lambda: torch.cumsum(scan_w, 0))
    out["K7a"].update(
        host_us_per_call=_host_us(lambda: prefix_sum(scan_w)),
        library_host_us_per_call=_host_us(lambda: torch.cumsum(scan_w, 0)),
        library_device_ms=cum[0], library_device_kernels_per_call=cum[1])
    scan_c = inputs["K7b"][0]
    cmx = _profile(lambda: torch.cummax(scan_c, 0))
    out["K7b"].update(
        host_us_per_call=_host_us(lambda: cummax_int32(scan_c)),
        library_host_us_per_call=_host_us(lambda: torch.cummax(scan_c, 0)),
        library_device_ms=cmx[0], library_device_kernels_per_call=cmx[1])
    out["K1"]["host_us_per_call"] = _host_us(
        lambda: systematic_counts_fused(*inputs["K1"]))
    ptxas_k6b_k8 = [ln for ln in ptxas
                    if ln.startswith(("counts_short_rows", "sweep_kernel"))]
    # the flagship's family (Poisson) at the PMMH shape, as the runtime
    # sees the loaded kernel
    occ = sweep_occupancy(7, N_PMMH, inputs["K8"][-1], scan_w.device)
    sms = torch.cuda.get_device_properties(scan_w.device).multi_processor_count
    occ.update(n=N_PMMH, d=7, sms=sms,
               resident_blocks=occ["blocks_per_sm"] * sms)
    occ[f"waves_for_{CHAINS}_chains"] = (
        -(-CHAINS // occ["resident_blocks"]) if occ["resident_blocks"]
        else None)
    out["K8"]["occupancy"] = occ
    print("[27] device time per call (torch.profiler, summed over the call's "
          "CUDA kernels): " + "; ".join(
              f"{k} {v['device_ms']} ms in {v['device_kernels_per_call']:g} "
              f"kernels ({', '.join(n[:32] for n in v['device_kernels'])})"
              for k, v in out.items())
          + f"; K6 batched at [{CHAINS}, 512] {k6b_512[0]} ms in "
          f"{k6b_512[1]:g} kernels; K8 at d=7, T={T_PMMH}: " + ", ".join(
              f"{k} {v} ms" for k, v in k8_shapes.items())
          + f"; torch.cumsum {cum[0]} ms in {cum[1]:g} kernels; "
          f"torch.cummax {cmx[0]} ms in {cmx[1]:g} kernels; host per "
          f"call (1000 calls, no sync): K1 "
          f"{out['K1']['host_us_per_call']:.2f} us, K6 batched "
          f"{out['K6b']['host_us_per_call']:.2f} us, K7a "
          f"{out['K7a']['host_us_per_call']:.2f} us, torch.cumsum "
          f"{out['K7a']['library_host_us_per_call']:.2f} us, K7b "
          f"{out['K7b']['host_us_per_call']:.2f} us, torch.cummax "
          f"{out['K7b']['library_host_us_per_call']:.2f} us; ptxas: "
          f"{' | '.join(ptxas_k6b_k8)}; K8 at N={N_PMMH}, d=7 (CUDA "
          f"runtime): {occ['registers']} registers, {occ['local_bytes']} B "
          f"local, {occ['blocks_per_sm']} blocks per SM x {sms} SMs = "
          f"{occ['resident_blocks']} resident, "
          f"{occ[f'waves_for_{CHAINS}_chains']} wave(s) for {CHAINS} "
          "chains", flush=True)
    for key in ONE_KERNEL:
        if out[key]["device_kernels_per_call"] not in (0.0, 1.0):
            raise AssertionError(
                f"{key} launched {out[key]['device_kernels_per_call']} CUDA "
                "kernels per call, expected 1")
    if k6b_512[1] not in (0.0, 1.0):
        raise AssertionError(f"K6b at [{CHAINS}, 512] launched {k6b_512[1]} "
                             "CUDA kernels per call, expected 1")
    return out, k3_device


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    from composablestatespacemodels_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    device_line = _device_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    print(device_line, flush=True)

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    ptxas = _ptxas_summary((path.parent / "build.log").read_text()
                           .splitlines())
    print(f"[2] built {path.relative_to(_build.BUILD_ROOT.parent.parent)} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(1234)
    k1_err, counts_in = phase_counts(gen, dev, N_MAIN)
    k2_err, prop_in, regime_counts = phase_resample(gen, dev)
    launches = phase_main(dev, device_line)
    phase_oracle(dev)
    times, k2_regimes = phase_timing(counts_in[:3], prop_in, regime_counts)
    k4_err, gather_in = phase_gather(gen, dev)
    k5_err, prop5_in = phase_propagate(gen, dev, N_MAIN)
    k7_err, scan_in = phase_scans(gen, dev, N_MAIN)
    summary_launches = phase_summary(dev, device_line)
    strat_launches = phase_oracle_summary(dev)
    phase_selection(gen, dev, N_MAIN)
    phase_ess_sync(dev)
    new_times, k2_regimes_15, k4_regimes = phase_timing_new(
        gather_in, prop5_in, scan_in, prop_in, regime_counts)
    times.update(new_times)
    # K1 at the single PMMH tier's shape, [N_PMMH] (phase 8 holds K4 there)
    k1_err = max(k1_err, phase_counts(gen, dev, N_PMMH)[0])
    k6b_err, counts_b_in, counts_b_512 = phase_counts_batched(gen, dev)
    k8_err = phase_sweep(gen, dev)
    phase_sweep_path(dev)
    phase_sweep_stats(dev)
    _, pmmh_launches = phase_pmmh(dev, device_line)
    pmmh_times, sweep_in = phase_timing_pmmh(counts_b_in)
    times.update(pmmh_times)
    k3 = phase_k3(gen, dev, counts_in[3])
    family_launches = phase_families(dev, device_line)
    clouds, kf = phase_schemes(dev)
    phase_forecast(dev, clouds, kf)
    nb_k8 = phase_pmmh_family(dev, device_line)
    library = phase_library(gather_in, scan_in)
    device, k3_device = phase_device(
        {"K1": counts_in[:3], "K2": prop_in, "K4": gather_in,
         "K5": prop5_in, "K7a": (scan_in[0],), "K7b": (scan_in[1],),
         "K6b": counts_b_in, "K8": sweep_in}, scan_in[0], k3, counts_b_512,
        ptxas)
    phase_main_device(dev)
    # slice 8: K7b's edges, interpolation and LGCP
    t_new = time.perf_counter()
    phase_k7b_edges(gen, dev)
    interp = phase_interpolation(dev, device_line)
    phase_interpolation_oracle(dev)
    lgcp, _ = phase_lgcp(dev, device_line)
    new_device = phase_new_paths_device(dev)
    print(f"[34] phases 29-33 took {time.perf_counter() - t_new:.1f} s; the "
          f"script {time.perf_counter() - t_start:.1f} s", flush=True)

    # bound_ms from this run's inputs: each input read once, each output
    # written once; operations counted per element as noted beside each
    n, d = N_MAIN, 7
    per_col = d * (OPS_NORMAL + 4) + OPS_K3       # K5: propagate + weights
    b, dk, nk = sweep_in[0].shape
    steps, kc = sweep_in[1].shape[0], sweep_in[3].shape[-1]
    k6b_rows, k6b_n = counts_b_in[0].shape
    bounds = {
        "K1": _bound(8 * n, 8 * n),        # read w, write counts
        # K2's ancestors by a merge: 2n merged positions, ~2 ops each
        "K2": _bound(4 * (2 * d * n + 2 * n), n * (per_col + 4)),
        # K4's ancestors by the same merge: 2n merged positions, ~2 ops each
        "K4": _bound(4 * (2 * d * n + n), 2 * 2 * n),
        "K5": _bound(4 * (2 * d * n + n), n * per_col),
        "K7a": _bound(8 * n, 2 * n),
        "K7b": _bound(8 * n, n),
        "K6b": _bound(8 * k6b_rows * k6b_n, 8 * k6b_rows * k6b_n),
        # clouds in and out, coefficients, design, constants, mask, ll;
        # per particle-step the propagate and weights, the reductions and
        # counts (~20) and the ancestor search
        "K8": _bound(4 * (2 * b * dk * nk + steps * b * dk * 3 + steps * dk
                          + steps * b * kc + steps + b),
                     b * nk * steps * (dk * (OPS_NORMAL + 5) + OPS_K3 + 20
                                       + 2 * math.log2(nk))),
    }
    src = "composablestatespacemodels_torch/csrc/"
    tpu = "composablestatespacemodels_tpu/ops/"
    fams = "all seven pointwise families"
    fused = summary_launches["systematic-pallas-fused"]

    def entry(key, name, source, replaces, launches, err, ms, plain_ms,
              device_ms=None):
        bound_ms, bound_by = bounds[key]
        extra = {k: v for k, v in device[key].items()
                 if k != "device_kernels"}
        if device_ms is not None:
            extra["device_ms"] = device_ms
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library.get(key), **extra}

    kernels = [
        entry("K1", "K1 systematic_counts_fused", "counts.cu",
              tpu + "scan_kernel.py:550", launches["K1"], k1_err,
              *times["K1"]),
        entry("K2", f"K2+K3 resample_propagate ({fams})",
              "resample_propagate.cu", tpu + "resample_kernel.py:667",
              launches["K2"],
              max(k2_err, *(v["err"]["K2"] for v in k3.values())),
              *times["K2"]),
        entry("K4", "K4 sorted_gather_resample_t", "gather.cu",
              tpu + "resample_kernel.py:616", fused["K4"], k4_err,
              *times["K4"]),
        entry("K5", f"K5+K3 propagate_weights_t ({fams})",
              "propagate_weights.cu", tpu + "resample_kernel.py:756",
              fused["K5"], max(k5_err, *(v["err"]["K5"] for v in k3.values())),
              *times["K5"]),
        entry("K7a", "K7a prefix_sum", "scan.cu", tpu + "scan_kernel.py:613",
              strat_launches["K7a"], k7_err, *times["K7a"]),
        entry("K7b", "K7b cummax_int32", "scan.cu",
              tpu + "scan_kernel.py:480", strat_launches["K7b"], k7_err,
              *times["K7b"]),
        entry("K6b", "K6 batched systematic_counts_batched", "counts.cu",
              tpu + "scan_kernel.py:302", pmmh_launches["chains"]["K6b"],
              k6b_err, *times["K6b"]),
        entry("K8", f"K8+K3 pf_sweep_chains ({fams})", "sweep.cu",
              tpu + "sweep_kernel.py:358",
              sum(pmmh_launches[k]["K8"] for k in
                  ("fused", "chains_fused", "fused_n512")),
              max(k8_err, *(v["err"]["K8"] for v in k3.values())),
              *times["K8"]),
    ]
    # K3 inside K5 at the main path's shapes: its time is K5's with the
    # family's device function, its launches those of K2 and K5 in the
    # family's full-width run (and K8 in the negative binomial's PMMH)
    hooks = {"Gaussian": 86, "Poisson": 116, "ZeroInflatedPoisson": 156,
             "NegativeBinomial": 196, "Bernoulli": 231, "StudentsT": 275,
             "Beta": 338}
    for name, v in k3.items():
        fl = family_launches[name]
        kernels.append(entry(
            "K5", f"K3 {name}", "obs_density.cuh",
            f"composablestatespacemodels_tpu/models/observation.py:"
            f"{hooks[name]}",
            fl["K2"] + fl["K5"] + (nb_k8 if name == "NegativeBinomial"
                                   else 0),
            max(v["err"].values()), v["K5"], v["K5 plain"], k3_device[name]))
    kernels[1]["ms_by_counts_regime"] = {
        k: [v, k2_regimes_15[k]] for k, v in k2_regimes.items()}
    kernels[2]["ms_by_counts_regime"] = k4_regimes
    # the launches of slice 8's paths, each read around its runs
    by_name = dict(zip(("K1", "K2", "K4", "K5", "K7a", "K7b", "K6b", "K8"),
                       kernels))
    for path, counts in (
            *((f"interpolation {k}", v["launches"]) for k, v in
              interp.items()),
            *((f"lgcp {k}", v["launches"]) for k, v in lgcp.items())):
        for key, v in counts.items():
            if v:
                by_name[key].setdefault("launches_by_path", {})[path] = v
    paths_line = {"interpolation": interp, "lgcp": {
        k: {"particle_slot_steps_per_s": v["rate"],
            "ms_per_run": v["ms_per_run"]} for k, v in lgcp.items()},
        "device_per_step": new_device}
    print(json.dumps({"paths": paths_line}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
