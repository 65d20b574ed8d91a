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
particle-slot-steps/s; and the new paths' device time per step.  Then
slice 9: ``utils.OnlineFilter`` on the flagship at N = 2^20 in 10
chunks of 100 (store="summary", K1 + K4) against one
``bootstrap_filter`` call, and on the Kalman oracle; ``pmmh_monitored``
at N = 100, T = 400 in 3 checkpointed chunks of 20, resumed to 4 and
equal bit for bit to an uninterrupted run, with and without
``store_state``; the native IO tier built from the checkout and held to
the Python parser on a 10^6-row CSV; and every example app
(``composablestatespacemodels_torch.examples``) at its defaults with
``--device cuda``, each app's launches read around it (K1, K4, K6
batched, K7a, K7b, K8).  Last, the mesh routes in a world of
one rank over NCCL (``parallel.initialize_distributed()``,
``make_mesh(1, 1)``): the flagship at N = 2^20 through
``bootstrap_filter(mesh=)`` under "systematic" (K7a, K7b, K4; the JAX
bench's ``sharded_particle_steps_per_sec``), the fused one-shard
delegation (K1, K2; ``sharded_fused_*``) and the fused summary with the
ESS trigger (K5, K7a, K7b, K4), each against its single-device route; the
ring's fill through K4 for S = 4 virtual shards of one cloud on five
weight regimes, every (shard, hop) bit-equal to the plain fill;
``sharded_pmmh`` and ``sharded_pmmh_monitored`` (resumed bit for bit),
``lgcp_filter(mesh=)``, ``OnlineFilter(mesh=)`` and both apps with
``--mesh``.  Then slice 11 (phase 42): every block of
``docs/tutorial_torch.md`` unchanged on the card, its launches read per
section (K1, K4, K8); ``decompose`` and ``component_f`` on the flagship's
2^20 cloud against ``model.f`` and against the CPU; the tree algebra on
CUDA leaves.
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


# ---------------------------------------------------------------------------
# slice 9: streaming, monitored PMMH, the example apps, native IO
# ---------------------------------------------------------------------------

STREAM_CHUNK = 100          # T_MAIN in 10 chunks
PMMH_CHUNK = 20             # pmmh_monitored: 3 chunks, then resume to 4
IO_ROWS = 10 ** 6
# the example apps' chains and iterations (the apps' own defaults otherwise:
# n_obs 500, N 1000): the sweep, the chain axis, the monitored chain
APP_CHAINS = 256
APP_ITERS = {"fused": 100, "chains": 10, "monitored": 40}


def _mean_se(lls):
    return (statistics.fmean(lls),
            statistics.stdev(lls) / math.sqrt(len(lls)))


def _online(model, params, data, n, gen, store, chunk):
    """One OnlineFilter pass over ``data`` in chunks of ``chunk`` steps."""
    import composablestatespacemodels_torch as ct

    f = ct.utils.OnlineFilter(model, params, n, gen, t0=float(data.ts[0]),
                              store=store)
    for i in range(0, len(data), chunk):
        res = f.step(ct.TimeSeries(data.ts[i:i + chunk],
                                   data.ys[i:i + chunk],
                                   data.mask[i:i + chunk]))
        if store == "summary":
            _check_summary(res, min(chunk, len(data) - i), model.dim,
                           "OnlineFilter")
    if f.n_observed != len(data):
        raise AssertionError(f"OnlineFilter saw {f.n_observed} of "
                             f"{len(data)} steps")
    return f


def phase_streaming(dev, device_line: str, runs: int = 2,
                    ll_runs: int = 6):
    """[35] OnlineFilter on the flagship at N = 2^20, T = 1000 in 10 chunks
    of 100 (store="summary", "systematic": K1 + K4 per observed step)
    against one bootstrap_filter call on the same data: ``runs`` timed runs
    of each (launch counters around them), and ``ll_runs`` more of each
    with store="ll" (the same draws as "summary" on one seed) for the
    standard error; the summed ll within 4 joint se of the unchunked.
    Then the oracle in chunks of 20 within 4 se of Kalman."""
    import torch

    import composablestatespacemodels_torch as ct

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_MAIN, dt=1.0).to_timeseries()
    n_obs = int(data.mask.sum())

    def chunked(gen, store):
        return _online(model, params, data, N_MAIN, gen, store,
                       STREAM_CHUNK).ll

    def unchunked(gen, store):
        res = ct.bootstrap_filter(model, params, data, N_MAIN, gen,
                                  store=store)
        if store == "summary":
            _check_summary(res, T_MAIN, model.dim, "bootstrap_filter")
        return res.ll

    _online(model, params, ct.TimeSeries(data.ts[:STREAM_CHUNK],
                                         data.ys[:STREAM_CHUNK],
                                         data.mask[:STREAM_CHUNK]),
            N_MAIN, torch.Generator(device=dev).manual_seed(699), "summary",
            STREAM_CHUNK)   # warm-up
    out = {}
    for what, fn, seed in (("chunked", chunked, 700),
                           ("unchunked", unchunked, 720)):
        torch.cuda.synchronize()
        _reset_counters()
        ms, lls = [], []
        for r in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ll = fn(torch.Generator(device=dev).manual_seed(seed + r),
                    "summary")
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            lls.append(float(ll))
        launches = _read_counters()
        want = {k: 0 for k in launches}
        want.update(K1=runs * n_obs, K4=runs * n_obs)
        if launches != want:
            raise AssertionError(f"streaming {what}: launches {launches}, "
                                 f"expected {want}")
        lls += [float(fn(torch.Generator(device=dev).manual_seed(
            seed + runs + r), "ll")) for r in range(ll_runs)]
        if not all(math.isfinite(v) for v in lls):
            raise AssertionError(f"streaming {what}: ll not finite: {lls}")
        out[what] = {"ms_per_step": statistics.median(ms) / T_MAIN,
                     "lls": lls, "launches": launches}
    (mc, sc), (mu, su) = (_mean_se(out[k]["lls"])
                          for k in ("chunked", "unchunked"))
    joint = math.hypot(sc, su)
    if not abs(mc - mu) <= 4 * joint:
        raise AssertionError(f"chunked ll {mc} vs unchunked {mu}: more than "
                             f"4 joint se ({joint})")

    o_model = ct.linear(ct.brownian_motion(1))
    o_params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    o_data = ct.simulate_regular(
        o_model, o_params, torch.Generator(device=dev).manual_seed(7),
        T_ORACLE).to_timeseries()
    kf = float(ct.kalman_filter(o_model, o_params, o_data).ll)
    o_lls = [float(_online(o_model, o_params, o_data, N_ORACLE,
                           torch.Generator(device=dev).manual_seed(740 + r),
                           "ll", 20).ll) for r in range(8)]
    mo, so = _mean_se(o_lls)
    if not abs(mo - kf) <= 4 * so:
        raise AssertionError(f"chunked oracle ll {mo} (se {so}) vs Kalman "
                             f"{kf}: more than 4 se")
    out["oracle"] = {"mean_ll": mo, "se": so, "kalman": kf}
    print(f"[35] OnlineFilter flagship d={model.dim} N={N_MAIN} T={T_MAIN} "
          f"in {T_MAIN // STREAM_CHUNK} chunks of {STREAM_CHUNK}, "
          f"store=summary, systematic: "
          f"{out['chunked']['ms_per_step']:.4f} ms/step chunked vs "
          f"{out['unchunked']['ms_per_step']:.4f} unchunked (CUDA events, "
          f"median of {runs}); mean ll {mc:.3f} (se {sc:.3f}) vs {mu:.3f} "
          f"(se {su:.3f}), {abs(mc - mu) / joint:.2f} joint se "
          f"({runs} summary + {ll_runs} ll runs each); launches "
          f"{ {k: v for k, v in out['chunked']['launches'].items() if v} } "
          f"over {runs} chunked runs; oracle T={T_ORACLE} N={N_ORACLE} in "
          f"chunks of 20: mean ll {mo:.4f} (se {so:.4f}) vs Kalman "
          f"{kf:.4f}, {abs(mo - kf) / so:.2f} se; {device_line}",
          flush=True)
    return out


def phase_pmmh_monitored(dev, device_line: str):
    """[36] pmmh_monitored on the flagship, N = 100, T = 400 (make_pf_loglik:
    K1 + K4 per observed step): 3 chunks of 20 with a checkpoint in a
    temporary directory, then a second call resumes to 4 chunks; the
    result equals an uninterrupted 4-chunk run bit for bit; the same with
    store_state=True.  Launch counters around the two checkpointed calls
    (the resume under store_state evaluates the filter once more for the
    latent state's shape)."""
    import io
    import os
    import tempfile

    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.models import perturb, stack_flat
    from composablestatespacemodels_torch.utils.streaming import (
        pmmh_monitored)

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_PMMH, dt=1.0).to_timeseries()
    n_obs = int(data.mask.sum())
    prop = perturb(0.05)
    out, lines = {}, []
    for store_state in (False, True):
        pf = ct.make_pf_loglik(model, data, N_PMMH, store_state=store_state)

        def run(n_iters, path):
            log = io.StringIO()
            t0 = time.perf_counter()
            res = pmmh_monitored(
                torch.Generator(device=dev).manual_seed(40), params, pf,
                prop, n_iters, chunk_size=PMMH_CHUNK,
                store_state=store_state, checkpoint_path=path, out=log)
            float(res.lls.sum())
            return res, time.perf_counter() - t0, log.getvalue()

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "chain.npz")
            torch.cuda.synchronize()
            _reset_counters()
            first, s_first, _ = run(3 * PMMH_CHUNK, path)
            resumed, s_resume, log = run(4 * PMMH_CHUNK, path)
            launches = _read_counters()
        full, s_full, _ = run(4 * PMMH_CHUNK, None)
        what = f"store_state={store_state}"
        evals = 4 * PMMH_CHUNK + (1 if store_state else 0)
        want = {k: 0 for k in launches}
        want.update(K1=evals * n_obs, K4=evals * n_obs)
        if launches != want:
            raise AssertionError(f"pmmh_monitored {what}: launches "
                                 f"{launches}, expected {want}")
        if f"at chunk 3/4" not in log:
            raise AssertionError(f"pmmh_monitored {what}: no resume: {log}")
        head = 3 * PMMH_CHUNK
        pairs = [(first.lls, full.lls[:head]),
                 (first.accepted, full.accepted[:head]),
                 (resumed.lls, full.lls), (resumed.accepted, full.accepted),
                 (stack_flat(resumed.params), stack_flat(full.params))]
        if store_state:
            pairs.append((resumed.states, full.states))
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"pmmh_monitored {what}: the resumed chain "
                                 "differs from the uninterrupted one")
        if not bool(torch.isfinite(full.lls).all()):
            raise AssertionError(f"pmmh_monitored {what}: ll not finite")
        rate = 4 * PMMH_CHUNK / s_full
        out[what] = {"iters_per_s": rate, "launches": launches,
                     "checkpointed_iters_per_s":
                         4 * PMMH_CHUNK / (s_first + s_resume)}
        lines.append(
            f"{what}: {rate:.2f} iters/s uninterrupted, "
            f"{out[what]['checkpointed_iters_per_s']:.2f} with checkpoints "
            f"and the resume; acceptance "
            f"{float(full.acceptance_rate()):.3f}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
    print(f"[36] pmmh_monitored flagship N={N_PMMH} T={T_PMMH}, chunks of "
          f"{PMMH_CHUNK}: 3 chunks, then resumed to 4, bit-equal to an "
          "uninterrupted run (lls, accepted, params; states); "
          + "; ".join(lines) + f"; {device_line}", flush=True)
    return out


def _csv_rows(path, header: bool = False):
    import numpy as np
    with open(path) as f:
        lines = f.read().strip().split("\n")
    return np.asarray([ln.split(",") for ln in lines[int(header):]],
                      dtype=float)


def phase_clis(dev, device_line: str):
    """[38] the example apps on the card with --device cuda at their
    defaults (n_obs 500, N 1000, d = 9), in a temporary directory: each
    app's main() with the launch counters set to 0 just before and read
    just after; each output file parsed with the port's readers."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from composablestatespacemodels_torch.examples import (
        determine_parameters, filtering, interpolate, simulate)
    from composablestatespacemodels_torch.utils import io as tio

    cuda = ["--device", str(dev)]
    out, lines = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "d")
        sims = d + "_sims.json"

        def app(what, main, argv, want):
            torch.cuda.synchronize()
            _reset_counters()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                main(argv + cuda)
            seconds = time.perf_counter() - t0
            launches = _read_counters()
            expected = {k: 0 for k in launches}
            expected.update(want)
            if launches != expected:
                raise AssertionError(f"app {what}: launches {launches}, "
                                     f"expected {expected}")
            out[what] = {"s": seconds, "launches": launches}
            lines.append(f"{what} {seconds:.2f} s "
                         f"{ {k: v for k, v in launches.items() if v} }")
            return buf.getvalue()

        app("simulate model", simulate.main, ["model", "--out", d], {})
        data = tio.read_timeseries_json(sims, device=dev)
        n_obs = int(data.mask.sum())
        if len(data) != 500 or _csv_rows(d + "_sims.csv").shape != (500, 13):
            raise AssertionError("simulate model: wrong output shape")
        text = app("filtering", filtering.main, [sims, "--out", d],
                   {"K1": n_obs, "K4": n_obs})
        rows = _csv_rows(d + "_filtered.csv")
        if (rows.shape != (500, 14) or not np.isfinite(rows).all()
                or not math.isfinite(float(text.split()[2].rstrip(";")))):
            raise AssertionError(f"filtering: {text!r}, rows {rows.shape}")
        text = app("pilot --fused-sweep", determine_parameters.main,
                   ["pilot", sims, "--fused-sweep", "--out", d],
                   {"K8": 4, "K6b": n_obs})
        pilot = [ln.split(",") for ln in text.strip().split("\n")[1:]]
        if ([int(p[0]) for p in pilot] != [100, 200, 500, 1000, 2000]
                or not all(math.isfinite(float(p[1])) for p in pilot)):
            raise AssertionError(f"pilot: {text!r}")
        out["pilot --fused-sweep"]["rows"] = [
            [int(p[0]), float(p[1]), float(p[2])] for p in pilot]
        rhat = {}
        it = APP_ITERS
        for what, extra, iters, want in (
                (f"posterior --chains {APP_CHAINS} --fused-sweep",
                 ["--fused-sweep"], it["fused"], {"K8": it["fused"]}),
                (f"posterior --chains {APP_CHAINS}", [], it["chains"],
                 {"K6b": it["chains"] * n_obs})):
            pd = d + ("_pf" if extra else "_pc")
            text = app(what, determine_parameters.main,
                       ["posterior", sims, "--chains", str(APP_CHAINS),
                        "--n-iters", str(iters), "--out", pd] + extra, want)
            rhat[what] = float(text.split("R-hat(ll): ")[1].split()[0])
            for c in (0, APP_CHAINS - 1):
                _, lls, _ = tio.read_posterior_json(
                    f"{pd}_posterior_{c}.json", device=dev)
                if len(lls) != iters or not bool(torch.isfinite(lls).all()):
                    raise AssertionError(f"{what}: chain {c} posterior")
            out[what]["rhat_ll"] = rhat[what]
        iters = it["monitored"]
        text = app("posterior monitored", determine_parameters.main,
                   ["posterior", sims, "--chains", "1", "--n-iters",
                    str(iters), "--out", d],
                   {"K1": iters * n_obs, "K4": iters * n_obs})
        _, lls, _ = tio.read_posterior_json(d + "_posterior.json",
                                            device=dev)
        if len(lls) != iters or not bool(torch.isfinite(lls).all()):
            raise AssertionError("posterior monitored: posterior")
        csv = os.path.join(tmp, "posterior.csv")
        app("tocsv", determine_parameters.main,
            ["tocsv", d + "_posterior.json", csv], {})
        if _csv_rows(csv, header=True).shape != (iters, 12):
            raise AssertionError("tocsv: wrong shape")
        for scheme, per in (("systematic", {"K1": 1, "K4": 1}),
                            ("stratified", {"K7a": 1, "K7b": 1, "K4": 1})):
            # the default knock-out window [420, 450] leaves 469 observed
            app(f"interpolate {scheme}", interpolate.main,
                ["--resample", scheme, "--out", d],
                {k: v * 469 for k, v in per.items()})
            rows = _csv_rows(d + "_interpolated.csv")
            if (rows.shape != (500, 5) or int(rows[:, 4].sum()) != 469
                    or not np.isfinite(rows).all()
                    or not (rows[:, 2] <= rows[:, 3]).all()):
                raise AssertionError(f"interpolate {scheme}: output")
        app("simulate lgcp", simulate.main, ["lgcp", "--out", d], {})
        ev = _csv_rows(d + "_lgcp.csv")
        if ev.ndim != 2 or ev.shape[1] != 5 or not (ev[:, 0] <= 10).all():
            raise AssertionError("simulate lgcp: output")
    print("[38] example apps, --device cuda, defaults (n_obs 500, N 1000, "
          "d = 9), host clock and launches: " + "; ".join(lines)
          + f"; R-hat(ll) {rhat}; {device_line}", flush=True)
    return out


def phase_native_io(dev):
    """[37] the port's native IO tier on the card machine's host: built
    with g++ here, before any other reader runs (the phase fails if it
    does not build); a 10^6-row CSV with NA, empty and
    whitespace-only rows read by the native and by the pure-Python
    parser onto the card, equal bit for bit; both parse times."""
    import os
    import tempfile

    import numpy as np
    import torch

    from composablestatespacemodels_torch.native import loader
    from composablestatespacemodels_torch.utils import io as tio

    t0 = time.perf_counter()
    if not loader.available():
        raise AssertionError("the native IO tier did not build: "
                             f"{loader.library_path()}")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(38)
    ts = np.cumsum(rng.uniform(0.01, 1.0, IO_ROWS))
    ys = rng.normal(3.0, 2.0, IO_ROWS)
    kind = rng.uniform(size=IO_ROWS)
    rows = [f"{t},NA" if k < 0.05 else f"{t}," if k < 0.1
            else f"{t},{y}\n  " if k < 0.11 else f"{t},{y}"
            for t, y, k in zip(ts.tolist(), ys.tolist(), kind.tolist())]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "big.csv")
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
        times = {}
        t0 = time.perf_counter()
        native = tio.read_timeseries_csv(path, device=dev)
        torch.cuda.synchronize()
        times["native"] = time.perf_counter() - t0
        saved = loader._lib, loader._tried
        loader._lib, loader._tried = None, True
        try:
            t0 = time.perf_counter()
            python = tio.read_timeseries_csv(path, device=dev)
            torch.cuda.synchronize()
            times["python"] = time.perf_counter() - t0
        finally:
            loader._lib, loader._tried = saved
    if len(native) != IO_ROWS:
        raise AssertionError(f"native parse: {len(native)} rows")
    for f in ("ts", "ys", "mask"):
        if not torch.equal(getattr(native, f), getattr(python, f)):
            raise AssertionError(f"native and Python parsers differ in {f}")
    n_missing = IO_ROWS - int(native.mask.sum())
    print(f"[37] native IO tier built and loaded in {build_s:.2f} s; "
          f"{IO_ROWS} rows ({n_missing} missing, "
          f"{int(((kind >= 0.1) & (kind < 0.11)).sum())} whitespace-only "
          f"lines): native {times['native']:.3f} s, Python "
          f"{times['python']:.3f} s to a series on the card, bit for bit "
          "equal", flush=True)
    return {"rows": IO_ROWS, "native_s": times["native"],
            "python_s": times["python"]}


# ---------------------------------------------------------------------------
# the mesh routes (parallel/) in a world of one rank over NCCL
# ---------------------------------------------------------------------------

# the JAX bench's sharded keys (bench.py:210-247): the machinery at T = 200
# under "systematic", the fused delegation at T = 1000; the fused summary
# with the ESS trigger at T = 100; timed runs each
T_MESH, T_MESH_FUSED, T_MESH_SUMMARY, MESH_RUNS = 200, T_MAIN, 100, 3
# the ring's virtual shards on the card (phase 40) and its weight regimes:
# phase 15's counts regimes, "spikes" as weight on the first and last
RING_SHARDS = 4
RING_REGIMES = ("uniform", "mild", "heavy", "degenerate", "spikes")
MESH_PMMH_ITERS, MESH_MONITORED_CHUNK, MESH_APP_ITERS = 20, 5, 4


def _series(data, t_len: int):
    """The first ``t_len`` steps of ``data``."""
    import composablestatespacemodels_torch as ct
    return ct.TimeSeries(data.ts[:t_len], data.ys[:t_len],
                         data.mask[:t_len])


def _timed_runs(run, seeds):
    """Host seconds of each ``run(seed)`` (ending in a host read of the
    ll) and the lls, after a warm-up run, with the launch counters set to
    0 just before the timed runs and read just after."""
    import torch
    float(run(seeds[0] - 1).ll)
    torch.cuda.synchronize()
    _reset_counters()
    secs, lls, results = [], [], []
    for seed in seeds:
        t0 = time.perf_counter()
        res = run(seed)
        lls.append(float(res.ll))
        secs.append(time.perf_counter() - t0)
        results.append(res)
    return secs, lls, _read_counters(), results


def _expect(launches, want, what):
    expected = {k: 0 for k in launches}
    expected.update(want)
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{expected}")


def _joint_se_check(a, b, what):
    (ma, sa), (mb, sb) = _mean_se(a), _mean_se(b)
    joint = math.hypot(sa, sb)
    if not abs(ma - mb) <= 4 * joint:
        raise AssertionError(f"{what}: {ma} vs {mb}, more than 4 joint se "
                             f"({joint})")
    return abs(ma - mb) / joint


def nccl_world_of_one():
    """A world of one rank over NCCL (initialize_distributed() with no
    torchrun environment) and its make_mesh(1, 1) on cuda."""
    import torch.distributed as dist

    from composablestatespacemodels_torch.parallel import (
        initialize_distributed, make_mesh)

    initialize_distributed()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"expected a world of one over NCCL, got "
                             f"{dist.get_world_size()} over "
                             f"{dist.get_backend()}")
    mesh = make_mesh(1, 1)
    if mesh.device_type != "cuda":
        raise AssertionError(f"mesh on {mesh.device_type}")
    return mesh


def phase_mesh_flagship(dev, device_line: str, mesh):
    """[39] on ``mesh`` (a world of one rank over NCCL), the flagship at
    N = 2^20 through bootstrap_filter(mesh=): "systematic", store "ll",
    T = 200 (the distributed machinery: K7a and K7b for the window counts,
    K4 for the local fill; the JAX bench's sharded_particle_steps_per_sec);
    "systematic-pallas-fused", store "ll", T = 1000 (the one-shard
    delegation to the fused filter: K1, K2; sharded_fused_*, and bit-equal
    to log_likelihood on one seed); "systematic-pallas-fused" with store
    "summary" and ess_threshold=0.5, T = 100 (K5 every step, K7a + K7b +
    K4 at each triggered resample, the sharded weighted summary).  Each
    route's ll within 4 joint se of its single-device route, the oracle
    within 4 se of Kalman."""
    import torch

    import composablestatespacemodels_torch as ct

    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_MAIN, dt=1.0).to_timeseries()
    seeds = list(range(1001, 1001 + MESH_RUNS))
    ref_seeds = list(range(1101, 1101 + MESH_RUNS))

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    out, lines = {}, []
    for what, t_len, kw in (
            ("systematic", T_MESH, dict(store="ll")),
            ("systematic-pallas-fused", T_MESH_FUSED, dict(store="ll")),
            ("fused summary ess 0.5", T_MESH_SUMMARY,
             dict(store="summary", ess_threshold=0.5))):
        d = _series(data, t_len)
        n_obs = int(d.mask.sum())
        resample = "systematic" if what == "systematic" else \
            "systematic-pallas-fused"

        def run(seed, mesh_=mesh):
            return ct.bootstrap_filter(model, params, d, N_MAIN, gen(seed),
                                       resample=resample, mesh=mesh_, **kw)

        secs, lls, launches, results = _timed_runs(run, seeds)
        k = MESH_RUNS * n_obs
        if what == "systematic":
            want = {"K7a": k, "K7b": k, "K4": k}
        elif what == "systematic-pallas-fused":
            want = {"K1": k, "K2": k}
        else:
            # K5 every step; a resample at each observed step whose ESS
            # fell below N / 2
            fired = sum(int(((r.ess < 0.5 * N_MAIN) & d.mask).sum())
                        for r in results)
            want = {"K5": MESH_RUNS * t_len, "K7a": fired, "K7b": fired,
                    "K4": fired}
            for r in results:
                _check_summary(r, t_len, model.dim, f"mesh {what}")
            out["summary_resamples"] = fired
        _expect(launches, want, f"mesh {what}")
        if not all(math.isfinite(v) for v in lls):
            raise AssertionError(f"mesh {what}: ll not finite: {lls}")
        for r in results:
            if tuple(r.final_particles.shape) != (N_MAIN, model.dim):
                raise AssertionError(f"mesh {what}: final particles "
                                     f"{tuple(r.final_particles.shape)}")
        ref = [float(run(s, None).ll) for s in ref_seeds]
        gap = _joint_se_check(lls, ref, f"mesh {what} vs single device")
        rate = N_MAIN * t_len / min(secs)
        out[what] = {"rate": rate, "ms_per_step": min(secs) / t_len * 1e3,
                     "lls": lls, "launches": launches}
        lines.append(f"{what} T={t_len}: best {min(secs) * 1e3:.1f} ms "
                     f"({min(secs) / t_len * 1e3:.4f} ms/step, {rate:.4g} "
                     f"particle-steps/s), {gap:.2f} joint se from the "
                     f"single-device route, launches "
                     f"{ {k: v for k, v in launches.items() if v} }")
        if what == "systematic-pallas-fused":
            one = ct.log_likelihood(model, params, d, N_MAIN, gen(seeds[0]),
                                    resample="systematic-fused")
            if float(one) != lls[0]:
                raise AssertionError(f"delegated ll {lls[0]} != "
                                     f"log_likelihood's {float(one)}")
    o_model = ct.linear(ct.brownian_motion(1))
    o_params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    o_data = ct.simulate_regular(o_model, o_params, gen(7),
                                 T_ORACLE).to_timeseries()
    kf = float(ct.kalman_filter(o_model, o_params, o_data).ll)
    o_lls = [float(ct.bootstrap_filter(o_model, o_params, o_data, N_ORACLE,
                                       gen(1200 + r), store="ll",
                                       mesh=mesh).ll) for r in range(8)]
    mo, so = _mean_se(o_lls)
    if not abs(mo - kf) <= 4 * so:
        raise AssertionError(f"mesh oracle ll {mo} (se {so}) vs Kalman {kf}")
    out["oracle"] = {"mean_ll": mo, "se": so, "kalman": kf}
    print(f"[39] bootstrap_filter(mesh=make_mesh(1, 1)) over NCCL, flagship "
          f"d={model.dim} N={N_MAIN}, {MESH_RUNS} runs each: "
          + "; ".join(lines) + f"; sharded_particle_steps_per_sec "
          f"{out['systematic']['rate']:.6g}, "
          f"sharded_fused_particle_steps_per_sec "
          f"{out['systematic-pallas-fused']['rate']:.6g}; oracle T="
          f"{T_ORACLE} N={N_ORACLE}: mean ll {mo:.4f} (se {so:.4f}) vs "
          f"Kalman {kf:.4f}, {abs(mo - kf) / so:.2f} se; {device_line}",
          flush=True)
    return out


def phase_mesh_ring(gen, dev, n: int = N_MAIN, d: int = 7,
                    s: int = RING_SHARDS):
    """[40] the ring's fill on the card: a 2^20 cloud at d = 7 as S = 4
    virtual shards in one process, on the weights of each of
    RING_REGIMES.  The window counts per shard (K7a, K7b), then for every
    shard and every hop of the ring (all S, the degenerate regimes'
    included) the fill through K4 held bit for bit to the plain fill, and
    the assembled sample to the plain ring's and to the global sample
    x[:, ancestors(counts)]."""
    from types import SimpleNamespace

    import torch

    from composablestatespacemodels_torch.inference import resampling as rs
    from composablestatespacemodels_torch.ops.resample_kernel import (
        sorted_gather_resample_t_ref)
    from composablestatespacemodels_torch.parallel.sharded_filter import (
        _counts_in_window, _kernel_fill, _plain_fill)

    m = n // s
    x = torch.randn((d, n), generator=gen, device=dev)
    hops, cases = {}, 0
    _reset_counters()
    for regime in RING_REGIMES:
        if regime == "spikes":
            w = torch.zeros(n, device=dev)
            w[0] = w[-1] = 0.5
        else:
            w = _weights(regime, n, gen, dev)
        u = torch.rand((), generator=gen, device=dev)
        cdfs = [rs._cumsum(w[i * m:(i + 1) * m]) for i in range(s)]
        s_all = torch.stack([c[-1] for c in cdfs])
        counts = [_counts_in_window(cdfs[i], s_all, u, i, s)
                  for i in range(s)]
        c_prev = [torch.zeros((), dtype=torch.int32, device=dev)] + [
            c[-1] for c in counts[:-1]]
        sample_k, sample_p, need = [], [], 0
        for i in range(s):
            shard = SimpleNamespace(idx=i)
            slots = i * m + torch.arange(m, dtype=torch.int32, device=dev)
            fk, fp = _kernel_fill(shard, slots), _plain_fill(shard, slots)
            out_k = out_p = torch.zeros((d, m), device=dev)
            filled_k = filled_p = torch.zeros(m, dtype=torch.bool,
                                              device=dev)
            for hop in range(s):
                j = (i - hop) % s
                xb = x[:, j * m:(j + 1) * m].contiguous()
                out_k, filled_k = fk(out_k, filled_k, xb, counts[j],
                                     c_prev[j])
                out_p, filled_p = fp(out_p, filled_p, xb, counts[j],
                                     c_prev[j])
                if not (torch.equal(out_k, out_p)
                        and torch.equal(filled_k, filled_p)):
                    raise AssertionError(f"ring {regime}: shard {i} hop "
                                         f"{hop}: K4's fill differs from the "
                                         "plain fill")
                cases += 1
                if bool(filled_k.all()):
                    need = max(need, hop + 1)
                    break
            if not bool(filled_k.all()):
                raise AssertionError(f"ring {regime}: shard {i} unfilled "
                                     f"after {s} hops")
            sample_k.append(out_k)
            sample_p.append(out_p)
        got = torch.cat(sample_k, dim=1)
        want = sorted_gather_resample_t_ref(x, torch.cat(counts))
        if not (torch.equal(got, torch.cat(sample_p, dim=1))
                and torch.equal(got, want)):
            raise AssertionError(f"ring {regime}: the assembled sample "
                                 "differs from the plain ring's or the "
                                 "global sample")
        hops[regime] = need
    launches = _read_counters()
    _expect(launches, {"K4": cases, "K7a": s * len(RING_REGIMES),
                       "K7b": s * len(RING_REGIMES)}, "ring")
    # one hop's fill, K4 against the plain fill, on the mild regime's shard 0
    w = _weights("mild", n, gen, dev)
    cdfs = [rs._cumsum(w[i * m:(i + 1) * m]) for i in range(s)]
    s_all = torch.stack([c[-1] for c in cdfs])
    c0 = _counts_in_window(cdfs[0], s_all, torch.tensor(0.5, device=dev), 0,
                           s)
    slots = torch.arange(m, dtype=torch.int32, device=dev)
    args = (torch.zeros((d, m), device=dev),
            torch.zeros(m, dtype=torch.bool, device=dev),
            x[:, :m].contiguous(), c0,
            torch.zeros((), dtype=torch.int32, device=dev))
    shard = SimpleNamespace(idx=0)
    fills = {"kernel": _kernel_fill(shard, slots),
             "plain": _plain_fill(shard, slots)}
    ms = {k: _cuda_ms(lambda f=f: f(*args), 50) for k, f in fills.items()}
    device = {k: _profile(lambda f=f: f(*args))[:2] for k, f in fills.items()}
    print(f"[40] ring fill, {s} virtual shards of N={n} at d={d}: every "
          f"(shard, hop) fill through K4 bit-equal to the plain fill, and "
          f"the sample to the plain ring's and the global one, on "
          f"{', '.join(RING_REGIMES)} ({cases} fills); hops needed "
          f"{hops}; one hop's fill at N/{s} (back to back; device ms in "
          "kernels a call): " + ", ".join(
              f"{k} {ms[k]:.4f} ms ({device[k][0]:.4f} ms in "
              f"{device[k][1]:.0f})" for k in ms), flush=True)
    return {"hops": hops, "fill_ms": ms,
            "fill_device_ms": {k: v[0] for k, v in device.items()},
            "fills": cases}


def phase_mesh_routes(dev, device_line: str, mesh, lgcp_lls, stream_lls):
    """[41] the other mesh routes on the card: sharded_pmmh on the flagship
    at N = 100, T = 400, MESH_PMMH_ITERS iterations (K7a, K7b, K4 per
    observed step); sharded_pmmh_monitored in 2 chunks, cut after one
    (a checkpoint in a temporary directory) and resumed, bit-equal to the
    uncut run; lgcp_filter(mesh=) at the LGCP bench's shape against phase
    32's single-device lls; OnlineFilter(mesh=) on the flagship at N = 2^20
    in 10 chunks of 100 (store "ll") against phase 35's unchunked lls; the
    filtering and determine_parameters apps with --mesh."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.examples import (
        determine_parameters, filtering, simulate)
    from composablestatespacemodels_torch.models import perturb, stack_flat
    from composablestatespacemodels_torch.parallel import (
        sharded_pmmh, sharded_pmmh_monitored)
    from composablestatespacemodels_torch.utils import io as tio

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    out, lines = {}, []
    model, params = flagship()
    data = ct.simulate_regular(model, params, gen(0), T_PMMH,
                               dt=1.0).to_timeseries()
    n_obs = int(data.mask.sum())
    prop = perturb(0.05)
    sharded_pmmh(model, params, data, N_PMMH, gen(1), 2, mesh,
                 proposal=prop)                              # warm-up
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    res = sharded_pmmh(model, params, data, N_PMMH, gen(2), MESH_PMMH_ITERS,
                       mesh, proposal=prop)
    float(res.lls.sum())
    secs = time.perf_counter() - t0
    k = MESH_PMMH_ITERS * n_obs
    _expect(_read_counters(), {"K7a": k, "K7b": k, "K4": k}, "sharded_pmmh")
    if (tuple(res.lls.shape) != (1, MESH_PMMH_ITERS)
            or not bool(torch.isfinite(res.lls).all())):
        raise AssertionError(f"sharded_pmmh: lls {tuple(res.lls.shape)}")
    out["sharded_pmmh"] = {"iters_per_s": MESH_PMMH_ITERS / secs,
                           "launches": _read_counters()}
    lines.append(f"sharded_pmmh N={N_PMMH} T={T_PMMH} {MESH_PMMH_ITERS} "
                 f"iterations: {MESH_PMMH_ITERS / secs:.2f} iters/s, "
                 f"acceptance {float(res.acceptance_rate()[0]):.2f}")

    chunk = MESH_MONITORED_CHUNK
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "chain.npz")

        def monitored(iters, path):
            return sharded_pmmh_monitored(
                gen(3), model, params, data, N_PMMH, iters, mesh,
                proposal=prop, chunk_size=chunk, checkpoint_path=path,
                log_every=False)

        _reset_counters()
        uncut = monitored(2 * chunk, None)
        monitored(chunk, ck)
        resumed = monitored(2 * chunk, ck)
        launches = _read_counters()
    k = 4 * chunk * n_obs
    _expect(launches, {"K7a": k, "K7b": k, "K4": k}, "sharded_pmmh_monitored")
    if not (torch.equal(uncut.lls, resumed.lls)
            and torch.equal(stack_flat(uncut.params),
                            stack_flat(resumed.params))):
        raise AssertionError("sharded_pmmh_monitored: the resumed chain "
                             "differs from the uncut one")
    out["sharded_pmmh_monitored"] = {"launches": launches}
    lines.append(f"sharded_pmmh_monitored 2 chunks of {chunk}, cut after one "
                 "and resumed: bit-equal to the uncut chain")

    l_model, l_params, l_data, slots = lgcp_case(dev)
    n_ev = len(l_data)
    secs, lls, launches, results = _timed_runs(
        lambda seed: ct.lgcp_filter(l_model, l_params, l_data, N_LGCP,
                                    gen(seed), precision=LGCP_PRECISION,
                                    mesh=mesh),
        list(range(1301, 1301 + MESH_RUNS)))
    k = MESH_RUNS * n_ev
    _expect(launches, {"K7a": k, "K7b": k, "K4": k}, "lgcp_filter(mesh=)")
    for r in results:
        if not (bool((r.eta_lower <= r.eta_upper).all())
                and bool((r.state_lower <= r.state_upper).all())):
            raise AssertionError("lgcp_filter(mesh=): intervals")
    gap = _joint_se_check(lls, lgcp_lls, "lgcp_filter(mesh=) vs one device")
    rate = N_LGCP * slots / min(secs)
    out["lgcp"] = {"particle_slot_steps_per_s": rate, "launches": launches}
    lines.append(f"lgcp_filter(mesh=) N={N_LGCP}, K={slots}: best "
                 f"{min(secs) * 1e3:.2f} ms, {rate:.4g} "
                 f"particle-slot-steps/s, {gap:.2f} joint se from the "
                 "single-device route")

    f_data = ct.simulate_regular(model, params, gen(0), T_MAIN,
                                 dt=1.0).to_timeseries()
    f_obs = int(f_data.mask.sum())

    def online(seed):
        f = ct.utils.OnlineFilter(model, params, N_MAIN, gen(seed),
                                  t0=float(f_data.ts[0]), store="ll",
                                  mesh=mesh)
        for i in range(0, T_MAIN, STREAM_CHUNK):
            j = i + STREAM_CHUNK
            f.step(ct.TimeSeries(f_data.ts[i:j], f_data.ys[i:j],
                                 f_data.mask[i:j]))
        if type(f.particles).__name__ != "DTensor":
            raise AssertionError("OnlineFilter(mesh=) carries "
                                 f"{type(f.particles).__name__}")
        return f

    secs, lls, launches, _ = _timed_runs(
        online, list(range(1401, 1401 + MESH_RUNS)))
    k = MESH_RUNS * f_obs
    _expect(launches, {"K7a": k, "K7b": k, "K4": k}, "OnlineFilter(mesh=)")
    gap = _joint_se_check(lls, stream_lls, "OnlineFilter(mesh=) vs unchunked")
    out["online"] = {"ms_per_step": min(secs) / T_MAIN * 1e3,
                     "launches": launches}
    lines.append(f"OnlineFilter(mesh=) N={N_MAIN} T={T_MAIN} in chunks of "
                 f"{STREAM_CHUNK}: best {min(secs) / T_MAIN * 1e3:.4f} "
                 f"ms/step, {gap:.2f} joint se from phase 35's unchunked")

    cuda = ["--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "d")
        with contextlib.redirect_stdout(io.StringIO()):
            simulate.main(["model", "--out", d] + cuda)
        sims = d + "_sims.json"
        a_obs = int(tio.read_timeseries_json(sims, device=dev).mask.sum())
        for what, main, argv, per in (
                ("filtering --mesh", filtering.main,
                 [sims, "--mesh", "--out", d], 1),
                ("posterior --mesh", determine_parameters.main,
                 ["posterior", sims, "--mesh", "--n-iters",
                  str(MESH_APP_ITERS), "--out", d], MESH_APP_ITERS)):
            torch.cuda.synchronize()
            _reset_counters()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                main(argv + cuda)
            seconds = time.perf_counter() - t0
            k = per * a_obs
            launches = _read_counters()
            _expect(launches, {"K7a": k, "K7b": k, "K4": k}, f"app {what}")
            out[f"app {what}"] = {"s": seconds, "launches": launches}
            lines.append(f"app {what} {seconds:.2f} s")
        rows = _csv_rows(d + "_filtered.csv")
        _, p_lls, _ = tio.read_posterior_json(d + "_posterior_0.json",
                                              device=dev)
        if (rows.shape != (500, 14) or tuple(p_lls.shape) != (MESH_APP_ITERS,)
                or not bool(torch.isfinite(p_lls).all())):
            raise AssertionError(f"apps --mesh: rows {rows.shape}, "
                                 f"posterior {tuple(p_lls.shape)}")
    print(f"[41] mesh routes over NCCL: " + "; ".join(lines)
          + f"; {device_line}", flush=True)
    return out


# CUDA kernels one call of each wrapper launches at its timing inputs (K6
# batched at N = 100: one tile); the kernels of ONE_KERNEL must launch one
TUTORIAL = "docs/tutorial_torch.md"
TUTORIAL_DEVICE_LINE = 'device = "cuda"\n'


def phase_tutorial(device_line: str):
    """[42a] every fenced block of docs/tutorial_torch.md, unchanged, in one
    namespace on the card (its device line is "cuda"; its section 6 keeps
    the NCCL group of phases 39-41 and destroys it at the end), launch
    counters set to 0 just before and read after each section: the
    filters and PMMH launch K1 and K4, section 4's make_pf_loglik_chains
    K8."""
    import re
    from pathlib import Path

    import torch

    src = (Path(__file__).resolve().parent / TUTORIAL).read_text()
    if src.count(TUTORIAL_DEVICE_LINE) != 1:
        raise AssertionError(f"{TUTORIAL}: expected one device line "
                             f"{TUTORIAL_DEVICE_LINE.strip()!r}")
    sections = []       # (heading, [blocks])
    for part in re.split(r"^## ", src, flags=re.MULTILINE)[1:]:
        blocks = re.findall(r"```python\n(.*?)```", part, flags=re.DOTALL)
        sections.append((part.splitlines()[0].split(".")[0], blocks))
    n_blocks = sum(len(b) for _, b in sections)
    if n_blocks < 6:
        raise AssertionError(f"{TUTORIAL}: {n_blocks} python blocks")
    ns = {"__name__": "tutorial"}
    by_section = {}
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    before = _read_counters()
    for heading, blocks in sections:
        for i, block in enumerate(blocks):
            exec(compile(block, f"{TUTORIAL} section {heading} block {i}",
                         "exec"), ns)
        torch.cuda.synchronize()
        after = _read_counters()
        by_section[heading] = {k: after[k] - before[k] for k in after
                               if after[k] != before[k]}
        before = after
    secs = time.perf_counter() - t0
    launches = _read_counters()
    if ns["gen"].device.type != "cuda" or ns["sim"].ys.device.type != "cuda":
        raise AssertionError("the tutorial did not run on the card")
    for section, keys in (("3", ("K1", "K4")), ("4", ("K1", "K4", "K8"))):
        missing = [k for k in keys if not by_section[section].get(k)]
        if missing:
            raise AssertionError(f"tutorial section {section} launched no "
                                 f"{missing}: {by_section}")
    print(f"[42a] {TUTORIAL}: {n_blocks} blocks in {len(sections)} sections "
          f"in {secs:.2f} s; launches {launches}, by section {by_section}; "
          f"{device_line}", flush=True)
    return {"s": secs, "launches": launches, "by_section": by_section}


def phase_decompose(dev, device_line: str):
    """[42b] Model.decompose and component_f on the flagship's final cloud
    at N = 2^20, d = 7 from bootstrap_filter(store="summary",
    resample="systematic-pallas"): the components sum to model.f within
    rtol 1e-5, atol 1e-5 of the largest |f| (float32: two terms against one
    contraction), each component_f is decompose's column bit for bit, and
    the card's result is the CPU's on the same cloud within rtol 1e-6
    (atol 1e-6 of the largest |part|: the dot products add in another
    order)."""
    import torch

    import composablestatespacemodels_torch as ct

    model, params = flagship()
    gen = torch.Generator(device=dev).manual_seed(42)
    data = ct.simulate_regular(model, params, gen, T_MAIN,
                               dt=1.0).to_timeseries()
    res = ct.bootstrap_filter(model, params, data, N_MAIN, gen,
                              resample="systematic-pallas", store="summary")
    cloud, t = res.final_particles, data.ts[-1]
    if tuple(cloud.shape) != (N_MAIN, model.dim) or cloud.device != dev:
        raise AssertionError(f"final cloud {tuple(cloud.shape)} on "
                             f"{cloud.device}")
    parts = model.decompose(cloud, t)
    f = model.f(cloud, t)
    if (tuple(parts.shape) != (N_MAIN, len(model.components()))
            or not bool(torch.isfinite(parts).all())):
        raise AssertionError(f"decompose gave {tuple(parts.shape)}, finite "
                             f"{bool(torch.isfinite(parts).all())}")
    f_max = float(f.abs().max())
    sum_err = float((parts.sum(-1) - f).abs().max())
    if not torch.allclose(parts.sum(-1), f, rtol=1e-5, atol=1e-5 * f_max):
        raise AssertionError(f"decompose sums to f within {sum_err} "
                             f"(largest |f| {f_max})")
    for i in range(parts.shape[-1]):
        if not torch.equal(model.component_f(cloud, t, i), parts[..., i]):
            raise AssertionError(f"component_f({i}) is not decompose's "
                                 "column")
    cpu = model.decompose(cloud.cpu(), t.cpu())
    p_max = float(cpu.abs().max())
    cpu_err = float((parts.cpu() - cpu).abs().max())
    if not torch.allclose(parts.cpu(), cpu, rtol=1e-6, atol=1e-6 * p_max):
        raise AssertionError(f"card and CPU decompose differ by {cpu_err} "
                             f"(largest |part| {p_max})")
    ms = _cuda_ms(lambda: model.decompose(cloud, t), 20)
    f_ms = _cuda_ms(lambda: model.f(cloud, t), 20)
    print(f"[42b] flagship decompose at N={N_MAIN}, d={model.dim}: "
          f"{ms:.4f} ms (model.f {f_ms:.4f} ms; CUDA events, 20 calls); "
          f"|sum - f| <= {sum_err:.3g} (largest |f| {f_max:.4g}), "
          f"|card - CPU| <= {cpu_err:.3g}; ll {float(res.ll):.2f}; "
          f"{device_line}", flush=True)
    return {"ms": ms, "f_ms": f_ms, "sum_err": sum_err, "cpu_err": cpu_err}


def phase_tree_cuda(dev):
    """[42c] the tree algebra on CUDA leaves: a tree equals its clone and
    its CPU copy, with equal hashes; params + params equals every field
    doubled; a changed field makes another tree."""
    import torch

    from composablestatespacemodels_torch.models import params_to, tree_map

    _, host = flagship()
    params = params_to(host, dev)
    if params.get_node(0).sde.m0.device != dev:
        raise AssertionError("the parameter tree is not on the card")
    clone = params.map(lambda v: tree_map(torch.clone, v))
    cpu = params_to(params, "cpu")
    doubled = params.map(lambda v: tree_map(lambda x: 2 * x, v))
    moved = params.map(lambda v: tree_map(lambda x: x + 1.0, v))
    checks = {
        "params == clone": params == clone,
        "hash(params) == hash(clone)": hash(params) == hash(clone),
        "CPU copy == params": cpu == params and params == cpu,
        "hash(CPU copy) == hash(params)": hash(cpu) == hash(params),
        "params + params == doubled": params + params == doubled,
        "(params + params) on the card": (
            (params + params).get_node(1).sde.mu.device == dev),
        "moved != params": moved != params,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"tree algebra on CUDA leaves: {failed}")
    print(f"[42c] tree algebra on CUDA leaves: {len(checks)} checks held",
          flush=True)


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
    # slice 9: streaming, monitored PMMH, the example apps, native IO
    t_new = time.perf_counter()
    streaming = phase_streaming(dev, device_line)
    monitored = phase_pmmh_monitored(dev, device_line)
    native_io = phase_native_io(dev)
    apps = phase_clis(dev, device_line)
    print(f"[35-38] took {time.perf_counter() - t_new:.1f} s; the script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    # the mesh routes in a world of one rank over NCCL
    t_new = time.perf_counter()
    mesh = nccl_world_of_one()
    mesh_flagship = phase_mesh_flagship(dev, device_line, mesh)
    ring = phase_mesh_ring(gen, dev)
    mesh_routes = phase_mesh_routes(dev, device_line, mesh,
                                    lgcp["systematic"]["lls"],
                                    streaming["unchunked"]["lls"])
    print(f"[39-41] took {time.perf_counter() - t_new:.1f} s; the script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    # slice 11: the tutorial on the card (its section 6 takes the NCCL
    # group of phases 39-41 and destroys it), the decomposition at full
    # width and the tree algebra on CUDA leaves
    t_new = time.perf_counter()
    tutorial = phase_tutorial(device_line)
    import torch.distributed as dist
    if dist.is_initialized():
        raise AssertionError("the tutorial left its process group behind")
    decompose = phase_decompose(dev, device_line)
    phase_tree_cuda(dev)
    print(f"[42] took {time.perf_counter() - t_new:.1f} s; the script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

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
            *((f"lgcp {k}", v["launches"]) for k, v in lgcp.items()),
            ("OnlineFilter (2 runs)", streaming["chunked"]["launches"]),
            *((f"pmmh_monitored {k}", v["launches"]) for k, v in
              monitored.items()),
            *((f"app {k}", v["launches"]) for k, v in apps.items()),
            *((f"mesh {k}", v["launches"]) for k, v in mesh_flagship.items()
              if isinstance(v, dict) and "launches" in v),
            ("mesh ring (every shard and hop)", {
                "K4": ring["fills"], "K7a": RING_SHARDS * len(RING_REGIMES),
                "K7b": RING_SHARDS * len(RING_REGIMES)}),
            *((f"mesh {k}", v["launches"]) for k, v in mesh_routes.items()),
            ("tutorial", tutorial["launches"])):
        for key, v in counts.items():
            if v:
                by_name[key].setdefault("launches_by_path", {})[path] = v
    paths_line = {"interpolation": interp, "lgcp": {
        k: {"particle_slot_steps_per_s": v["rate"],
            "ms_per_run": v["ms_per_run"]} for k, v in lgcp.items()},
        "device_per_step": new_device,
        "streaming": {k: {"ms_per_step": v["ms_per_step"]} for k, v in
                      streaming.items() if k != "oracle"},
        "pmmh_monitored": {k: {"iters_per_s": v["iters_per_s"],
                               "checkpointed_iters_per_s":
                                   v["checkpointed_iters_per_s"]}
                           for k, v in monitored.items()},
        "apps_s": {k: v["s"] for k, v in apps.items()},
        "native_io": native_io,
        "sharded": {
            "sharded_particle_steps_per_sec":
                mesh_flagship["systematic"]["rate"],
            "sharded_fused_particle_steps_per_sec":
                mesh_flagship["systematic-pallas-fused"]["rate"],
            "fused_summary_ess_ms_per_step":
                mesh_flagship["fused summary ess 0.5"]["ms_per_step"],
            "ring": ring,
            "sharded_pmmh_iters_per_s":
                mesh_routes["sharded_pmmh"]["iters_per_s"],
            "lgcp_particle_slot_steps_per_s":
                mesh_routes["lgcp"]["particle_slot_steps_per_s"],
            "online_ms_per_step": mesh_routes["online"]["ms_per_step"],
            "apps_s": {k: v["s"] for k, v in mesh_routes.items()
                       if k.startswith("app ")}},
        "tutorial_s": tutorial["s"],
        "decompose": decompose}
    print(json.dumps({"paths": paths_line}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
