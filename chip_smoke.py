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
Every check raises on failure.  Prints one line per phase, then a JSON
line of per-kernel results, and last ``{"ok": true, "device": {...}}``.
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


def _counters():
    from composablestatespacemodels_torch.ops import resample_kernel as rk
    from composablestatespacemodels_torch.ops import scan_kernel as sk
    return {"K1": sk.systematic_counts_fused, "K2": rk.resample_propagate,
            "K4": rk.sorted_gather_resample_t, "K5": rk.propagate_weights_t,
            "K7a": sk.prefix_sum, "K7b": sk.cummax_int32}


def _reset_counters():
    for fn in _counters().values():
        fn.launches = 0


def _read_counters():
    return {k: fn.launches for k, fn in _counters().items()}


def phase_gather(gen, dev, n: int, d: int = 7):
    """[8] K4 against its plain version on the four weight regimes' counts."""
    import torch

    from composablestatespacemodels_torch.ops.resample_kernel import (
        sorted_gather_resample_t, sorted_gather_resample_t_ref)
    from composablestatespacemodels_torch.ops.scan_kernel import (
        systematic_counts_fused)

    x = torch.randn((d, n), generator=gen, device=dev)
    keep = None
    for regime in ("uniform", "mild", "heavy", "degenerate"):
        w = _weights(regime, n, gen, dev)
        counts = systematic_counts_fused(
            w, w.sum(), torch.rand((), generator=gen, device=dev))
        yk = sorted_gather_resample_t(x, counts)
        yp = sorted_gather_resample_t_ref(x, counts)
        torch.cuda.synchronize()
        if not torch.equal(yk, yp):
            raise AssertionError(f"K4 {regime}: gather differs from "
                                 "x[:, ancestors(counts)]")
        if regime == "heavy":
            keep = (x, counts)
    print(f"[8] K4 gather vs plain at d={d} N={n}: bit-equal in the uniform, "
          "mild, heavy and degenerate regimes", flush=True)
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


def phase_scans(gen, dev, n: int):
    """[10] K7a and K7b against their plain versions; the stratified counts
    built by the kernels against the plain composition."""
    import torch

    from composablestatespacemodels_torch.inference import resampling as rs
    from composablestatespacemodels_torch.ops.scan_kernel import (
        cummax_int32, cummax_int32_ref, prefix_sum, prefix_sum_ref)

    keep = None
    for regime in ("uniform", "mild", "heavy", "degenerate"):
        w = _weights(regime, n, gen, dev)
        pk, pp = prefix_sum(w), prefix_sum_ref(w)
        c = torch.randint(-1000, n, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        ck, cp = cummax_int32(c), cummax_int32_ref(c)
        u = torch.rand(n, generator=gen, device=dev)
        sk = rs.stratified_counts(w, u)
        sp = torch.cummax(rs._stratified_from_cdf(
            rs._cumsum_ref(w / w.sum()), u, n), dim=0).values
        torch.cuda.synchronize()
        for name, k, p in (("K7a prefix_sum", pk, pp),
                           ("K7b cummax_int32", ck, cp),
                           ("stratified counts", sk, sp)):
            if not torch.equal(k, p):
                bad = int((k != p).sum())
                raise AssertionError(f"{name} {regime}: {bad} entries differ "
                                     "from the plain version")
        if not bool((torch.diff(sk) >= 0).all()) or int(sk[-1]) != n:
            raise AssertionError(f"stratified counts {regime}: not monotone "
                                 "with counts[-1] == N")
        if regime == "heavy":
            keep = (w, c)
    print(f"[10] K7a prefix_sum, K7b cummax_int32 and the kernel-built "
          f"stratified counts vs plain at N={n}: bit-equal in four weight "
          "regimes", flush=True)
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
                "K5": runs * T_MAIN if fused else 0, "K7a": 0, "K7b": 0}
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
                    "K7a": runs * n_obs, "K7b": runs * n_obs}
        else:
            want = {"K1": runs * n_obs, "K2": 0, "K4": runs * n_obs,
                    "K5": 0, "K7a": 0, "K7b": 0}
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


def phase_timing_new(gather_in, prop_in, scan_in):
    """[15] each new kernel alone against its plain version at N = 2^20."""
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
    print(f"[15] kernel alone vs plain at N={N_MAIN}: "
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
    k4_err, gather_in = phase_gather(gen, dev, N_MAIN)
    k5_err, prop5_in = phase_propagate(gen, dev, N_MAIN)
    k7_err, scan_in = phase_scans(gen, dev, N_MAIN)
    summary_launches = phase_summary(dev, device_line)
    strat_launches = phase_oracle_summary(dev)
    phase_selection(gen, dev, N_MAIN)
    phase_ess_sync(dev)
    times.update(phase_timing_new(gather_in, prop5_in, scan_in))

    src = "composablestatespacemodels_torch/csrc/"
    tpu = "composablestatespacemodels_tpu/ops/"
    fused = summary_launches["systematic-pallas-fused"]
    kernels = [
        {"name": "K1 systematic_counts_fused", "route": "cuda",
         "source": src + "counts.cu",
         "replaces": tpu + "scan_kernel.py:550",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "K2+K3 resample_propagate (Poisson/Gaussian log-density)",
         "route": "cuda", "source": src + "resample_propagate.cu",
         "replaces": tpu + "resample_kernel.py:667",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
        {"name": "K4 sorted_gather_resample_t", "route": "cuda",
         "source": src + "gather.cu",
         "replaces": tpu + "resample_kernel.py:616",
         "launches": fused["K4"], "max_abs_err": k4_err,
         "ms": times["K4"][0], "plain_ms": times["K4"][1]},
        {"name": "K5+K3 propagate_weights_t (Poisson/Gaussian log-density)",
         "route": "cuda", "source": src + "propagate_weights.cu",
         "replaces": tpu + "resample_kernel.py:756",
         "launches": fused["K5"], "max_abs_err": k5_err,
         "ms": times["K5"][0], "plain_ms": times["K5"][1]},
        {"name": "K7a prefix_sum", "route": "cuda", "source": src + "scan.cu",
         "replaces": tpu + "scan_kernel.py:613",
         "launches": strat_launches["K7a"], "max_abs_err": k7_err,
         "ms": times["K7a"][0], "plain_ms": times["K7a"][1]},
        {"name": "K7b cummax_int32", "route": "cuda",
         "source": src + "scan.cu",
         "replaces": tpu + "scan_kernel.py:480",
         "launches": strat_launches["K7b"], "max_abs_err": k7_err,
         "ms": times["K7b"][0], "plain_ms": times["K7b"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
