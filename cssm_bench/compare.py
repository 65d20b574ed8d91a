"""The comparisons that decide ``correct``: the system's answers against
the plain reference's, as scale-free z-scores.

A particle filter's answer is an estimate with Monte Carlo noise, and the
reference draws its own random numbers, so the two agree in distribution
only.  Each number below is a distance in units of that noise, measured
in the same run, so that one limit holds at the cell's size and at a test's
size alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

def _ratio(num: float, den: float) -> float:
    if den > 0.0:
        return num / den
    return 0.0 if num == 0.0 else math.inf


def call_noise(rep_incs) -> float:
    """The Monte Carlo spread of one filter call's log-likelihood, from the
    reference's replicas of every step's increment: the per-step spreads
    added up.  It does not depend on the system's answers, so no fault of
    theirs moves it."""
    incs = torch.stack([torch.as_tensor(x, dtype=torch.float64)
                        for x in rep_incs])
    n = incs.shape[0]
    return math.sqrt(float(((incs - incs.mean(0)) ** 2).sum() / (n - 1)))


def increments(running) -> torch.Tensor:
    """Per-step increments ``[..., T]``, float64, of running float32
    log-likelihoods ``[..., T]``, the first from nought."""
    r = torch.as_tensor(running, dtype=torch.float64)
    return torch.diff(r, dim=-1, prepend=torch.zeros_like(r[..., :1]))


def running_float32(incs) -> torch.Tensor:
    """The running sums of ``incs [..., T]`` as a filter keeps them, float32
    added step by step: the reference's increments read back through the
    same rounding as the system's (:func:`increments`)."""
    a = np.asarray(torch.as_tensor(incs, dtype=torch.float64), np.float32)
    return torch.from_numpy(np.cumsum(a, axis=-1, dtype=np.float32))


def _log_chi2(k: int) -> float:
    """``E[log(X / k)]`` for ``X`` chi-squared with ``k`` degrees of
    freedom: the mean of the log of a variance estimate over its true
    value, from ``k + 1`` normal draws."""
    return float(torch.special.digamma(
        torch.tensor(k / 2, dtype=torch.float64))) - math.log(k / 2)


def _log_ratio(num, den, k_num: int, k_den: int) -> float:
    """Two variance estimates ``[...]``, element by element, with ``k_num``
    and ``k_den`` degrees of freedom: the ratio of their true values,
    common to every element, from the mean of the logs of their ratios.
    Every element counts alike, so a few elements that spread far more
    than the rest do not make the answer, and the log has every moment.
    Elements where either estimate is nought are left out."""
    keep = (num > 0) & (den > 0)
    if not bool(keep.any()):
        return math.inf
    mean = float((torch.log(num[keep]) - torch.log(den[keep])).mean())
    return math.exp(mean - _log_chi2(k_num) + _log_chi2(k_den))


def call_spread_ratio(prog_incs, ref_incs) -> float:
    """The Monte Carlo spread of the system's calls against the
    reference's: each step's increment's variance over the system's calls
    ``[M, T]`` against its variance over the reference's runs ``[R, T]``,
    the ratio common to the steps (:func:`_log_ratio`).  About 1 where
    the two filters are alike, and about 2 where the system runs half the
    particles it is given."""
    p = torch.as_tensor(prog_incs, dtype=torch.float64)
    r = torch.as_tensor(ref_incs, dtype=torch.float64)
    m, n = p.shape[0], r.shape[0]
    if not (bool(torch.isfinite(p).all()) and m > 1 and n > 1):
        return math.inf
    return _log_ratio(p.var(dim=0), r.var(dim=0), m - 1, n - 1)


def replica_spread_ratio(prog, reps) -> float:
    """One run of the system ``prog [S, Q]`` (S steps, Q quantities)
    against ``R`` replicas of the reference ``reps [R, S, Q]``: each
    squared gap to the replicas' mean against what it would be were the
    system a further replica, ``(1 + 1/R)`` times the replicas' variance
    there, the ratio common to every step and quantity
    (:func:`_log_ratio`).  About 1 where the two filters are alike, and
    ``(2 + 1/R) / (1 + 1/R)`` where the system runs half the particles."""
    r = torch.stack([torch.as_tensor(x, dtype=torch.float64) for x in reps])
    p = torch.as_tensor(prog, dtype=torch.float64)
    n = r.shape[0]
    if not (bool(torch.isfinite(p).all()) and n > 1):
        return math.inf
    return _log_ratio((p - r.mean(0)) ** 2, r.var(dim=0) * (1 + 1 / n),
                      1, n - 1)


def calls_vs_reference(prog, refs, noise: float) -> dict:
    """Repeated estimates of one quantity (the log-likelihood of one
    series, a call each) against the reference's estimates of it, in
    units of ``noise``, one call's Monte Carlo spread (:func:`call_noise`).

    * ``ll_z``: the gap of the means over its standard error;
    * ``ll_max_z``: the widest single call's gap from the reference mean,
      over its standard error."""
    p = torch.as_tensor(prog, dtype=torch.float64)
    r = torch.as_tensor(refs, dtype=torch.float64)
    gap = float(p.mean() - r.mean())
    return {
        "ll_z": _ratio(abs(gap),
                       noise * math.sqrt(1 / p.numel() + 1 / r.numel())),
        "ll_max_z": _ratio(float(torch.max(torch.abs(p - r.mean()))),
                           noise * math.sqrt(1 + 1 / r.numel())),
    }


def paired_vs_reference(prog, ref, ref2) -> dict:
    """One estimate each of many quantities (the log-likelihood at many
    parameter sets), the system's against two replicas of the reference's,
    pair by pair.  Where all are right the estimates of a pair are alike
    in distribution, so a gap between two of them is symmetric about
    nought and spreads alike, however its spread varies from pair to pair.

    * ``ll_z``: the mean gap to the reference's first replica over its
      standard error;
    * ``ll_sign_z``: the count of positive gaps against half the pairs,
      over its standard error (a sign test: heavy tails do not move it);
    * ``ll_spread_ratio``: the standard deviation of those gaps over that
      of the gaps between the two replicas: about 1, and far above it
      where some answers are not their own parameters' estimate."""
    p, r, r2 = (torch.as_tensor(x, dtype=torch.float64)
                for x in (prog, ref, ref2))
    d = p - r
    m = d.numel()
    if not bool(torch.isfinite(d).all()):
        return {"ll_z": math.inf, "ll_sign_z": math.inf,
                "ll_spread_ratio": math.inf}
    sd = float(d.std()) if m > 1 else 0.0
    pos = float((d > 0).sum()) + 0.5 * float((d == 0).sum())
    return {
        "ll_z": _ratio(abs(float(d.mean())), sd / math.sqrt(m)),
        "ll_sign_z": _ratio(abs(pos - m / 2), math.sqrt(m) / 2),
        "ll_spread_ratio": _ratio(sd, float((r2 - r).std()) if m > 1
                                  else 0.0),
    }


def summaries_vs_replicas(prog: torch.Tensor, reps: list, dim: int) -> float:
    """The system's per-step summaries ``prog [S, 3 + 3 dim]`` (eta mean,
    lower, upper; the state's means, lowers, uppers) against the mean of
    the reference's replicas.  Each quantity's gap is scaled by the width
    of its step's interval, then by the Monte Carlo spread of that scaled
    quantity, read from the replicas about their mean and pooled over the
    steps.  Returns the largest, over the quantities, of the root mean
    square of those z-scores over the steps: about 1 where the two agree,
    whatever the spread does from step to step, and far above it where
    every step is off by a little or one step by much."""
    r = torch.stack([torch.as_tensor(x, dtype=torch.float64) for x in reps])
    p = torch.as_tensor(prog, dtype=torch.float64)
    rbar = r.mean(0)
    eta_w = (rbar[:, 2] - rbar[:, 1])[:, None]
    st_w = rbar[:, 3 + 2 * dim:] - rbar[:, 3 + dim:3 + 2 * dim]
    width = torch.cat([eta_w.expand(-1, 3), st_w, st_w, st_w], dim=1)
    u = (p - rbar) / width
    ur = (r - rbar) / width
    n = r.shape[0]
    var = (ur ** 2).sum(0).mean(0) / (n - 1)
    z2 = (u ** 2).mean(0) / (var * (1 + 1 / n))
    if not bool(torch.isfinite(z2).all()):
        return math.inf
    return float(torch.sqrt(z2.max()))


def total_vs_replicas(prog_total: float, rep_totals, rep_incs) -> float:
    """A running log-likelihood against the reference's replicas: the gap
    from their mean over the noise that the replicas' per-step increments
    show (:func:`call_noise`)."""
    n = len(rep_totals)
    gap = abs(prog_total - sum(rep_totals) / n)
    return _ratio(gap, call_noise(rep_incs) * math.sqrt(1 + 1 / n))


def accept_z(accepted: torch.Tensor, ll_prop: torch.Tensor,
             ll_cur: torch.Tensor) -> float:
    """Metropolis-Hastings under a flat prior and a symmetric proposal
    accepts with probability ``min(1, exp(ll' - ll))``: the count of
    accepts against the sum of those probabilities, over its standard
    error."""
    p = torch.clamp(torch.exp((ll_prop.double() - ll_cur.double())), max=1.0)
    var = float((p * (1 - p)).sum())
    return _ratio(abs(float(accepted.double().sum() - p.sum())),
                  math.sqrt(var))
