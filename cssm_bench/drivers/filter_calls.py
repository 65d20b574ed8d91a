"""Closed-loop log-likelihood calls over one series.

Traffic keys: ``n_particles``, ``n_obs`` (the series, simulated from the
seed), ``call`` (keyword arguments of ``bootstrap_filter``: ``resample``
and ``store="ll"``, which is ``log_likelihood``'s own call),
``warmup_calls``, ``reference_runs``, ``trace_units``.  Each unit is one
call on a generator folded from ``(seed, call index)``, its running
log-likelihood (``ll_history``, whose last entry is the log-likelihood)
read on the host.  The check holds every call of the window against the
reference filter run ``reference_runs`` times on the same series: the
log-likelihoods in units of one call's Monte Carlo spread read from the
reference's runs (:func:`cssm_bench.compare.calls_vs_reference`), and that
spread itself, step by step, against the spread of the window's calls
(:func:`cssm_bench.compare.call_spread_ratio`).
"""

from __future__ import annotations

import itertools
import statistics

import torch

from .. import compare, faults, system
from ..cell import fold
from ..reference import pf
from ..reference.model import RefModel
from ..reference.simulate import simulate

CALL, WARM, REFERENCE, CONTROL = 1, 2, 3, 4
FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def setup(run) -> None:
    tr, cfg = run.traffic, run.config
    ref = RefModel(cfg)
    ts, ys = simulate(ref, int(tr["n_obs"]), float(cfg["dt"]), run.seed)
    run.phase(f"series of {len(ts)} simulated")
    model, params = system.build(cfg)
    run.phase(f"port imported, model d = {model.dim} built")
    data = system.series(ts, ys, run.device)
    run.state.update(model=model, params=params, data=data, ts=ts, ys=ys,
                     ref=ref)
    for k in range(int(tr["warmup_calls"])):
        hist = _call(run, system.generator(run.device,
                                           fold(run.seed, WARM, k)))
        run.phase(f"warm-up call {k}: ll {float(hist[-1]):.4f}")


def _call(run, gen) -> torch.Tensor:
    """One call; its running log-likelihood ``[T]`` on the host."""
    st, tr = run.state, run.traffic
    res = system.port().bootstrap_filter(
        st["model"], st["params"], st["data"], int(tr["n_particles"]), gen,
        **tr.get("call", {}))
    return res.ll_history.cpu()


def unit(run, i: int) -> dict:
    hist = _call(run, system.generator(run.device, fold(run.seed, CALL, i)))
    return {"ll": float(hist[-1]), "running": hist}


def work(run) -> dict:
    """The work of one unit, by the end-to-end metric that counts it."""
    tr = run.traffic
    return {"particle_steps": int(tr["n_particles"]) * int(tr["n_obs"])}


def steps_per_unit(run) -> int:
    return int(run.traffic["n_obs"])


def release(run) -> None:
    for k in ("model", "params", "data"):
        run.state.pop(k, None)


def _reference(run, dtype, purpose: int, count: int) -> list:
    """``count`` runs of the reference filter: ``(ll, per-step
    increments)`` each."""
    st, tr = run.state, run.traffic
    ref = st["ref"]
    params = ref.params(run.device)
    return [pf.filter_one(ref, params, st["ts"], st["ys"],
                          int(tr["n_particles"]),
                          system.generator(run.device,
                                           fold(run.seed, purpose, k)),
                          dtype=dtype)[:2]
            for k in range(count)]


def _read_back(incs) -> torch.Tensor:
    """A reference run's increments as the system's are read: through a
    float32 running log-likelihood."""
    return compare.increments(compare.running_float32(incs))


def _numbers(run, lls, incs) -> dict:
    refs = run.state["refs"]
    noise = compare.call_noise([r[1] for r in refs])
    run.log(f"lls: mean {sum(lls) / len(lls)!r} of {len(lls)}, spread "
            f"{statistics.stdev(lls) if len(lls) > 1 else 0.0!r}; "
            f"reference {[r[0] for r in refs]!r}, noise {noise!r}")
    return {**compare.calls_vs_reference(lls, [r[0] for r in refs], noise),
            "inc_spread_ratio": compare.call_spread_ratio(
                incs, torch.stack([_read_back(r[1]) for r in refs]))}


def check(run) -> dict:
    run.state["refs"] = _reference(run, torch.float32, REFERENCE,
                                   int(run.traffic["reference_runs"]))
    return _numbers(run, [u["ll"] for u in run.units],
                    torch.stack([compare.increments(u["running"])
                                 for u in run.units]))


def control(run) -> dict:
    """The numbers with the reference in bfloat16 in the system's place,
    as many calls as the window made (after :func:`check`)."""
    low = _reference(run, torch.bfloat16, CONTROL, len(run.units))
    return _numbers(run, [r[0] for r in low],
                    torch.stack([_read_back(r[1]) for r in low]))


def planted(run, fault: str):
    """The fault under the fused step, :func:`resample_propagate` (K2):
    the cloud it was given handed back; half the cloud and its weights
    copied into the other half; or one step's increment, half way through
    the window's second call, moved by 5 nats."""
    from composablestatespacemodels_torch.inference import filter as flt

    if fault == "state_unchanged":
        def make(orig):
            def unchanged(x, *args, **kwargs):
                return x, orig(x, *args, **kwargs)[1]
            return unchanged
        return faults.patched(flt, "resample_propagate", make)
    if fault == "half_batch":
        def make(orig):
            def half(*args, **kwargs):
                x, logw = orig(*args, **kwargs)
                return faults.half_copied(x), faults.half_copied(logw)
            return half
        return faults.patched(flt, "resample_propagate", make)
    n_obs = int(run.traffic["n_obs"])
    target = (int(run.traffic["warmup_calls"]) + 1) * n_obs + n_obs // 2

    def make(orig):
        calls = itertools.count()

        def weigh(logw, wn):
            inc, wn1 = orig(logw, wn)
            return (inc + 5.0 if next(calls) == target else inc), wn1
        return weigh
    return faults.patched(flt, "_weigh", make)
