"""Closed-loop streaming: one observation at a time into ``OnlineFilter``.

Traffic keys: ``n_particles``, ``n_obs`` (the stream, simulated from the
seed in set-up, longer than any window), ``filter`` (keyword arguments of
``OnlineFilter``: ``resample``, ``store``, ``interval``),
``warmup_steps``, ``reference_runs``, ``trace_units``.
Each unit hands the next observation to ``OnlineFilter.step`` as a chunk
of length one and reads that step's summaries (and its log-likelihood
increment) on the host; the next is handed over once they are read.  The
check replays every step the filter took through the reference filter
``reference_runs`` times and compares the summaries of every step of the
window (:func:`cssm_bench.compare.summaries_vs_replicas`), their spread
against the replicas' (:func:`cssm_bench.compare.replica_spread_ratio`),
and the running
log-likelihood, ``OnlineFilter.ll``
(:func:`cssm_bench.compare.total_vs_replicas`).
"""

from __future__ import annotations

import itertools

import torch

from .. import compare, faults, system
from ..cell import fold
from ..reference import pf
from ..reference.model import RefModel
from ..reference.simulate import simulate

STREAM, REFERENCE, CONTROL = 1, 3, 4
FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def setup(run) -> None:
    tr, cfg = run.traffic, run.config
    ref = RefModel(cfg)
    ts, ys = simulate(ref, int(tr["n_obs"]), float(cfg["dt"]), run.seed)
    run.phase(f"stream of {len(ts)} simulated")
    model, params = system.build(cfg)
    run.phase(f"port imported, model d = {model.dim} built")
    data = system.series(ts, ys, run.device)
    ct = system.port()
    chunks = [ct.utils.TimeSeries(data.ts[k:k + 1], data.ys[k:k + 1],
                                  data.mask[k:k + 1]) for k in range(len(ts))]
    filt = ct.utils.OnlineFilter(
        model, params, int(tr["n_particles"]),
        system.generator(run.device, fold(run.seed, STREAM)),
        float(ts[0]), **tr.get("filter", {}))
    run.state.update(filter=filt, chunks=chunks, ts=ts, ys=ys, ref=ref,
                     steps=[], model=model)
    for _ in range(int(tr["warmup_steps"])):
        _step(run)
    run.phase(f"warm-up: {tr['warmup_steps']} steps")


def _step(run) -> dict:
    st = run.state
    k = len(st["steps"])
    res = st["filter"].step(st["chunks"][k])
    s = res.summary
    host = torch.cat([s.eta_mean, s.eta_lower, s.eta_upper,
                      s.state_mean[0], s.state_lower[0], s.state_upper[0],
                      res.ll.reshape(1)]).double().cpu()
    rec = {"summary": host[:-1], "inc": float(host[-1])}
    st["steps"].append(rec)
    return rec


def unit(run, i: int) -> dict:
    if len(run.state["steps"]) >= len(run.state["chunks"]):
        raise RuntimeError("the stream ran out: raise n_obs")
    return {"step": len(run.state["steps"]), **_step(run)}


def work(run) -> dict:
    return {"observations": 1}


def steps_per_unit(run) -> int:
    return 1


def release(run) -> None:
    run.state["ll_total"] = float(run.state["filter"].ll)
    for k in ("filter", "chunks", "model"):
        run.state.pop(k, None)


def _replicas(run, dtype, purpose: int, count: int):
    st, tr = run.state, run.traffic
    ref = st["ref"]
    n_steps = len(st["steps"])
    st["pick"] = [u["step"] for u in run.units]
    interval = float(tr.get("filter", {}).get("interval", 0.975))
    out = []
    for r in range(count):
        ll, incs, summ = pf.filter_one(
            ref, ref.params(run.device), st["ts"][:n_steps],
            st["ys"][:n_steps], int(tr["n_particles"]),
            system.generator(run.device, fold(run.seed, purpose, r)),
            t0=float(st["ts"][0]), dtype=dtype, summary_steps=st["pick"],
            interval=interval)
        out.append((ll, incs, torch.stack([summ[k] for k in st["pick"]])))
    return out


def _numbers(run, total: float, summaries: torch.Tensor, reps) -> dict:
    d = run.state["ref"].dim
    return {
        "summary_rms_z": compare.summaries_vs_replicas(
            summaries, [r[2] for r in reps], d),
        "summary_spread_ratio": compare.replica_spread_ratio(
            summaries, [r[2] for r in reps]),
        "ll_z": compare.total_vs_replicas(
            total, [r[0] for r in reps], [r[1] for r in reps]),
    }


def check(run) -> dict:
    reps = _replicas(run, torch.float32, REFERENCE,
                     int(run.traffic["reference_runs"]))
    run.state["reps"] = reps
    steps = run.state["steps"]
    prog = torch.stack([steps[k]["summary"] for k in run.state["pick"]])
    return _numbers(run, run.state["ll_total"], prog, reps)


def control(run) -> dict:
    """The numbers with the reference in bfloat16 in the system's place
    over the same steps (after :func:`check`)."""
    ll, _, summ = _replicas(run, torch.bfloat16, CONTROL, 1)[0]
    return _numbers(run, ll, summ, run.state["reps"])


def planted(run, fault: str):
    """The fault under the summary route's step: the resample (K4) handing
    back the cloud it was given; the propagate computing half the cloud
    and copying it into the other half; or the third window step's order
    statistics each given its pair's other (every lower bound for its
    upper, and back)."""
    from composablestatespacemodels_torch.inference import filter as flt

    if fault == "state_unchanged":
        def make(orig):
            def unchanged(x, *args, **kwargs):
                orig(x, *args, **kwargs)
                return x
            return unchanged
        return faults.patched(flt, "sorted_gather_resample_t", make)
    if fault == "half_batch":
        def make(orig):
            def half(*args, **kwargs):
                return faults.half_copied(orig(*args, **kwargs))
            return half
        return faults.patched(flt, "_propagate", make)
    warm = int(run.traffic["warmup_steps"])

    def make(orig):
        calls = itertools.count()

        def select(vals, ks, psum=None):
            out = orig(vals, ks, psum)
            return out.flip(-1) if next(calls) == warm + 2 else out
        return select
    return faults.patched(flt, "kth_smallest_bits", make)
