"""Closed-loop PMMH fits: ``pmmh_chains`` calls of many chains at once.

Traffic keys: ``n_chains``, ``n_particles``, ``n_obs`` (the series,
simulated from the seed), ``perturb`` (the random walk's variance per
parameter), ``iters_per_call``, ``warmup_calls``, ``compare_iters``,
``trace_units``.  Each unit is one ``pmmh_chains`` call from the
configuration's parameters, flat prior, ``perturb`` proposals, every
chain's filter in one batched evaluation (``make_pf_loglik_chains``) per
iteration, on a generator folded from ``(seed, call index)``; it ends
when the device has finished.  The port's public ``pmmh_chains`` takes no
chain state to resume from, so each call starts its chains afresh.

The evaluation the call is given records what it returns (the proposed
parameters and their log-likelihoods), stacked into a few tensors a call
once the call is done, and the call returns every iteration's parameters,
log-likelihood and running count of accepts.
The check holds:

* the log-likelihoods of ``compare_iters`` iterations drawn from the seed,
  every chain, against two runs of the reference filter at the same
  parameters (:func:`cssm_bench.compare.paired_vs_reference`);
* every accept and reject of the window: the chain moves to the proposal
  exactly where it accepts and stays exactly where it rejects
  (``mh_violations``, a count), and the accepts agree with
  ``min(1, exp(ll' - ll))`` (:func:`cssm_bench.compare.accept_z`).
"""

from __future__ import annotations

import torch

from .. import compare, faults, system
from ..cell import fold
from ..reference import pf
from ..reference.model import RefModel
from ..reference.simulate import rng_for, simulate

CALL, WARM, REFERENCE, CONTROL, SAMPLE = 1, 2, 3, 4, 5
FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "accept_shifted")


def setup(run) -> None:
    tr, cfg = run.traffic, run.config
    ref = RefModel(cfg)
    ts, ys = simulate(ref, int(tr["n_obs"]), float(cfg["dt"]), run.seed)
    run.phase(f"series of {len(ts)} simulated")
    model, params = system.build(cfg)
    run.phase(f"port imported, model d = {model.dim} built")
    data = system.series(ts, ys, run.device)
    ct = system.port()
    evaluate = ct.make_pf_loglik_chains(model, data, int(tr["n_particles"]))
    records: list = []

    def recorded(generator, params_b):
        ll = evaluate(generator, params_b)
        records.append((params_b, ll))
        return ll

    run.state.update(model=model, params=params, ts=ts, ys=ys, ref=ref,
                     evaluate=recorded, records=records,
                     proposal=ct.models.perturb(float(tr["perturb"])))
    for k in range(int(tr["warmup_calls"])):
        _call(run, fold(run.seed, WARM, k))
        run.phase(f"warm-up call {k}")
    records.clear()


def _call(run, seed: int):
    st, tr = run.state, run.traffic
    res = system.port().pmmh_chains(
        system.generator(run.device, seed), st["params"], None,
        st["proposal"], int(tr["iters_per_call"]), int(tr["n_chains"]),
        pf_ll_chains=st["evaluate"])
    run.sync()
    return res


def _stacked(records):
    """One call's records as its proposals, a list per component of
    ``{"scale": [B, I] or None, "sde": {field: [B, I, k]}}``, and their
    log-likelihoods ``[B, I]``."""
    plain = [system.plain_params(p, dtype=None) for p, _ in records]
    props = [{"scale": None if comp[0]["scale"] is None else
              torch.stack([c["scale"] for c in comp], 1),
              "sde": {f: torch.stack([c["sde"][f] for c in comp], 1)
                      for f in comp[0]["sde"]}}
             for comp in zip(*plain)]
    return props, torch.stack([ll for _, ll in records], 1)


def unit(run, i: int) -> dict:
    records = run.state["records"]
    res = _call(run, fold(run.seed, CALL, i))
    props, ll_prop = _stacked(records)
    records.clear()
    return {"result": res, "props": props, "ll_prop": ll_prop}


def work(run) -> dict:
    tr = run.traffic
    return {"chain_iters": int(tr["n_chains"]) * int(tr["iters_per_call"])}


def steps_per_unit(run) -> int:
    return int(run.traffic["iters_per_call"])


def release(run) -> None:
    for k in ("model", "evaluate", "proposal"):
        run.state.pop(k, None)


def _sample(run):
    """The sampled iterations' proposals as the reference's parameters
    (every chain), and the system's log-likelihoods there."""
    tr = run.traffic
    pairs = [(u, k) for u, unit in enumerate(run.units)
             for k in range(unit["ll_prop"].shape[1])]
    rng = rng_for(run.seed, SAMPLE)
    pick = rng.choice(len(pairs), size=min(int(tr["compare_iters"]),
                                           len(pairs)), replace=False)
    at = [pairs[j] for j in pick]

    def gather(get):
        return torch.cat([get(run.units[u])[:, k] for u, k in at]).double()

    props = run.units[0]["props"]
    params = [{"scale": None if comp["scale"] is None else
               gather(lambda unit: unit["props"][ci]["scale"]),
               "sde": {f: gather(lambda unit: unit["props"][ci]["sde"][f])
                       for f in comp["sde"]}}
              for ci, comp in enumerate(props)]
    return params, gather(lambda unit: unit["ll_prop"]).cpu()


def _reference_lls(run, params, dtype, purpose: int,
                   replica: int = 0) -> torch.Tensor:
    st, tr = run.state, run.traffic
    return pf.ll_chains(st["ref"], params, st["ts"], st["ys"],
                        int(tr["n_particles"]),
                        system.generator(run.device,
                                         fold(run.seed, purpose, replica)),
                        dtype=dtype)


def _mh(run) -> dict:
    """The accepts and rejects of every call of the window."""
    violations, acc, prop, cur = 0, [], [], []
    for unit in run.units:
        res = unit["result"]
        lls = res.lls.double()                                 # [B, I]
        steps = torch.diff(res.accepted, dim=1,
                           prepend=torch.zeros_like(res.accepted[:, :1]))
        a = steps.bool()
        ll_prop = unit["ll_prop"].double()
        moved = a[:, 1:]
        bad = torch.where(moved, lls[:, 1:] != ll_prop[:, 1:],
                          lls[:, 1:] != lls[:, :-1])
        bad |= (steps[:, 1:] < 0) | (steps[:, 1:] > 1)
        chain = system.plain_params(res.params)
        for ci, comp in enumerate(chain):
            fields = dict(comp["sde"])
            props = dict(unit["props"][ci]["sde"])
            if comp["scale"] is not None:
                fields["scale"] = comp["scale"]
                props["scale"] = unit["props"][ci]["scale"]
            for f, v in fields.items():
                v = v.reshape(v.shape[0], v.shape[1], -1)      # [B, I, k]
                pv = props[f].double().reshape(v.shape)
                bad |= torch.where(moved[..., None], v[:, 1:] != pv[:, 1:],
                                   v[:, 1:] != v[:, :-1]).any(-1)
        violations += int(bad.sum())
        acc.append(moved)
        prop.append(ll_prop[:, 1:])
        cur.append(lls[:, :-1])
    return {"mh_violations": violations,
            "accept_z": compare.accept_z(torch.cat(acc, 1).flatten(),
                                         torch.cat(prop, 1).flatten(),
                                         torch.cat(cur, 1).flatten())}


def check(run) -> dict:
    params, lls = _sample(run)
    refs = [_reference_lls(run, params, torch.float32, REFERENCE, k)
            for k in range(2)]
    run.state["sample"] = (params, refs)
    return {**compare.paired_vs_reference(lls, *refs), **_mh(run)}


def control(run) -> dict:
    """The numbers with the reference filter in bfloat16 in place of the
    system's at the same proposals (after :func:`check`); the accepts are
    the system's."""
    params, refs = run.state["sample"]
    low = _reference_lls(run, params, torch.bfloat16, CONTROL)
    return {**compare.paired_vs_reference(low, *refs), **_mh(run)}


def planted(run, fault: str):
    """The fault under the MH loop: its select keeping every chain where
    it was; the batched evaluation computing the first half of the chains
    and giving the rest their mean, or moving every chain's log-likelihood
    by 1 nat; or the acceptance log-ratio moved by 1 nat."""
    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.inference import pmmh

    if fault == "state_unchanged":
        return faults.patched(pmmh, "_select",
                              lambda orig: lambda a, cur, prop: cur)
    if fault == "accept_shifted":
        return faults.patched(pmmh, "_log_ratio",
                              lambda orig: lambda *a: orig(*a) + 1.0)

    def make(orig):
        def evaluate(model, data, n, **kwargs):
            inner = orig(model, data, n, **kwargs)

            def lls(generator, params_b):
                ll = inner(generator, params_b)
                if fault == "answer_altered":
                    return ll + 1.0
                half = ll.shape[0] // 2
                return torch.cat([ll[:half], ll[:half].mean().expand(
                    ll.shape[0] - half)])
            return lls
        return evaluate
    return faults.patched(ct, "make_pf_loglik_chains", make)
