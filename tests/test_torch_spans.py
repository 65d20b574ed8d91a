"""The port's spans (``utils.profiling.span``) on the CPU at tiny sizes:
none entered while no profiler records, each counted and nested as the
layer map has them under ``torch.profiler``, and the results bit-equal
with the profiler on and off."""

from __future__ import annotations

import json
import math
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.models import perturb
from composablestatespacemodels_torch.utils import profiling
from composablestatespacemodels_torch.utils.checkpoint import tree_leaves

CHUNK, CHUNKS, T = 3, 2, 6
# each span's parent on the thread, where it has one on these paths
PARENT = {"cssm.filter.setup": "cssm.online.step",
          "cssm.filter.step": "cssm.online.step",
          "cssm.select": "cssm.filter.step"}


@pytest.fixture(scope="module")
def case():
    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.2, 0.25, 0.3))
    sim = ct.simulate_regular(model, params, torch.Generator().manual_seed(5),
                              T, dt=0.5)
    return model, params, sim.to_timeseries()


def _online(case):
    model, params, data = case
    f = ct.utils.OnlineFilter(model, params, 64,
                              torch.Generator().manual_seed(1),
                              float(data.ts[0]))
    out = []
    for k in range(CHUNKS):
        s = slice(k * CHUNK, (k + 1) * CHUNK)
        res = f.step(ct.utils.TimeSeries(data.ts[s], data.ys[s],
                                         data.mask[s]))
        out += [res.ll, res.summary.eta_lower, res.summary.state_upper]
    return out + [f.particles, f.ll]


def _fused(case):
    model, params, data = case
    res = ct.bootstrap_filter(model, params, data, 32,
                              torch.Generator().manual_seed(2),
                              resample="systematic-fused", store="ll")
    return [res.ll_history, res.final_particles]


def _ess(case):
    model, params, data = case
    res = ct.bootstrap_filter(model, params, data, 32,
                              torch.Generator().manual_seed(3),
                              ess_threshold=0.5)
    return [res.ll_history, res.ess, res.summary.eta_upper,
            res.final_particles]


ITERS, CHAINS = 3, 4


def _pmmh(case):
    model, params, data = case
    res = ct.pmmh_chains(torch.Generator().manual_seed(4), params, None,
                         perturb(0.02), ITERS, CHAINS,
                         pf_ll_chains=ct.make_pf_loglik_chains(model, data,
                                                               16))
    return [res.lls, res.accepted, *tree_leaves(res.params)]


# path -> (run, the span counts it makes)
PATHS = {
    "online": (_online, {"cssm.online.step": CHUNKS,
                         "cssm.host_read": 2 * CHUNKS,
                         "cssm.filter.setup": CHUNKS,
                         "cssm.filter.step": T, "cssm.select": T}),
    "fused": (_fused, {"cssm.host_read": 1, "cssm.filter.setup": 1,
                       "cssm.filter.step": T}),
    "ess": (_ess, {"cssm.host_read": 1 + T, "cssm.filter.setup": 1,
                   "cssm.filter.step": T, "cssm.select": T}),
    "pmmh": (_pmmh, {"cssm.pmmh.iter": ITERS}),
}


def _spans(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("cssm.")]


def _inside(child, parent):
    return (child.start_thread_id() == parent.start_thread_id()
            and parent.start_ns() <= child.start_ns()
            and child.end_ns() <= parent.end_ns())


def test_spans_off_enter_no_record_function(case, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        entered.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    for run in (_online, _fused, _pmmh):
        run(case)
    assert entered == []
    assert profiling.span("cssm.select") is profiling.span(
        "cssm.pmmh.iter", 7)
    # the same patch sees the spans while a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        _fused(case)
    assert entered.count("cssm.filter.step") == T


@pytest.mark.parametrize("path", sorted(PATHS))
def test_span_counts_nesting_and_bit_equal_results(case, path):
    run, counts = PATHS[path]
    off = run(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run(case)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    spans = _spans(prof)
    assert Counter(e.name() for e in spans) == counts
    assert {e.name() for e in spans} <= set(profiling.SPANS)
    by_name = {n: [e for e in spans if e.name() == n] for n in counts}
    for name, parent in PARENT.items():
        if name in counts and parent in counts:
            for e in by_name[name]:
                assert any(_inside(e, p) for p in by_name[parent]), name
    if path == "online":
        # both host reads of a step inside its span
        for e in by_name["cssm.host_read"]:
            assert any(_inside(e, p) for p in by_name["cssm.online.step"])


def test_trace_chrome_file_holds_the_spans(case, tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        _online(case)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"cssm.online.step", "cssm.host_read", "cssm.filter.setup",
            "cssm.filter.step", "cssm.select"} <= names
