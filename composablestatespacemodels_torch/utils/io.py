"""CSV / line-delimited-JSON persistence.

PyTorch port of ``composablestatespacemodels_tpu/utils/io.py``, which
replaces the reference's spray-json codecs (jsonFormats.scala:16-144) and
cats Show CSV instances (CsvFormat.scala:7-87):

* time-series CSV with ``NA``/empty for missing observations
  (DataFromFile, Data.scala:252-260);
* line-delimited JSON for observations (DataFromJson, Data.scala:265-272);
* parameter trees serialised with explicit structure and type tags;
* PMMH posterior read/write with burn-in/thinning
  (Streaming.pmmhToJson/readPosterior, Streaming.scala:42-58, 113-140) and
  posterior-to-CSV with parameter-name headers (JsonToCSV,
  DetermineParameters.scala:90-101).

The file formats are the JAX package's, byte for byte for the same
values: both write float32 values through the same conversions, and the
time-series CSV and posterior CSV through the same native writer
(:mod:`..native`, with the same pure-Python fallback).  The writers take
tensors on any device and copy them to the host once.  The readers build
tensors on ``device``, ``"cuda"`` unless the caller names another (the
tests pass ``"cpu"``); :func:`posterior_to_csv`, a file-to-file
conversion, stays on the host.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..models.params import (BrownianParams, GenBrownianParams, OuParams,
                             ParamNode, param_names, stack_flat)
from ..models.tree import Branch, Empty, EmptyTree, Leaf, Tree, tree_map
from .data import SimulatedData, TimeSeries, timeseries_from_timestamps
from .data import timestamps_of, to_numpy as _np


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32), device=device)


def _records(path: str) -> list:
    """The JSON objects of a line-delimited file (blank lines skipped)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# time series
# ---------------------------------------------------------------------------


def write_timeseries_csv(path: str, data: TimeSeries) -> None:
    """Rows ``t,y`` with an empty observation field when missing.

    Uses the native C++ writer (:mod:`..native`) when available.
    """
    ts, ys, mask = _np(data.ts), _np(data.ys), _np(data.mask)
    from .. import native
    if native.write_timeseries_csv(path, ts, ys, mask):
        return
    with open(path, "w") as f:
        for t, y, m in zip(ts, ys, mask):
            f.write(f"{t},{y if m else ''}\n")


def _build_timeseries(ts, ys, mask, device) -> TimeSeries:
    """The native parsers' arrays as a series; a NaN observation is
    missing, as in :meth:`TimeSeries.from_arrays` (the parsers read
    ``nan`` as a number)."""
    mask = mask & ~np.isnan(ys)
    return TimeSeries(_f32(ts, device), _f32(np.where(mask, ys, 0.0), device),
                      torch.tensor(mask, device=device))


def read_timeseries_csv(path: str, device="cuda") -> TimeSeries:
    """First column time, second observation; ``NA``/empty => missing
    (Data.scala:258).  The series lands on ``device``.

    Uses the native single-pass C++ parser (:mod:`..native`) when
    available, falling back to pure Python.  The native parser is lenient:
    lines whose time field does not parse are skipped (the Python fallback
    raises).
    """
    from .. import native
    parsed = native.parse_timeseries_csv(path)
    if parsed is not None:
        return _build_timeseries(*parsed, device)
    ts, ys = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            ts.append(float(parts[0]))
            v = parts[1].strip() if len(parts) > 1 else ""
            ys.append(None if v in ("", "NA") else float(v))
    return TimeSeries.from_arrays(np.asarray(ts), ys, device=device)


def write_timeseries_json(path: str, data: TimeSeries) -> None:
    """Line-delimited ``{"t": ..., "observation": ...|null}``."""
    with open(path, "w") as f:
        for t, y, m in zip(_np(data.ts), _np(data.ys), _np(data.mask)):
            f.write(json.dumps(
                {"t": float(t), "observation": float(y) if m else None})
                + "\n")


def read_timeseries_json(path: str, device="cuda") -> TimeSeries:
    """Line-delimited JSON reader (native fast path when available)."""
    from .. import native
    parsed = native.parse_timeseries_json(path)
    if parsed is not None:
        return _build_timeseries(*parsed, device)
    recs = _records(path)
    return TimeSeries.from_arrays(np.asarray([r["t"] for r in recs]),
                                  [r.get("observation") for r in recs],
                                  device=device)


def write_timestamped_json(path: str, data: TimeSeries, epoch,
                           unit: str = "h") -> None:
    """Line-delimited ``{"timestamp": ISO-8601, "observation": ...|null}``:
    the wall-clock flavour of :func:`write_timeseries_json`
    (jsonFormats.scala:106-118, Data.scala:45); the continuous time axis
    maps back to stamps through ``(epoch, unit)`` (see
    :func:`..utils.data.timestamps_of`)."""
    stamps = timestamps_of(data.ts, epoch, unit)
    with open(path, "w") as f:
        for s, y, m in zip(stamps, _np(data.ys), _np(data.mask)):
            f.write(json.dumps({
                "timestamp": np.datetime_as_string(s),
                "observation": float(y) if m else None}) + "\n")


def read_timestamped_json(path: str, unit: str = "h", epoch=None,
                          device="cuda"):
    """Read ISO-timestamped observations; returns ``(TimeSeries, epoch)``
    (the inverse of :func:`write_timestamped_json`)."""
    recs = _records(path)
    return timeseries_from_timestamps([r["timestamp"] for r in recs],
                                      [r.get("observation") for r in recs],
                                      unit=unit, epoch=epoch, device=device)


def write_simulated_csv(path: str, sim: SimulatedData) -> None:
    """Rows ``t,y,eta,gamma,x_0,...,x_{d-1}`` (the reference Show[Data]
    layout, CsvFormat.scala:18-27)."""
    ts, ys, etas, gammas, xs = (_np(v) for v in (sim.ts, sim.ys, sim.etas,
                                                 sim.gammas, sim.xs))
    with open(path, "w") as f:
        for i in range(len(ts)):
            row = [ts[i], ys[i], etas[i], gammas[i], *xs[i]]
            f.write(",".join(str(float(v)) for v in row) + "\n")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

_SDE_TAGS = {BrownianParams: "brownian", GenBrownianParams: "gen_brownian",
             OuParams: "ou"}
_SDE_TYPES = {v: k for k, v in _SDE_TAGS.items()}


def _sde_to_json(p) -> dict:
    d = {"type": _SDE_TAGS[type(p)]}
    for field in p.__dataclass_fields__:
        d[field] = _np(getattr(p, field)).tolist()
    return d


def _sde_from_json(d: dict, device):
    cls = _SDE_TYPES[d["type"]]
    return cls(**{k: _f32(v, device) for k, v in d.items() if k != "type"})


def params_to_json(p) -> dict:
    """Parameter tree -> JSON-able dict, structure preserved (unlike the
    reference's flatten-and-rebuild, jsonFormats.scala:60-104)."""
    if isinstance(p, Leaf):
        return {"leaf": params_to_json(p.value)}
    if isinstance(p, Branch):
        return {"left": params_to_json(p.left),
                "right": params_to_json(p.right)}
    if isinstance(p, EmptyTree):
        return {"empty": True}
    if isinstance(p, ParamNode):
        return {"scale": None if p.scale is None else float(p.scale),
                "sde": _sde_to_json(p.sde)}
    raise TypeError(f"cannot serialise {type(p).__name__}")


def params_from_json(d: dict, device="cuda"):
    """The parameter tree of a :func:`params_to_json` dict, on ``device``."""
    if "leaf" in d:
        return Leaf(params_from_json(d["leaf"], device))
    if "left" in d:
        return Branch(params_from_json(d["left"], device),
                      params_from_json(d["right"], device))
    if d.get("empty"):
        return Empty
    scale = d["scale"]
    return ParamNode(None if scale is None else _f32(scale, device),
                     _sde_from_json(d["sde"], device))


def write_params_json(path: str, p: Tree) -> None:
    with open(path, "w") as f:
        json.dump(params_to_json(p), f)


def read_params_json(path: str, device="cuda") -> Tree:
    with open(path) as f:
        return params_from_json(json.load(f), device)


# ---------------------------------------------------------------------------
# posteriors
# ---------------------------------------------------------------------------


def _iter_params(stacked, n: int):
    """The ``n`` per-iteration trees of a stacked parameter tree, from ONE
    host copy of each leaf (indexing device tensors row by row would cost
    a transfer per leaf per row)."""
    params_np = tree_map(_np, stacked)
    for i in range(n):
        yield tree_map(lambda x: x[i], params_np)


def _stack_params(params: list, device):
    return tree_map(lambda *xs: torch.stack(xs).to(device), *params)


def write_posterior_json(path: str, result) -> None:
    """Line-delimited PMMH iterations ``{"ll":..,"accepted":..,"params":..}``
    (reference pmmhToJson, Streaming.scala:42-58).  ``result`` is a
    single-chain :class:`~..inference.pmmh.PmmhResult`."""
    lls, accs = _np(result.lls), _np(result.accepted)
    with open(path, "w") as f:
        for i, p_i in enumerate(_iter_params(result.params, len(lls))):
            f.write(json.dumps({
                "ll": float(lls[i]),
                "accepted": int(accs[i]),
                "params": params_to_json(p_i),
            }) + "\n")


def read_posterior_json(path: str, burn_in: int = 0, thin: int = 1,
                        device="cuda"):
    """Read back a posterior with burn-in and thinning
    (Streaming.readPosterior, Streaming.scala:113-140).

    Returns ``(stacked_params, lls, accepted)`` on ``device``.
    """
    recs = _records(path)[burn_in::thin]
    if not recs:
        raise ValueError("no posterior records after burn-in/thinning")
    params = [params_from_json(r["params"], "cpu") for r in recs]
    lls = _f32([r["ll"] for r in recs], device)
    accs = torch.tensor(np.asarray([r["accepted"] for r in recs], np.int32),
                        device=device)
    return _stack_params(params, device), lls, accs


def posterior_to_csv(json_path: str, csv_path: str, template: Tree) -> None:
    """Posterior JSON -> CSV with parameter-name header (the reference
    JsonToCSV app, DetermineParameters.scala:90-101).

    A file-to-file conversion on the host: the rows are flattened in one
    batched ``stack_flat`` and go through the native C++ matrix writer
    when available.
    """
    stacked, lls, _ = read_posterior_json(json_path, device="cpu")
    names = param_names(template)
    mat = np.column_stack([_np(stack_flat(stacked)),
                           _np(lls)[:, None]]).astype(np.float64)
    header = ",".join(names + ["ll"])

    from .. import native
    if native.write_matrix_csv(csv_path, header, mat):
        return
    with open(csv_path, "w") as f:
        f.write(header + "\n")
        for row in mat:
            f.write(",".join(str(v) for v in row) + "\n")


def write_forecast_csv(path: str, fc) -> None:
    """Forecast summaries -> CSV (reference Show[ForecastOut],
    CsvFormat.scala:66-76): t, obs mean/lo/hi, eta mean/lo/hi, state mean."""
    cols = [np.atleast_1d(_np(c)) for c in (
        fc.t, fc.obs_mean, fc.obs_lower, fc.obs_upper, fc.eta_mean,
        fc.eta_lower, fc.eta_upper)]
    state = np.atleast_2d(_np(fc.state_mean))
    with open(path, "w") as f:
        for i in range(cols[0].shape[0]):
            row = [c[i] for c in cols] + list(state[i])
            f.write(",".join(str(float(v)) for v in row) + "\n")


def write_filter_json(path: str, result, ts=None) -> None:
    """Per-step filter summaries -> line-delimited JSON (reference
    Show/json for PfOut, jsonFormats.scala:120-143)."""
    s = result.summary
    if s is None:
        raise ValueError("write_filter_json needs store='summary' output")
    ts_, eta, e_lo, e_hi, sm, sl, su, ess, llh = (
        _np(x) for x in (s.ts, s.eta_mean, s.eta_lower, s.eta_upper,
                         s.state_mean, s.state_lower, s.state_upper,
                         result.ess, result.ll_history))
    with open(path, "w") as f:
        for i in range(int(ts_.shape[0])):
            f.write(json.dumps({
                "time": float(ts_[i]),
                "eta": float(eta[i]),
                "etaIntervals": [float(e_lo[i]), float(e_hi[i])],
                "state": [float(v) for v in sm[i]],
                "stateLower": [float(v) for v in sl[i]],
                "stateUpper": [float(v) for v in su[i]],
                "ess": int(ess[i]),
                "ll": float(llh[i]),
            }) + "\n")


# ---------------------------------------------------------------------------
# filter / chain state records (jsonFormats.scala:120-143)
# ---------------------------------------------------------------------------


def state_space_to_json(time, state) -> dict:
    """``StateSpace(time, state)`` codec (stateSpaceFormat,
    jsonFormats.scala:120; Sde.scala:170)."""
    return {"time": float(time), "state": _np(state).tolist()}


def state_space_from_json(d, device="cuda"):
    return float(d["time"]), _f32(d["state"], device)


def pf_state_to_json(t, observation, particles, ll, ess) -> dict:
    """``PfState(t, observation, particles, ll, ess)`` codec
    (pfStateFormat, jsonFormats.scala:143; ParticleFilter.scala:32-37).
    Argument order matches the reference record (and
    :func:`pf_state_from_json`'s return)."""
    return {
        "t": float(t),
        "observation": None if observation is None else float(observation),
        "particles": _np(particles).tolist(),
        "ll": float(ll),
        "ess": int(ess),
    }


def pf_state_from_json(d, device="cuda"):
    obs = d.get("observation")
    return (float(d["t"]), None if obs is None else float(obs),
            _f32(d["particles"], device), float(d["ll"]), int(d["ess"]))


def metrop_state_to_json(ll, params, state_time, state, accepted) -> dict:
    """``MetropState(ll, params, state: StateSpace, accepted)`` codec
    (metropFormat, jsonFormats.scala:121; PMMH.scala:26)."""
    return {
        "ll": float(ll),
        "params": params_to_json(params),
        "state": state_space_to_json(state_time, state),
        "accepted": int(accepted),
    }


def metrop_state_from_json(d, device="cuda"):
    t, s = state_space_from_json(d["state"], device)
    return (float(d["ll"]), params_from_json(d["params"], device), t, s,
            int(d["accepted"]))


def write_metrop_states_json(path: str, result, state_time) -> None:
    """Line-delimited ``MetropState`` records from a joint-posterior chain
    (``pmmh(store_state=True)``): ll, params, the sampled latent state at
    ``state_time`` (the data's last observation time) and the cumulative
    acceptance count -- the reference's ``monitorStateStream`` sink
    feeding ``Data.forecast`` (Streaming.scala:84-94, PMMH.scala:26)."""
    if result.states is None:
        raise ValueError(
            "write_metrop_states_json needs a pmmh(store_state=True) "
            "result (result.states is None)")
    lls, accs, states = (_np(v) for v in (result.lls, result.accepted,
                                          result.states))
    with open(path, "w") as f:
        for i, p_i in enumerate(_iter_params(result.params, len(lls))):
            f.write(json.dumps(metrop_state_to_json(
                lls[i], p_i, state_time, states[i], accs[i])) + "\n")


def read_metrop_states_json(path: str, burn_in: int = 0, thin: int = 1,
                            device="cuda"):
    """Read a joint posterior back: ``(stacked_params, lls, state_time,
    stacked_states, accepted)`` on ``device``, the paired draws for
    :func:`~..inference.filter.forecast_from_posterior`."""
    recs = [metrop_state_from_json(d, "cpu")
            for d in _records(path)][burn_in::thin]
    if not recs:
        raise ValueError("no metrop records after burn-in/thinning")
    lls = _f32([r[0] for r in recs], device)
    states = torch.stack([r[3] for r in recs]).to(device)
    accs = torch.tensor(np.asarray([r[4] for r in recs], np.int32),
                        device=device)
    return (_stack_params([r[1] for r in recs], device), lls, recs[0][2],
            states, accs)


def write_pf_states_json(path: str, states) -> None:
    """Line-delimited PfState records (one per filter step) -- the
    reference streams these through its Show/json sinks."""
    with open(path, "w") as f:
        for rec in states:
            f.write(json.dumps(pf_state_to_json(*rec)) + "\n")


def read_pf_states_json(path: str, device="cuda"):
    return [pf_state_from_json(d, device) for d in _records(path)]
