"""Gloo worlds for the tests of the port's ``parallel/``.

A test module calls :func:`run_world` with a scenario name and numpy
inputs; the scenario then runs on every rank of a fresh gloo world on the
CPU (``composablestatespacemodels_torch.parallel.dryrun.run_cpu_world``,
one process per rank, a time limit on the whole world), and each rank's
outputs come back as a dict of numpy arrays.  A scenario runs many cases
in one world, since a world takes seconds to start.  The scenarios import
the port only, never JAX.

Run by the launcher as ``python tests/_torch_dist.py <scenario> --inputs
in.npz --out dir --rank r --world n --store file``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 120.0     # seconds for a whole world, start-up included


def run_world(scenario: str, n: int, inputs: dict, tmp_path,
              timeout: float = WORLD_TIMEOUT) -> list:
    """Every rank's outputs of ``scenario`` in an n-rank gloo world."""
    sys.path.insert(0, str(ROOT))
    from composablestatespacemodels_torch.parallel.dryrun import run_cpu_world

    src = Path(tmp_path) / f"{scenario}-inputs.npz"
    np.savez(src, **inputs)
    out = Path(tmp_path) / f"{scenario}-out"
    out.mkdir()
    results = run_cpu_world(n, [__file__, scenario, "--inputs", str(src),
                                "--out", str(out)], timeout)
    for r, (rc, _, err) in enumerate(results):
        if rc != 0:
            raise AssertionError(
                f"rank {r} of {scenario!r}: "
                + ("timed out" if rc is None else f"exit code {rc}")
                + "\n" + err[-4000:])
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]


# ---------------------------------------------------------------------------
# the scenarios (run on every rank)
# ---------------------------------------------------------------------------


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _states_agree(gen) -> np.ndarray:
    """Whether every rank's generator holds the same state."""
    import torch
    import torch.distributed as dist
    s = gen.get_state()
    parts = [torch.empty_like(s) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, s)
    return np.array(all(torch.equal(p, s) for p in parts))


def _oracle(inputs):
    import composablestatespacemodels_torch as ct
    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(np.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    data = ct.TimeSeries(_t(inputs["ts"]), _t(inputs["ys"]),
                         _t(inputs["mask"]))
    return model, params, data


def scenario_resample(inputs):
    """The distributed resampler's pieces and the sharded order statistics
    on each case's weights, with the case's shared uniform."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.parallel import (
        PARTICLE_AXIS, distributed_systematic_resample, particle_mesh)
    from composablestatespacemodels_torch.parallel import sharded_filter as sf

    mesh = particle_mesh("cpu")
    sh = sf._Shards(mesh, PARTICLE_AXIS, torch.device("cpu"))
    n = inputs["n"].item()
    m = n // sh.n
    sl = slice(sh.idx * m, (sh.idx + 1) * m)
    out = {}
    for name in inputs["cases"]:
        w = _t(inputs[f"{name}/w"])[sl]
        x_t = _t(inputs[f"{name}/x"])[sl].T.contiguous()
        u = _t(inputs[f"{name}/u"])
        counts, c_prev = sf._window_counts(w, u, sh)
        out[f"{name}/counts"] = counts.numpy()
        out[f"{name}/c_prev"] = c_prev.numpy()
        out[f"{name}/plain"] = sf._resample_t(x_t, w, u, sh, False).numpy()
        out[f"{name}/k4"] = sf._resample_t(x_t, w, u, sh).numpy()
        out[f"{name}/allgather"] = sf._all_gather_resample_t(
            x_t, w, u, sh).numpy()
    # the public [local_n, d] route draws its uniform from the generator
    name = inputs["cases"][0]
    w, x = _t(inputs[f"{name}/w"])[sl], _t(inputs[f"{name}/x"])[sl]
    gen = torch.Generator().manual_seed(5)
    pub = distributed_systematic_resample(x, w, gen, mesh)
    u_pub = torch.rand((), generator=torch.Generator().manual_seed(5))
    out["public_equal"] = np.array(torch.equal(
        pub, sf._resample_t(x.T.contiguous(), w, u_pub, sh).T))
    out["gen_agree"] = _states_agree(gen)
    # the order statistics
    out["kth"] = sf._kth_smallest_sharded(_t(inputs["vals"])[:, sl],
                                          _t(inputs["ks"]), sh).numpy()
    wn = _t(inputs["wn"])[sl]
    out["pick"] = sf._sharded_weighted_pick(wn, _t(inputs["u_pick"]), sh,
                                            n).numpy()
    model = ct.linear(ct.brownian_motion(1))
    summary = sf._sharded_weighted_summary(
        model, _t(inputs["cols"])[:, sl], wn, _t(inputs["mean"]),
        torch.ones(1), float(inputs["interval"]), n, sh)
    for i, v in enumerate(summary):
        out[f"summary/{i}"] = v.numpy()
    # the unweighted summary at floor(N * interval) == 0, where the JAX
    # sharded route asks its bisection for k = -1 and k = N
    edge = ct.linear(ct.brownian_motion(inputs["edge_x"].shape[0]))
    save = sf._make_save_fn_sharded_t(
        edge, "summary", float(inputs["edge_interval"]), False,
        torch.Generator(), 1, m, sh)
    for i, v in enumerate(save(0, 0.0, edge.design_vector(0.0),
                               _t(inputs["edge_x"])[:, sl], None)):
        out[f"edge/{i}"] = v.numpy()
    return out


def scenario_filter(inputs):
    """The sharded filter on the oracle: lls of R seeds (systematic and
    fused), every store mode, the ESS trigger, the all-gather route and
    the errors; the generator states compared across ranks after each."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.parallel import particle_mesh

    mesh = particle_mesh("cpu")
    model, params, data = _oracle(inputs)
    n = inputs["n"].item()
    out = {}
    agree = []

    def run(seed, **kw):
        gen = torch.Generator().manual_seed(int(seed))
        res = ct.bootstrap_filter(model, params, data, n, gen, mesh=mesh,
                                  **kw)
        agree.append(_states_agree(gen))
        return res

    for scheme in ("systematic", "systematic-pallas-fused"):
        runs = [run(s, store="ll", resample=scheme) for s in inputs["seeds"]]
        out[f"{scheme}/ll"] = np.array([float(r.ll) for r in runs])
        out[f"{scheme}/ess"] = np.stack([r.ess.numpy() for r in runs])
        out[f"{scheme}/final_shape"] = np.array(
            runs[0].final_particles.shape)
        out[f"{scheme}/final_local"] = runs[0].final_particles.to_local(
        ).numpy()
    for tag, kw in (("summary", dict(store="summary")),
                    ("weighted", dict(store="summary", ess_threshold=0.5)),
                    ("path", dict(store="path")),
                    ("path_weighted", dict(store="path", ess_threshold=0.5)),
                    ("allgather", dict(store="ll",
                                       resample_comm="allgather"))):
        res = run(11, **kw)
        out[f"{tag}/ll"] = np.array(float(res.ll))
        out[f"{tag}/ess"] = res.ess.numpy()
        if res.summary is not None:
            for f in ("eta_mean", "eta_lower", "eta_upper", "state_mean",
                      "state_lower", "state_upper"):
                out[f"{tag}/{f}"] = getattr(res.summary, f).numpy()
        if res.sampled_path is not None:
            out[f"{tag}/path"] = res.sampled_path.numpy()
    out["gen_agree"] = np.array(all(agree))
    # K5's per-step seeds: this shard's stream, twice from one seed
    from composablestatespacemodels_torch.inference.filter import _step_seeds
    from composablestatespacemodels_torch.parallel import PARTICLE_AXIS
    from composablestatespacemodels_torch.parallel import sharded_filter as sf
    sh = sf._Shards(mesh, PARTICLE_AXIS, torch.device("cpu"))
    out["k5_seeds"] = np.stack([_step_seeds(sf._shard_generator(
        torch.Generator().manual_seed(3), sh), 8).numpy() for _ in range(2)])
    errors = []
    for kw in (dict(n_particles=n - 1), dict(resample="stratified"),
               dict(resample_comm="ring")):
        args = dict(n_particles=n, resample="systematic", store="ll")
        args.update(kw)
        try:
            ct.bootstrap_filter(model, params, data, args.pop("n_particles"),
                                torch.Generator(), mesh=mesh, **args)
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)
    return out


def scenario_pmmh(inputs):
    """Sharded PMMH on a 2 x 2 mesh: the tiers, a resume through
    ``init_state`` and through ``sharded_pmmh_monitored``'s checkpoint."""
    import torch

    from composablestatespacemodels_torch.models import perturb
    from composablestatespacemodels_torch.models.params import flatten_params
    from composablestatespacemodels_torch.parallel import (
        make_mesh, sharded_adaptive_pmmh, sharded_pmmh,
        sharded_pmmh_monitored)
    from composablestatespacemodels_torch.utils.streaming import (
        fold_generator)

    mesh = make_mesh(2, 2, "cpu")
    model, params, data = _oracle(inputs)
    n, iters = inputs["n"].item(), inputs["iters"].item()
    prop = perturb(0.01)
    out = {}
    agree = []

    def gen():
        g = torch.Generator().manual_seed(7)
        agree.append(g)
        return g

    def keep(tag, res):
        out[f"{tag}/lls"] = res.lls.numpy()
        out[f"{tag}/accepted"] = res.accepted.numpy()
        out[f"{tag}/params"] = flatten_params(res.params).numpy()
        if res.states is not None:
            out[f"{tag}/states"] = res.states.numpy()

    keep("plain", sharded_pmmh(model, params, data, n, gen(), iters, mesh,
                               proposal=prop))
    keep("approx", sharded_pmmh(model, params, data, n, gen(), iters, mesh,
                                proposal=prop, approx=True))
    keep("state", sharded_pmmh(model, params, data, n, gen(), iters, mesh,
                               proposal=prop, store_state=True))
    # the monitored run in two chunks, resumed from its checkpoint after
    # the first, and by hand through init_state
    half = iters // 2
    ck = os.path.join(inputs["dir"].item(), "chain.npz")
    keep("uncut", sharded_pmmh_monitored(
        gen(), model, params, data, n, iters, mesh, proposal=prop,
        chunk_size=half, store_state=True, log_every=False))
    sharded_pmmh_monitored(gen(), model, params, data, n, half, mesh,
                           proposal=prop, chunk_size=half, store_state=True,
                           checkpoint_path=ck, log_every=False)
    keep("resumed", sharded_pmmh_monitored(
        gen(), model, params, data, n, iters, mesh, proposal=prop,
        chunk_size=half, store_state=True, checkpoint_path=ck,
        log_every=False))
    g = gen()
    base = int(torch.randint(0, 2 ** 62, (), generator=g))
    r0, s0 = sharded_pmmh(model, params, data, n,
                          fold_generator(base, 0, "cpu"), half, mesh,
                          proposal=prop, store_state=True, return_state=True)
    r1 = sharded_pmmh(model, params, data, n, fold_generator(base, 1, "cpu"),
                      iters - half, mesh, proposal=prop, store_state=True,
                      init_state=s0)
    out["by_hand/lls"] = torch.cat([r0.lls, r1.lls], dim=1).numpy()
    out["by_hand/states"] = torch.cat([r0.states, r1.states], dim=1).numpy()
    keep("adaptive", sharded_adaptive_pmmh(model, params, data, n, gen(),
                                           iters, mesh, pilot_iters=iters))
    out["gen_agree"] = np.array(all(_states_agree(g) for g in agree))
    return out


def scenario_routes(inputs):
    """``lgcp_filter(mesh=)`` and ``OnlineFilter(mesh=)`` against their
    one-device routes over R seeds."""
    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.parallel import particle_mesh
    from composablestatespacemodels_torch.utils.streaming import OnlineFilter

    mesh = particle_mesh("cpu")
    n = inputs["n"].item()
    out = {}
    lmodel = ct.lgcp(ct.brownian_motion(1))
    lparams = ct.parameters(None, ct.brownian_params(1.0, 0.05, 0.1))
    events = _t(inputs["events"])
    ldata = ct.TimeSeries(events, torch.ones_like(events),
                          torch.ones(events.shape, dtype=torch.bool))
    sharded, single, agree = [], [], []
    for s in inputs["seeds"]:
        gen = torch.Generator().manual_seed(int(s))
        sharded.append(ct.lgcp_filter(lmodel, lparams, ldata, n, gen,
                                      mesh=mesh))
        agree.append(_states_agree(gen))
        single.append(ct.lgcp_filter(lmodel, lparams, ldata, n,
                                     torch.Generator().manual_seed(int(s))))
    out["lgcp/sharded"] = np.array([float(r.ll) for r in sharded])
    out["lgcp/single"] = np.array([float(r.ll) for r in single])
    r = sharded[0]
    for f in ("eta_lower", "eta_upper", "state_lower", "state_upper", "ess"):
        out[f"lgcp/{f}"] = getattr(r, f).numpy()
    out["lgcp/final_shape"] = np.array(r.final_particles.shape)

    model, params, data = _oracle(inputs)
    chunks = [ct.TimeSeries(data.ts[i:i + 10], data.ys[i:i + 10],
                            data.mask[i:i + 10])
              for i in range(0, len(data), 10)]
    lls = {"sharded": [], "single": []}
    kinds = []
    for s in inputs["seeds"]:
        for tag, m in (("sharded", mesh), ("single", None)):
            gen = torch.Generator().manual_seed(int(s))
            f = OnlineFilter(model, params, n, gen, t0=0.0, store="ll",
                             mesh=m)
            for c in chunks:
                f.step(c)
                if m is not None:
                    kinds.append(type(f.particles).__name__)
            lls[tag].append(float(f.ll))
            if m is not None:
                agree.append(_states_agree(gen))
    out["online/sharded"] = np.array(lls["sharded"])
    out["online/single"] = np.array(lls["single"])
    out["online/kinds"] = np.array(sorted(set(kinds)))
    out["gen_agree"] = np.array(all(agree))
    return out


SCENARIOS = {"resample": scenario_resample, "filter": scenario_filter,
             "pmmh": scenario_pmmh, "routes": scenario_routes}


def _main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from composablestatespacemodels_torch.parallel.dryrun import (join_world,
                                                                  rank_args)

    def extra(ap):
        ap.add_argument("scenario", choices=sorted(SCENARIOS))
        ap.add_argument("--inputs", required=True)
        ap.add_argument("--out", required=True)

    args = rank_args(extra=extra)
    join_world(args)
    try:
        with np.load(args.inputs) as f:
            inputs = dict(f)
        out = SCENARIOS[args.scenario](inputs)
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
