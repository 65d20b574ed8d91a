"""Dry run of every mesh route in an N-rank gloo world on the CPU.

    python -m composablestatespacemodels_torch.parallel.dryrun N

Starts N processes of this module, each a rank of one gloo world met
through a file store in a temporary directory, and runs in each what the
JAX package's ``__graft_entry__.py::dryrun_multichip`` runs on N virtual
devices, at tiny shapes on the flagship ``poisson(ou(1)) + seasonal(24, 3,
ou(6))``: one sharded PMMH step on a (chains, particles) mesh (two chain
rows when N is even), with ``approx`` and a resume from its state, and
with ``store_state``; the particle-sharded filter; the sharded LGCP
filter; and two chunks of ``OnlineFilter(mesh=)``.  Rank 0 prints one
line, ``dryrun_multichip(N): mesh={...} ... OK``; the exit code is 0 only
if every rank finished within the time limit (``--timeout``, seconds).

:func:`run_cpu_world` is the launcher: it also serves tests that need a
gloo world of their own.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parents[2])


def run_cpu_world(n: int, argv, timeout: float):
    """Run ``python <argv> --rank r --world n --store <file>`` for r in 0..n-1
    at once, the ranks of one gloo world meeting through a file store in a
    fresh temporary directory, each with one intra-op thread.  Every
    process is killed once ``timeout`` seconds have passed.  Returns
    ``[(returncode, stdout, stderr)]`` by rank; a killed rank's returncode
    is None."""
    with tempfile.TemporaryDirectory(prefix="cssm-world-") as tmp:
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       p for p in (_ROOT, os.environ.get("PYTHONPATH"))
                       if p))
        procs = []
        for r in range(n):
            out = open(os.path.join(tmp, f"out{r}"), "w+")
            err = open(os.path.join(tmp, f"err{r}"), "w+")
            cmd = [sys.executable, *argv, "--rank", str(r), "--world",
                   str(n), "--store", os.path.join(tmp, "store")]
            procs.append((subprocess.Popen(cmd, stdout=out, stderr=err,
                                           env=env, cwd=_ROOT), out, err))
        deadline = time.monotonic() + timeout
        results = []
        for p, out, err in procs:
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                rc = None
            results.append(rc)
        texts = []
        for (p, out, err), rc in zip(procs, results):
            if p.poll() is None:
                p.kill()
                p.wait()
            out.seek(0)
            err.seek(0)
            texts.append((rc, out.read(), err.read()))
            out.close()
            err.close()
        return texts


def rank_args(argv=None, extra=None):
    """Parse the ``--rank``, ``--world`` and ``--store`` that
    :func:`run_cpu_world` appends (and ``extra(parser)``'s arguments)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    if extra is not None:
        extra(ap)
    return ap.parse_args(argv)


def join_world(args, timeout: float = 60.0) -> None:
    """Join the gloo world of :func:`run_cpu_world` as rank ``args.rank``."""
    import torch

    from .multihost import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{args.store}",
                           world_size=args.world, rank=args.rank,
                           timeout=timeout)


def _flagship():
    import composablestatespacemodels_torch as ct

    model = (ct.poisson(ct.ou_process(1))
             + ct.seasonal(24, 3, ct.ou_process(6)))
    params = ct.branch(
        ct.leaf(ct.param_node(None, ct.ou_params(1.0, 0.2, 0.3, 1.0, 0.3))),
        ct.leaf(ct.param_node(None,
                              ct.ou_params(0.2, 0.2, 0.25, 0.2, 0.2))))
    return model, params


def _dryrun_body(n_ranks: int) -> str:
    """Every mesh route once on this rank; rank 0's summary line."""
    import torch
    import torch.distributed as dist

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.models import perturb
    from composablestatespacemodels_torch.utils.streaming import OnlineFilter

    from . import (make_mesh, particle_mesh, sharded_bootstrap_filter,
                   sharded_pmmh)

    def gen():
        return torch.Generator().manual_seed(0)

    n_chains = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    mesh = make_mesh(n_chains, n_ranks // n_chains, "cpu")
    model, params = _flagship()
    data = ct.simulate_regular(model, params, gen(), 5,
                               dt=1.0).to_timeseries()
    n_particles = 16 * (n_ranks // n_chains)

    def finite(x, what):
        if not torch.isfinite(torch.as_tensor(x)).all():
            raise RuntimeError(f"dry run: {what} not finite")

    res = sharded_pmmh(model, params, data, n_particles, gen(), 1, mesh,
                       proposal=perturb(0.01))
    finite(res.lls, "sharded_pmmh ll")
    # approx (ApproxPMMH) and its resumable state over the same mesh
    res_a, state_a = sharded_pmmh(model, params, data, n_particles, gen(), 1,
                                  mesh, proposal=perturb(0.01), approx=True,
                                  return_state=True)
    res_r = sharded_pmmh(model, params, data, n_particles, gen(), 1, mesh,
                         proposal=perturb(0.01), init_state=state_a)
    finite(res_a.lls, "approx ll")
    finite(res_r.lls, "resumed ll")
    # joint (params, state) draws: one particle of each chain's global cloud
    res_s = sharded_pmmh(model, params, data, n_particles, gen(), 1, mesh,
                         proposal=perturb(0.01), store_state=True)
    if tuple(res_s.states.shape) != (n_chains, 1, model.dim):
        raise RuntimeError(f"store_state gave {tuple(res_s.states.shape)}")
    finite(res_s.states, "store_state draws")

    pmesh = particle_mesh("cpu")
    res_t = sharded_bootstrap_filter(model, params, data, 16 * n_ranks,
                                     gen(), pmesh, store="ll",
                                     transposed=True, pallas_fill=False)
    finite(res_t.ll, "sharded filter ll")
    lmodel = ct.lgcp(ct.brownian_motion(1))
    lparams = ct.parameters(None, ct.brownian_params(1.0, 0.05, 0.05))
    ldata = ct.TimeSeries(torch.tensor([0.0, 0.3, 0.9, 1.0]), torch.ones(4),
                          torch.ones(4, dtype=torch.bool))
    res_l = ct.lgcp_filter(lmodel, lparams, ldata, 16 * n_ranks, gen(),
                           precision=1, mesh=pmesh)
    finite(res_l.ll, "sharded LGCP ll")
    online = OnlineFilter(model, params, 16 * n_ranks, gen(), t0=0.0,
                          store="ll", mesh=pmesh)
    online.step(data)
    online.step(ct.TimeSeries(data.ts + 5.0, data.ys, data.mask))
    finite(online.ll, "OnlineFilter(mesh=) ll")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    line = (f"dryrun_multichip({n_ranks}): mesh={shape} "
            f"n_particles={n_particles} ll={float(res.lls[0, -1]):.3f} "
            f"ll_t={float(res_t.ll):.3f} ll_lgcp={float(res_l.ll):.3f} "
            f"ll_online={float(online.ll):.3f} OK")
    dist.barrier()
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--rank" in argv:
        args = rank_args(argv, lambda ap: ap.add_argument("n", type=int))
        join_world(args)
        import torch.distributed as dist
        try:
            line = _dryrun_body(args.world)
            if args.rank == 0:
                print(line, flush=True)
        finally:
            dist.destroy_process_group()
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks of the gloo world")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    results = run_cpu_world(
        args.n, ["-m", "composablestatespacemodels_torch.parallel.dryrun",
                 str(args.n)], args.timeout)
    ok = True
    for r, (rc, out, err) in enumerate(results):
        sys.stdout.write(out)
        if rc != 0:
            ok = False
            print(f"rank {r}: " + ("timed out" if rc is None
                                   else f"exit code {rc}"), file=sys.stderr)
            sys.stderr.write(err[-4000:])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
