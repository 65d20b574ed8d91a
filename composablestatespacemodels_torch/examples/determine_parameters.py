r"""Pilot run + PMMH posterior + JSON-to-CSV
(reference examples/DetermineParameters.scala:22-101).

  python -m composablestatespacemodels_torch.examples.determine_parameters \
      pilot data_sims.json
  python -m composablestatespacemodels_torch.examples.determine_parameters \
      posterior data_sims.json --n-iters 10000 --n-particles 100
  python -m composablestatespacemodels_torch.examples.determine_parameters \
      tocsv posterior.json posterior.csv

Add ``--device cpu`` to run without a card.  ``posterior --mesh`` runs the
chains over a (chains x particles) mesh of every rank, each chain's filter
sharding its cloud (``--adaptive``: the adaptive tier, else the monitored
one with a checkpoint): under torchrun over its ranks, under plain
``python -m`` over a world of one.  Rank 0 writes the files.
"""

import argparse

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.examples.common import (
    add_common_args, config_from_args, generator, test_model)
from composablestatespacemodels_torch.models import perturb, tree_map
from composablestatespacemodels_torch.utils import io as cio
from composablestatespacemodels_torch.utils.streaming import pmmh_monitored


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("what", choices=["pilot", "posterior", "tocsv"])
    ap.add_argument("data")
    ap.add_argument("csv_out", nargs="?")
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--delta", type=float, default=0.05,
                    help="random-walk proposal variance "
                         "(DetermineParameters.scala:72)")
    ap.add_argument("--plot", action="store_true",
                    help="also write trace/histogram + pilot PNGs "
                         "(R/Plots.R:77-107 analogue)")
    ap.add_argument("--adaptive", action="store_true",
                    help="two-phase adaptive PMMH: pilot RW chain -> "
                         "covariance -> MVN-eigen main chain "
                         "(Parameters.scala:111-123 + Utilities.scala:11-18 "
                         "workflow)")
    ap.add_argument("--fused-sweep", action="store_true",
                    help="evaluate all chains' likelihoods (and the pilot "
                         "run's at N <= 1024) with the whole-filter sweep "
                         "kernel K8 (n_particles <= 1024, exact-transition "
                         "models) -- the fast path for --chains at MCMC "
                         "shapes")
    ap.add_argument("--mesh", action="store_true",
                    help="run chains over a (chains x particles) mesh of "
                         "every rank (parallel.sharded_pmmh: each chain's "
                         "filter shards its cloud); combines with "
                         "--adaptive and --chains")
    add_common_args(ap)
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    model, params = test_model()

    if args.what == "tocsv":
        cio.posterior_to_csv(args.data, args.csv_out or "posterior.csv",
                             params)
        print(f"wrote {args.csv_out or 'posterior.csv'}")
        return

    if args.mesh and args.what == "posterior":
        # before any tensor is made: on a card the rank takes its card here
        from composablestatespacemodels_torch.parallel import (
            initialize_distributed)
        initialize_distributed(cfg.device)
    data = cio.read_timeseries_json(args.data, device=cfg.device)
    gen = generator(cfg)

    if args.what == "pilot":
        # ll variance at several particle counts (PilotRun,
        # DetermineParameters.scala:22-45)
        out = ct.pilot_run(model, params, data, gen,
                           particle_counts=(100, 200, 500, 1000, 2000),
                           n_reps=100, fused_sweep=args.fused_sweep)
        print("n_particles, mean_ll, var_ll")
        for n, m, v in out:
            print(f"{n}, {m:.3f}, {v:.3f}")
        if args.plot:
            from composablestatespacemodels_torch.utils import plots
            plots.plot_pilot_run([n for n, _, _ in out],
                                 [v for _, _, v in out],
                                 f"{cfg.out}_pilot.png")
            print(f"wrote {cfg.out}_pilot.png")
        return

    # posterior: chains on a chain axis, monitored single chain via a host
    # loop of chunks
    if args.mesh:
        return _posterior_mesh(args, cfg, model, params, data, gen)
    pf_ll = ct.make_pf_loglik(model, data, cfg.n_particles, cfg.resample)
    if args.chains > 1:
        pf_all = (ct.make_pf_loglik_chains(model, data, cfg.n_particles)
                  if args.fused_sweep else None)
        res = ct.pmmh_chains(gen, params, pf_ll, perturb(args.delta),
                             cfg.n_iters, args.chains, pf_ll_chains=pf_all)
        for c in range(args.chains):
            chain = tree_map(lambda x: x[c], res)
            cio.write_posterior_json(f"{cfg.out}_posterior_{c}.json", chain)
        print(f"acceptance rates: {res.acceptance_rate().tolist()}")
        print(f"R-hat(ll): {float(ct.gelman_rubin(res.lls)):.3f}")
    elif args.adaptive:
        res = ct.adaptive_pmmh(gen, params, pf_ll, cfg.n_iters,
                               pilot_iters=max(200, cfg.n_iters // 4),
                               pilot_delta=args.delta)
        cio.write_posterior_json(f"{cfg.out}_posterior.json", res)
        print(f"acceptance (adapted chain): "
              f"{float(res.acceptance_rate()):.3f}")
    else:
        res = pmmh_monitored(gen, params, pf_ll, perturb(args.delta),
                             cfg.n_iters, chunk_size=1000,
                             checkpoint_path=f"{cfg.out}_chain.npz")
        cio.write_posterior_json(f"{cfg.out}_posterior.json", res)
        print(f"acceptance: {float(res.acceptance_rate()):.3f}")
    if args.plot:
        from composablestatespacemodels_torch.utils import plots
        plots.plot_posterior(res, path=f"{cfg.out}_posterior.png")
        plots.plot_diagnostics(res, path=f"{cfg.out}_diagnostics.png")
        print(f"wrote {cfg.out}_posterior.png + _diagnostics.png")


def _posterior_mesh(args, cfg, model, params, data, gen):
    """The posterior over a (chains x particles) mesh of every rank."""
    import torch
    import torch.distributed as dist

    from composablestatespacemodels_torch.parallel import (
        make_mesh, sharded_adaptive_pmmh, sharded_pmmh_monitored)

    n_ranks = dist.get_world_size()
    n_chains = max(1, min(args.chains, n_ranks))
    mesh = make_mesh(n_chains, n_ranks // n_chains,
                     torch.device(cfg.device).type)
    if args.adaptive:
        res = sharded_adaptive_pmmh(
            model, params, data, cfg.n_particles, gen, cfg.n_iters, mesh,
            pilot_iters=max(200, cfg.n_iters // 4), pilot_delta=args.delta)
    else:
        res = sharded_pmmh_monitored(
            gen, model, params, data, cfg.n_particles, cfg.n_iters, mesh,
            proposal=perturb(args.delta), chunk_size=1000,
            checkpoint_path=f"{cfg.out}_mesh_chain.npz")
    if dist.get_rank() != 0:
        return
    for c in range(n_chains):
        chain = tree_map(lambda x: x[c], res)
        cio.write_posterior_json(f"{cfg.out}_posterior_{c}.json", chain)
    print(f"acceptance rates: {res.acceptance_rate().tolist()}")
    if args.plot:
        from composablestatespacemodels_torch.utils import plots
        plots.plot_posterior(res, path=f"{cfg.out}_posterior.png")
        plots.plot_diagnostics(res, path=f"{cfg.out}_diagnostics.png")
        print(f"wrote {cfg.out}_posterior.png + _diagnostics.png")


if __name__ == "__main__":
    main()
