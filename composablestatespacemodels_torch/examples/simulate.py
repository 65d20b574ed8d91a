r"""Forward-simulation apps (reference examples/Simulation.scala:31-96).

  python -m composablestatespacemodels_torch.examples.simulate ornstein \
      --n-obs 5000                                        # SimOrnstein
  python -m composablestatespacemodels_torch.examples.simulate model \
      --n-obs 5000                                        # SimulateModel
  python -m composablestatespacemodels_torch.examples.simulate seasonal \
      --n-obs 5000                                        # SimulateSeasonal
  python -m composablestatespacemodels_torch.examples.simulate lgcp

Add ``--device cpu`` to run without a card.
"""

import argparse
import math

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.examples.common import (
    add_common_args, config_from_args, generator, test_model)
from composablestatespacemodels_torch.models import ou_params, parameters
from composablestatespacemodels_torch.utils import io as cio


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("what", choices=["ornstein", "model", "seasonal", "lgcp"])
    ap.add_argument("--plot", action="store_true",
                    help="also write a PNG figure (R/Plots.R analogue)")
    add_common_args(ap)
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    gen = generator(cfg)

    if args.what == "ornstein":
        sde = ct.ou_process(1)
        p = ou_params(0.0, 1.0, 0.3, 1.0, 0.5)
        ts, xs = sde.simulate(p, gen, 0.0, cfg.dt, cfg.n_obs)
        with open(f"{cfg.out}_ou.csv", "w") as f:
            for t, x in zip(ts.tolist(), xs[:, 0].tolist()):
                f.write(f"{t},{x}\n")
        print(f"wrote {cfg.out}_ou.csv ({cfg.n_obs + 1} rows)")

    elif args.what == "model":
        model, params = test_model()
        sim = ct.simulate_regular(model, params, gen, cfg.n_obs, cfg.dt)
        cio.write_simulated_csv(f"{cfg.out}_sims.csv", sim)
        cio.write_timeseries_json(f"{cfg.out}_sims.json", sim.to_timeseries())
        print(f"wrote {cfg.out}_sims.csv + .json ({cfg.n_obs} rows)")
        if args.plot:
            from composablestatespacemodels_torch.utils import plots
            plots.plot_simulation(sim, f"{cfg.out}_sims.png")
            print(f"wrote {cfg.out}_sims.png")

    elif args.what == "seasonal":
        model = ct.seasonal(24, 3, ct.ou_process(6))
        params = parameters(math.log(1.0),
                            ou_params(0.5, 0.2, 0.25, 0.5, 0.2))
        sim = ct.simulate_regular(model, params, gen, cfg.n_obs, cfg.dt)
        cio.write_simulated_csv(f"{cfg.out}_seasonal.csv", sim)
        print(f"wrote {cfg.out}_seasonal.csv")

    else:  # lgcp
        model = ct.lgcp(ct.brownian_motion(1))
        params = parameters(None, ct.brownian_params(1.0, 0.05, 0.05))
        events, _ = ct.simulate_lgcp(model, params, gen, 0.0, 10.0,
                                     precision=2)
        cio.write_simulated_csv(f"{cfg.out}_lgcp.csv", events)
        print(f"wrote {cfg.out}_lgcp.csv ({len(events)} events)")


if __name__ == "__main__":
    main()
