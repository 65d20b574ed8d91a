r"""Missing-data interpolation (reference examples/Interpolate.scala:10-53):
knock out observations in a window, reconstruct them with the path-storing
particle filter, write smoothed credible intervals.

  python -m composablestatespacemodels_torch.examples.interpolate \
      --knock-lo 420 --knock-hi 450

Add ``--device cpu`` to run without a card.
"""

import argparse

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.examples.common import (
    add_common_args, config_from_args, generator, test_model)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--knock-lo", type=float, default=420.0)
    ap.add_argument("--knock-hi", type=float, default=450.0)
    add_common_args(ap)
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    gen = generator(cfg)

    model, params = test_model()
    sim = ct.simulate_regular(model, params, gen, cfg.n_obs, cfg.dt)
    data = sim.to_timeseries().knock_out(args.knock_lo, args.knock_hi)

    res = ct.interpolation_filter(model, params, data, cfg.n_particles, gen,
                                  resample=cfg.resample)
    cols = [c.tolist() for c in (res.ts, res.eta_mean, res.eta_lower,
                                 res.eta_upper, data.mask.float())]
    path = f"{cfg.out}_interpolated.csv"
    with open(path, "w") as f:
        for i in range(len(data)):
            f.write(",".join(str(float(c[i])) for c in cols) + "\n")
    print(f"ll = {float(res.ll):.3f}; wrote {path}")


if __name__ == "__main__":
    main()
