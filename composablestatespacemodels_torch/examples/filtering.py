r"""Particle filtering with per-step credible intervals
(reference examples/Filtering.scala:16-33).

  python -m composablestatespacemodels_torch.examples.simulate model --out data
  python -m composablestatespacemodels_torch.examples.filtering \
      data_sims.json --n-particles 1000

Add ``--device cpu`` to run without a card.  ``--mesh`` shards the
particle cloud over every rank: under torchrun (``python -m
torch.distributed.run --nproc-per-node=2 -m
composablestatespacemodels_torch.examples.filtering ... --mesh``) over its
ranks, NCCL on cards and gloo with ``--device cpu``; under plain ``python
-m`` over a world of one.  Rank 0 writes the files.
"""

import argparse

import torch
import torch.distributed

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.examples.common import (
    add_common_args, config_from_args, generator, test_model)
from composablestatespacemodels_torch.utils import io as cio


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data", help="line-delimited JSON observations")
    ap.add_argument("--plot", action="store_true",
                    help="also write a filtered-ribbon PNG (R/Plots.R:58-75)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the particle cloud over every rank "
                         "(distributed systematic resampling)")
    add_common_args(ap)
    args = ap.parse_args(argv)
    cfg = config_from_args(args)

    mesh = None
    if args.mesh:
        from composablestatespacemodels_torch.parallel import (
            initialize_distributed, particle_mesh)
        initialize_distributed(cfg.device)
        mesh = particle_mesh(torch.device(cfg.device).type)
        print(f"mesh: {mesh.size()} rank(s) on the particle axis")
    model, params = test_model()
    data = cio.read_timeseries_json(args.data, device=cfg.device)
    res = ct.bootstrap_filter(model, params, data, cfg.n_particles,
                              generator(cfg), resample=cfg.resample,
                              store="summary", mesh=mesh)
    if mesh is not None and torch.distributed.get_rank() != 0:
        return
    s = res.summary
    cols = [s.ts, s.eta_mean, s.eta_lower, s.eta_upper]
    cols = [c.tolist() for c in cols]
    state, ess = s.state_mean.tolist(), res.ess.tolist()
    path = f"{cfg.out}_filtered.csv"
    with open(path, "w") as f:
        for i in range(len(data)):
            row = [c[i] for c in cols] + state[i] + [ess[i]]
            f.write(",".join(str(float(v)) for v in row) + "\n")
    print(f"ll = {float(res.ll):.3f}; wrote {path}")
    if args.plot:
        from composablestatespacemodels_torch.utils import plots
        plots.plot_filtering(s, data, f"{cfg.out}_filtered.png")
        print(f"wrote {cfg.out}_filtered.png")


if __name__ == "__main__":
    main()
