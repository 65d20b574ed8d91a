#!/usr/bin/env python3
"""``pmmh_monitored`` against ``pmmh`` on one CUDA card, in one fresh process.

    python3 scripts/torch_pmmh_monitored_probe.py

The flagship at PMMH's shape (N = 100, T = 400, ``make_pf_loglik``: K1 +
K4 per step, ``perturb(0.05)``), 40 iterations a run, host clock ending
in a host read, in the rounds plain, monitored, monitored with a
checkpoint a chunk, plain (``pmmh``; ``pmmh_monitored`` in chunks of 20),
twice.  Then the same round once more after each of two changes of the
process's state that ``chip_smoke.py``'s earlier phases leave behind:
1 GiB device tensors allocated and freed up to 24 GiB (the caching
allocator's segments), and two million live Python objects (the garbage
collector's older generations).  Prints iters/s per run, the card's name
and power limit, and last one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ITERS, CHUNK = 40, 20


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import composablestatespacemodels_torch as ct
    from chip_smoke import N_PMMH, T_PMMH, _device_line, flagship
    from composablestatespacemodels_torch.models import perturb
    from composablestatespacemodels_torch.utils.streaming import (
        pmmh_monitored)

    dev = torch.device("cuda", 0)
    model, params = flagship()
    data = ct.simulate_regular(model, params,
                               torch.Generator(device=dev).manual_seed(0),
                               T_PMMH, dt=1.0).to_timeseries()
    pf = ct.make_pf_loglik(model, data, N_PMMH)
    prop = perturb(0.05)
    tmp = tempfile.TemporaryDirectory()

    def plain(seed):
        return ct.pmmh(torch.Generator(device=dev).manual_seed(seed),
                       params, pf, prop, ITERS)

    def monitored(seed, checkpoint=False):
        path = (os.path.join(tmp.name, f"c{seed}.npz") if checkpoint
                else None)
        return pmmh_monitored(torch.Generator(device=dev).manual_seed(seed),
                              params, pf, prop, ITERS, chunk_size=CHUNK,
                              checkpoint_path=path, out=io.StringIO())

    variants = {"plain": plain, "monitored": monitored,
                "monitored+checkpoint": lambda s: monitored(s, True)}

    def timed(name, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(variants[name](seed).lls.sum())
        return ITERS / (time.perf_counter() - t0)

    timed("plain", 1)           # warm-up
    timed("monitored", 2)
    rates = {k: [] for k in variants}
    order = ("plain", "monitored", "monitored+checkpoint", "plain")
    seed = 10
    for _ in range(2):
        for name in order:
            rates[name].append(timed(name, seed))
            seed += 1
    after = {}
    blocks = [torch.empty(2 ** 28, device=dev) for _ in range(24)]
    del blocks
    after["after 24 GiB allocated and freed"] = {
        n: timed(n, seed + i) for i, n in enumerate(variants)}
    keep = [[i] for i in range(2_000_000)]
    after["with 2e6 live Python objects"] = {
        n: timed(n, seed + 10 + i) for i, n in enumerate(variants)}
    del keep
    tmp.cleanup()
    line = _device_line()
    for name, vals in rates.items():
        print(f"{name}: {[round(v, 2) for v in vals]} iters/s (median "
              f"{statistics.median(vals):.2f})", flush=True)
    for what, vals in after.items():
        print(f"{what}: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      vals.items()), flush=True)
    print(line, flush=True)
    print(json.dumps({"iters_per_s": rates, "after": after,
                      "device": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
