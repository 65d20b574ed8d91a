"""The summaries' order statistics alone: ``ops.selection``'s
``kth_smallest_bits`` on the cell's own rows, the filter's final cloud and
its eta row ``[d + 1, N]``, with the summary's eight pairs of ranks;
CUDA events around ``REPEATS`` calls after one untimed call, after the
traced run's window."""

import math

import torch

REPEATS = 5


def probe(run):
    filt = run.state.get("filter")
    if filt is None or run.device.type != "cuda":
        return
    from composablestatespacemodels_torch.ops.selection import \
        kth_smallest_bits
    x = filt.particles.T.contiguous()                         # [d, N]
    d, n = x.shape
    g = filt.model.design_vector(filt.t)
    cols = torch.cat([x, filt.model.link(g @ x)[None]])
    k = math.floor(n * float(run.traffic["filter"]["interval"]))
    ks = torch.tensor([[(n - k - 1) % n, (k - 1) % n]] * d
                      + [[min(n - k, n - 1), min(k, n - 1)]],
                      dtype=torch.int32, device=x.device)
    kth_smallest_bits(cols, ks)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPEATS):
        kth_smallest_bits(cols, ks)
    stop.record()
    stop.synchronize()
    run.probes["selection_ms"] = start.elapsed_time(stop) / REPEATS


def read(run):
    return run.probes.get("selection_ms")
