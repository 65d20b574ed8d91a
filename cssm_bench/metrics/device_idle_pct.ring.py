"""The share of rank 0's traced window in which card 0 ran nothing: 100 *
(1 - busy_s / window_s), busy_s the union of every kernel, copy and fill
interval (``cssm_bench.trace``), NCCL's kernels among them, so that a
card waiting inside a collective for a slower rank counts as busy."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
