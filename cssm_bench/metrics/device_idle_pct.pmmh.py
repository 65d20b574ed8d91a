"""The share of the traced window in which the card ran nothing: 100 *
(1 - busy_s / window_s), busy_s the union of every kernel, copy and fill
interval (``cssm_bench.trace``)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
