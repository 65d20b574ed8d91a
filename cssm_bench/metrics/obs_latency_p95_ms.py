"""The 95th percentile, over every observation of the window, of the wait
from its hand-off to ``OnlineFilter.step`` until that step's summaries are
read on the host."""

from cssm_bench.stats import latencies_ms, percentile


def read(run):
    lat = latencies_ms(run)
    return percentile(lat, 95.0) if lat else None
