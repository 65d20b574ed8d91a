"""The median of the same waits as ``obs_latency_p95_ms``, every
observation of the untraced window."""

from cssm_bench.stats import latencies_ms, percentile


def read(run):
    lat = latencies_ms(run)
    return percentile(lat, 50.0) if lat else None
