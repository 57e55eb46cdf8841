"""Median latency of every scan of the window, from its due time to the
return of ``push_scan`` (host clock)."""

from portbench.stats import percentile


def read(rec):
    if rec.kind != "serve" or not rec.latencies:
        return None
    return percentile(rec.latencies, 50) * 1e3
