"""95th percentile of the latency of every scan of the window, from its due
time to the return of ``push_scan`` (host clock). A per-layer reading: the
tail of 300 scans follows the host's speed, which moves by more between runs
than an end-to-end bound can hold."""

from portbench.stats import percentile


def read(rec):
    if rec.kind != "serve" or not rec.latencies:
        return None
    return percentile(rec.latencies, 95) * 1e3
