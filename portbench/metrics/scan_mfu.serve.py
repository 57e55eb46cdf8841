"""The serving step's share of the card's dense bf16 peak, in percent: a
scan's forward FLOPs (closed form, ``flops.py``) times the window's scans
over the sum of their latencies."""


def read(rec):
    if rec.kind != "serve" or rec.peaks is None or not rec.latencies:
        return None
    return rec.flops * len(rec.latencies) / sum(rec.latencies) / rec.peaks.bf16_flops * 100.0
