"""Share of the time the traced scans were in flight (each from the call of
``push_scan`` to its return) in which no kernel, copy or memset ran on the
card, in percent."""

from portbench.stats import idle_share


def read(rec):
    if not rec.on_card or rec.trace is None or rec.kind != "serve":
        return None
    scans = [(e.start, e.end) for e in rec.trace.spans("portbench.scan")]
    if not scans:
        return None
    return idle_share(rec.trace.busy(), scans) * 100.0
