"""Mean host milliseconds of ``filter_scan`` a scan of the window (the
program's ``step_times["filter"]``)."""


def read(rec):
    if rec.kind != "serve" or not rec.step_times:
        return None
    return sum(s["filter"] for s in rec.step_times) / len(rec.step_times) * 1e3
