"""Mean host milliseconds a scan of the window from issuing the network's
forward to holding its transform on the host (the program's
``step_times["forward"] + step_times["readback"]``)."""


def read(rec):
    steps = [s for s in (rec.step_times or []) if "forward" in s]
    if rec.kind != "serve" or not steps:
        return None
    return sum(s["forward"] + s["readback"] for s in steps) / len(steps) * 1e3
