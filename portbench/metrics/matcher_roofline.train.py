"""The hard window matcher's share of its roofline, in percent: the least
time of a call at the step's shapes (``roofline.window_match_work``) over
the kernel's device time a call in the traced span (launches counted by the
program)."""

from portbench.roofline import bound_s, window_match_work


def read(rec):
    if not (rec.on_card and rec.trace is not None and rec.peaks is not None
            and rec.launches.get("window_match")):
        return None
    seconds = rec.trace.kernel_seconds("window_match_hard") / rec.launches["window_match"]
    if seconds <= 0:
        return None
    s = rec.shapes
    least, _ = bound_s(*window_match_work(s["batch"], s["height"], s["width"], s["window"]),
                       rec.peaks)
    return least / seconds * 100.0
