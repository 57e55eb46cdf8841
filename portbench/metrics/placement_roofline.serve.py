"""The placement kernel's share of its roofline under the exact rule (one
scan's range image), in percent: the least time of a call for the traced
scans' mean point count (``roofline.placement_work``, 4 channels out) over
the kernels' device time a call in the traced span."""

from portbench.roofline import bound_s, placement_work

KERNELS = ("select_winners", "write_and_reset")


def read(rec):
    if not (rec.on_card and rec.trace is not None and rec.peaks is not None
            and rec.launches.get("placement_exact")):
        return None
    seconds = rec.trace.kernel_seconds(*KERNELS) / rec.launches["placement_exact"]
    if seconds <= 0:
        return None
    s = rec.shapes
    least, _ = bound_s(*placement_work(1, s["points"], s["height"], s["width"], 4), rec.peaks)
    return least / seconds * 100.0
