"""The placement kernel's share of its roofline under the packed rule (the
warped source's re-projection), in percent: the least time of a call at the
step's shapes (``roofline.placement_work``, 7 channels out) over the
kernels' device time a call in the traced span."""

from portbench.roofline import bound_s, placement_work

KERNELS = ("select_winners", "write_and_reset")


def read(rec):
    if not (rec.on_card and rec.trace is not None and rec.peaks is not None
            and rec.launches.get("placement_packed")):
        return None
    seconds = rec.trace.kernel_seconds(*KERNELS) / rec.launches["placement_packed"]
    if seconds <= 0:
        return None
    s = rec.shapes
    least, _ = bound_s(*placement_work(s["batch"], s["cap"], s["height"], s["width"], 7),
                       rec.peaks)
    return least / seconds * 100.0
