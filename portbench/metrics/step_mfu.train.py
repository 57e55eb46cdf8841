"""The training step's share of the card's dense bf16 peak, in percent: the
network's FLOPs a step (closed form, ``flops.py``) times the steps of the
window (never traced) over its seconds."""


def read(rec):
    if rec.kind != "train" or rec.peaks is None or not rec.window_s:
        return None
    return rec.flops * rec.steps / rec.window_s / rec.peaks.bf16_flops * 100.0
