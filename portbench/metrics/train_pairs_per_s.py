"""Scan pairs of the whole epochs run in the window over the window's
seconds (host clock; each epoch ends in the trainer's readback)."""


def read(rec):
    if rec.kind != "train" or not rec.window_s:
        return None
    return rec.pairs / rec.window_s
