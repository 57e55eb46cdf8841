"""Host milliseconds a step inside the trainer's own ``train_step`` region
(``Trainer.train_epoch``), the mean over the traced span's steps."""


def read(rec):
    if rec.trace is None:
        return None
    steps = rec.trace.spans("train_step")
    if not steps:
        return None
    return sum(e.end - e.start for e in steps) / len(steps) * 1e3
