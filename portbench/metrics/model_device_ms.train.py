"""Device milliseconds of the network's forward and backward alone on one
batch of the cell (the trainer's batch, a surrogate loss), a call, from the
profiler's trace."""


def read(rec):
    return rec.model_device_ms if rec.on_card else None
