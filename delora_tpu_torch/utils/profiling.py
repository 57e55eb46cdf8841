"""Profiling on ``torch.profiler``: the port of ``delora_tpu/utils/profiling.py``.

- ``trace(log_dir, name)``: a context manager that records the host (CPU)
  and, where a card is present, the device (CUDA) activity of its region and
  writes it as a Chrome trace, ``<log_dir>/<name>.pt.trace.json`` (open it in
  Perfetto or ``chrome://tracing``);
- ``annotate(name)``: a named region inside a trace; the trainer marks each
  step's ``batch`` (the batch gathered or received) and ``train_step``;
- the trainer traces the epochs listed in ``profile_epochs`` into the run's
  artifacts, ``<log_dir>/<experiment>/<run>/artifacts/profile``.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Record the region and write ``<log_dir>/<name>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))


def annotate(name: str):
    """A named region: shows as ``name`` in a trace; costs a few host
    microseconds when no trace is recording."""
    return torch.profiler.record_function(name)
