"""A short profiled span: ``torch.profiler`` over CPU and CUDA activity, its
Chrome trace written under ``TMPDIR`` and read back.

The harness marks its own spans with ``record_function`` (``portbench.*``),
around its calls into the program; the program marks its own (the trainer's
``batch`` and ``train_step``). On the device every kernel, copy and memset
counts as busy.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Tuple

from portbench import stats

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
NAME_CHARS = 96


class Event(NamedTuple):
    name: str
    start: float     # seconds, the trace's clock
    end: float
    tid: int


class Trace(NamedTuple):
    device: List[Event]
    host: List[Event]

    def spans(self, name: str) -> List[Event]:
        return [e for e in self.host if e.name == name]

    def busy(self) -> List[stats.Interval]:
        return stats.union((e.start, e.end) for e in self.device)

    def kernel_seconds(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds any of ``parts``."""
        return sum(e.end - e.start for e in self.device if any(p in e.name for p in parts))

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            total[e.name[:NAME_CHARS]] += e.end - e.start
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, window: stats.Interval, thread: int, n: int = 10) -> List[List]:
        """Device-idle time within ``window`` by what the host thread was
        doing at the middle of each gap: the innermost op or span running,
        else "python"; summed by name, the longest first."""
        host = sorted((e for e in self.host if e.tid == thread), key=lambda e: (e.start, -e.end))
        total: Dict[str, float] = collections.defaultdict(float)
        stack: List[Event] = []
        i = 0
        for lo, hi in stats.gaps(self.busy(), window):
            mid = 0.5 * (lo + hi)
            while i < len(host) and host[i].start <= mid:
                while stack and stack[-1].end <= host[i].start:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1].end <= mid:
                stack.pop()
            total[stack[-1].name[:NAME_CHARS] if stack else "python"] += hi - lo
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def read(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        ev = Event(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                   int(e.get("tid", 0)) if str(e.get("tid", 0)).lstrip("-").isdigit() else 0)
        if cat in DEVICE_CATEGORIES:
            device.append(ev)
        elif cat in HOST_CATEGORIES:
            host.append(ev)
    return Trace(device, host)


def profile(fn, name: str) -> Tuple[Trace, object]:
    """Run ``fn()`` under the profiler -> (its trace, what ``fn`` returned).
    The Chrome trace is written to ``$TMPDIR/portbench-<name>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    path = os.path.join(tempfile.gettempdir(), f"portbench-{name}.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        return read(path), out
    finally:
        os.remove(path)
