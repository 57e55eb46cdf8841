"""Serving traffic: one sensor stream through
``StreamingOdometry.push_scan``, open loop at the sensor's rate.

Set-up makes ``warmup_scans + rate_hz * seconds`` scans of one drive from the
seed (plus ``trace_scans`` in a traced run) as the sensor reports them, builds
the engine on the benchmark's weights and pushes the warm-up scans back to
back. In the window scan k is due at t0 + k / rate_hz; its latency runs from
its due time to the return of ``push_scan``, so a late start counts. A scan
fails when it returns no pose, a pose that is not finite or not rigid, or
comes back past ``deadline_ms`` (the next scan has arrived).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, scenes, stats, trace
from portbench.context import Context, log
from portbench.reference import compare, serve as ref_serve
from portbench.roofline import peaks

RIGID_TOLERANCE = 1e-3


def _wait(until: float) -> None:
    while True:
        left = until - time.perf_counter()
        if left <= 0:
            return
        if left > 2e-3:
            time.sleep(left - 1e-3)


def _rigid(T) -> bool:
    if T is None or T.shape != (4, 4) or not np.isfinite(T).all():
        return False
    R = T[:3, :3].astype(np.float64)
    err = max(np.abs(R.T @ R - np.eye(3)).max(), abs(np.linalg.det(R) - 1.0))
    return err <= RIGID_TOLERANCE and np.allclose(T[3], [0.0, 0.0, 0.0, 1.0])


class Altered:
    """A fault planted where the answer is produced: one forward's
    translation moved by 5 cm."""

    def __init__(self, net, call: int):
        self.net, self.call, self.n = net, call, 0
        net.forward = self.forward

    def forward(self, *args, **kwargs):
        translation, rotation = type(self.net).forward(self.net, *args, **kwargs)
        self.n += 1
        if self.n == self.call:
            translation = translation + 0.05
        return translation, rotation


def setup(ctx: Context) -> SimpleNamespace:
    from delora_tpu_torch.serving.stream import StreamingOdometry

    tr = ctx.traffic
    rate = float(tr["rate_hz"])
    n_window = int(round(rate * ctx.seconds))
    n_warm = int(tr["warmup_scans"])
    n_span = int(tr["trace_scans"]) if ctx.trace else 0
    sensor = scenes.Sensor.from_config(ctx.config["sensor"])
    drive = scenes.generate(ctx.config["scene"], sensor, n_warm + n_window + n_span, ctx.seed,
                            ctx.device, organized=True)
    log(f"generator: {ctx.config['scene']} {drive.stats(sensor.beams * sensor.azimuth_steps)}, "
        f"{drive.points[0].shape[0]} rows a scan, at {ctx.elapsed():.3f} s")
    if ctx.device.type == "cuda":
        # The ray-cast's scratch memory goes back, and the peak counts from
        # here: ``memory_peak_bytes`` is the program's.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    engine = StreamingOdometry(ctx.program_config(), params=ctx.weights(), device=ctx.device,
                               dataset=ctx.dataset)
    if ctx.variant == "altered":
        Altered(engine.model, n_warm + 1)
    st = SimpleNamespace(engine=engine, drive=drive, relative=[], poses=[], n_warm=n_warm,
                         n_window=n_window, n_span=n_span, rate=rate, next=0)
    log(f"engine built at {ctx.elapsed():.3f} s")
    for _ in range(n_warm):
        _push(st)
    log(f"{n_warm} warm-up scans done at {ctx.elapsed():.3f} s")
    return st


def _push(st):
    out = st.engine.push_scan(st.drive.points[st.next])
    st.next += 1
    if out is not None:
        st.relative.append(np.asarray(out[0], np.float64))
        st.poses.append(np.asarray(out[1], np.float64))
    return out


def _stream(ctx: Context, st, n: int, mark: bool = False):
    """``n`` scans at the sensor's rate -> (latencies, lateness, step times,
    failures)."""
    from torch.profiler import record_function

    deadline = float(ctx.traffic["deadline_ms"]) * 1e-3
    latencies, late, steps, failed = [], [], [], 0
    t0 = time.perf_counter()
    for j in range(n):
        due = t0 + j / st.rate
        _wait(due)
        start = time.perf_counter()
        if mark:
            with record_function("portbench.scan"):
                out = _push(st)
        else:
            out = _push(st)
        done = time.perf_counter()
        latencies.append(done - due)
        late.append(start - due)
        steps.append(dict(st.engine.step_times))
        if out is None or not _rigid(out[0]) or done - due > deadline:
            failed += 1
    return latencies, late, steps, failed


def window(ctx: Context, st, rec) -> None:
    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.t_start
    rec.latencies, rec.late, rec.step_times, rec.failed = _stream(ctx, st, st.n_window)
    rec.window_s = time.perf_counter() - t0
    rec.attempted = st.n_window
    rec.kind = "serve"
    spec = st.engine.pspec
    rec.flops = flops.forward_flops(ctx.arch, 1, spec.height, spec.width)
    rec.shapes = {"batch": 1, "height": spec.height, "width": spec.width}
    if ctx.device.type == "cuda":
        rec.peaks = peaks(torch.cuda.get_device_name(ctx.device))
    thirds = [stats.percentile(part, 50) * 1e3
              for part in np.array_split(np.asarray(rec.latencies), 3)]
    parts = {k: round(float(np.mean([s[k] for s in rec.step_times if k in s])) * 1e3, 4)
             for k in rec.step_times[-1]}
    log(f"window: {st.n_window} scans in {rec.window_s:.3f} s; generator late by p50 "
        f"{stats.percentile(rec.late, 50) * 1e3:.4f} ms, max {max(rec.late) * 1e3:.4f} ms; "
        f"latency p50 by third of the window {[round(x, 3) for x in thirds]} ms; mean ms of "
        f"push_scan's parts {parts}")


def span(ctx: Context, st, rec) -> None:
    """The traced span: ``trace_scans`` more scans at the sensor's rate under
    the profiler, each marked ``portbench.scan``."""
    from torch.profiler import record_function

    from delora_tpu_torch.ops.cuda.placement import placement

    from_scan = st.next
    before = placement.launches_exact

    def scans():
        with record_function("portbench.window"):
            return _stream(ctx, st, st.n_span, mark=True)

    rec.trace, (_, _, _, failed) = trace.profile(scans, f"{ctx.cell.name}-{ctx.seed}")
    rec.launches = {"placement_exact": placement.launches_exact - before}
    rec.attempted += st.n_span
    rec.failed += failed
    max_points = ctx.max_points
    rec.shapes["points"] = float(np.mean([
        min(len(ref_serve.filtered(torch.from_numpy(p), max_points)), max_points)
        for p in st.drive.points[from_scan:st.next]]))


def outputs(ctx: Context, st) -> SimpleNamespace:
    out = SimpleNamespace(relative=np.stack(st.relative), poses=np.stack(st.poses),
                          drive=st.drive)
    st.engine = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def reference(ctx: Context, out, quant=None, nhwc: bool = False) -> SimpleNamespace:
    """The reference's transform of every pair the program answered, the
    poses they chain to, and the same network's transforms in bfloat16 (how
    far rounding alone moves each); with ``quant``, in the control's
    precision; with ``nhwc``, in bfloat16 with NHWC activations (calibration:
    another sound computation of the configuration)."""
    points = out.drive.points[:len(out.relative) + 1]
    scans: List[torch.Tensor] = [torch.from_numpy(p).to(ctx.device) for p in points]
    rel = ref_serve.relative_poses(ctx.weights(), scans, ctx.spec, ctx.arch, ctx.max_points,
                                   quant, autocast=torch.bfloat16 if nhwc else None,
                                   channels_last=nhwc)
    rounded = ref_serve.relative_poses(ctx.weights(), scans, ctx.spec, ctx.arch,
                                       ctx.max_points, autocast=torch.bfloat16)
    return SimpleNamespace(relative=rel, poses=_chain(rel), rounded=rounded, drive=out.drive)


def _chain(relative: np.ndarray) -> np.ndarray:
    poses, pose = [], np.eye(4)
    for T in relative:
        pose = pose @ T
        poses.append(pose)
    return np.stack(poses)


def compare_outputs(subject, ref) -> Dict[str, float]:
    return compare.serving(subject.relative, subject.poses, ref.relative, ref.rounded)


def drain(st) -> None:
    """Push the rest of the drive back to back (calibration: the poses do
    not depend on the timing)."""
    while st.next < len(st.drive.points):
        _push(st)
