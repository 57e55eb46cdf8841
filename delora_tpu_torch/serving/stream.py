"""Streaming odometry engine: scan in, (relative transform, accumulated pose,
latency) out.

The port of ``delora_tpu/serving/stream.py``. Each pushed scan is uploaded
as it comes, masked on the device (NaN, zero and range < 0.3 m rows left out
of the placement, as the reference's ``filter_scan`` drops them), projected
once through the placement kernel, and paired with the previous scan's image,
which stays on the device; the model's relative transform is chained by the
integrator. On a CUDA device the network's forward is one replayed CUDA graph a
pair. ``serve_stdin`` speaks the same JSONL protocol as the reference.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from delora_tpu_torch import resolve_device
from delora_tpu_torch.data.kitti import read_velodyne_bin
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.ops.projection import ProjectionSpec, project_image
from delora_tpu_torch.training.checkpoint import deploy_weights, load_checkpoint
from delora_tpu_torch.training.step import forward_pose
from delora_tpu_torch.utils.poses import reorthonormalize_np

MIN_RANGE = 0.3


class OdometryIntegrator:
    """Accumulates T_0_t = T_0_{t-1} @ T_{t-1,t}, re-orthonormalized."""

    def __init__(self):
        self.pose = np.eye(4)

    def integrate(self, relative: np.ndarray) -> np.ndarray:
        self.pose = reorthonormalize_np(self.pose @ relative)
        return self.pose


def _least_square(dtype) -> float:
    """The least ``x*x + y*y + z*z`` of ``dtype`` whose correctly rounded
    square root is at least ``MIN_RANGE`` rounded to ``dtype``."""
    t = dtype(MIN_RANGE)
    s = t * t
    while np.sqrt(s) >= t:
        s = np.nextafter(s, dtype(0))
    while np.sqrt(s) < t:
        s = np.nextafter(s, dtype(np.inf))
    return float(s)


_LEAST_SQUARE = {torch.float32: _least_square(np.float32),
                 torch.float64: _least_square(np.float64)}


def scan_rows(points: np.ndarray) -> np.ndarray:
    """A raw scan ``[M, C>=3]`` as C-contiguous float32 or float64 rows (any
    other dtype as float64, as numpy's norm takes it), copied only when it is
    not so already."""
    points = np.asarray(points)
    if points.dtype != np.float32 and points.dtype != np.float64:
        points = points.astype(np.float64)
    return np.ascontiguousarray(points)


def keep_mask(rows: torch.Tensor) -> torch.Tensor:
    """``[M, C>=3]`` float32 or float64 rows -> ``[M]`` bool: the rows the
    reference's ``filter_scan`` keeps, finite in x, y and z and at range
    ``MIN_RANGE`` or more, bit for bit in the rows' dtype.

    numpy's norm sums ``(x*x + y*y) + z*z``; here each step is its own op, so
    no multiply-add contracts. PyTorch's square root is not correctly rounded
    on every device, so the sum is compared with the least sum whose rounded
    root reaches the limit: the same test, since rounding is monotonic."""
    xyz = rows[:, :3]
    sq = xyz * xyz
    return torch.isfinite(xyz).all(-1) & (sq[:, 0] + sq[:, 1] + sq[:, 2]
                                          >= _LEAST_SQUARE[rows.dtype])


def filter_scan(points: np.ndarray) -> np.ndarray:
    """Drop the rows :func:`keep_mask` leaves out; keep x, y, z."""
    points = scan_rows(points)
    return points[:, :3][keep_mask(torch.from_numpy(points)).numpy()]


def load_serving_checkpoint(path: str) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """-> (embedded config, weights to serve) of a trainer checkpoint
    (``training/checkpoint.py``: its deploy weights, the EMA's when the run
    tracked one, as the reference's stream.py:85-88) or of the older serving
    file ``{"config", "model"}``, which the port no longer writes."""
    payload = load_checkpoint(path)
    if "meta" in payload:
        return payload["meta"]["parameters"], deploy_weights(payload["state"])
    return payload["config"], payload["model"]


class StreamingOdometry:
    """Parameters come from a checkpoint (:func:`load_serving_checkpoint`),
    from ``params`` (a state_dict, for example ``params_from_jax(...)``), or
    else from the seeded default initialisation.

    On a CUDA device the engine captures the network's forward once, when it
    is built (:meth:`_capture`), and ``push_scan`` replays it for every pair;
    on the CPU it runs the forward eagerly and captures nothing. The graphs
    read the model's parameters where they lie, so change the weights in
    place only: ``self.model.load_state_dict`` copies into them and the next
    pair is served with the new weights, while a parameter replaced by
    another tensor (``to``, ``load_state_dict(assign=True)``) or a forward
    patched in Python goes unseen. ``graph_counts`` counts the captures and
    the replays."""

    def __init__(self, config, checkpoint: Optional[str] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None, dataset: str = "kitti"):
        self.device = resolve_device(device)
        self.config = config
        self.dataset = dataset
        self.max_points = int(config[dataset]["max_points"])
        self.pspec = ProjectionSpec.from_config(config, dataset)
        self.model = OdometryModel(ModelConfig.from_config(config))
        if checkpoint:
            params = load_serving_checkpoint(checkpoint)[1]
        if params is not None:
            self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        self._prev_img = None
        self.integrator = OdometryIntegrator()
        self.step_times = {}
        self.filter_counts = {"scans": 0, "over_max_points": 0}
        self.graph_counts = {"captures": 0, "replays": 0}
        self._slots = self._graphs = None      # set by _capture on CUDA
        if self.device.type == "cuda":
            self._capture()

    @torch.no_grad()
    def _capture(self) -> None:
        """Capture :func:`forward_pose` at the configuration's image shape
        ``[1, H, W, 4]`` as two CUDA graphs in one memory pool, over two
        static image slots: graph k reads slot k as the previous image and
        slot 1 - k as the current one, and writes a static ``[4, 4]``.
        Each scan's image is copied into the slot the previous image does not
        hold, so no image is copied twice.

        Three eager calls on the capture stream first settle cuDNN and the
        allocator, as PyTorch's recipe asks. Autocast's weight cache is off
        during the capture, so the bfloat16 casts of the weights are made
        inside the graphs, from the parameters as they are at each replay."""
        shape = (1, self.pspec.height, self.pspec.width, self.model.cfg.in_channels_per_image)
        slots = [torch.zeros(shape, device=self.device) for _ in range(2)]
        graphs, pool = [], None
        cache = torch.is_autocast_cache_enabled()
        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(3):
                    forward_pose(self.model, slots[0], slots[1])
            torch.cuda.current_stream().wait_stream(stream)
            torch.set_autocast_cache_enabled(False)
            try:
                for k in range(2):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool, stream=stream):
                        T = forward_pose(self.model, slots[k], slots[1 - k])
                    pool = graph.pool()
                    graphs.append((graph, T[0]))
                    self.graph_counts["captures"] += 1
            finally:
                torch.set_autocast_cache_enabled(cache)
        self._slots, self._graphs = slots, graphs

    def scan_mask(self, rows: torch.Tensor) -> torch.Tensor:
        """:func:`keep_mask` of one scan's rows, less the kept rows past the
        first ``max_points``; counts the scan in ``filter_counts``."""
        keep = keep_mask(rows)
        self.filter_counts["scans"] += 1
        if rows.shape[0] > self.max_points:
            keep &= torch.cumsum(keep, 0) <= self.max_points
            self.filter_counts["over_max_points"] += 1
        return keep

    @torch.no_grad()
    def push_scan(self, points: np.ndarray):
        """Feed one raw scan; returns (T_rel, T_abs, latency_s) or None for
        the first scan (no pair yet).

        ``step_times`` then holds the host-clock seconds of each step of this
        call. The card runs the projection and the forward asynchronously, so
        "project" and "forward" are the host's time to issue them, and
        "readback" waits for the card to finish both. On a CUDA device
        "forward" is the copy of the image into its slot and the graph's
        replay (:meth:`_capture`).

        The scan goes up as it comes, in its own dtype; the rows that the
        reference's ``filter_scan`` drops, or that pass ``max_points``, are
        masked there (:meth:`scan_mask`), not compacted. The placement sends
        masked rows to no pixel and keeps the lowest index among equal
        ranges, and the kept rows keep their order, so the image (x, y, z
        cast to float32 there, and the range) is the one of the compacted
        scan, bit for bit. "filter" is the host's time to issue the mask."""
        t0 = time.perf_counter()
        rows = torch.from_numpy(scan_rows(points)).to(self.device)
        t1 = time.perf_counter()
        keep = self.scan_mask(rows)
        t2 = time.perf_counter()
        img = project_image(rows[:, :3], keep, self.pspec)[None]
        t3 = time.perf_counter()
        self.step_times = {"upload": t1 - t0, "filter": t2 - t1, "project": t3 - t2}
        prev = self._prev_img
        if self._graphs is not None:
            k = 1 if prev is self._slots[0] else 0
            img = self._slots[k].copy_(img)
        self._prev_img = img
        if prev is None:
            return None
        if self._graphs is None:
            T = forward_pose(self.model, prev, img)[0]
        else:
            graph, T = self._graphs[1 - k]
            with record_function("serving.forward_graph"):
                graph.replay()
            self.graph_counts["replays"] += 1
        t4 = time.perf_counter()
        T = T.cpu().numpy()
        t5 = time.perf_counter()
        pose = self.integrator.integrate(T)
        t6 = time.perf_counter()
        self.step_times.update(forward=t4 - t3, readback=t5 - t4, integrate=t6 - t5)
        return T, pose, t6 - t0

    def serve_stdin(self):
        """JSONL protocol: {"scan": "<path .npy|.bin>"} per line ->
        {"relative": [...], "pose": [...], "latency_ms": x} per line."""
        print(json.dumps({"ready": True, "dataset": self.dataset}), flush=True)
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                path = json.loads(line)["scan"]
                scan = read_velodyne_bin(path) if path.endswith(".bin") else np.load(path)
                out = self.push_scan(np.asarray(scan, np.float32))
                if out is None:
                    print(json.dumps({"first_scan": True}), flush=True)
                    continue
                T, pose, latency = out
                print(json.dumps({
                    "relative": np.round(T, 6).tolist(),
                    "pose": np.round(pose, 6).tolist(),
                    "latency_ms": round(latency * 1000, 2),
                }), flush=True)
            except Exception as e:  # the serve loop must not die on one bad scan
                print(json.dumps({"error": str(e)}), flush=True)
