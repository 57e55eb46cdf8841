"""Streaming odometry engine: scan in, (relative transform, accumulated pose,
latency) out.

The port of ``delora_tpu/serving/stream.py``. Each pushed scan is filtered
(NaN, zero and range < 0.3 m points dropped), projected once on the device
through the placement kernel, and paired with the previous scan's image, which
stays on the device; the model's relative transform is chained by the
integrator. ``serve_stdin`` speaks the same JSONL protocol as the reference.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

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


def filter_scan(points: np.ndarray) -> np.ndarray:
    """Drop NaN/zero points and range < 0.3 m; keep x, y, z."""
    points = points[:, :3]
    finite = np.isfinite(points).all(axis=-1)
    r = np.linalg.norm(points, axis=-1)
    keep = finite & (r >= MIN_RANGE)
    return points[keep]


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
    else from the seeded default initialisation."""

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

    @torch.no_grad()
    def push_scan(self, points: np.ndarray):
        """Feed one raw scan; returns (T_rel, T_abs, latency_s) or None for
        the first scan (no pair yet).

        ``step_times`` then holds the host-clock seconds of each step of this
        call. The card runs the projection and the forward asynchronously, so
        "project" and "forward" are the host's time to issue them, and
        "readback" waits for the card to finish both."""
        t0 = time.perf_counter()
        pts = np.ascontiguousarray(filter_scan(points)[: self.max_points], np.float32)
        t1 = time.perf_counter()
        pts = torch.from_numpy(pts).to(self.device)
        t2 = time.perf_counter()
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=self.device)
        img = project_image(pts, valid, self.pspec)[None]
        t3 = time.perf_counter()
        self.step_times = {"filter": t1 - t0, "upload": t2 - t1, "project": t3 - t2}
        if self._prev_img is None:
            self._prev_img = img
            return None
        T = forward_pose(self.model, self._prev_img, img)[0]
        t4 = time.perf_counter()
        T = T.cpu().numpy()
        t5 = time.perf_counter()
        self._prev_img = img
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
