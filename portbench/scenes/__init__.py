"""The scan generator: a spinning LiDAR ray-cast on the device into a scene.

A scene is the module ``scenes/<name>.py``, found by the name a configuration
gives. It defines

- ``poses(n, gen, device) -> (origins [n, 3], rotations [n, 3, 3])``: the
  sensor's path, world from sensor, float64, drawn from ``gen``;
- ``intersect(origins [S, 3], dirs [S, R, 3]) -> (t [S, R], normals
  [S, R, 3])``: the distance along each unit ray to the first surface
  (inf where none) and that surface's unit normal, in the world frame.

The sensor (beams, azimuth steps, elevations, range, noise, dropout) comes
from the configuration. Every scan is cast in float64 on the device in blocks
of scans, with range noise and dropout drawn from the run's seed; normals are
turned toward the sensor. A scan's points are its returns in firing order
(beam-major), as ``[M, 4]`` float32 (x, y, z, intensity) in the sensor frame,
or, for a sensor that reports an organised cloud, every ray with zeros where
nothing returned.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from portbench.weights import sub_seed

BLOCK = 32


class Sensor(NamedTuple):
    beams: int
    azimuth_steps: int
    elevation_deg: Tuple[float, float]
    max_range_m: float
    range_noise_m: float
    azimuth_jitter_rad: float
    dropout: float
    organized: bool

    @classmethod
    def from_config(cls, sensor: Dict) -> "Sensor":
        return cls(int(sensor["beams"]), int(sensor["azimuth_steps"]),
                   tuple(float(v) for v in sensor["elevation_deg"]),
                   float(sensor["max_range_m"]), float(sensor["range_noise_m"]),
                   float(sensor["azimuth_jitter_rad"]), float(sensor["dropout"]),
                   bool(sensor["organized"]))


class Drive(NamedTuple):
    points: List[np.ndarray]      # per scan [M, 4] float32
    normals: List[np.ndarray]     # per scan [M, 3] float32 (none for an organised cloud)
    returned: List[int]           # returns per scan

    def stats(self, rays: int) -> Dict[str, float]:
        n = np.asarray(self.returned, np.float64)
        return {"scans": len(n), "returns_mean": float(n.mean()), "returns_min": int(n.min()),
                "returns_max": int(n.max()), "return_share": float(n.mean() / rays)}


def scene(name: str):
    return importlib.import_module(f"portbench.scenes.{name}")


def rotation_zyx(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """[n, 3, 3]: Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)


def plane(o: torch.Tensor, d: torch.Tensor, axis: int, level: float):
    """Distance along each ray to the plane x[axis] = level (inf if behind)."""
    t = (level - o[:, None, axis]) / d[..., axis]
    return torch.where(t > 0, t, math.inf)


def cylinder(o: torch.Tensor, d: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
             radius: float):
    """Distance along each ray to the vertical cylinder of axis (cx, cy)
    (one centre a scan, [S]) from outside, and its outward normal."""
    ox = (o[:, 0] - cx)[:, None]
    oy = (o[:, 1] - cy)[:, None]
    qa = d[..., 0] ** 2 + d[..., 1] ** 2
    qb = 2 * (ox * d[..., 0] + oy * d[..., 1])
    qc = ox * ox + oy * oy - radius * radius
    disc = qb * qb - 4 * qa * qc
    t = (-qb - torch.sqrt(disc.clamp(min=0))) / (2 * qa)
    t = torch.where((disc > 0) & (t > 0), t, math.inf)
    n = torch.stack([ox + t * d[..., 0], oy + t * d[..., 1], torch.zeros_like(t)], -1) / radius
    return t, n


def nearest(hits):
    """The first surface of each ray over (t, normal) candidates; a normal
    may be a [3] vector shared by every ray."""
    t_best, n_best = None, None
    for t, n in hits:
        n = n.expand(t.shape + (3,)) if n.dim() == 1 else n
        if t_best is None:
            t_best, n_best = t, n.clone()
            continue
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        n_best = torch.where(closer[..., None], n, n_best)
    return t_best, n_best


def ray_directions(sensor: Sensor, device) -> torch.Tensor:
    """[beams * azimuth_steps, 3] unit rays in the sensor frame, beam-major."""
    lo, hi = (math.radians(v) for v in sensor.elevation_deg)
    elev = torch.linspace(lo, hi, sensor.beams, dtype=torch.float64, device=device)
    az = torch.arange(sensor.azimuth_steps, dtype=torch.float64, device=device)
    az = az * (2 * math.pi / sensor.azimuth_steps) - math.pi
    e, a = torch.meshgrid(elev, az, indexing="ij")
    return torch.stack([torch.cos(e) * torch.cos(a), torch.cos(e) * torch.sin(a),
                        torch.sin(e)], -1).reshape(-1, 3)


def generate(scene_name: str, sensor: Sensor, n_scans: int, seed: int, device,
             organized: bool = False) -> Drive:
    """``n_scans`` consecutive scans of a drive drawn from ``seed``; with
    ``organized`` (and a sensor that reports so) every ray of a scan."""
    module = scene(scene_name)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    origins, rotations = module.poses(n_scans, gen, device)
    base = ray_directions(sensor, device)
    rays = base.shape[0]
    organized = organized and sensor.organized
    points, normals, returned = [], [], []
    for s in range(0, n_scans, BLOCK):
        S = min(BLOCK, n_scans - s)
        jitter = torch.rand(S, generator=gen, device=device, dtype=torch.float64)
        jitter = jitter * sensor.azimuth_jitter_rad
        c, si = torch.cos(jitter)[:, None], torch.sin(jitter)[:, None]
        local = torch.stack([base[:, 0] * c - base[:, 1] * si, base[:, 0] * si + base[:, 1] * c,
                             base[:, 2].expand(S, rays)], -1)
        R = rotations[s:s + S]
        world = local @ R.transpose(1, 2)
        t, n = module.intersect(origins[s:s + S], world)
        t = t + sensor.range_noise_m * torch.randn(t.shape, generator=gen, device=device,
                                                   dtype=torch.float64)
        keep = torch.isfinite(t) & (t < sensor.max_range_m)
        if sensor.dropout > 0:
            keep &= torch.rand(t.shape, generator=gen, device=device) >= sensor.dropout
        n = torch.where(((n * world).sum(-1) > 0)[..., None], -n, n)
        n_local = n @ R                                          # world -> sensor frame
        xyz = local * torch.where(keep, t, 0.0)[..., None]
        intensity = torch.rand(t.shape, generator=gen, device=device, dtype=torch.float64)
        pts = torch.cat([xyz, (intensity * keep)[..., None]], -1).float()
        n_local = torch.where(keep[..., None], n_local, 0.0).float()
        counts = keep.sum(-1).tolist()
        returned += counts
        if organized:
            # A stream serves points only: its normals stay on the device.
            points += list(pts.cpu().numpy())
        else:
            p_host = pts[keep].cpu().numpy()
            n_host = n_local[keep].cpu().numpy()
            cuts = np.cumsum(counts)[:-1]
            points += np.split(p_host, cuts)
            normals += np.split(n_host, cuts)
    return Drive(points, normals, returned)
