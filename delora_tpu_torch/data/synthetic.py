"""Synthetic LiDAR world simulator: structured scenes and ray-cast scans.

The port's copy of ``delora_tpu/data/synthetic.py`` (numpy only), so that
the port makes KITTI-layout drives (velodyne .bin scans and ground-truth pose
files) without the JAX package; for the same arguments its files are byte for
byte the reference writer's. The scenes (a ground plane, box walls, axis
aligned or yawed) give the geometric losses planar regions with normals, so
point-to-plane alignment has a well-defined optimum at the true pose.

Sensor model, HDL-64-like: ``rings`` elevation angles spanning the vertical
field of view, ``azimuth_steps`` horizontal rays, additive range noise, a
maximum range.

``write_kitti_layout`` forks a process pool when more than 8 scans are
missing. A process that has initialised CUDA must not fork: call it from a
fresh process there (``python -c ...``), as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from delora_tpu_torch.utils.poses import TRANSFORM_LIDAR_TO_WORLD


class PlaneSegment:
    """Axis-aligned rectangle: plane n.x = d bounded in the other two axes."""

    def __init__(self, axis: int, offset: float, lo: Tuple[float, float],
                 hi: Tuple[float, float]):
        self.axis = axis        # normal axis (0=x, 1=y, 2=z)
        self.offset = offset
        self.lo = lo            # bounds over the two remaining axes
        self.hi = hi

    def intersect(self, origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        """Ray-plane hit distances, +inf if miss. origins/dirs: [N, 3]."""
        denom = dirs[:, self.axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (self.offset - origins[:, self.axis]) / denom
        t = np.where(np.abs(denom) < 1e-9, np.inf, t)
        hit = origins + t[:, None] * dirs
        other = [i for i in range(3) if i != self.axis]
        inside = (
            (hit[:, other[0]] >= self.lo[0]) & (hit[:, other[0]] <= self.hi[0])
            & (hit[:, other[1]] >= self.lo[1]) & (hit[:, other[1]] <= self.hi[1])
        )
        return np.where((t > 0.1) & inside, t, np.inf)


class RotatedPlaneSegment:
    """Finite rectangle with arbitrary orientation: center ``c``, unit normal
    ``n``, orthonormal in-plane axes ``a1, a2`` with half-extents ``h1, h2``.

    Generalizes :class:`PlaneSegment` beyond axis-aligned geometry — needed
    because an axis-aligned world puts every wall normal in {±x, ±y}, which
    leaves the point-to-plane objective degenerate along any direction not
    spanned densely (the projective-ICP sliding failure measured on the
    880 m corridor world, docs/BENCH_NOTES.md r17). Yawed walls spread
    normals over all azimuths, conditioning translation in the whole plane.
    """

    def __init__(self, center, normal, a1, a2, h1: float, h2: float):
        self.center = np.asarray(center, np.float64)
        self.normal = np.asarray(normal, np.float64)
        self.a1 = np.asarray(a1, np.float64)
        self.a2 = np.asarray(a2, np.float64)
        self.h1 = float(h1)
        self.h2 = float(h2)

    def intersect(self, origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        denom = dirs @ self.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((self.center - origins) @ self.normal) / denom
        t = np.where(np.abs(denom) < 1e-9, np.inf, t)
        hit = origins + t[:, None] * dirs - self.center
        inside = (np.abs(hit @ self.a1) <= self.h1) & (
            np.abs(hit @ self.a2) <= self.h2
        )
        return np.where((t > 0.1) & inside, t, np.inf)

    def bounding_sphere(self):
        return self.center, float(np.hypot(self.h1, self.h2))


def _segment_bounding_sphere(seg):
    if hasattr(seg, "bounding_sphere"):
        return seg.bounding_sphere()
    lo = np.asarray(seg.lo, np.float64)
    hi = np.asarray(seg.hi, np.float64)
    other = [i for i in range(3) if i != seg.axis]
    center = np.zeros(3)
    center[seg.axis] = seg.offset
    center[other[0]] = (lo[0] + hi[0]) / 2
    center[other[1]] = (lo[1] + hi[1]) / 2
    return center, float(np.linalg.norm(hi - lo)) / 2


def _add_box_yawed(world, cx: float, cy: float, w: float, d: float,
                   h: float, yaw: float, floor: float = -1.8) -> None:
    """Four vertical walls of a box rotated by ``yaw`` about z."""
    c, s = np.cos(yaw), np.sin(yaw)
    ex = np.array([c, s, 0.0])            # box x axis in world
    ey = np.array([-s, c, 0.0])           # box y axis in world
    ez = np.array([0.0, 0.0, 1.0])
    zc = floor + h / 2
    center = np.array([cx, cy, zc])
    for sign in (-1.0, 1.0):
        world.append(RotatedPlaneSegment(
            center + sign * ex * (w / 2), ex, ey, ez, d / 2, h / 2))
        world.append(RotatedPlaneSegment(
            center + sign * ey * (d / 2), ey, ex, ez, w / 2, h / 2))


def make_world(seed: int = 0, extent: float = 60.0, n_boxes: int = 24
               ) -> List[PlaneSegment]:
    """Ground plane + random boxes (walls perpendicular to x/y)."""
    rng = np.random.default_rng(seed)
    world: List[PlaneSegment] = [
        PlaneSegment(2, -1.8, (-extent * 4, -extent), (extent * 4, extent)),
    ]
    for _ in range(n_boxes):
        cx = rng.uniform(-extent, extent * 3)
        cy = rng.uniform(-extent * 0.8, extent * 0.8)
        if abs(cy) < 4.0:
            cy += np.sign(cy or 1.0) * 6.0   # keep the corridor clear
        w, d, h = rng.uniform(1.5, 8.0, size=3)
        h = min(h, 4.0)
        world.append(PlaneSegment(0, cx - w / 2, (cy - d / 2, -1.8),
                                  (cy + d / 2, -1.8 + h)))
        world.append(PlaneSegment(0, cx + w / 2, (cy - d / 2, -1.8),
                                  (cy + d / 2, -1.8 + h)))
        world.append(PlaneSegment(1, cy - d / 2, (cx - w / 2, -1.8),
                                  (cx + w / 2, -1.8 + h)))
        world.append(PlaneSegment(1, cy + d / 2, (cx - w / 2, -1.8),
                                  (cx + w / 2, -1.8 + h)))
    return world


def _add_box(world: List[PlaneSegment], cx: float, cy: float,
             w: float, d: float, h: float) -> None:
    world.append(PlaneSegment(0, cx - w / 2, (cy - d / 2, -1.8),
                              (cy + d / 2, -1.8 + h)))
    world.append(PlaneSegment(0, cx + w / 2, (cy - d / 2, -1.8),
                              (cy + d / 2, -1.8 + h)))
    world.append(PlaneSegment(1, cy - d / 2, (cx - w / 2, -1.8),
                              (cx + w / 2, -1.8 + h)))
    world.append(PlaneSegment(1, cy + d / 2, (cx - w / 2, -1.8),
                              (cx + w / 2, -1.8 + h)))


def make_world_along(traj: np.ndarray, n_boxes: int = 200, seed: int = 0,
                     lateral: Tuple[float, float] = (8.0, 60.0),
                     yawed: bool = False) -> List[PlaneSegment]:
    """World whose geometry FOLLOWS a trajectory: a ground plane covering the
    path's bounding box (+ sensor range margin) and boxes scattered at
    lateral offsets from random path points, so arbitrarily long drives
    (the >= 800 m KITTI-metric experiments) keep structure in sensor range
    for the whole sequence — ``make_world``'s fixed-extent scatter empties
    out past ~240 m.

    ``yawed=True`` rotates every box by a random yaw: axis-aligned worlds put
    all wall normals in {±x, ±y}, leaving the point-to-plane objective
    degenerate along unrepresented directions (the r17 sliding failure);
    yawed walls spread normals over all azimuths like real street scenes.
    """
    rng = np.random.default_rng(seed)
    xy = traj[:, :2, 3]
    lo = xy.min(axis=0) - 100.0
    hi = xy.max(axis=0) + 100.0
    world: List[PlaneSegment] = [
        PlaneSegment(2, -1.8, (lo[0], lo[1]), (hi[0], hi[1])),
    ]
    for _ in range(n_boxes):
        k = int(rng.integers(len(traj)))
        side = rng.choice([-1.0, 1.0])
        offset = rng.uniform(*lateral) * side
        heading = traj[k, :2, 0]                    # forward axis in world
        normal = np.array([-heading[1], heading[0]])
        c = xy[k] + normal * offset + rng.uniform(-10, 10, size=2)
        w, d, h = rng.uniform(1.5, 8.0, size=3)
        if yawed:
            _add_box_yawed(world, float(c[0]), float(c[1]), w, d,
                           min(h, 4.0), float(rng.uniform(0.0, np.pi / 2)))
        else:
            _add_box(world, float(c[0]), float(c[1]), w, d, min(h, 4.0))
    return world


def cull_world(world: List[PlaneSegment], origin: np.ndarray,
               max_range: float) -> List[PlaneSegment]:
    """Segments whose bounding sphere intersects the sensor range ball.

    Ray casting is O(rays x segments); a trajectory-following world for an
    800 m drive has ~10k segments of which only a few hundred are within
    sensor range of any one pose — culling makes long-sequence generation
    ~10x faster with identical output (a culled segment cannot produce a
    hit within max_range)."""
    keep = []
    for seg in world:
        center, radius = _segment_bounding_sphere(seg)
        if np.linalg.norm(center - origin) <= max_range + radius:
            keep.append(seg)
    return keep


def simulate_scan(
    world: List[PlaneSegment],
    pose: np.ndarray,                 # [4, 4] sensor -> world
    rings: int = 32,
    azimuth_steps: int = 900,
    v_fov=(-24.5, 2.0),
    max_range: float = 80.0,
    noise: float = 0.01,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """-> [M, 3] hit points in the SENSOR frame."""
    rng = rng or np.random.default_rng(0)
    if len(world) > 512:
        world = cull_world(world, np.asarray(pose[:3, 3], np.float64),
                           max_range)
    elev = np.deg2rad(np.linspace(v_fov[0], v_fov[1], rings))
    azim = np.linspace(-np.pi, np.pi, azimuth_steps, endpoint=False)
    E, A = np.meshgrid(elev, azim, indexing="ij")
    dirs_sensor = np.stack(
        [np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], axis=-1
    ).reshape(-1, 3)

    R, t = pose[:3, :3], pose[:3, 3]
    dirs_world = dirs_sensor @ R.T
    origins = np.broadcast_to(t, dirs_world.shape)

    t_best = np.full(len(dirs_world), np.inf)
    for seg in world:
        t_best = np.minimum(t_best, seg.intersect(origins, dirs_world))
    hit = np.isfinite(t_best) & (t_best <= max_range)
    t_noisy = t_best[hit] + rng.normal(scale=noise, size=hit.sum())
    return (dirs_sensor[hit] * t_noisy[:, None]).astype(np.float32)


def forward_trajectory(n_scans: int, step: float = 0.8, yaw_rate: float = 0.004
                       ) -> np.ndarray:
    """Gently curving forward drive -> [K, 4, 4] sensor poses in world."""
    poses = [np.eye(4)]
    for _ in range(n_scans - 1):
        T = np.eye(4)
        c, s = np.cos(yaw_rate), np.sin(yaw_rate)
        T[:2, :2] = [[c, -s], [s, c]]
        T[0, 3] = step
        poses.append(poses[-1] @ T)
    return np.stack(poses)


_GEN_CTX = None


def _gen_init(ctx):
    global _GEN_CTX
    _GEN_CTX = ctx


def _gen_scan(item):
    """Render + write one scan (module-level for Pool pickling)."""
    seq_dir, world, rings, azimuth_steps, seed = _GEN_CTX
    k, pose = item
    srng = np.random.default_rng((seed + 1, k))
    pts = simulate_scan(world, pose, rings=rings,
                        azimuth_steps=azimuth_steps, rng=srng)
    intensity = srng.random((len(pts), 1), dtype=np.float32)
    tmp = os.path.join(seq_dir, f".{k:06d}.bin.tmp")
    np.concatenate([pts, intensity], axis=1).tofile(tmp)
    os.replace(tmp, os.path.join(seq_dir, f"{k:06d}.bin"))


def write_kitti_layout(
    out_dir: str,
    sequence: int = 0,
    n_scans: int = 60,
    rings: int = 32,
    azimuth_steps: int = 900,
    seed: int = 0,
    step: float = 0.8,
    yawed: bool = False,
) -> Tuple[str, str]:
    """Emit <out>/sequences/<seq>/velodyne/*.bin + <out>/poses/<seq>.txt.

    Pose files use the KITTI convention (camera/world frame — the lidar
    poses conjugated by the fixed lidar->world permutation, matching what
    utils/poses.compute_poses produces for evaluation).

    Trajectories longer than ~150 m get a trajectory-following world
    (:func:`make_world_along`, ~2.5 boxes per drive-meter) so the >= 800 m
    KITTI-segment-metric experiments keep geometry in sensor range
    everywhere; short sequences keep the original fixed world for
    reproducibility with earlier rounds.
    """
    traj = forward_trajectory(n_scans, step=step)
    drive_m = step * (n_scans - 1)
    if drive_m > 150.0:
        world = make_world_along(
            traj, n_boxes=max(200, int(drive_m * 2.5)), seed=seed,
            yawed=yawed,
        )
    else:
        world = make_world(seed=seed)

    seq_dir = os.path.join(out_dir, "sequences", f"{sequence:02d}", "velodyne")
    pose_dir = os.path.join(out_dir, "poses")
    os.makedirs(seq_dir, exist_ok=True)
    os.makedirs(pose_dir, exist_ok=True)

    # Per-scan seeding (rng is deterministic in (seed, k), independent of
    # worker count or completion order) makes generation embarrassingly
    # parallel AND resumable: scans whose .bin already exists are skipped, so
    # an interrupted long-world generation continues where it left off.
    todo = [
        (k, pose) for k, pose in enumerate(traj)
        if not os.path.exists(os.path.join(seq_dir, f"{k:06d}.bin"))
    ]

    ctx = (seq_dir, world, rings, azimuth_steps, seed)
    n_workers = min(os.cpu_count() or 1, max(1, len(todo)))
    if n_workers > 1 and len(todo) > 8:
        # fork start method: workers inherit the world via the initializer
        # global (no per-task pickling of the ~1000-segment world).
        from multiprocessing import get_context

        with get_context("fork").Pool(
            n_workers, initializer=_gen_init, initargs=(ctx,)
        ) as pool:
            for _ in pool.imap_unordered(_gen_scan, todo, chunksize=8):
                pass
    else:
        _gen_init(ctx)
        for item in todo:
            _gen_scan(item)

    L = TRANSFORM_LIDAR_TO_WORLD
    with open(os.path.join(pose_dir, f"{sequence:02d}.txt"), "w") as f:
        for pose in traj:
            world_pose = L @ pose @ L.T
            f.write(" ".join(f"{v:.9e}" for v in world_pose.reshape(16)[:12]))
            f.write("\n")
    return seq_dir, os.path.join(pose_dir, f"{sequence:02d}.txt")
