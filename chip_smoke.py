"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced on flushed lines; any failure raises and the script
exits non-zero without printing a result:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the port's CUDA sources (placement, window matcher),
   one compiler each, started together; each one's time and ``-Xptxas -v``;
3. drive: 24 ray-cast scans of a street (64 beams x 2000 azimuth steps) with
   the analytic normal of the surface each ray hit, turned to the sensor;
4. kernels: each kernel against its plain PyTorch version on the card,
   bit-equal:
   - placement, exact rule, at the serving shapes (KITTI 64x720, N = 131072,
     B = 1 and 2);
   - placement, packed rule, at the train shape (B = 8, N = 46,080 survivors,
     7 payload channels, no range channel) on the main path's warped
     survivors and on a cloud with duplicates and 16-bit range near-ties; its
     overflow count equal to the plain path's on the CPU;
   - window matcher, B = 8 at 64x720 with windows (5,9) and (9,17), and
     B = 1 at 64x2250, on targets with duplicated points (ties) and empty
     rows;
   with the time of a wrapper call (CUDA events), the kernels' device time
   (torch.profiler), the plain version's time, the bound and a one-call
   PyTorch yardstick where there is one;
5. serving: ``StreamingOdometry`` at the full width of the default KITTI model
   (bf16 autocast, random weights from a seeded generator) on the first 12
   scans; every relative transform finite and rigid, every scan through the
   placement kernel; one pair also in fp32 (TF32 off) against the CPU;
6. training: the ``Trainer`` at the full width of the default KITTI model
   (bf16 autocast, random seeded weights), B = 8, tables on the card, on the
   24 scans: 4 supervised steps, then 20 unsupervised; every step's metrics
   finite, ``placement_overflow_tiles`` 0, one launch of each kernel per
   step; steady-state pairs/s and the per-step device time split with the
   card's idle share; one fp32 step (TF32 off) on the card against the CPU
   (plain kernels) on the same batch and params; from the identity, 20 Adam
   steps (lr 1e-4) on one fixed batch must lower ``loss_pc`` (the mean of the
   last three 3% below the first).

The last lines are the card (nvidia-smi), the kernel table as one JSON object,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12              # float32 outside the tensor cores
FP64_OPS_PER_S = 34e12              # float64 outside the tensor cores
H, W, N = 64, 720, 131072
TRAIN_B = 8
SEED = 0
PLACEMENT_KERNELS = ("init_keys", "select_winners", "write_image")
MATCHER_KERNELS = ("window_match_hard",)
OPTIMIZER_KERNELS = ("multi_tensor_apply", "adam")
# Tolerances of the fp32 card step against the CPU step, set before the first
# run: the card's atan2 and conv sums differ from the CPU's in the last bits,
# so a few warped points change pixel and a few matches change hands; each
# moves the means by about 1 / (number of pairs) ~ 3e-5.
FP32_RTOL = 1e-3
# Gradients reach the loss: from the identity, LOSS_STEPS Adam steps at
# LOSS_LR on one fixed batch must bring the mean loss_pc of the last three
# steps 3% below the first step's.
LOSS_STEPS, LOSS_LR = 20, 1e-4


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Median over ``reps`` samples of the time of one call, each sample
    timed with CUDA events around ``inner`` back-to-back calls. Where the host
    cannot launch faster than the card runs, this is the host's rate."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def device_kernel_times(fn, calls: int):
    """(kernel name -> device ms per call, host wall ms per call) over
    ``calls`` calls, from torch.profiler's CUDA activity only (so each kernel
    counts once)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    times = {e.key: e.device_time_total / 1e3 / calls for e in prof.key_averages()
             if e.device_time_total > 0}
    return times, wall_ms


def profiled_device_ms(fn, kernel_names=(), calls: int = 50):
    """Device time per call of the named kernels (all device activity if none
    are named); None when the profiler records no device time."""
    times, _ = device_kernel_times(fn, calls)
    total = sum(v for k, v in times.items()
                if not kernel_names or any(n in k for n in kernel_names))
    return total if total > 0 else None


def kitti_like_cloud(rng: np.random.Generator, n: int, spec) -> np.ndarray:
    """n points over a 64x720 sensor: ~2.4 per pixel inside the FoV, the
    rest above or below it, and 10% exact duplicates (exact range ties)."""
    n_in = int(2.4 * spec.height * spec.width)
    az = rng.uniform(-math.pi, math.pi, n)
    el = np.where(np.arange(n) < n_in,
                  rng.uniform(spec.fov_down, spec.fov_up, n),
                  rng.choice([-1.0, 1.0], n) * rng.uniform(0.5, 1.2, n))
    rng_m = rng.uniform(2.0, 80.0, n)
    pts = np.stack([rng_m * np.cos(el) * np.cos(az), rng_m * np.cos(el) * np.sin(az),
                    rng_m * np.sin(el)], axis=-1).astype(np.float32)
    dst = rng.choice(n, n // 10, replace=False)
    pts[dst] = pts[rng.choice(n, n // 10)]
    return pts


def near_tie_cloud(rng: np.random.Generator, n: int, spec) -> np.ndarray:
    """A kitti-like cloud in which every 8th point is followed by a point on
    its ray 1e-4 nearer: ranges that mostly agree in the top 16 bits."""
    pts = kitti_like_cloud(rng, n, spec)
    pts[1::8] = pts[0::8][: len(pts[1::8])] * np.float32(1 - 1e-4)
    return pts


def drive(n_scans: int, rng: np.random.Generator):
    """A sensor moving 1 m per scan (yaw 0.01 rad per scan) down a street:
    ground at -1.73 m, facades at y = -7 and +9 m, a wall 120 m ahead and a
    row of round pillars. 64 beams x 2000 azimuth steps are ray-cast; each
    scan is [M, 4] (x, y, z, intensity) in the sensor frame, with [M, 3]
    normals of the surface each ray hit, turned toward the sensor."""
    elev = np.deg2rad(np.linspace(-24.5, 2.0, 64))
    scans, normals = [], []
    for k in range(n_scans):
        az = np.linspace(-math.pi, math.pi, 2000, endpoint=False) + rng.uniform(0, 0.003)
        e, a = np.meshgrid(elev, az, indexing="ij")
        d_local = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1)
        d_local = d_local.reshape(-1, 3)
        yaw = 0.01 * k
        c, s = math.cos(yaw), math.sin(yaw)
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        d = d_local @ rot
        o = np.array([1.0 * k, 0.05 * k, 0.0])
        hits = np.full(len(d), np.inf)
        nrm = np.zeros((len(d), 3))
        with np.errstate(divide="ignore", invalid="ignore"):
            for axis, level in ((2, -1.73), (1, -7.0), (1, 9.0), (0, 120.0)):
                t = (level - o[axis]) / d[:, axis]
                closer = (t > 0) & (t < hits)
                hits = np.where(closer, t, hits)
                nrm[closer] = np.eye(3)[axis]
            for px in np.arange(-20.0, 130.0, 12.0):        # pillars, radius 0.6
                for py in (-5.5, 7.5):
                    ox, oy = o[0] - px, o[1] - py
                    qa = d[:, 0] ** 2 + d[:, 1] ** 2
                    qb = 2 * (ox * d[:, 0] + oy * d[:, 1])
                    qc = ox * ox + oy * oy - 0.36
                    disc = qb * qb - 4 * qa * qc
                    t = (-qb - np.sqrt(np.maximum(disc, 0))) / (2 * qa)
                    closer = (disc > 0) & (t > 0) & (t < hits)
                    hits = np.where(closer, t, hits)
                    radial = np.stack([ox + t * d[:, 0], oy + t * d[:, 1],
                                       np.zeros_like(t)], -1) / 0.6
                    nrm[closer] = radial[closer]
        keep = hits < 80.0
        # Toward the sensor (against the ray), then into the sensor frame.
        nrm = np.where((np.sum(nrm * d, -1) > 0)[:, None], -nrm, nrm)
        t = hits[keep] + rng.normal(0, 0.02, keep.sum())
        pts = d_local[keep] * t[:, None]
        scans.append(np.c_[pts, rng.random(len(pts))].astype(np.float32))
        normals.append((nrm[keep] @ rot.T).astype(np.float32))
    return scans, normals


def check_rigid(T: np.ndarray) -> None:
    if T.shape != (4, 4) or not np.isfinite(T).all():
        raise RuntimeError(f"relative transform not finite 4x4: {T}")
    R = T[:3, :3].astype(np.float64)
    err = max(np.abs(R.T @ R - np.eye(3)).max(), abs(np.linalg.det(R) - 1.0))
    if err > 1e-3 or not np.allclose(T[3], [0, 0, 0, 1]):
        raise RuntimeError(f"relative transform not rigid (err {err:.2e}): {T}")


def require_equal(name: str, out, ref) -> float:
    """Raise unless every tensor of ``out`` equals its ``ref`` bit for bit
    (NaN-free inputs; +inf compares equal); -> max abs diff of finite parts."""
    err = 0.0
    for a, b in zip(out, ref):
        if not torch.equal(a, b):
            both = torch.isfinite(a) & torch.isfinite(b)
            raise RuntimeError(f"{name}: kernel differs from its plain version on "
                               f"{(a != b).sum().item()} of {a.numel()} values, max abs diff "
                               f"{(a - b)[both].abs().max().item()}")
        fin = torch.isfinite(a)
        err = max(err, (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0)
    return err


def check_exact_placement(spec, rng, card):
    """Phase 4a: the exact rule at the serving shapes (as in the serving
    slice). -> timing of B = 1 and the max abs error."""
    from delora_tpu_torch.ops.cuda.placement import placement, placement_plain
    from delora_tpu_torch.ops.projection import _pixel_coords

    dev = torch.device("cuda")
    max_err, timing = 0.0, None
    for batch in (1, 2):
        pts = torch.from_numpy(np.stack([kitti_like_cloud(rng, N, spec)
                                         for _ in range(batch)])).to(dev)
        valid = torch.ones(batch, N, dtype=torch.bool, device=dev)
        r, _, _, in_fov, pix = _pixel_coords(pts, valid, spec)
        args = (pix.contiguous(), r.contiguous(), pts.contiguous(), spec.height, spec.width)
        out = placement(*args)
        ref = placement_plain(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, require_equal(f"placement exact B={batch}", [out], [ref]))
        cpu = placement_plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        if not torch.equal(cpu, out.cpu()):
            raise RuntimeError(f"placement B={batch}: kernel differs from the CPU plain version")
        hw = spec.height * spec.width
        occ = ref[..., 3] > 0
        ms = cuda_ms(lambda: placement(*args))
        plain_ms = cuda_ms(lambda: placement_plain(*args), reps=10, inner=5)
        # Yardstick: the winner selection alone, as one scatter_reduce_ over
        # (range bits << 32 | index) keys. The port never calls it.
        keys64 = (r.view(torch.int32).long() << 32) | torch.arange(N, device=dev)
        slot = torch.where(pix < hw, pix + hw * torch.arange(batch, device=dev)[:, None],
                           batch * hw).long()
        lib_ms = cuda_ms(lambda: torch.full((batch * hw + 1,), 2**63 - 1, dtype=torch.int64,
                                            device=dev).scatter_reduce_(
            0, slot.view(-1), keys64.view(-1), "amin"))
        C = pts.shape[-1]
        moved = batch * N * 8 + int(occ.sum().item()) * C * 4 + batch * hw * (C + 1) * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        say(f"placement exact B={batch} N={N} {spec.height}x{spec.width}: bit-equal to plain, "
            f"occupancy {occ.float().mean().item():.4f}, {in_fov.sum().item()} in FoV | kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, scatter_reduce amin "
            f"{lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({moved} B) on {card}")
        if batch == 1:    # serving projects one scan at a time
            dev_ms = profiled_device_ms(lambda: placement(*args), PLACEMENT_KERNELS)
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                          device_ms=dev_ms)
            say("placement exact B=1 device time of its three kernels (torch.profiler): "
                + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us")
                + f" per call on {card}")
    return timing, max_err


def warped_survivors(trainer):
    """The main path's input to the packed placement: a train batch's
    compacted source survivors, warped by a small rigid motion."""
    from delora_tpu_torch import se3

    n = TRAIN_B
    batch = first_batch(trainer)
    yaw = torch.linspace(-0.02, 0.02, n, device=trainer.device)
    T = torch.eye(4, device=trainer.device).repeat(n, 1, 1)
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = yaw.cos(), -yaw.sin(), yaw.sin(), yaw.cos()
    T[:, 0, 3] = 0.9
    pts = batch.src_points
    pos = se3.transform_points(T, pts)
    vals = torch.cat([pts, batch.src_normals, torch.ones_like(pts[..., :1])], -1)
    return pos.contiguous(), batch.src_valid, vals.contiguous()


def check_packed_placement(trainer, spec, rng, card):
    """Phase 4b: the packed rule at the train shape."""
    from delora_tpu_torch.ops.cuda.placement import placement, placement_plain
    from delora_tpu_torch.ops.projection import _pixel_coords, project_image_packed_batch

    pos, valid, vals = warped_survivors(trainer)
    B, cap = valid.shape
    r, _, _, in_fov, pix = _pixel_coords(pos, valid, spec)
    args = (pix.contiguous(), r.contiguous(), vals, spec.height, spec.width)
    kw = dict(packed=True, append_range=False)
    out = placement(*args, **kw)
    ref = placement_plain(*args, **kw)
    torch.cuda.synchronize()
    err = require_equal("placement packed (main-path survivors)", [out], [ref])
    # The overflow count: the card's main path against the CPU's plain path.
    _, n_over = project_image_packed_batch(pos, valid, spec, values=vals, return_overflow=True,
                                           append_range=False)
    _, n_over_cpu = project_image_packed_batch(pos.cpu(), valid.cpu(), spec, values=vals.cpu(),
                                               return_overflow=True, append_range=False)
    if not torch.equal(n_over.cpu(), n_over_cpu):
        raise RuntimeError(f"overflow counts differ: card {n_over.tolist()}, "
                           f"CPU {n_over_cpu.tolist()}")
    # A cloud with duplicates and 16-bit near-ties at the same shape.
    cloud = torch.from_numpy(np.stack([near_tie_cloud(rng, cap, spec) for _ in range(B)])).cuda()
    cvals = torch.from_numpy(rng.normal(size=(B, cap, 7)).astype(np.float32)).cuda()
    cr, _, _, _, cpix = _pixel_coords(cloud, torch.ones_like(valid), spec)
    cargs = (cpix.contiguous(), cr.contiguous(), cvals, spec.height, spec.width)
    err = max(err, require_equal("placement packed (near-tie cloud)",
                                 [placement(*cargs, **kw)], [placement_plain(*cargs, **kw)]))
    near = (placement_plain(*cargs, packed=False, append_range=False)
            != placement_plain(*cargs, **kw)).any(-1).sum().item()
    hw = spec.height * spec.width
    occ = ref[..., 6] > 0.5
    ms = cuda_ms(lambda: placement(*args, **kw))
    plain_ms = cuda_ms(lambda: placement_plain(*args, **kw), reps=10, inner=5)
    dev_ms = profiled_device_ms(lambda: placement(*args, **kw), PLACEMENT_KERNELS)
    # Yardstick: the packed winner selection alone, one scatter_reduce_ amin
    # over (16-bit range key << 32 | index). The port never calls it.
    keys64 = (((r.view(torch.int32) >> 16) & 0xFFFF).long() << 32) | torch.arange(
        cap, device=r.device)
    slot = torch.where(in_fov, pix + hw * torch.arange(B, device=r.device)[:, None],
                       B * hw).long()
    lib_ms = cuda_ms(lambda: torch.full((B * hw + 1,), 2**63 - 1, dtype=torch.int64,
                                        device=r.device).scatter_reduce_(
        0, slot.view(-1), keys64.view(-1), "amin"))
    C = vals.shape[-1]
    moved = B * cap * 8 + int(occ.sum().item()) * C * 4 + B * hw * C * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    say(f"placement packed B={B} N={cap} C={C} {spec.height}x{spec.width}: bit-equal to plain "
        f"on the warped survivors and on a near-tie cloud ({near} pixels where the exact rule "
        f"picks another point), overflow tiles card {n_over.tolist()} = CPU; occupancy "
        f"{occ.float().mean().item():.4f} | kernel {ms * 1e3:.2f} us, device "
        + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us")
        + f", plain {plain_ms * 1e3:.2f} us, scatter_reduce amin {lib_ms * 1e3:.2f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({moved} B) on {card}")
    if near == 0:
        raise RuntimeError("the near-tie cloud did not separate the packed and exact rules")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                device_ms=dev_ms), err


def matcher_inputs(image, normals, rng):
    """Target with every fourth column duplicated into the next (exact ties
    whenever that point wins) and two empty rows; source = target xyz plus
    noise, held as the xyz slice of a [B, H, W, 7] image as the train step
    holds it."""
    tgt = image.clone()
    tgt[:, :, 1::4] = tgt[:, :, 0::4][:, :, : tgt[:, :, 1::4].shape[2]]
    tgt[:, 30:32] = 0.0
    noise = torch.from_numpy(rng.normal(0, 0.05, tuple(tgt.shape[:3]) + (3,))
                             .astype(np.float32)).to(tgt.device)
    src = torch.zeros(tgt.shape[:3] + (7,), device=tgt.device)
    src[..., 0:3] = tgt[..., 0:3] + noise * (tgt[..., 3:4] > 0)
    return src[..., 0:3], tgt[..., 0:3], normals.contiguous()


def window_work(tgt_xyz, window):
    """(candidates the matcher visits: in-image window offsets summed over
    pixels; of them occupied, each costing a distance) for this target."""
    wv, wu = window
    occ = (tgt_xyz != 0).any(-1).to(torch.float64)
    rows = torch.nn.functional.pad(torch.ones_like(occ), (0, 0, wv // 2, wv // 2))
    occ_pad = torch.nn.functional.pad(occ, (0, 0, wv // 2, wv // 2))
    Hh = occ.shape[1]
    visited = occupied = 0.0
    for dv in range(wv):
        visited += rows[:, dv:dv + Hh].sum().item() * wu
        for du in range(-(wu // 2), wu // 2 + 1):
            occupied += torch.roll(occ_pad[:, dv:dv + Hh], -du, dims=2).sum().item()
    return int(visited), int(occupied)


def check_matcher(trainer, spec, scan, rng, card):
    """Phase 4c: the window matcher at the train shapes and at 64x2250."""
    from delora_tpu_torch.ops.cuda.window_match import window_match, window_match_plain
    from delora_tpu_torch.ops.projection import ProjectionSpec, project_image

    idx = torch.as_tensor(trainer.pair_target[:TRAIN_B], device=trainer.device)
    src, tgt, nrm = matcher_inputs(trainer.tables.image[idx], trainer.tables.normal_image[idx],
                                   rng)
    B, Hh, Ww, _ = src.shape
    err, timing = 0.0, None
    for window in ((5, 9), (9, 17)):
        out = window_match(src, tgt, nrm, window)
        ref = window_match_plain(src, tgt, nrm, window)
        torch.cuda.synchronize()
        err = max(err, require_equal(f"window_match {window}", out, ref))
        found = torch.isfinite(ref[0])
        ms = cuda_ms(lambda: window_match(src, tgt, nrm, window))
        plain_ms = cuda_ms(lambda: window_match_plain(src, tgt, nrm, window), reps=5, inner=2)
        dev_ms = profiled_device_ms(lambda: window_match(src, tgt, nrm, window), MATCHER_KERNELS)
        # Read the source xyz, target xyz and normal once (36 B a pixel),
        # write sq, xyz and normal once (28 B a pixel).
        moved = B * Hh * Ww * 64
        visited, occupied = window_work(tgt, window)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ((3 * visited + 5 * occupied) / FP32_OPS_PER_S
                  + 4 * occupied / FP64_OPS_PER_S) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        say(f"window_match B={B} {Hh}x{Ww} window {window}: bit-equal to plain (sq, xyz, nrm), "
            f"{found.float().mean().item():.4f} of pixels matched | kernel {ms * 1e3:.2f} us, "
            "device " + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us")
            + f", plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
            f"({moved} B: {bytes_ms * 1e3:.2f} us; {visited} candidates visited, {occupied} "
            f"occupied: {ops_ms * 1e3:.2f} us) on {card}")
        if window == (5, 9):
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                          bound_by=bound_by, device_ms=dev_ms)
    wide = ProjectionSpec(spec.height, 2250, spec.fov_up, spec.fov_down, spec.fov_left,
                          spec.fov_right)
    pts = torch.from_numpy(np.ascontiguousarray(scan[:, :3])).cuda()
    image = project_image(pts, torch.ones(len(pts), dtype=torch.bool, device="cuda"), wide)[None]
    normals = torch.from_numpy(rng.normal(size=(1, spec.height, 2250, 3))
                               .astype(np.float32)).cuda()
    src, tgt, nrm = matcher_inputs(image, normals, rng)
    out = window_match(src, tgt, nrm, (5, 9))
    err = max(err, require_equal("window_match 64x2250", out,
                                 window_match_plain(src, tgt, nrm, (5, 9))))
    ms = cuda_ms(lambda: window_match(src, tgt, nrm, (5, 9)), reps=10, inner=5)
    say(f"window_match B=1 64x2250 window (5, 9): bit-equal to plain, "
        f"{torch.isfinite(out[0]).float().mean().item():.4f} of pixels matched | kernel "
        f"{ms * 1e3:.2f} us on {card}")
    return timing, err


def run_serving(config, scans, spec, card):
    """Phase 5, as in the serving slice. -> placement launches."""
    from torch.profiler import ProfilerActivity, profile

    from delora_tpu_torch.ops.cuda.placement import placement
    from delora_tpu_torch.ops.projection import project_image
    from delora_tpu_torch.serving.stream import StreamingOdometry
    from delora_tpu_torch.training.step import forward_pose

    dev = torch.device("cuda")
    say(f"serving: {len(scans)} ray-cast scans, {min(map(len, scans))}-"
        f"{max(map(len, scans))} points each")
    engine = StreamingOdometry(config, device=dev)
    placement.launches = 0
    latencies, transforms, steps = [], [], {}
    for scan in scans:
        out = engine.push_scan(scan)
        if out is not None:
            check_rigid(out[0])
            transforms.append(out[0])
            latencies.append(out[2])
            for key, dt in engine.step_times.items():
                steps.setdefault(key, []).append(dt)
    launches = placement.launches
    if launches != len(scans):
        raise RuntimeError(f"placement kernel launched {launches} times for {len(scans)} scans")
    say(f"serving bf16: {len(latencies)} pairs, every T finite and rigid, placement launches "
        f"{launches} for {len(scans)} scans | per-scan latency p50 "
        f"{statistics.median(latencies) * 1e3:.2f} ms, first {latencies[0] * 1e3:.2f} ms, "
        f"max {max(latencies) * 1e3:.2f} ms on {card}")
    say(f"serving bf16 host clock per step of push_scan, median of {len(latencies)} pairs: "
        + ", ".join(f"{k} {statistics.median(v) * 1e3:.3f} ms" for k, v in steps.items())
        + f" on {card}")

    pts0 = torch.from_numpy(np.ascontiguousarray(scans[0][:, :3])).to(dev)
    valid0 = torch.ones(len(pts0), dtype=torch.bool, device=dev)
    img0 = project_image(pts0, valid0, spec)[None]
    img1 = project_image(torch.from_numpy(np.ascontiguousarray(scans[1][:, :3])).to(dev),
                         valid0.new_ones(len(scans[1])), spec)[None]
    with torch.no_grad():
        proj_ms = profiled_device_ms(lambda: project_image(pts0, valid0, spec), calls=10)
        fwd_ms = profiled_device_ms(lambda: forward_pose(engine.model, img0, img1), calls=10)
    say("serving bf16 device busy time (torch.profiler): " + ", ".join(
        f"{k} " + ("not measured" if v is None else f"{v:.3f} ms")
        for k, v in (("project_image", proj_ms), ("forward_pose", fwd_ms)))
        + f" per scan pair on {card}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for scan in scans:
            engine.push_scan(scan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    say(f"serving bf16 profiled: {len(scans)} push_scan in {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f} on {card}")

    from delora_tpu_torch.config import default_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fp32 = default_config({"compute_dtype": "float32"})
    eng32 = StreamingOdometry(fp32, device=dev)
    eng32.push_scan(scans[0])
    T32 = eng32.push_scan(scans[1])[0]
    check_rigid(T32)
    bf16_diff = np.abs(transforms[0] - T32).max()
    cpu_model = StreamingOdometry(fp32, device="cpu").model
    with torch.no_grad():
        T_cpu = forward_pose(cpu_model, img0.cpu(), img1.cpu())[0].numpy()
        T_gpu = forward_pose(eng32.model, img0, img1)[0].cpu().numpy()
    model_diff = np.abs(T_gpu - T_cpu).max()
    # The card's atan2 and norm may round the last bit differently from the
    # CPU's: values then differ by an ulp, and a pixel changes hands only
    # where a point sits on a rounding boundary or a near-tie.
    img_cpu = project_image(pts0.cpu(), valid0.cpu(), spec)
    img_gpu = img0[0].cpu()
    changed = ((img_cpu - img_gpu).abs() > 1e-4 * img_cpu.abs().clamp(min=1.0)).any(-1)
    pix_diff = changed.sum().item()
    ulp_diff = (img_cpu - img_gpu)[~changed].abs().max().item()
    if model_diff > 1e-4:
        raise RuntimeError(f"fp32 model on the card differs from the CPU by {model_diff}")
    if pix_diff > 0.001 * spec.height * spec.width:
        raise RuntimeError(f"card and CPU projections change hands on {pix_diff} pixels")
    say(f"serving fp32 (TF32 off): max |T_bf16 - T_fp32| {bf16_diff:.3e}; fp32 card vs CPU "
        f"on the same images {model_diff:.3e} (limit 1e-4); card vs CPU projection: "
        f"{pix_diff} of {spec.height * spec.width} pixels change hands (limit 0.1%), max abs "
        f"diff elsewhere {ulp_diff:.3e}")
    return launches


def first_batch(trainer):
    """The batch of the first B pairs, gathered from the trainer's tables."""
    return trainer.batch(torch.as_tensor(trainer.pair_target[:TRAIN_B], device=trainer.device),
                         torch.as_tensor(trainer.pair_source[:TRAIN_B], device=trainer.device))


def check_steps(trainer, epoch):
    """Every step of the last epoch: metrics finite, no overflowing tile."""
    for key, values in trainer.last_steps.items():
        if not np.isfinite(values).all():
            raise RuntimeError(f"epoch {epoch}: metric {key} not finite: {values}")
    if (trainer.last_steps["placement_overflow_tiles"] != 0).any():
        raise RuntimeError(f"epoch {epoch}: placement overflow "
                           f"{trainer.last_steps['placement_overflow_tiles']}")


def run_training(trainer, card):
    """Phase 6, the trainer's steps. -> (launches of placement and matcher,
    steady-state pairs/s)."""
    from delora_tpu_torch.ops.cuda.placement import placement
    from delora_tpu_torch.ops.cuda.window_match import window_match

    placement.launches = 0
    window_match.launches = 0
    steps, history = 0, []
    # Two supervised epochs (2 steps each: 23 pairs, B = 8), then unsupervised.
    # The warmup's own switch (epoch loss < 1e-2) would take hundreds of steps
    # at lr 1e-5 from random weights, so the run switches after 4 steps.
    for epoch in range(12):
        if epoch == 2:
            trainer.supervised = False
        metrics = trainer.train_epoch(epoch)
        check_steps(trainer, epoch)
        steps += metrics["steps"]
        history.append(metrics)
        say(f"train epoch {epoch} ({'supervised' if epoch < 2 else 'unsupervised'}): "
            f"{metrics['steps']} steps, loss {metrics['loss']:.6f}, loss_pc "
            f"{metrics['loss_pc']:.6f}, po2pl {metrics['loss_po2pl']:.6f}, pl2pl "
            f"{metrics['loss_pl2pl']:.6f}, pairs {metrics['num_po2pl_pairs']:.1f}, visible "
            f"{metrics['visible_pixels']:.1f}, grad_norm {metrics['grad_norm']:.4e}, "
            f"{metrics['epoch_seconds'] * 1e3:.1f} ms")
    launches = (placement.launches, window_match.launches)
    if launches != (steps, steps):
        raise RuntimeError(f"kernel launches {launches} for {steps} steps (expected one each)")
    steady = history[3:]
    pairs_per_s = (sum(h["steps"] for h in steady) * trainer.batch_size
                   / sum(h["epoch_seconds"] for h in steady))
    say(f"training bf16 B={trainer.batch_size}: {steps} steps (4 supervised), every step's "
        f"metrics finite, overflow tiles 0, launches placement {launches[0]} and matcher "
        f"{launches[1]} for {steps} steps | steady state (epochs 3-11, host clock, one "
        f"readback an epoch) {pairs_per_s:.1f} pairs/s on {card}")
    return launches, pairs_per_s


def step_split(trainer, card):
    """The device time of a train step by part, and the card's idle share."""
    from delora_tpu_torch.training.step import StepConfig, forward_pose, train_step

    cfg = StepConfig.from_config(trainer.config, trainer.dataset, supervised=False)
    n = TRAIN_B
    batch = first_batch(trainer)
    model, opt = trainer.model, trainer.optimizer
    times, wall_ms = device_kernel_times(lambda: train_step(model, opt, batch, cfg), calls=5)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        forward_pose(model, batch.image_1, batch.image_2).square().sum().backward()

    fb_times, _ = device_kernel_times(fwd_bwd, calls=5)
    total = sum(times.values())

    def part(names):
        return sum(v for k, v in times.items() if any(s in k.lower() for s in names))

    split = {"forward+backward": sum(fb_times.values()), "matcher": part(MATCHER_KERNELS),
             "placement": part(tuple(k.lower() for k in PLACEMENT_KERNELS)),
             "optimizer": part(OPTIMIZER_KERNELS)}
    split["rest"] = total - sum(split.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    say(f"training step device time (torch.profiler, 5 steps, B={n}): total {total:.3f} ms of "
        f"{wall_ms:.3f} ms wall, idle share {1 - total / wall_ms:.3f} | "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f" on {card}")
    say("training step largest kernels: " + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
    return split, total, wall_ms


def check_fp32_step(trainer):
    """One fp32 step (TF32 off) on the card against the CPU's plain path."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.training.state import make_optimizer
    from delora_tpu_torch.training.step import FullyCachedBatch, StepConfig, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = default_config({"compute_dtype": "float32"}, base=trainer.config)
    step_cfg = StepConfig.from_config(cfg32, supervised=False)
    model = OdometryModel(ModelConfig.from_config(cfg32),
                          torch.Generator().manual_seed(SEED + 1)).to(trainer.device)
    model_cpu = copy.deepcopy(model).cpu()
    batch = first_batch(trainer)
    batch_cpu = FullyCachedBatch(*(t.cpu() for t in batch))
    out = train_step(model, make_optimizer(cfg32, model.parameters(), TRAIN_B)[0], batch,
                     step_cfg)
    t0 = time.perf_counter()
    ref = train_step(model_cpu, make_optimizer(cfg32, model_cpu.parameters(), TRAIN_B)[0],
                     batch_cpu, step_cfg)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for key, value in ref.items():
        a, b = float(out[key]), float(value)
        rel = abs(a - b) / max(abs(b), 1e-6)
        worst = max(worst, rel)
        if rel > FP32_RTOL:
            raise RuntimeError(f"fp32 step: {key} card {a} vs CPU {b} (rel {rel:.2e} > "
                               f"{FP32_RTOL})")
    say(f"training fp32 (TF32 off) card vs CPU step on the same batch and params: loss "
        f"{float(out['loss']):.6f} vs {float(ref['loss']):.6f}, grad_norm "
        f"{float(out['grad_norm']):.6f} vs {float(ref['grad_norm']):.6f}, pairs "
        f"{float(out['num_po2pl_pairs']):.1f} vs {float(ref['num_po2pl_pairs']):.1f}; worst "
        f"relative difference over {len(ref)} values {worst:.2e} (limit {FP32_RTOL}); CPU step "
        f"{cpu_s:.1f} s")


def check_loss_falls(trainer):
    """Gradients reach the loss: Adam on one fixed batch lowers loss_pc."""
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.training.state import make_optimizer
    from delora_tpu_torch.training.step import StepConfig, train_step

    config = dict(trainer.config, learning_rate=LOSS_LR, lr_schedule="constant")
    model = OdometryModel(ModelConfig.from_config(config),
                          torch.Generator().manual_seed(SEED + 2))
    # Start at the identity, where the supervised warmup leaves the model: the
    # heads' last layers output translation 0 and quaternion (0, 0, 0, 1).
    # From a random pose the hard-matched loss jumps between basins under
    # any step that moves all 11.9 M parameters.
    with torch.no_grad():
        for head, bias in ((model.fully_connected_rotation, (0.0, 0.0, 0.0, 1.0)),
                           (model.fully_connected_translation, (0.0, 0.0, 0.0))):
            head[-1].weight.zero_()
            head[-1].bias.copy_(torch.tensor(bias))
    model.to(trainer.device)
    optimizer, _ = make_optimizer(config, model.parameters(), TRAIN_B)
    cfg = StepConfig.from_config(config, supervised=False)
    batch = first_batch(trainer)
    losses = [train_step(model, optimizer, batch, cfg)["loss_pc"] for _ in range(LOSS_STEPS)]
    losses = torch.stack(losses).tolist()
    if not statistics.mean(losses[-3:]) < 0.97 * losses[0]:
        raise RuntimeError(f"loss_pc did not fall on a fixed batch: {losses}")
    say(f"training: {LOSS_STEPS} Adam steps from the identity (lr {LOSS_LR}, "
        f"{config['compute_dtype']}, unsupervised) on one fixed "
        f"batch: loss_pc " + " ".join(f"{x:.4f}" for x in losses))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.ops.cuda import build as cuda_build
    from delora_tpu_torch.ops.projection import ProjectionSpec
    from delora_tpu_torch.training.trainer import Trainer

    card = card_line()
    name = torch.cuda.get_device_name(0)
    say(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    builds = cuda_build.build_all(["placement", "window_match"])
    say(f"build: {time.perf_counter() - t0:.2f} s for both, one nvcc each started together "
        f"({' '.join(cuda_build.NVCC_FLAGS)})")
    for lib, (log, seconds) in builds.items():
        say(f"build {lib}: {seconds:.2f} s{'' if log else ' (already built)'}")
        for line in log.strip().splitlines():
            say(f"  {lib}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    scans, normals = drive(24, rng)
    say(f"drive: {len(scans)} ray-cast scans, {min(map(len, scans))}-{max(map(len, scans))} "
        f"points each, analytic normals, {time.perf_counter() - t0:.1f} s")

    config = default_config()
    spec = ProjectionSpec.from_config(config)
    train_config = default_config({"batch_size": TRAIN_B})
    t0 = time.perf_counter()
    trainer = Trainer(train_config, [list(zip(scans, normals))], device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in trainer.model.parameters())
    say(f"trainer: {len(scans)} scans' artifacts on the card as tables, {trainer.num_pairs} "
        f"pairs, {n_params} parameters, {time.perf_counter() - t0:.1f} s")

    exact, err_exact = check_exact_placement(spec, rng, card)
    packed, err_packed = check_packed_placement(trainer, spec, rng, card)
    matcher, err_matcher = check_matcher(trainer, spec, scans[0], rng, card)

    serving_launches = run_serving(config, scans[:12], spec, card)
    (packed_launches, matcher_launches), _ = run_training(trainer, card)
    step_split(trainer, card)
    check_fp32_step(trainer)
    check_loss_falls(trainer)

    def row(name_, source, replaces, launches, err, t):
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t.get("bound_by", "bytes"),
                "library_ms": t["library_ms"]}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        row("placement", "delora_tpu_torch/csrc/placement.cu",
            "delora_tpu/ops/pallas/placement.py:72", serving_launches, err_exact, exact),
        row("placement_packed", "delora_tpu_torch/csrc/placement.cu",
            "delora_tpu/ops/pallas/placement.py:72", packed_launches, err_packed, packed),
        row("window_match", "delora_tpu_torch/csrc/window_match.cu",
            "delora_tpu/ops/pallas/window_match.py:249", matcher_launches, err_matcher,
            matcher),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
