"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced on one flushed line; any failure raises and the script
exits non-zero without printing a result:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the port's CUDA source (the placement kernel);
3. kernels: each kernel against its plain PyTorch version on the card, at the
   serving shapes (KITTI 64x720, N = 131072, B = 1 and 2), bit-equal; times of
   the kernel, the plain version and a one-call PyTorch yardstick;
4. serving: ``StreamingOdometry`` at the full width of the default KITTI model
   (bf16 autocast, random weights from a seeded generator) takes a numpy-made
   drive; every relative transform must be finite and orthonormal, and every
   scan must have gone through the placement kernel. One pair is also run in
   fp32 (TF32 off) on the card and on the CPU as the reference.

The last lines are the card (nvidia-smi), the kernel table as one JSON object,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
H, W, N = 64, 720, 131072
SEED = 0


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


def profiled_device_ms(fn, kernel_names=(), calls: int = 50):
    """Device time per call of the named kernels (all device activity if none
    are named), from torch.profiler's CUDA activity; None when the profiler
    records no device time. Only device activity is recorded, so the sum
    counts each kernel once."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for event in prof.key_averages():
        if not kernel_names or any(k in event.key for k in kernel_names):
            total_us += event.device_time_total
    return total_us / calls / 1e3 if total_us > 0 else None


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


def drive(n_scans: int, rng: np.random.Generator):
    """A sensor moving 1 m per scan (yaw 0.01 rad per scan) down a street:
    ground at -1.73 m, facades at y = -7 and +9 m, a wall 120 m ahead and a
    row of round pillars. 64 beams x 2000 azimuth steps are ray-cast; each
    scan is [M, 4] (x, y, z, intensity) in the sensor frame."""
    elev = np.deg2rad(np.linspace(-24.5, 2.0, 64))
    scans = []
    for k in range(n_scans):
        az = np.linspace(-math.pi, math.pi, 2000, endpoint=False) + rng.uniform(0, 0.003)
        e, a = np.meshgrid(elev, az, indexing="ij")
        d_local = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1)
        d_local = d_local.reshape(-1, 3)
        yaw = 0.01 * k
        c, s = math.cos(yaw), math.sin(yaw)
        d = d_local @ np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        o = np.array([1.0 * k, 0.05 * k, 0.0])
        hits = np.full(len(d), np.inf)
        with np.errstate(divide="ignore", invalid="ignore"):
            for axis, level in ((2, -1.73), (1, -7.0), (1, 9.0), (0, 120.0)):
                t = (level - o[axis]) / d[:, axis]
                hits = np.where((t > 0) & (t < hits), t, hits)
            for px in np.arange(-20.0, 130.0, 12.0):        # pillars, radius 0.6
                for py in (-5.5, 7.5):
                    ox, oy = o[0] - px, o[1] - py
                    qa = d[:, 0] ** 2 + d[:, 1] ** 2
                    qb = 2 * (ox * d[:, 0] + oy * d[:, 1])
                    qc = ox * ox + oy * oy - 0.36
                    disc = qb * qb - 4 * qa * qc
                    t = (-qb - np.sqrt(np.maximum(disc, 0))) / (2 * qa)
                    hits = np.where((disc > 0) & (t > 0) & (t < hits), t, hits)
        keep = hits < 80.0
        t = hits[keep] + rng.normal(0, 0.02, keep.sum())
        pts = d_local[keep] * t[:, None]
        scans.append(np.c_[pts, rng.random(len(pts))].astype(np.float32))
    return scans


def check_rigid(T: np.ndarray) -> None:
    if T.shape != (4, 4) or not np.isfinite(T).all():
        raise RuntimeError(f"relative transform not finite 4x4: {T}")
    R = T[:3, :3].astype(np.float64)
    err = max(np.abs(R.T @ R - np.eye(3)).max(), abs(np.linalg.det(R) - 1.0))
    if err > 1e-3 or not np.allclose(T[3], [0, 0, 0, 1]):
        raise RuntimeError(f"relative transform not rigid (err {err:.2e}): {T}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.ops.cuda import build as cuda_build
    from delora_tpu_torch.ops.cuda.placement import placement, placement_plain
    from delora_tpu_torch.ops.projection import ProjectionSpec, _pixel_coords, project_image
    from delora_tpu_torch.serving.stream import StreamingOdometry
    from delora_tpu_torch.training.step import forward_pose

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    log = cuda_build.build("placement")
    say(f"build: {time.perf_counter() - t0:.2f} s for placement"
        f"{'' if log else ' (already built)'} ({' '.join(cuda_build.NVCC_FLAGS)})")
    for line in log.strip().splitlines():
        say(f"  placement: {line.strip()}")

    # --- kernels against their plain versions -------------------------------
    config = default_config()
    spec = ProjectionSpec.from_config(config)
    rng = np.random.default_rng(SEED)
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
        err = (out - ref).abs().max().item()
        occ_k, occ_p = out[..., 3] > 0, ref[..., 3] > 0
        if err != 0.0 or not torch.equal(occ_k, occ_p):
            raise RuntimeError(f"placement B={batch}: max abs diff {err}, occupancy differs "
                               f"on {(occ_k != occ_p).sum().item()} pixels")
        cpu = placement_plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        if not torch.equal(cpu, out.cpu()):
            raise RuntimeError(f"placement B={batch}: kernel differs from the CPU plain version")
        max_err = max(max_err, err)
        hw = spec.height * spec.width
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
        # The bytes the function must move: pix and r of every point, the
        # payload of this run's winners only, the image once.
        C = pts.shape[-1]
        moved = batch * N * 8 + int(occ_p.sum().item()) * C * 4 + batch * hw * (C + 1) * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        say(f"placement B={batch} N={N} {spec.height}x{spec.width}: bit-equal to plain "
            f"(max abs diff {err}), occupancy {occ_k.float().mean().item():.4f}, "
            f"{in_fov.sum().item()} in FoV | kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} "
            f"us, scatter_reduce amin {lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({moved} B) on {card}")
        if batch == 1:    # serving projects one scan at a time
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms)
            dev_ms = profiled_device_ms(lambda: placement(*args),
                                        ("init_keys", "select_winners", "write_image"))
            say(f"placement B=1 device time of its three kernels (torch.profiler): "
                + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us")
                + f" per call; the per-call time above includes the Python wrapper, on {card}")

    # --- the serving path ---------------------------------------------------
    scans = drive(12, rng)
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

    # Where a scan's time goes, on the device: projection and model forward.
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
    # The card's idle share over whole push_scan calls.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for scan in scans:
            engine.push_scan(scan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    say(f"serving bf16 profiled: {len(scans)} push_scan in {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f} on {card}")

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

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "placement",
        "route": "cuda",
        "source": "delora_tpu_torch/csrc/placement.cu",
        "replaces": "delora_tpu/ops/pallas/placement.py:72",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": timing["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
