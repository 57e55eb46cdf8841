"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced on flushed lines; any failure raises and the script
exits non-zero without printing a result:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the port's CUDA sources (placement, window matcher,
   1-NN search), one compiler each, started together; each one's time and
   ``-Xptxas -v``;
3. drive: 24 ray-cast scans of a street (64 beams x 2000 azimuth steps) with
   the analytic normal of the surface each ray hit, turned to the sensor;
4. kernels: each kernel against its plain PyTorch version on the card,
   bit-equal:
   - placement, exact rule, at the serving shapes (KITTI 64x720, N = 131072,
     B = 1 and 2) and at the preprocessing shape (64x2250, N = 147,456, the
     KITTI staging capacity, on a drive scan), also against the CPU;
   - placement, packed rule, at the train shape (B = 8, N = 46,080 survivors,
     7 payload channels, no range channel) on the main path's warped
     survivors and on a cloud with duplicates and 16-bit range near-ties; its
     overflow count equal to the plain path's on the CPU;
   - placement after a larger call: the key workspace that the kernel keeps
     between calls is clean at the real shapes (exact B = 8, then exact
     B = 1, packed on the survivors, exact B = 8 again, each bit-equal);
   - window matcher, B = 8 at 64x720 with windows (5,9) and (9,17), and
     B = 1 at 64x2250, on targets with duplicated points (ties) and empty
     rows;
   - soft window matcher, sigma 0.3, B = 8 at 64x720 with windows (5,9) and
     (9,17), B = 1 at 64x2250 with (9,17) (halo kernel), and B = 1 at 64x720
     with (41,89), whose halo passes a block's shared memory (global
     kernel): squared distances and misses bit-equal, blends within
     rtol 1e-5 / atol 1e-5 (set before its first run), the measured maximum
     and the count of values not bit-equal printed, with the share of
     occupied candidates whose weight underflows to +0 (and adds nothing)
     and an issue-slot floor: the SASS instructions an exp of the kernel's
     cheapest loop (cuobjdump of the built library) times the occupied
     candidates over the SMs x 128 lanes x the card's maximum SM clock;
   - index search (the reverse direction's), B = 8 at 64x720, (5,9): target
     pixels against a warped-source image with its occupancy plane;
   - exact 1-NN, B = 8, S = 46,080 warped survivors against T = 131,072
     padded target points with the drive's survivor mask, and a near-tie
     cloud with duplicated targets, each also at B = 1 (its first row);
   with the time of a wrapper call (CUDA events), the kernels' device time
   (torch.profiler; the placement's and the 1-NN's by pass), the plain
   version's time, the bound and a one-call PyTorch yardstick where there is
   one (its call and its device time);
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
   last three 3% below the first);
7. training, quality recipe: the same model, B and scans on the fully-cached
   feed with soft matching (sigma 0.3), the reverse po2pl term (1.0), the
   parameter EMA (0.999) and dropout; every step finite with
   ``loss_po2pl_rev`` > 0 and one launch each of the soft matcher, the index
   search and the placement; pairs/s and the device split; the EMA weights
   finite and apart from the live ones, the deploy model's pose on one pair
   finite and rigid; one fp32 step (TF32 off, dropout off) against the CPU;
8. training, brute correspondence on the raw feed: the same model and B on
   the padded clouds (131,072 points) in tables on the card; every step
   finite with one 1-NN launch; pairs/s and the device split; one fp32 step
   against the CPU on a reduced cloud (max_points 16,384, B = 2: the CPU's
   exact search over full clouds would take minutes);
9. the offline pipeline from disk, through ``python -m delora_tpu_torch.cli``
   on the card, on the 24 drive scans written as a KITTI layout (velodyne
   .bin files and camera-frame poses) in a temporary directory:
   ``preprocess`` at 64x2250 (one exact placement a scan; the host-clock
   read, device and write time a scan, the projection's and the normals'
   CUDA-event time), two scans also through the CPU's plain path (survivors
   that differ, limit 0.05% of points; normals of common survivors within
   1e-4 on >= 99.9%, the worst printed); ``train`` at full width, B = 8,
   3 epochs, unsupervised, evaluated every epoch, ``epoch_NNNNN`` kept every
   2 (checkpoints latest, epoch_00000, epoch_00002 and best; every epoch's
   metrics finite; one packed placement and one matcher launch a step; the
   set-up seconds and pairs/s); a resume from ``latest`` that starts at
   epoch 3; one epoch streamed from the host (``hbm_cache_scans`` 8); ``test``
   of ``best`` (24 finite, rigid poses; finite RPE; no kernel launch, the
   cached path projects on the host); and the tester's loss evaluation on
   the raw feed (two exact placements, one packed and one matcher launch a
   batch).

Each path of phases 5-9 is driven with every kernel's launch count set to 0
just before it and read just after; the placement wrapper counts its exact
and its packed rule apart. A path fails unless each of its kernels launched
as often as the path should launch it and every other kernel not at all.

The last lines are the card (nvidia-smi), the kernel table as one JSON object
(every row with its launches by path, as read in those runs, and the exact
placement's row with its preprocessing shape), and ``{"ok": true, "device":
{...}}``.

    python3 chip_smoke.py --train-rate EPOCHS

times the main path's training alone in a fresh process: phase 6's trainer
on phase 3's drive, 2 supervised epochs, then EPOCHS unsupervised ones; it
prints each epoch's pairs/s from the fourth on, their median and quartiles.
It uses only the trainer's long-standing interface, so this one file,
placed beside an older commit's ``delora_tpu_torch``, times both commits the
same way.

    python3 chip_smoke.py --serve-rate ROUNDS

pushes phase 3's first 12 scans through ``StreamingOdometry`` ROUNDS times in
a fresh process and prints the per-scan latency's median and quartiles after
the first round; like ``--train-rate`` it reads only the long-standing
interface.

    python3 chip_smoke.py --placement-time

times the placement wrapper alone at the exact rule's serving shape (B = 1,
N = 131072, C = 3 + range) and the packed rule's train shape (B = 8, N =
46,080 warped survivors of scans that hit every pixel, C = 7): a call (CUDA
events), the device time by pass (torch.profiler), the scatter_reduce_
yardstick's call and device time, and the host microseconds of the
wrapper's parts (checks, stream, key workspace or key buffer, output,
``ctypes`` launch). It reads the wrapper of this commit or of an older one,
so the same file, placed beside both, compares them in one call.

    python3 chip_smoke.py --nn-time
    python3 chip_smoke.py --matcher-time

time the 1-NN (B = 8 and B = 1 on the drive's warped survivors and on the
near-tie cloud of phase 4f) or the window matchers (hard (5,9) and (9,17)
at B = 8, the index search, hard 64x2250 at B = 1, the inputs of phases 4c
and 4e; soft (5,9) and (9,17) at B = 8 and (9,17) at B = 1 64x2250, sigma
0.3, as phase 4d) alone in a fresh process: each case checked against its
plain version (bit-equal; the soft blends within phase 4d's tolerance, the
count of values not bit-equal printed), then a call (CUDA events), the
device time by kernel (torch.profiler) and the host microseconds of the
wrapper's parts; for the soft matcher also the SASS instructions an exp of
its kernel's cheapest loop. Both flags together run both. Like
``--placement-time`` they read only long-standing interfaces, so the same
file times this commit and an older one.
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
LANES_PER_SM = 128                  # Hopper: 4 schedulers x 32 lanes issue a cycle
H, W, N = 64, 720, 131072
TRAIN_B = 8
SEED = 0
PLACEMENT_KERNELS = ("select_winners", "write_and_reset")
MATCHER_KERNELS = ("window_match_hard",)
SOFT_KERNELS = ("window_match_soft_halo", "window_match_soft_global")
NN_KERNELS = ("nn_count_targets", "nn_pack_targets", "nn_search", "nn_finish")
OPTIMIZER_KERNELS = ("multi_tensor_apply", "adam")
# Tolerances of the fp32 card step against the CPU step, set before the first
# run: the card's atan2 and conv sums differ from the CPU's in the last bits,
# so a few warped points change pixel and a few matches change hands; each
# moves the means by about 1 / (number of pairs) ~ 3e-5.
FP32_RTOL = 1e-3
# The soft matcher's blends against its plain version on the card, set before
# its first run: the kernel's expf and torch.exp may differ in the last bit,
# which moves a blend by about 1e-7 of the spread of its candidates.
SOFT_RTOL = SOFT_ATOL = 1e-5
# The smallest 41-row window whose soft halo (32 B a cell) passes a block's
# 232,448 B of shared memory: it takes the soft global kernel.
LARGE_SOFT_WINDOW = (41, 89)
RECIPE = {"soft_match_sigma": 0.3, "lambda_reverse_po2pl": 1.0, "ema_decay": 0.999,
          "use_dropout": True}
# The brute phase's fp32 card-vs-CPU step runs on clouds cut to this many
# points and this batch: the CPU's exact search over 46,080 x 131,072 slots a
# scan pair would take minutes.
BRUTE_CHECK_POINTS, BRUTE_CHECK_B = 16384, 2
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
    are named); None when two profiler windows in a row record no device
    time (one window occasionally comes back empty)."""
    for _ in range(2):
        times, _ = device_kernel_times(fn, calls)
        total = sum(v for k, v in times.items()
                    if not kernel_names or any(n in k for n in kernel_names))
        if total > 0:
            return total
    return None


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


def survivor_cloud(rng: np.random.Generator, spec, batch: int) -> np.ndarray:
    """[batch, H*W, 3]: the compacted survivors of scans that hit every
    pixel, one point on each pixel's centre ray at a range of 2-80 m, turned
    0.02 rad in yaw and moved 0.9 m ahead, as the train step warps them."""
    el = spec.fov_up - (np.arange(spec.height) + 0.5) / spec.height * (spec.fov_up - spec.fov_down)
    az = spec.fov_left + (np.arange(spec.width) + 0.5) / spec.width * (spec.fov_right
                                                                     - spec.fov_left)
    e, a = (g.ravel() for g in np.meshgrid(el, az, indexing="ij"))
    rng_m = rng.uniform(2.0, 80.0, (batch, e.size))
    x, y, z = (rng_m * np.cos(e) * np.cos(a), rng_m * np.cos(e) * np.sin(a), rng_m * np.sin(e))
    c, s = math.cos(0.02), math.sin(0.02)
    return np.stack([c * x - s * y + 0.9, s * x + c * y, z], -1).astype(np.float32)


def placement_yardstick(pix, r, hw: int, packed: bool):
    """One scatter_reduce_ amin over (range key << 32 | index) keys: the
    winner selection alone, as a PyTorch call the port never makes. The range
    key is the f32 bits (exact rule, ranges > 0) or their top 16 (packed)."""
    B, n = pix.shape
    bits = r.view(torch.int32).long()
    keys = ((bits >> 16) & 0xFFFF if packed else bits) << 32 | torch.arange(n, device=r.device)
    slot = torch.where((pix >= 0) & (pix < hw),
                       pix + hw * torch.arange(B, device=r.device)[:, None], B * hw).long()
    return lambda: torch.full((B * hw + 1,), 2**63 - 1, dtype=torch.int64,
                              device=r.device).scatter_reduce_(0, slot.view(-1),
                                                               keys.view(-1), "amin")


def host_us(fn, calls: int = 100, reps: int = 20) -> float:
    """Host microseconds of one call (perf_counter, median of ``reps`` samples
    of ``calls`` calls, the card drained between samples and never waited on
    inside one)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


def placement_host_split(mod, args, kw):
    """Host microseconds of the parts of one placement wrapper call, each
    timed alone, for this tree's lean wrapper or an older one (per-call
    checks, ``_library()``, the device context, a key buffer per call)."""
    pix, r, vals, height, width = args
    packed, append = kw.get("packed", False), kw.get("append_range", True)
    dev = pix.device
    B, n = pix.shape
    C = vals.shape[2]
    hw = height * width
    out = torch.empty(B, height, width, C + int(append), dtype=torch.float32, device=dev)
    ptrs = (pix.data_ptr(), r.data_ptr(), vals.data_ptr())
    parts = {}
    if hasattr(mod, "_check_launch"):
        index = dev.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        keys = mod._workspace(index, stream, B * hw, dev)
        fn = mod._launcher()
        key32 = int(mod.key_bits(packed, n) == 32)
        parts["checks"] = host_us(lambda: mod._check_launch(*args))
        parts["stream"] = host_us(lambda: torch._C._cuda_getCurrentRawStream(index))
        parts["workspace"] = host_us(lambda: mod._workspace(index, stream, B * hw, dev))
        parts["output"] = host_us(lambda: vals.new_empty((B, height, width, C + int(append))))
        parts["launch"] = host_us(lambda: fn(*ptrs, keys.data_ptr(), out.data_ptr(), B, n, C,
                                             hw, int(packed), key32, int(append), index,
                                             stream))
    else:
        keys = torch.empty(B * hw, dtype=torch.int64, device=dev)
        lib = mod._library()

        def stream():
            with torch.cuda.device(dev):
                return torch.cuda.current_stream().cuda_stream

        raw = stream()
        parts["checks"] = host_us(lambda: (mod._check(*args), pix.is_contiguous(),
                                           r.is_contiguous(), vals.is_contiguous()))
        parts["library"] = host_us(mod._library)
        parts["stream"] = host_us(stream)
        parts["keys"] = host_us(lambda: torch.empty(B * hw, dtype=torch.int64, device=dev))
        parts["output"] = host_us(lambda: torch.empty(B, height, width, C + int(append),
                                                      dtype=torch.float32, device=dev))
        parts["launch"] = host_us(lambda: lib.placement_launch(
            *ptrs, keys.data_ptr(), out.data_ptr(), B, n, C, hw, int(packed), int(append), raw))
    parts["call"] = host_us(lambda: mod.placement(*args, **kw))
    return parts


def placement_time() -> None:
    """``--placement-time`` (see the module docstring)."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.ops.cuda import placement as mod
    from delora_tpu_torch.ops.projection import ProjectionSpec, _pixel_coords

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    card = card_line()
    say(f"placement-time: {mod.__file__} | raw stream query "
        f"{hasattr(torch._C, '_cuda_getCurrentRawStream')} | torch {torch.__version__} on {card}")
    spec = ProjectionSpec.from_config(default_config())
    hw = spec.height * spec.width
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    cases = []
    pts = torch.from_numpy(kitti_like_cloud(rng, N, spec)[None]).to(dev)
    r, _, _, _, pix = _pixel_coords(pts, torch.ones(1, N, dtype=torch.bool, device=dev), spec)
    cases.append(("exact B=1 N=131072 C=3+range", (pix.contiguous(), r.contiguous(), pts,
                                                    spec.height, spec.width), {}))
    sur = torch.from_numpy(survivor_cloud(rng, spec, TRAIN_B)).to(dev)
    vals = torch.from_numpy(rng.normal(size=sur.shape[:2] + (7,)).astype(np.float32)).to(dev)
    r, _, _, _, pix = _pixel_coords(sur, torch.ones(sur.shape[:2], dtype=torch.bool,
                                                    device=dev), spec)
    cases.append((f"packed B={TRAIN_B} N={sur.shape[1]} C=7", (
        pix.contiguous(), r.contiguous(), vals, spec.height, spec.width),
        dict(packed=True, append_range=False)))
    results = {}
    for label, args, kw in cases:
        out = mod.placement(*args, **kw)
        require_equal(f"placement {label}", [out], [mod.placement_plain(*args, **kw)])
        ms = cuda_ms(lambda: mod.placement(*args, **kw))
        passes, _ = device_kernel_times(lambda: mod.placement(*args, **kw), 50)
        yard = placement_yardstick(args[0], args[1], hw, kw.get("packed", False))
        lib_ms = cuda_ms(yard)
        lib_dev, _ = device_kernel_times(yard, 50)
        host = placement_host_split(mod, args, kw)
        results[label] = dict(ms=ms, device_ms=sum(passes.values()), passes=passes,
                              library_ms=lib_ms, library_device_ms=sum(lib_dev.values()),
                              host_us=host)
        say(f"placement {label}: bit-equal to plain | call {ms * 1e3:.2f} us, device "
            f"{sum(passes.values()) * 1e3:.2f} us ("
            + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in passes.items())
            + f"); scatter_reduce amin call {lib_ms * 1e3:.2f} us, device "
            f"{sum(lib_dev.values()) * 1e3:.2f} us | host us: "
            + ", ".join(f"{k} {v:.2f}" for k, v in host.items()) + f" on {card}")
    print(json.dumps({"placement_time": results}), flush=True)


def nn_host_split(mod, args):
    """Host microseconds of the parts of one 1-NN wrapper call, each timed
    alone, for this tree's lean wrapper or an older one (per-call checks,
    ``_library()``, the device context, scratch allocated per call)."""
    src, tgt, valid = args
    dev = src.device
    B, S, _ = src.shape
    T = tgt.shape[1]
    idx = torch.empty(B, S, dtype=torch.int32, device=dev)
    sq = torch.empty(B, S, dtype=torch.float32, device=dev)
    ptrs = (src.data_ptr(), tgt.data_ptr(), valid.data_ptr())
    few = dict(calls=10, reps=5)
    parts = {}
    if hasattr(mod, "_check_launch"):
        index = dev.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        need = mod.scratch_bytes(B, T)
        keys, scratch = mod._workspace(index, stream, B * S, need, dev)
        fn = mod._launcher()
        parts["checks"] = host_us(lambda: mod._check_launch(*args))
        parts["stream"] = host_us(lambda: torch._C._cuda_getCurrentRawStream(index))
        parts["workspace"] = host_us(lambda: mod._workspace(index, stream, B * S, need, dev))
        parts["outputs"] = host_us(lambda: (torch.empty((B, S), dtype=torch.int32, device=dev),
                                            src.new_empty((B, S))))
        parts["launch"] = host_us(lambda: fn(*ptrs, keys.data_ptr(), scratch.data_ptr(),
                                             idx.data_ptr(), sq.data_ptr(), B, S, T, index,
                                             stream), **few)
    else:
        lib = mod._library()

        def stream():
            with torch.cuda.device(dev):
                return torch.cuda.current_stream().cuda_stream

        raw = stream()
        packed = torch.empty(B, T, 4, dtype=torch.float32, device=dev)
        orig = torch.empty(B, T, dtype=torch.int32, device=dev)
        count = torch.empty(B, dtype=torch.int32, device=dev)
        parts["checks"] = host_us(lambda: (mod._check(*args), src.is_contiguous(),
                                           tgt.is_contiguous(), valid.is_contiguous()))
        parts["library"] = host_us(mod._library)
        parts["stream"] = host_us(stream)
        parts["scratch"] = host_us(lambda: (
            torch.empty(B, T, 4, dtype=torch.float32, device=dev),
            torch.empty(B, T, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev)))
        parts["outputs"] = host_us(lambda: (torch.empty(B, S, dtype=torch.int32, device=dev),
                                            torch.empty(B, S, dtype=torch.float32, device=dev)))
        parts["launch"] = host_us(lambda: lib.nn_search_launch(
            *ptrs, packed.data_ptr(), orig.data_ptr(), count.data_ptr(), idx.data_ptr(),
            sq.data_ptr(), B, S, T, raw), **few)
    parts["call"] = host_us(lambda: mod.nn_search(*args), **few)
    return parts


def matcher_host_split(mod, name, args):
    """Host microseconds of the parts of one hard matcher wrapper call
    (``window_match`` or ``window_match_indices``), each timed alone, for
    this tree's lean wrapper or an older one."""
    src, xyz, third, window = args
    index_search = name == "window_match_indices"
    B, Hh, Ww, _ = src.shape
    dev = src.device
    outs = (torch.empty(B, Hh, Ww, device=dev),
            None if index_search else torch.empty(B, Hh, Ww, 3, device=dev),
            None if index_search else torch.empty(B, Hh, Ww, 3, device=dev),
            torch.empty(B, Hh, Ww, dtype=torch.int32, device=dev) if index_search else None)
    ptrs = tuple(0 if t is None else t.data_ptr() for t in outs)
    nrm, occ = (None, third) if index_search else (third, None)

    def views():
        return (*mod._view(src, "src"), *mod._view(xyz, "xyz"), *mod._view(nrm, "nrm"),
                *mod._view(occ, "occ")) if not hasattr(mod, "_check_launch") else (
            *mod._view(src), *mod._view(xyz), *mod._view(nrm), *mod._view(occ))

    def outputs():
        if index_search:
            return (src.new_empty(src.shape[:3]),
                    torch.empty(src.shape[:3], dtype=torch.int32, device=dev))
        return src.new_empty(src.shape[:3]), src.new_empty(src.shape), src.new_empty(src.shape)

    parts = {}
    if hasattr(mod, "_check_launch"):
        index = dev.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        third_name = "cand_occ" if index_search else "tgt_nrm"
        fn = mod._launchers()[0]
        v = views()
        parts["checks"] = host_us(lambda: mod._check_launch(window, src, xyz, third, third_name))
        parts["stream"] = host_us(lambda: torch._C._cuda_getCurrentRawStream(index))
        parts["outputs"] = host_us(outputs)
        parts["views"] = host_us(views)
        parts["launch"] = host_us(lambda: fn(*v, *ptrs, B, Hh, Ww, window[0], window[1], index,
                                             stream))
    else:
        lib = mod._library()

        def stream():
            with torch.cuda.device(dev):
                return torch.cuda.current_stream().cuda_stream

        raw = stream()
        v = views()
        kw = {"cand_xyz": xyz, "cand_occ": third} if index_search else {"tgt_xyz": xyz,
                                                                         "tgt_nrm": third}
        parts["checks"] = host_us(lambda: mod._check(window, src, **kw))
        parts["library"] = host_us(mod._library)
        parts["stream"] = host_us(stream)
        parts["outputs"] = host_us(outputs)
        parts["views"] = host_us(views)
        parts["launch"] = host_us(lambda: lib.window_match_launch(
            *v, *ptrs, B, Hh, Ww, window[0], window[1], raw))
    parts["call"] = host_us(lambda: getattr(mod, name)(*args))
    return parts


def wide_inputs(spec, scan, rng):
    """Phase 3's first scan projected at 64x2250 (B = 1), random normals,
    made into matcher inputs (ties, empty rows, a noisy source)."""
    from delora_tpu_torch.ops.projection import ProjectionSpec, project_image

    wide = ProjectionSpec(spec.height, 2250, spec.fov_up, spec.fov_down, spec.fov_left,
                          spec.fov_right)
    pts = torch.from_numpy(np.ascontiguousarray(scan[:, :3])).cuda()
    image = project_image(pts, torch.ones(len(pts), dtype=torch.bool, device="cuda"), wide)[None]
    normals = torch.from_numpy(rng.normal(size=(1, spec.height, 2250, 3))
                               .astype(np.float32)).cuda()
    return matcher_inputs(image, normals, rng)


def soft_host_split(mod, args):
    """Host microseconds of the parts of one soft matcher wrapper call, each
    timed alone, for this tree's wrapper or the previous one (whose launch
    takes no kernel choice)."""
    src, xyz, nrm, window, sigma = args
    B, Hh, Ww, _ = src.shape
    dev = src.device
    index = dev.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    fn = mod._launchers()[1]
    ptrs = tuple(t.data_ptr() for t in (torch.empty(B, Hh, Ww, device=dev),
                                        torch.empty(B, Hh, Ww, 3, device=dev),
                                        torch.empty(B, Hh, Ww, 3, device=dev)))
    v = (*mod._view(src), *mod._view(xyz), *mod._view(nrm))
    choice = (int(mod.soft_halo_fits(window)),) if hasattr(mod, "soft_halo_fits") else ()
    tau = mod.inv_tau(sigma)
    return {
        "checks": host_us(lambda: mod._check_launch(window, src, xyz, nrm, "tgt_nrm", hard=False)),
        "stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(index)),
        "outputs": host_us(lambda: (src.new_empty(src.shape[:3]), src.new_empty(src.shape),
                                    src.new_empty(src.shape))),
        "views": host_us(lambda: (*mod._view(src), *mod._view(xyz), *mod._view(nrm))),
        "launch": host_us(lambda: fn(*v, *ptrs, B, Hh, Ww, window[0], window[1], *choice, tau,
                                     index, stream)),
        "call": host_us(lambda: mod.window_match_soft(*args)),
    }


def soft_loop_slots(names=("window_match_soft_halo", "window_match_soft")):
    """(instructions, exps) of the soft matcher kernel's innermost loop with
    the fewest SASS instructions an exp (MUFU.EX2), read with cuobjdump from
    the built library: a loop is the span from a backward branch's target to
    the branch. The first of ``names`` the library holds is the kernel (this
    tree's halo kernel, or the previous tree's one kernel)."""
    import shutil

    from delora_tpu_torch.ops.cuda import window_match as wm_mod
    from delora_tpu_torch.ops.cuda.build import library_path

    wm_mod._launchers()                                 # builds the library if needed
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library_path("window_match"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    return loop_slots(sass, names)


def loop_slots(sass: str, names):
    """(instructions, exps) of the innermost loop with the fewest
    instructions an exp in the first function of ``sass`` (cuobjdump -sass
    text) whose name holds one of ``names``, tried in order."""
    import re

    functions = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        functions[chunk.split("\n", 1)[0].strip()] = [
            (int(m.group(1), 16), m.group(2).strip())
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
    name = next(n for want in names for n in functions if want in n)
    code = functions[name]
    loops = []
    for addr, text in code:
        m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for start, end in loops:
        if any((s, e) != (start, end) and start <= s and e <= end for s, e in loops):
            continue                                    # not innermost
        body = [t for a, t in code if start <= a <= end]
        exps = sum(bool(re.search(r"\bMUFU\.EX2\b", t)) for t in body)
        if exps and (best is None or len(body) / exps < best[0] / best[1]):
            best = (len(body), exps)
    if best is None:
        raise RuntimeError(f"no loop with an exp in the SASS of {name}")
    return best


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
                          "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def issue_floor_ms(instructions_per_candidate: float, candidates: int) -> float:
    """The least time the card's SMs take to issue ``instructions_per_candidate``
    for each of ``candidates``: 128 lanes an SM a cycle at the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * LANES_PER_SM * max_sm_clock_mhz() * 1e6
    return instructions_per_candidate * candidates / rate * 1e3


def check_soft(label, out, ref):
    """Raise unless the soft matcher's best_sq (and so its misses) is
    bit-equal to its plain version's and its blends lie within SOFT_RTOL /
    SOFT_ATOL -> (max abs diff of the blends, their values not bit-equal)."""
    require_equal(f"{label} best_sq", out[:1], ref[:1])
    pairs = list(zip(out[1:], ref[1:]))
    err = max((a - b).abs().max().item() for a, b in pairs)
    differ = sum(int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32))
                     .sum().item()) for a, b in pairs)
    for a, b in pairs:
        if not torch.allclose(a, b, rtol=SOFT_RTOL, atol=SOFT_ATOL):
            raise RuntimeError(f"{label}: blend differs from its plain version by {err} "
                               f"(rtol {SOFT_RTOL}, atol {SOFT_ATOL})")
    return err, differ


def soft_underflow(src, tgt_xyz, window, sigma: float) -> int:
    """Occupied candidates whose weight exp(-sq / sigma^2) lies below FLT_MIN,
    which the soft blend flushes to +0 so that they add nothing (|d|^2 is
    summed plainly here, so a count at the boundary may differ from the
    kernel's by a few)."""
    wv, wu = window
    tau = float(np.float32(1.0 / sigma ** 2))
    tiny = float(np.finfo(np.float32).tiny)
    Hh = src.shape[1]
    pad = torch.nn.functional.pad(tgt_xyz, (0, 0, 0, 0, wv // 2, wv // 2))
    count = 0
    for dv in range(wv):
        slab = pad[:, dv:dv + Hh]
        for du in range(-(wu // 2), wu // 2 + 1):
            cand = torch.roll(slab, -du, dims=2)
            sq = ((cand - src) ** 2).sum(-1)
            count += int(((torch.exp(-sq * tau) < tiny) & (cand != 0).any(-1)).sum().item())
    return count


def matcher_cases(trainer, spec, scan, rng):
    """The matchers' inputs: (wrapper name, args) by label. The train
    batch's target images (duplicated columns, empty rows) against noisy
    copies held as the xyz slice of [B, H, W, 7] images, windows (5,9) and
    (9,17) at B = 8, hard and soft (sigma 0.3); the index search of the
    reverse term (the target images' pixels against a warped-source image
    and its occupancy plane); one ray-cast scan at 64x2250, B = 1, hard at
    (5,9) and soft at (9,17)."""
    from delora_tpu_torch.ops.projection import project_image_packed_batch

    dev = trainer.device
    tables, idx = first_targets(trainer)
    src, tgt, nrm = matcher_inputs(tables.image[idx], tables.normal_image[idx], rng)
    pos, valid, vals = warped_survivors(trainer)
    payload = torch.cat([pos, vals[..., 3:7]], -1).contiguous()    # warped xyz, normal, 1
    wimage = project_image_packed_batch(pos, valid, spec, values=payload, append_range=False)
    query = tables.image[idx][..., 0:3]
    wsrc, wtgt, wnrm = wide_inputs(spec, scan, rng)
    B = src.shape[0]
    sigma = RECIPE["soft_match_sigma"]
    return {f"hard (5, 9) B={B}": ("window_match", (src, tgt, nrm, (5, 9))),
            f"hard (9, 17) B={B}": ("window_match", (src, tgt, nrm, (9, 17))),
            f"index (5, 9) B={B}": ("window_match_indices",
                                    (query, wimage[..., 0:3], wimage[..., 6], (5, 9))),
            "hard (5, 9) B=1 64x2250": ("window_match", (wsrc, wtgt, wnrm, (5, 9))),
            f"soft (5, 9) B={B}": ("window_match_soft", (src, tgt, nrm, (5, 9), sigma)),
            f"soft (9, 17) B={B}": ("window_match_soft", (src, tgt, nrm, (9, 17), sigma)),
            "soft (9, 17) B=1 64x2250": ("window_match_soft",
                                         (wsrc, wtgt, wnrm, (9, 17), sigma))}


def kernel_time(nn: bool, matcher: bool) -> None:
    """``--nn-time`` / ``--matcher-time`` (see the module docstring)."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.ops.cuda import nn_search as nn_mod
    from delora_tpu_torch.ops.cuda import window_match as wm_mod
    from delora_tpu_torch.ops.projection import ProjectionSpec
    from delora_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    card = card_line()
    say(f"kernel-time: {nn_mod.__file__} | torch {torch.__version__} on {card}")
    rng = np.random.default_rng(SEED)
    scans, normals = drive(24, rng)
    config = default_config({"batch_size": TRAIN_B})
    spec = ProjectionSpec.from_config(config)
    trainer = Trainer(config, [list(zip(scans, normals))], device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    results = {}

    def measure(label, call, calls, host, verdict="bit-equal to plain"):
        ms = cuda_ms(call, reps=5 if calls < 20 else 25, inner=3 if calls < 20 else 20)
        passes = passes_us(call, calls)
        results[label] = dict(ms=ms, device_us=sum(passes.values()), passes=passes, host_us=host)
        say(f"{label}: {verdict} | call {ms * 1e3:.2f} us, device "
            f"{sum(passes.values()):.2f} us (" + ", ".join(f"{k} {v:.2f} us" for k, v in
                                                          passes.items())
            + ") | host us: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
            + f" on {card}")

    if nn:
        for label, args in nn_cases(trainer, scans, normals, spec, rng).items():
            require_equal(f"nn_search {label}", nn_mod.nn_search(*args),
                          nn_mod.nn_search_plain(*args))
            measure(f"nn_search {label}", lambda args=args: nn_mod.nn_search(*args), 5,
                    nn_host_split(nn_mod, args))
    if matcher:
        slots, exps = soft_loop_slots()
        say(f"soft matcher SASS ({wm_mod.__file__}): its cheapest loop takes {slots} "
            f"instructions for {exps} exps, {slots / exps:.2f} an exp")
        for label, (name, args) in matcher_cases(trainer, spec, scans[0], rng).items():
            fn = getattr(wm_mod, name)
            out, ref = fn(*args), getattr(wm_mod, name + "_plain")(*args)
            if name != "window_match_soft":
                require_equal(label, out, ref)
                measure(label, lambda fn=fn, args=args: fn(*args), 50,
                        matcher_host_split(wm_mod, name, args))
                continue
            err, differ = check_soft(label, out, ref)
            measure(label, lambda fn=fn, args=args: fn(*args), 50, soft_host_split(wm_mod, args),
                    f"best_sq and misses bit-equal to plain, blends max abs diff {err:.3e} "
                    f"({differ} of {2 * out[1].numel()} values not bit-equal)")
    print(json.dumps({"kernel_time": results}), flush=True)


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
        yard = placement_yardstick(args[0], args[1], hw, packed=False)
        lib_ms = cuda_ms(yard)
        C = pts.shape[-1]
        moved = batch * N * 8 + int(occ.sum().item()) * C * 4 + batch * hw * (C + 1) * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        say(f"placement exact B={batch} N={N} {spec.height}x{spec.width}: bit-equal to plain, "
            f"occupancy {occ.float().mean().item():.4f}, {in_fov.sum().item()} in FoV | kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, scatter_reduce amin "
            f"{lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({moved} B) on {card}")
        if batch == 1:    # serving projects one scan at a time
            dev_ms = placement_device_times("placement exact B=1", lambda: placement(*args),
                                            yard, lib_ms, card)
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                          device_ms=dev_ms)
    return timing, max_err


def placement_device_times(label, call, yard, lib_ms, card):
    """Print a placement call's device time by pass and the yardstick's device
    time beside its call (torch.profiler, 50 calls) -> the call's device ms
    (None when the profiler saw no device time)."""
    passes, _ = device_kernel_times(call, 50)
    passes = {k[k.index(n):].split("(")[0]: v for k, v in passes.items()
              for n in PLACEMENT_KERNELS if n in k}
    lib_dev, _ = device_kernel_times(yard, 50)
    dev_ms = sum(passes.values()) or None
    say(f"{label} device time (torch.profiler): "
        + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us = " + " + ".join(
            f"{k} {v * 1e3:.2f} us" for k, v in passes.items()))
        + f"; scatter_reduce amin yardstick: call {lib_ms * 1e3:.2f} us, device "
        f"{sum(lib_dev.values()) * 1e3:.2f} us per call on {card}")
    return dev_ms


def preprocess_input(scan, spec, capacity):
    """One raw scan padded to the preprocessing capacity, on the card, as
    ``Preprocessor.preprocess_scan`` stages it -> (points [1, N, 3], valid)."""
    n = min(len(scan), capacity)
    pts = torch.zeros(1, capacity, 3)
    pts[0, :n] = torch.from_numpy(np.ascontiguousarray(scan[:n, :3]))
    valid = torch.zeros(1, capacity, dtype=torch.bool)
    valid[0, :n] = True
    return pts.cuda(), valid.cuda()


def check_exact_placement_preprocess(scan, card):
    """Phase 4a, the preprocessing shape: the exact rule at 64x2250 with
    N = 147,456 (the KITTI staging capacity) on a drive scan, bit-equal to
    its plain version on the card and on the CPU -> (timing, max abs error)."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.data.preprocess import staging_capacity
    from delora_tpu_torch.ops.cuda.placement import placement, placement_plain
    from delora_tpu_torch.ops.projection import ProjectionSpec, _pixel_coords

    config = default_config(mode="preprocessing")
    spec = ProjectionSpec.from_config(config, "kitti", preprocessing=True)
    capacity = staging_capacity(config, "kitti", spec)
    pts, valid = preprocess_input(scan, spec, capacity)
    r, _, _, in_fov, pix = _pixel_coords(pts, valid, spec)
    args = (pix.contiguous(), r.contiguous(), pts.contiguous(), spec.height, spec.width)
    out = placement(*args)
    ref = placement_plain(*args)
    torch.cuda.synchronize()
    err = require_equal(f"placement exact {spec.height}x{spec.width} N={capacity}", [out], [ref])
    cpu = placement_plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    if not torch.equal(cpu, out.cpu()):
        raise RuntimeError("placement at the preprocessing shape differs from the CPU plain "
                           "version")
    hw = spec.height * spec.width
    occ = ref[..., 3] > 0
    ms = cuda_ms(lambda: placement(*args))
    plain_ms = cuda_ms(lambda: placement_plain(*args), reps=10, inner=5)
    yard = placement_yardstick(args[0], args[1], hw, packed=False)
    lib_ms = cuda_ms(yard)
    dev_ms = placement_device_times(f"placement exact preprocessing {spec.height}x{spec.width}",
                                    lambda: placement(*args), yard, lib_ms, card)
    moved = capacity * 8 + int(occ.sum().item()) * 3 * 4 + hw * 4 * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    say(f"placement exact B=1 N={capacity} {spec.height}x{spec.width} (preprocessing, "
        f"{int(valid.sum())} valid): bit-equal to plain on the card and the CPU, occupancy "
        f"{occ.float().mean().item():.4f}, {in_fov.sum().item()} in FoV | kernel "
        f"{ms * 1e3:.2f} us, device "
        + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us")
        + f", plain {plain_ms * 1e3:.2f} us, scatter_reduce amin {lib_ms * 1e3:.2f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({moved} B) on {card}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                device_ms=dev_ms, bound_by="bytes", max_abs_err=err,
                shape=f"B=1 N={capacity} {spec.height}x{spec.width}"), err


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
    r, _, _, _, pix = _pixel_coords(pos, valid, spec)
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
    yard = placement_yardstick(args[0], args[1], hw, packed=True)
    lib_ms = cuda_ms(yard)
    dev_ms = placement_device_times(f"placement packed B={B}", lambda: placement(*args, **kw),
                                    yard, lib_ms, card)
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


def check_placement_after_larger_call(trainer, spec, rng, card):
    """Phase 4g: the key workspace at the real shapes. The placement keeps
    its keys between calls and its write pass leaves them empty, so each
    call here follows a larger one on other data: the exact rule at B = 8,
    N = 131072 (64-bit keys over 8 images), then the serving shape (exact,
    B = 1), the main path's (packed, 32-bit keys, the warped survivors) and
    the large call again, each bit-equal to its plain version."""
    from delora_tpu_torch.ops.cuda.placement import placement, placement_plain
    from delora_tpu_torch.ops.projection import _pixel_coords

    dev = torch.device("cuda")

    def exact_args(batch):
        pts = torch.from_numpy(np.stack([kitti_like_cloud(rng, N, spec)
                                         for _ in range(batch)])).to(dev)
        r, _, _, _, pix = _pixel_coords(pts, torch.ones(batch, N, dtype=torch.bool, device=dev),
                                        spec)
        return (pix.contiguous(), r.contiguous(), pts, spec.height, spec.width), {}

    pos, valid, vals = warped_survivors(trainer)
    r, _, _, _, pix = _pixel_coords(pos, valid, spec)
    big = exact_args(TRAIN_B)
    calls = [(f"exact B={TRAIN_B} N={N}", big), (f"exact B=1 N={N}", exact_args(1)),
             (f"packed B={TRAIN_B} warped survivors", (
                 (pix.contiguous(), r.contiguous(), vals, spec.height, spec.width),
                 dict(packed=True, append_range=False))),
             (f"exact B={TRAIN_B} N={N} again", big)]
    err = 0.0
    for label, (args, kw) in calls:
        err = max(err, require_equal(f"placement after a larger call: {label}",
                                     [placement(*args, **kw)], [placement_plain(*args, **kw)]))
    say("placement after larger calls: " + ", then ".join(label for label, _ in calls)
        + f", each bit-equal to its plain version on {card}")
    return err


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


def matcher_bound(moved, visited, occupied, per_occupied):
    """(bound_ms, bound_by, bytes_ms, ops_ms) of a window matcher that moves
    ``moved`` bytes, spends 3 float32 operations on each visited candidate
    (its row test, column wrap and occupancy test) and ``per_occupied`` on
    each occupied one (the distance's three differences, its product and two
    fmas, counted as 9 with the compare, plus whatever the branch adds)."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = (3 * visited + per_occupied * occupied) / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms


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

    tables, idx = first_targets(trainer)
    src, tgt, nrm = matcher_inputs(tables.image[idx], tables.normal_image[idx], rng)
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
        bound_ms, bound_by, bytes_ms, ops_ms = matcher_bound(moved, visited, occupied, 9)
        say(f"window_match B={B} {Hh}x{Ww} window {window}: bit-equal to plain (sq, xyz, nrm), "
            f"{found.float().mean().item():.4f} of pixels matched | kernel {ms * 1e3:.2f} us, "
            "device " + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us")
            + f", plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
            f"({moved} B: {bytes_ms * 1e3:.2f} us; {visited} candidates visited, {occupied} "
            f"occupied: {ops_ms * 1e3:.2f} us) on {card}")
        if window == (5, 9):
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                          bound_by=bound_by, device_ms=dev_ms)
    src, tgt, nrm = wide_inputs(spec, scan, rng)
    out = window_match(src, tgt, nrm, (5, 9))
    err = max(err, require_equal("window_match 64x2250", out,
                                 window_match_plain(src, tgt, nrm, (5, 9))))
    ms = cuda_ms(lambda: window_match(src, tgt, nrm, (5, 9)), reps=10, inner=5)
    plain_ms = cuda_ms(lambda: window_match_plain(src, tgt, nrm, (5, 9)), reps=5, inner=2)
    dev_ms = profiled_device_ms(lambda: window_match(src, tgt, nrm, (5, 9)), MATCHER_KERNELS)
    moved = 2250 * spec.height * 64
    visited, occupied = window_work(tgt, (5, 9))
    bound_ms, bound_by, bytes_ms, ops_ms = matcher_bound(moved, visited, occupied, 9)
    say(f"window_match B=1 64x2250 window (5, 9): bit-equal to plain, "
        f"{torch.isfinite(out[0]).float().mean().item():.4f} of pixels matched | kernel "
        f"{ms * 1e3:.2f} us, device " + ("not measured" if dev_ms is None else
                                          f"{dev_ms * 1e3:.2f} us")
        + f", plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
        f"({moved} B: {bytes_ms * 1e3:.2f} us;"
        f" {occupied} occupied candidates: {ops_ms * 1e3:.2f} us) on {card}")
    return timing, err


def once_ms(fn) -> float:
    """One call's time by CUDA events (for plain versions too slow to repeat)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def check_soft_matcher(trainer, spec, scan, rng, card):
    """Phase 4d: the soft matcher at the train shapes (halo kernel), at
    64x2250 and at a window past a block's shared memory (global kernel)."""
    from delora_tpu_torch.ops.cuda.window_match import window_match_soft, window_match_soft_plain

    sigma = RECIPE["soft_match_sigma"]
    tables, idx = first_targets(trainer)
    src, tgt, nrm = matcher_inputs(tables.image[idx], tables.normal_image[idx], rng)
    wide = wide_inputs(spec, scan, rng)
    slots, exps = soft_loop_slots()
    per_candidate = slots / exps
    say(f"window_match_soft SASS: the halo kernel's cheapest loop takes {slots} instructions "
        f"for {exps} exps, {per_candidate:.2f} an exp; SM clock at most "
        f"{max_sm_clock_mhz():.0f} MHz")
    cases = [((src, tgt, nrm), (5, 9), True), ((src, tgt, nrm), (9, 17), True),
             (wide, (9, 17), False), (tuple(t[:1] for t in (src, tgt, nrm)), LARGE_SOFT_WINDOW,
                                      False)]
    err, timing = 0.0, None
    for (s, t, n), window, timed in cases:
        B, Hh, Ww, _ = s.shape
        label = f"window_match_soft sigma {sigma} B={B} {Hh}x{Ww} window {window}"
        out = window_match_soft(s, t, n, window, sigma)
        ref = window_match_soft_plain(s, t, n, window, sigma)
        torch.cuda.synchronize()
        blend_err, differ = check_soft(label, out, ref)
        err = max(err, blend_err)
        found = torch.isfinite(ref[0])
        call = (lambda s=s, t=t, n=n, window=window: window_match_soft(s, t, n, window, sigma))
        ms = cuda_ms(call, reps=10 if timed else 5, inner=20 if timed else 2)
        dev_ms = profiled_device_ms(call, SOFT_KERNELS, calls=50 if timed else 5)
        # Bytes as the hard matcher's; per occupied candidate beside the
        # distance: the exponent's product, the exp, seven products and seven
        # sums, the minimum (17 more than the hard branch's 9).
        moved = B * Hh * Ww * 64
        visited, occupied = window_work(t, window)
        bound_ms, bound_by, bytes_ms, ops_ms = matcher_bound(moved, visited, occupied, 26)
        floor_ms = issue_floor_ms(per_candidate, occupied)
        underflowed = soft_underflow(s, t, window, sigma)
        plain_ms = (cuda_ms(lambda: window_match_soft_plain(s, t, n, window, sigma), reps=3,
                            inner=2) if timed else None)
        say(f"{label}: best_sq and misses bit-equal to plain, blends max abs diff "
            f"{blend_err:.3e} ({differ} of {2 * out[1].numel()} values not bit-equal; limit "
            f"rtol {SOFT_RTOL} atol {SOFT_ATOL}), {found.float().mean().item():.4f} of pixels "
            f"matched, {underflowed} of {occupied} occupied candidates weigh +0 | kernel "
            f"{ms * 1e3:.2f} us, device "
            + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us")
            + ("" if plain_ms is None else f", plain {plain_ms * 1e3:.2f} us")
            + f", bound {bound_ms * 1e3:.2f} us by {bound_by} ({moved} B: {bytes_ms * 1e3:.2f} "
            f"us; {visited} candidates visited, {occupied} occupied: {ops_ms * 1e3:.2f} us), "
            f"issue-slot floor {floor_ms * 1e3:.2f} us ({per_candidate:.2f} instructions x "
            f"{occupied} occupied candidates)"
            + ("" if dev_ms is None else f", {floor_ms / dev_ms:.3f} of it reached")
            + f" on {card}")
        if timed and window == (5, 9):
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                          bound_by=bound_by, device_ms=dev_ms, floor_ms=floor_ms,
                          floor_instructions_per_candidate=per_candidate)
    return timing, err


def check_index_matcher(trainer, spec, card):
    """Phase 4e: the reverse direction's index search at the train shape:
    the target images' pixels against a warped-source image and its
    occupancy plane."""
    from delora_tpu_torch.ops.cuda.window_match import (
        window_match_indices,
        window_match_indices_plain,
    )
    from delora_tpu_torch.ops.projection import project_image_packed_batch

    pos, valid, vals = warped_survivors(trainer)
    payload = torch.cat([pos, vals[..., 3:7]], -1).contiguous()    # warped xyz, normal, 1
    wimage = project_image_packed_batch(pos, valid, spec, values=payload, append_range=False)
    tables, idx = first_targets(trainer)
    query = tables.image[idx][..., 0:3]
    args = (query, wimage[..., 0:3], wimage[..., 6], (5, 9))
    out = window_match_indices(*args)
    ref = window_match_indices_plain(*args)
    torch.cuda.synchronize()
    err = require_equal("window_match_indices", out, ref)
    B, Hh, Ww, _ = query.shape
    ms = cuda_ms(lambda: window_match_indices(*args))
    plain_ms = cuda_ms(lambda: window_match_indices_plain(*args), reps=5, inner=2)
    dev_ms = profiled_device_ms(lambda: window_match_indices(*args), MATCHER_KERNELS)
    # Read the query xyz, the candidate xyz and occupancy (28 B a pixel),
    # write the offset and squared distance (8 B).
    moved = B * Hh * Ww * 36
    visited, occupied = window_work(wimage[..., 0:3], (5, 9))
    bound_ms, bound_by, bytes_ms, ops_ms = matcher_bound(moved, visited, occupied, 9)
    found = torch.isfinite(ref[1]) & (query != 0).any(-1)
    say(f"window_match_indices B={B} {Hh}x{Ww} window (5, 9), occupancy plane: bit-equal to "
        f"plain (k, sq), {found.float().mean().item():.4f} of pixels matched | kernel "
        f"{ms * 1e3:.2f} us, device " + ("not measured" if dev_ms is None else
                                          f"{dev_ms * 1e3:.2f} us")
        + f", plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
        f"({moved} B: {bytes_ms * 1e3:.2f} us; {occupied} occupied candidates: "
        f"{ops_ms * 1e3:.2f} us) on {card}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                device_ms=dev_ms), err


def nn_bound(src, valid_tgt):
    """(bound ms, what sets it, pairs): 8 float32 operations a (source,
    valid target) pair of the same batch; bytes: sources, targets and their
    flags read once, indices and distances written once."""
    B, S, _ = src.shape
    T = valid_tgt.shape[1]
    pairs = S * int(valid_tgt.sum().item())
    ops_ms = 8 * pairs / FP32_OPS_PER_S * 1e3
    bytes_ms = (B * S * 12 + B * T * 13 + B * S * 8) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), pairs


def kernel_label(key: str) -> str:
    """A profiler kernel name without its namespace and arguments."""
    key = key.replace("(anonymous namespace)::", "")
    return (key[5:] if key.startswith("void ") else key).split("(")[0]


def passes_us(call, calls: int):
    """Device microseconds per call of each kernel ``call`` launches
    (torch.profiler), by kernel name."""
    times, _ = device_kernel_times(call, calls)
    return {kernel_label(k): v * 1e3 for k, v in times.items()}


def nn_cases(trainer, scans, normals, spec, rng):
    """The 1-NN's inputs at the brute path's shapes: the train batch's warped
    survivors against the padded target clouds (N points) and their survivor
    masks, and a near-tie cloud (targets with 10% exact duplicates and points
    1e-4 nearer on their rays, a third valid; sources near random targets);
    each at B = 8 and, as its first row, B = 1. -> {label: (src, tgt, valid)}."""
    from delora_tpu_torch.ops.projection import project_scan_batch
    from delora_tpu_torch.training.trainer import padded_scan

    dev = trainer.device
    pos, _, _ = warped_survivors(trainer)
    padded = [padded_scan(scans[i], normals[i], N) for i in first_targets(trainer)[1].tolist()]
    pts = torch.from_numpy(np.stack([p for p, _, _ in padded])).to(dev)
    mask = torch.from_numpy(np.stack([m for _, _, m in padded])).to(dev)
    survivor = project_scan_batch(pts, mask, spec).survivor
    B, S, _ = pos.shape
    tie_t = torch.from_numpy(np.stack([near_tie_cloud(rng, N, spec) for _ in range(B)])).to(dev)
    tie_v = torch.from_numpy(rng.random((B, N)) < 0.35).to(dev)
    pick = torch.from_numpy(rng.integers(0, N, (B, S))).to(dev)
    noise = torch.from_numpy(rng.normal(0, 0.01, (B, S, 3)).astype(np.float32)).to(dev)
    tie_s = (torch.gather(tie_t, 1, pick[..., None].expand(-1, -1, 3)) + noise).contiguous()
    cases = {}
    for name, args in (("survivors", (pos, pts, survivor)), ("near-tie", (tie_s, tie_t, tie_v))):
        cases[f"{name} B={B}"] = args
        cases[f"{name} B=1"] = tuple(a[:1] for a in args)
    return cases


def check_nn_search(trainer, scans, normals, spec, rng, card):
    """Phase 4f: the exact 1-NN at the brute path's shape (B = 8) and at
    B = 1, on the train batch's warped survivors and on a near-tie cloud,
    bit-equal to its plain version; timed on the survivors."""
    from delora_tpu_torch.ops.cuda.nn_search import nn_search, nn_search_plain

    cases = nn_cases(trainer, scans, normals, spec, rng)
    err, timing = 0.0, None
    for label, args in cases.items():
        out = nn_search(*args)
        ref = []
        plain_ms = once_ms(lambda: ref.extend(nn_search_plain(*args)))
        err = max(err, require_equal(f"nn_search ({label})", out, ref))
        if not label.startswith("survivors"):
            say(f"nn_search {label}: bit-equal to plain (idx, sq) on {card}")
            continue
        B, S, _ = args[0].shape
        ms = cuda_ms(lambda: nn_search(*args), reps=5, inner=3)
        passes = {k: v for k, v in passes_us(lambda: nn_search(*args), 5).items()
                  if any(n in k for n in NN_KERNELS)}
        dev_ms = sum(passes.values()) / 1e3 or None
        bound_ms, bound_by, pairs = nn_bound(args[0], args[2])
        say(f"nn_search {label} S={S} T={N}: bit-equal to plain (idx, sq), "
            f"{args[2].sum(1).tolist()} valid targets | kernel {ms * 1e3:.2f} us, device "
            + ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us = " + " + ".join(
                f"{k} {v:.2f} us" for k, v in passes.items()))
            + f", plain {plain_ms * 1e3:.2f} us (one call), bound {bound_ms * 1e3:.2f} us by "
            f"{bound_by} ({pairs} pairs x 8 operations) on {card}")
        if B == TRAIN_B:
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                          bound_by=bound_by, device_ms=dev_ms)
    return timing, err


def run_serving(config, scans, spec, card):
    """Phase 5, as in the serving slice."""
    from torch.profiler import ProfilerActivity, profile

    from delora_tpu_torch.ops.projection import project_image
    from delora_tpu_torch.serving.stream import StreamingOdometry
    from delora_tpu_torch.training.step import forward_pose

    dev = torch.device("cuda")
    say(f"serving: {len(scans)} ray-cast scans, {min(map(len, scans))}-"
        f"{max(map(len, scans))} points each")
    engine = StreamingOdometry(config, device=dev)
    reset_launches()
    latencies, transforms, steps = [], [], {}
    for scan in scans:
        out = engine.push_scan(scan)
        if out is not None:
            check_rigid(out[0])
            transforms.append(out[0])
            latencies.append(out[2])
            for key, dt in engine.step_times.items():
                steps.setdefault(key, []).append(dt)
    launches = path_launches("serving", {"placement": len(scans)})
    say(f"serving bf16: {len(latencies)} pairs, every T finite and rigid, launches "
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


def first_targets(trainer):
    """The drive's device tables and the target rows of its first B pairs."""
    feed = trainer.feeds["kitti"]
    return feed.tables, torch.as_tensor(feed.pair_target[:TRAIN_B], device=trainer.device)


def first_batch(trainer):
    """The batch of the first B pairs, gathered from the trainer's tables."""
    feed = trainer.feeds["kitti"]
    return trainer.batch(torch.as_tensor(feed.pair_target[:TRAIN_B], device=trainer.device),
                         torch.as_tensor(feed.pair_source[:TRAIN_B], device=trainer.device))


def counters():
    """Each kernel row's launch count, by row name -> (wrapper, attribute).
    The placement wrapper counts its two winner rules apart."""
    from delora_tpu_torch.ops.cuda.nn_search import nn_search
    from delora_tpu_torch.ops.cuda.placement import placement
    from delora_tpu_torch.ops.cuda.window_match import (
        window_match,
        window_match_indices,
        window_match_soft,
    )

    return {"placement": (placement, "launches_exact"),
            "placement_packed": (placement, "launches_packed"),
            "window_match": (window_match, "launches"),
            "window_match_soft": (window_match_soft, "launches"),
            "window_match_index": (window_match_indices, "launches"),
            "nn_search": (nn_search, "launches")}


# Path -> each kernel's launches in that path's run (see path_launches).
PATH_LAUNCHES = {}


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for wrapper, attr in counters().values():
        setattr(wrapper, attr, 0)


def path_launches(path: str, expected) -> dict:
    """The launches since :func:`reset_launches`, read just after ``path``
    was driven and kept as its own: fails unless each kernel named in
    ``expected`` launched that often and every other kernel not at all.
    -> the kernels that launched, with their counts."""
    counts = {name: getattr(wrapper, attr) for name, (wrapper, attr) in counters().items()}
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise RuntimeError(f"{path}: kernel launches {counts}, expected {want}")
    PATH_LAUNCHES[path] = counts
    return {name: n for name, n in counts.items() if n}


def check_steps(trainer, epoch, positive=()):
    """Every step of the last epoch: metrics finite, no overflowing tile,
    and the ``positive`` metrics > 0."""
    for key, values in trainer.last_steps.items():
        if not np.isfinite(values).all():
            raise RuntimeError(f"epoch {epoch}: metric {key} not finite: {values}")
    if (trainer.last_steps["placement_overflow_tiles"] != 0).any():
        raise RuntimeError(f"epoch {epoch}: placement overflow "
                           f"{trainer.last_steps['placement_overflow_tiles']}")
    for key in positive:
        if not (trainer.last_steps[key] > 0).all():
            raise RuntimeError(f"epoch {epoch}: {key} not > 0: {trainer.last_steps[key]}")


def run_training(trainer, card, label, epochs, per_step, positive=()):
    """Train ``epochs`` epochs (2 supervised, then unsupervised) as the path
    ``label`` and check its kernel launches: ``per_step`` maps a kernel row
    to its launches a step, every other kernel launches none. -> steady-state
    pairs/s."""
    reset_launches()
    steps, history = 0, []
    # The warmup's own switch (epoch loss < 1e-2) would take hundreds of steps
    # at lr 1e-5 from random weights, so the run switches after 2 epochs.
    for epoch in range(epochs):
        if epoch == 2:
            trainer.supervised = False
        metrics = trainer.train_epoch(epoch)
        check_steps(trainer, epoch, positive)
        steps += metrics["steps"]
        history.append(metrics)
        say(f"{label} epoch {epoch} ({'supervised' if epoch < 2 else 'unsupervised'}): "
            f"{metrics['steps']} steps, loss {metrics['loss']:.6f}, loss_pc "
            f"{metrics['loss_pc']:.6f}, po2pl {metrics['loss_po2pl']:.6f}, pl2pl "
            f"{metrics['loss_pl2pl']:.6f}, rev {metrics['loss_po2pl_rev']:.6f}, pairs "
            f"{metrics['num_po2pl_pairs']:.1f}, visible {metrics['visible_pixels']:.1f}, "
            f"grad_norm {metrics['grad_norm']:.4e}, {metrics['epoch_seconds'] * 1e3:.1f} ms")
    launches = path_launches(label, {name: k * steps for name, k in per_step.items()})
    steady = history[3:]
    pairs_per_s = (sum(h["steps"] for h in steady) * trainer.batch_size
                   / sum(h["epoch_seconds"] for h in steady))
    say(f"{label} B={trainer.batch_size}: {steps} steps (4 supervised), every step's metrics "
        f"finite{''.join(f', {k} > 0' for k in positive)}, overflow tiles 0, launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()) + f" for {steps} steps | steady "
        f"state (epochs 3-{epochs - 1}, host clock, one readback an epoch) {pairs_per_s:.1f} "
        f"pairs/s on {card}")
    return pairs_per_s


def model_images(trainer, batch):
    """The model's two input images of a batch (projected on the raw feed)."""
    from delora_tpu_torch.ops.projection import project_compact_exact_batch, project_scan_batch

    if trainer.feed == "full":
        return batch.image_1, batch.image_2
    spec = trainer.feeds["kitti"].spec
    return (project_scan_batch(batch.points_1, batch.valid_1, spec).image,
            project_compact_exact_batch(batch.points_2, batch.valid_2, spec).image)


def step_split(trainer, card, label):
    """The device time of a train step by part, and the card's idle share."""
    from delora_tpu_torch.training.step import StepConfig, forward_pose

    cfg = StepConfig.from_config(trainer.config, trainer.dataset, supervised=False)
    batch = first_batch(trainer)
    model = trainer.model
    times, wall_ms = device_kernel_times(lambda: trainer.step(batch, cfg), calls=5)
    image_1, image_2 = model_images(trainer, batch)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        forward_pose(model, image_1, image_2,
                     generator=trainer.dropout_generator).square().sum().backward()

    fb_times, _ = device_kernel_times(fwd_bwd, calls=5)
    total = sum(times.values())

    def part(names):
        return sum(v for k, v in times.items() if any(s in k.lower() for s in names))

    split = {"forward+backward": sum(fb_times.values()),
             "matcher": part(MATCHER_KERNELS + SOFT_KERNELS), "1-NN": part(NN_KERNELS),
             "placement": part(tuple(k.lower() for k in PLACEMENT_KERNELS)),
             "optimizer": part(OPTIMIZER_KERNELS)}
    split["rest"] = total - sum(split.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    say(f"{label} step device time (torch.profiler, 5 steps, B={trainer.batch_size}): total "
        f"{total:.3f} ms of {wall_ms:.3f} ms wall, idle share {1 - total / wall_ms:.3f} | "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f" on {card}")
    say(f"{label} step largest kernels: " + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
    return split, total, wall_ms


def check_fp32_step(trainer, label, overrides=None):
    """One fp32 step (TF32 off) on the card against the CPU's plain path,
    on the trainer's first batch and fresh seeded params."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.training.state import make_optimizer
    from delora_tpu_torch.training.step import StepConfig, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = default_config({"compute_dtype": "float32", **(overrides or {})},
                           base=trainer.config)
    step_cfg = StepConfig.from_config(cfg32, supervised=False)
    model = OdometryModel(ModelConfig.from_config(cfg32),
                          torch.Generator().manual_seed(SEED + 1)).to(trainer.device)
    model_cpu = copy.deepcopy(model).cpu()
    batch = first_batch(trainer)
    batch_cpu = type(batch)(*(t.cpu() for t in batch))
    out = train_step(model, make_optimizer(cfg32, model.parameters(), trainer.batch_size)[0],
                     batch, step_cfg)
    t0 = time.perf_counter()
    ref = train_step(model_cpu, make_optimizer(cfg32, model_cpu.parameters(),
                                               trainer.batch_size)[0], batch_cpu, step_cfg)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for key, value in ref.items():
        a, b = float(out[key]), float(value)
        rel = abs(a - b) / max(abs(b), 1e-6)
        worst = max(worst, rel)
        if rel > FP32_RTOL:
            raise RuntimeError(f"{label} fp32 step: {key} card {a} vs CPU {b} (rel {rel:.2e} > "
                               f"{FP32_RTOL})")
    say(f"{label} fp32 (TF32 off) card vs CPU step on the same batch (B={trainer.batch_size}) "
        f"and params: loss {float(out['loss']):.6f} vs {float(ref['loss']):.6f}, grad_norm "
        f"{float(out['grad_norm']):.6f} vs {float(ref['grad_norm']):.6f}, pairs "
        f"{float(out['num_po2pl_pairs']):.1f} vs {float(ref['num_po2pl_pairs']):.1f}, rev "
        f"{float(out['loss_po2pl_rev']):.6f} vs {float(ref['loss_po2pl_rev']):.6f}; worst "
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


def check_ema(trainer, card):
    """The recipe's EMA weights are finite and apart from the live ones, and
    the deploy model gives a finite, rigid pose on one pair."""
    from delora_tpu_torch.training.step import forward_pose

    deployed = trainer.deploy_model()
    live = dict(trainer.model.named_parameters())
    apart = 0
    for name, value in deployed.named_parameters():
        if not torch.isfinite(value).all():
            raise RuntimeError(f"EMA weight {name} not finite")
        apart += int(not torch.equal(value, live[name]))
    if apart == 0 or deployed.training:
        raise RuntimeError("the deploy model is the live model")
    batch = first_batch(trainer)
    with torch.no_grad():
        T = forward_pose(deployed, batch.image_1[:1], batch.image_2[:1])[0].cpu().numpy()
    check_rigid(T)
    drift = max((v - live[k]).abs().max().item() for k, v in deployed.named_parameters())
    say(f"recipe EMA: {apart} of {len(live)} weight tensors apart from the live ones (max abs "
        f"{drift:.3e}), all finite; the deploy model's pose on one pair is finite and rigid "
        f"(translation {np.round(T[:3, 3], 4).tolist()}) on {card}")


def write_kitti_layout(root: str, scans) -> None:
    """The drive's scans as a KITTI raw layout under ``root``:
    ``sequences/00/velodyne/NNNNNN.bin`` and ``poses/00.txt``, the sensor's
    poses (1 m and 0.01 rad of yaw a scan, as ``drive`` moves it) in the KITTI
    camera frame."""
    import os

    from delora_tpu_torch.utils.poses import TRANSFORM_LIDAR_TO_WORLD as P

    velodyne = os.path.join(root, "sequences", "00", "velodyne")
    os.makedirs(velodyne)
    os.makedirs(os.path.join(root, "poses"))
    rows = []
    for k, scan in enumerate(scans):
        np.ascontiguousarray(scan, np.float32).tofile(os.path.join(velodyne, f"{k:06d}.bin"))
        c, s_ = math.cos(0.01 * k), math.sin(0.01 * k)
        pose = np.array([[c, -s_, 0.0, 1.0 * k], [s_, c, 0.0, 0.05 * k], [0.0, 0.0, 1.0, 0.0],
                         [0.0, 0.0, 0.0, 1.0]])
        rows.append((P @ pose @ P.T)[:3].ravel())
    np.savetxt(os.path.join(root, "poses", "00.txt"), np.asarray(rows))


def metrics_records(trainer):
    """The records of a disk trainer's metrics.jsonl."""
    import os

    with open(os.path.join(trainer.logger.run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def epoch_records(trainer):
    return [r for r in metrics_records(trainer) if "loss" in r]


def check_preprocessing_against_cpu(root, scans, card):
    """Two scans preprocessed on the CPU through the plain path against the
    card's files: survivors that differ (limit 0.05% of points) and the
    normals of common survivors (limit 1e-4 on >= 99.9% of them)."""
    import os

    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.data.preprocess import Preprocessor, staging_capacity
    from delora_tpu_torch.ops.normals import NormalsSpec
    from delora_tpu_torch.ops.projection import ProjectionSpec

    config = default_config(mode="preprocessing")
    pspec = ProjectionSpec.from_config(config, "kitti", preprocessing=True)
    nspec = NormalsSpec.from_config(config, "kitti")
    capacity = staging_capacity(config, "kitti", pspec)
    cpu = Preprocessor(config, device="cpu")
    points = moved = common = within = 0
    worst = 0.0
    for k in (0, len(scans) - 1):
        t0 = time.perf_counter()
        ref_pts, ref_nrm, _ = cpu.preprocess_scan(scans[k][:, :3], pspec, nspec, capacity)
        cpu_s = time.perf_counter() - t0
        base = os.path.join(root, "preprocessed", "00")
        pts = np.load(os.path.join(base, "scans", f"{k:06d}.npy"))
        nrm = np.load(os.path.join(base, "normals", f"{k:06d}.npy"))
        # Survivors keep the raw scan's order: match rows by their bytes.
        key = lambda a: np.ascontiguousarray(a).view(np.dtype((np.void, 12))).ravel()
        both, i_card, i_cpu = np.intersect1d(key(pts), key(ref_pts), return_indices=True)
        points += len(scans[k])
        moved += len(pts) + len(ref_pts) - 2 * len(both)
        diff = np.abs(nrm[i_card] - ref_nrm[i_cpu]).max(-1)
        common += len(both)
        within += int((diff <= 1e-4).sum())
        worst = max(worst, float(diff.max()))
        say(f"preprocess scan {k}: card {len(pts)} survivors, CPU {len(ref_pts)}, "
            f"{len(pts) - len(both)} only on the card, {len(ref_pts) - len(both)} only on the "
            f"CPU; normals of {len(both)} common survivors: max abs diff {diff.max():.3e}, "
            f"{int((diff > 1e-4).sum())} above 1e-4, zero rows card "
            f"{int((nrm == 0).all(-1).sum())} CPU {int((ref_nrm == 0).all(-1).sum())}; CPU "
            f"plain path {cpu_s:.2f} s")
    if moved > 0.0005 * points:
        raise RuntimeError(f"preprocessing: {moved} survivors differ between card and CPU, "
                           f"over 0.05% of {points} points")
    if within < 0.999 * common:
        raise RuntimeError(f"preprocessing: normals within 1e-4 on {within} of {common} "
                           f"common survivors (< 99.9%); worst {worst:.3e}")
    say(f"preprocess card vs CPU plain path on 2 scans: {moved} of {points} survivors differ "
        f"(limit 0.05%), normals within 1e-4 on {within} of {common} common survivors "
        f"({within / common:.5f}, limit 0.999), worst {worst:.3e} on {card}")


def run_disk_phase(scans, card):
    """Phase 9: the offline pipeline from disk through the command line, on
    the card, at the default KITTI width."""
    import os
    import shutil
    import tempfile

    from delora_tpu_torch import cli
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.data.preprocess import staging_capacity
    from delora_tpu_torch.ops.normals import NormalsSpec, normals_for_points
    from delora_tpu_torch.ops.projection import ProjectionSpec, project_scan_batch
    from delora_tpu_torch.training.tester import Tester
    from delora_tpu_torch.utils.poses import read_poses_from_text_file

    root = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    try:
        write_kitti_layout(os.path.join(root, "raw"), scans)
        kitti = {"data_path": os.path.join(root, "raw", "sequences"),
                 "preprocessed_path": os.path.join(root, "preprocessed"),
                 "pose_data_path": os.path.join(root, "raw", "poses"),
                 "training_identifiers": [0], "testing_identifiers": [0]}
        common = [f"kitti={json.dumps(kitti)}", f"log_dir={json.dumps(os.path.join(root, 'runs'))}"]
        ckpt = os.path.join(root, "ckpt")
        train = common + [f"batch_size={TRAIN_B}", "unsupervised_at_start=true",
                          "eval_every_epochs=1", "checkpoint_keep_every=2",
                          f"checkpoint_dir={json.dumps(ckpt)}"]

        # 1. preprocess on the card.
        reset_launches()
        t0 = time.perf_counter()
        pre = cli.main(["preprocess", "--set"] + common)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        pre_launches = path_launches("preprocess", {"placement": len(scans)})
        config = default_config(mode="preprocessing")
        pspec = ProjectionSpec.from_config(config, "kitti", preprocessing=True)
        nspec = NormalsSpec.from_config(config, "kitti")
        pts, valid = preprocess_input(scans[0], pspec, staging_capacity(config, "kitti", pspec))
        proj = project_scan_batch(pts, valid, pspec)
        project_ms = cuda_ms(lambda: project_scan_batch(pts, valid, pspec), reps=5, inner=5)
        normals_ms = cuda_ms(lambda: normals_for_points(proj.image[0, ..., :3], proj.u[0],
                                                        proj.v[0], proj.survivor[0], nspec),
                             reps=5, inner=5)
        per_scan = {k: v / len(scans) * 1e3 for k, v in pre.seconds.items()}
        say(f"preprocess (cli, card): {len(scans)} scans at {pspec.height}x{pspec.width} in "
            f"{pre_s:.2f} s, launches {pre_launches}; host "
            f"clock a scan: " + ", ".join(f"{k} {v:.2f} ms" for k, v in per_scan.items())
            + f"; CUDA events a scan: projection {project_ms:.3f} ms, normals "
            f"{normals_ms:.3f} ms on {card}")
        check_preprocessing_against_cpu(root, scans, card)

        # 2. train at full width for 3 epochs, with evaluation and checkpoints.
        # One packed placement and one matcher launch a step; the evaluation
        # projects on the host.
        reset_launches()
        trainer = cli.main(["train", "--epochs", "3", "--run-name", "disk", "--set"] + train)
        torch.cuda.synchronize()
        records = epoch_records(trainer)
        steps = sum(int(r["steps"]) for r in records)
        train_launches = path_launches("disk_train",
                                       {"placement_packed": steps, "window_match": steps})
        files = sorted(os.listdir(ckpt))
        if not {"latest", "epoch_00000", "epoch_00002", "best"} <= set(files):
            raise RuntimeError(f"disk train: checkpoints {files}")
        if len(records) != 3 or not all(np.isfinite(v) for r in records for v in r.values()):
            raise RuntimeError(f"disk train: epoch metrics {records}")
        n_params = sum(p.numel() for p in trainer.model.parameters())
        eval_scores = [r["eval_score"] for r in metrics_records(trainer) if "eval_score" in r]
        if len(eval_scores) != 3 or trainer.best_eval is None:
            raise RuntimeError(f"disk train: eval scores {eval_scores}")
        say(f"disk train (cli, card, {n_params} parameters, B={TRAIN_B}, bf16): set-up "
            f"{trainer.setup_seconds:.2f} s ({trainer.num_pairs} pairs, tables on the card: "
            f"{trainer.feeds['kitti'].tables is not None}); epochs " + "; ".join(
                f"{r['step']}: loss {r['loss']:.6f}, {r['steps']:.0f} steps, "
                f"{r['scan_pairs_per_sec']:.1f} pairs/s" for r in records)
            + f"; eval scores {eval_scores}, best "
            f"{trainer.best_eval}; checkpoints {files}; launches {train_launches} "
            f"for {steps} steps on {card}")

        # 3. resume from 'latest' for a fourth epoch.
        reset_launches()
        resumed = cli.main(["train", "--epochs", "4", "--run-name", "disk_resume",
                            "--checkpoint", os.path.join(ckpt, "latest"), "--set"] + train)
        torch.cuda.synchronize()
        resumed_records = epoch_records(resumed)
        if resumed.start_epoch != 3 or [r["step"] for r in resumed_records] != [3]:
            raise RuntimeError(f"resume started at {resumed.start_epoch}: {resumed_records}")
        steps = int(resumed_records[0]["steps"])
        resume_launches = path_launches("disk_resume",
                                        {"placement_packed": steps, "window_match": steps})
        say(f"disk resume: started at epoch {resumed.start_epoch}, unsupervised "
            f"{not resumed.supervised}, loss {resumed_records[0]['loss']:.6f}, launches "
            f"{resume_launches}")

        # 4. one epoch streamed from the host.
        reset_launches()
        streamed = cli.main(["train", "--epochs", "1", "--run-name", "disk_streamed",
                             "--set"] + train + [
            "hbm_cache_scans=8", "eval_every_epochs=0",
            f"checkpoint_dir={json.dumps(os.path.join(root, 'ckpt_streamed'))}"])
        torch.cuda.synchronize()
        stream_rec = epoch_records(streamed)[0]
        steps = int(stream_rec["steps"])
        stream_launches = path_launches("disk_streamed",
                                        {"placement_packed": steps, "window_match": steps})
        if streamed.feeds["kitti"].tables is not None or not np.isfinite(stream_rec["loss"]):
            raise RuntimeError("streamed epoch: tables on the card or loss not finite")
        say(f"disk streamed (hbm_cache_scans 8 < {len(scans)} scans): set-up "
            f"{streamed.setup_seconds:.2f} s, {stream_rec['steps']:.0f} steps, loss "
            f"{stream_rec['loss']:.6f}, {stream_rec['scan_pairs_per_sec']:.1f} pairs/s "
            f"(first epoch, host clock), launches {stream_launches} on {card}")

        # 5. test the best checkpoint: the cached path projects on the host.
        reset_launches()
        t0 = time.perf_counter()
        results = cli.main(["test", "--checkpoint", os.path.join(ckpt, "best"),
                            "--run-name", "disk_test"])
        test_s = time.perf_counter() - t0
        path_launches("disk_test", {})
        embedded = default_config(base=trainer.config)
        poses = read_poses_from_text_file(os.path.join(
            embedded["log_dir"], embedded["experiment"], "disk_test", "artifacts",
            "poses_kitti_00.txt"))
        if poses.shape != (len(scans), 4, 4):
            raise RuntimeError(f"pose file holds {poses.shape}")
        for pose in poses:
            check_rigid(pose)
        rpe = results["kitti"][0]
        if rpe is None or not np.isfinite(rpe).all():
            raise RuntimeError(f"test metrics not finite: {rpe}")
        say(f"disk test (cli, card): {len(poses)} poses finite and rigid, RPE t {rpe[0]:.4f} "
            f"m/step, r {rpe[1]:.4f} deg/step (a {len(scans) - 1} m drive, under the 100 m "
            f"KITTI segment); {test_s:.2f} s, {(len(scans) - 1) / test_s:.1f} pairs/s with "
            f"set-up and the host projection of every scan, on {card}")

        # 6. the tester's loss evaluation: the raw feed on the card.
        test_cfg = default_config({"inference_only": False}, base=trainer.config,
                                  mode="testing")
        tester = Tester(dict(test_cfg, checkpoint=os.path.join(ckpt, "best")),
                        run_name="disk_losses")
        # The exact rule for the target and the source, the packed rule for
        # the warped source, and one matcher launch, a batch.
        reset_launches()
        t0 = time.perf_counter()
        losses = tester.evaluate_losses("kitti", 0)
        torch.cuda.synchronize()
        loss_s = time.perf_counter() - t0
        batches = -(-(len(scans) - 1) // tester.batch_size)
        loss_launches = path_launches("test_losses", {
            "placement": 2 * batches, "placement_packed": batches, "window_match": batches})
        if not all(np.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"test losses not finite: {losses}")
        say(f"disk test losses (raw feed, card): {batches} batches, loss {losses['loss']:.6f}, "
            f"po2pl {losses['loss_po2pl']:.6f}, pairs {losses['num_po2pl_pairs']:.1f}, "
            f"launches {loss_launches}, {loss_s:.2f} s on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    builds = cuda_build.build_all(["placement", "window_match", "nn_search"])
    say(f"build: {time.perf_counter() - t0:.2f} s for all three, one nvcc each started "
        f"together ({' '.join(cuda_build.NVCC_FLAGS)})")
    for lib, (log, seconds) in builds.items():
        say(f"build {lib}: {seconds:.2f} s{'' if log else ' (already built)'}")
        for line in log.strip().splitlines():
            say(f"  {lib}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    scans, normals = drive(24, rng)
    say(f"drive: {len(scans)} ray-cast scans, {min(map(len, scans))}-{max(map(len, scans))} "
        f"points each, analytic normals, {time.perf_counter() - t0:.1f} s")
    drive_scans = [list(zip(scans, normals))]

    config = default_config()
    spec = ProjectionSpec.from_config(config)
    train_config = default_config({"batch_size": TRAIN_B})
    t0 = time.perf_counter()
    trainer = Trainer(train_config, drive_scans, device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in trainer.model.parameters())
    say(f"trainer: {len(scans)} scans' artifacts on the card as tables, {trainer.num_pairs} "
        f"pairs, {n_params} parameters, {time.perf_counter() - t0:.1f} s")

    exact, err_exact = check_exact_placement(spec, rng, card)
    exact_pre, err_pre = check_exact_placement_preprocess(scans[0], card)
    err_exact = max(err_exact, err_pre)
    packed, err_packed = check_packed_placement(trainer, spec, rng, card)
    err_exact = max(err_exact, check_placement_after_larger_call(trainer, spec, rng, card))
    matcher, err_matcher = check_matcher(trainer, spec, scans[0], rng, card)
    soft, err_soft = check_soft_matcher(trainer, spec, scans[0], rng, card)
    index, err_index = check_index_matcher(trainer, spec, card)
    nn, err_nn = check_nn_search(trainer, scans, normals, spec, rng, card)

    run_serving(config, scans[:12], spec, card)
    run_training(trainer, card, "main", 12, {"placement_packed": 1, "window_match": 1})
    step_split(trainer, card, "training")
    check_fp32_step(trainer, "training")
    check_loss_falls(trainer)

    # Phase 7: the quality recipe on the fully-cached feed.
    recipe = Trainer(default_config({"batch_size": TRAIN_B, **RECIPE}), drive_scans,
                     device="cuda", generator=torch.Generator().manual_seed(SEED + 3))
    say(f"recipe: {RECIPE}, feed {recipe.feed}, B={TRAIN_B}, bf16")
    run_training(recipe, card, "recipe", 8, {
        "window_match_soft": 1, "window_match_index": 1, "placement_packed": 1},
        positive=("loss_po2pl_rev",))
    step_split(recipe, card, "recipe")
    check_ema(recipe, card)
    check_fp32_step(recipe, "recipe", {"use_dropout": False})
    del recipe

    # Phase 8: brute correspondence on the raw feed.
    brute = Trainer(default_config({"batch_size": TRAIN_B, "correspondence": "brute"}),
                    drive_scans, device="cuda", generator=torch.Generator().manual_seed(SEED + 4))
    say(f"brute: feed {brute.feed}, tables {tuple(brute.feeds['kitti'].tables[0].shape)} "
        f"padded points, B={TRAIN_B}, bf16")
    # The raw feed projects the target and the source under the exact rule.
    run_training(brute, card, "brute", 6, {"nn_search": 1, "placement": 2})
    step_split(brute, card, "brute")
    del brute
    small = Trainer(default_config({"batch_size": BRUTE_CHECK_B, "correspondence": "brute",
                                    "kitti": {"max_points": BRUTE_CHECK_POINTS}}),
                    [drive_scans[0][:BRUTE_CHECK_B + 1]], device="cuda",
                    generator=torch.Generator().manual_seed(SEED + 5))
    say(f"brute fp32 check on a reduced cloud: max_points {BRUTE_CHECK_POINTS} (of up to "
        f"{max(map(len, scans))} a scan), B={BRUTE_CHECK_B}")
    check_fp32_step(small, "brute")
    del small, trainer

    # Phase 9: the offline pipeline from disk through the command line.
    run_disk_phase(scans, card)

    def row(name_, source, replaces, err, t):
        by_path = {path: counts[name_] for path, counts in PATH_LAUNCHES.items()
                   if counts[name_]}
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t.get("bound_by", "bytes"),
                "library_ms": t["library_ms"], "device_ms": t["device_ms"],
                "launches_by_path": by_path,
                **{k: t[k] for k in ("floor_ms", "floor_instructions_per_candidate",
                                     "preprocess_shape") if k in t}}

    matcher_src = "delora_tpu_torch/csrc/window_match.cu"
    print(card, flush=True)
    print(json.dumps({"kernels": [
        row("placement", "delora_tpu_torch/csrc/placement.cu",
            "delora_tpu/ops/pallas/placement.py:72", err_exact,
            dict(exact, preprocess_shape=exact_pre)),
        row("placement_packed", "delora_tpu_torch/csrc/placement.cu",
            "delora_tpu/ops/pallas/placement.py:72", err_packed, packed),
        row("window_match", matcher_src, "delora_tpu/ops/pallas/window_match.py:249",
            err_matcher, matcher),
        row("window_match_soft", matcher_src, "delora_tpu/ops/pallas/window_match.py:249",
            err_soft, soft),
        row("window_match_index", matcher_src, "delora_tpu/ops/correspondence.py:495",
            err_index, index),
        row("nn_search", "delora_tpu_torch/csrc/nn_search.cu",
            "delora_tpu/ops/pallas/nn_search.py:172", err_nn, nn),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def train_rate(epochs: int) -> None:
    """``--train-rate EPOCHS`` (see the module docstring)."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    card = card_line()
    scans, normals = drive(24, np.random.default_rng(SEED))
    trainer = Trainer(default_config({"batch_size": TRAIN_B}), [list(zip(scans, normals))],
                      device="cuda", generator=torch.Generator().manual_seed(SEED))
    rates = []
    for epoch in range(epochs + 2):
        trainer.supervised = epoch < 2
        metrics = trainer.train_epoch(epoch)
        check_steps(trainer, epoch)
        if epoch >= 3:
            rates.append(metrics["scan_pairs_per_sec"])
    q1, med, q3 = statistics.quantiles(rates, n=4)
    say(f"train-rate B={TRAIN_B}, main path, {len(rates)} epochs of {metrics['steps']} steps "
        f"(host clock, one readback an epoch): median {med:.1f} pairs/s, quartiles {q1:.1f}-"
        f"{q3:.1f} on {card}")
    print(json.dumps({"pairs_per_s": rates}), flush=True)


def serve_rate(rounds: int) -> None:
    """``--serve-rate ROUNDS`` (see the module docstring)."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.serving.stream import StreamingOdometry

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    card = card_line()
    scans, _ = drive(12, np.random.default_rng(SEED))
    engine = StreamingOdometry(default_config(), device=torch.device("cuda"))
    latencies = []
    for _ in range(rounds):
        for scan in scans:
            out = engine.push_scan(scan)
            if out is not None:
                check_rigid(out[0])
                latencies.append(out[2] * 1e3)
    latencies = latencies[len(scans) - 1:]      # the first round warms up
    q1, med, q3 = statistics.quantiles(latencies, n=4)
    say(f"serve-rate: {len(latencies)} scan pairs after a warm-up round of {len(scans)} scans: "
        f"per-scan latency median {med:.3f} ms, quartiles {q1:.3f}-{q3:.3f} ms on {card}")
    print(json.dumps({"latency_ms": latencies}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rate"]:
        sys.exit(train_rate(int(sys.argv[2])))
    if sys.argv[1:2] == ["--serve-rate"]:
        sys.exit(serve_rate(int(sys.argv[2])))
    if sys.argv[1:2] == ["--placement-time"]:
        sys.exit(placement_time())
    if sys.argv[1:2] in (["--nn-time"], ["--matcher-time"]):
        sys.exit(kernel_time("--nn-time" in sys.argv[1:], "--matcher-time" in sys.argv[1:]))
    sys.exit(main())
