"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced on flushed lines; any failure raises and the script
exits non-zero without printing a result:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the port's CUDA sources (placement, window matcher,
   1-NN search, the backbone's wrap-pad), one compiler each, started
   together; each one's time and ``-Xptxas -v``;
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
   - the backbone's wrap-pad, channels-last bf16 at the default model's
     shapes in a B = 32 train step at 64x720: the max-pool's (32, 64, 64,
     360) with -inf rows, a stage-1 (32, 64, 64, 180) and a stage-4 (32,
     512, 32, 23) convolution's; the padded tensor and the input gradient,
     one launch each way, each way timed;
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
   batch);
10. the paths of the reference's other training keys, each at full width,
   B = 8, 3 unsupervised epochs of 2 steps on the drive: ``augment_full``
   (``random_point_cloud_rotations``, fully-cached feed: the rotated
   survivors projected again; exact, packed and matcher once a step),
   ``augment_cached`` (the same on the cached-target feed,
   ``cache_source_projections: false``; the same launches), ``projective``
   (projective correspondence on the cached-target feed with augmentation:
   one exact placement a step and no other kernel), ``raw_64x1024`` (the raw
   feed at 64x1024 = 65,536 pixels: three exact placements and one matcher a
   step) and ``remat`` (the main path with ``remat`` and ``fused_adam``:
   packed and matcher once a step); every step finite with no overflowing
   tile; every augmented step's rotations within +-2 degrees, none the
   identity; pairs/s and the device split; one fp32 step against the CPU on
   the same batch, params and rotations for ``augment_cached``,
   ``projective`` and ``raw_64x1024`` (at B = 2: the CPU's plain step would
   project 8 x 3 full clouds); for ``remat``, its fp32 loss and gradients
   against no remat on the card and the peak memory of a bf16 step with and
   without it;
11. config files, the synthetic drive, the C++ batcher, profiling and the
   DeLORA weights, at full width: (a) the port's ``write_kitti_layout`` writes
   24 scans of 64 rings x 2000 azimuth steps with poses, in a child process
   (it forks a pool; this process holds CUDA), and a JSON config file is
   written from the port's defaults with the drive's paths; (b) ``preprocess
   --config`` at 64x2250 (one exact placement a scan); (c) ``train --config``
   for 3 epochs on the raw feed streamed through the C++ pair batcher
   (``native_io`` true, the target cache and the RAM cache off), epoch 1
   traced and the training images on: the batcher engaged, two epochs of its
   batches bit-equal to the Python producer's, the trace names the placement
   and hard matcher kernels and the step's regions, without matplotlib the
   image logging's skip line and no launch for it, each kernel's launches
   stated before the run and exact, the epochs' pairs/s and the feed's own
   pairs/s (native against Python, alternated, to the card and on the host
   only); (d) ``export-torch`` of the
   run's ``latest`` to a ``.pth`` whose weights are the checkpoint's live
   weights bit for bit, served by ``StreamingOdometry(params=
   load_reference_checkpoint(...))`` on 12 scans (one exact placement each,
   poses finite, rigid and bit-equal to serving the weights directly); (e)
   the training panels on the card (two exact placements, one packed, one
   matcher launch) against the CPU's plain path on the same weights and pair
   in fp32, TF32 off (each panel's pixels within atol 1e-5 + rtol 1e-4 on at
   least 99.5% of them);
12. the ROS half and data parallelism, at full width: (a) ``RosOdometryBridge``
   under stub ROS modules (``serving/ros_stubs.py``, in ``sys.modules``) with the
   default KITTI model (bf16, seeded weights) on phase 3's first 12 scans:
   one exact placement a scan and no other kernel, every published Odometry
   and TF bit-equal to ``StreamingOdometry`` fed the same scans, the
   callback's latency (p50, max); (b) phase 3's drive exported by
   ``data/export_sequence.py`` as ``.npy`` (sequence 0) and as a stub bag on
   the darpa topic (sequence 1), preprocessed as the rosbag-type ``darpa``
   at its published 64x512 (one exact placement a scan; the bag's files
   bit-equal to the export's), then 3 epochs at full width, B = 8, on device
   tables (one packed placement and one matcher launch a step, every metric
   finite); (c) data parallelism through ``parallel/multiprocess.py`` on the
   drive preprocessed as KITTI, fp32 (TF32 off, deterministic kernels),
   global B = 8. First a step witness from random weights: one step of two
   gloo processes on the card, whose averaged gradients and metrics must
   equal the mean of the plain step's on the two halves of the batch (rtol
   1e-5 of each tensor's largest gradient, predicted bit-equal) and lie
   within 1e-2 norm-wise of the plain step's on the whole batch, with the
   gap between each half's forward at B = 4 and the whole batch's at B = 8
   printed. Then the disk trainer, 3 epochs on device tables and a resume
   from ``latest`` on every process for one epoch streamed from the host:
   from the identity pose the plain trainer in one process, a group of one
   over NCCL (every step's loss bit-equal to the plain trainer's) and two
   gloo processes sharing the card (tables split over them; every step's
   loss within rtol 1e-5 of the plain trainer's); from the random weights
   the plain trainer and two gloo processes, their drift printed, not held.
   Each run's processes report identical losses, each process's launches
   are exact (one packed placement and one matcher a step, on every rank),
   rank 0 alone writes the checkpoints, and every rank resumes with the
   saved weights; pairs/s by epoch, the two processes' labelled as sharing
   one card;
13. the bench: ``python -m delora_tpu_torch.cli bench 8 20`` in a fresh
   process (its stderr relayed here), its last line parsed: every key of
   ``bench.JSON_KEYS``, the numbers finite, the headline > 0, both p50s under
   the 100 ms scan period, 0 < ``mfu`` <= 1, the four
   ``kernel_parity_max_abs_diff`` rows 0.0, no overflowing tile, and
   ``flops_per_step`` equal to FlopCounterMode's count of a headline step
   here and to the closed form over the model's Conv2d and Linear shapes
   (forward 2 x MACs, backward twice that less the first layer's input
   gradient); then the headline once more in this process (2 x 32 warm-up
   and 160 timed steps), one packed placement and one matcher launch a step.
   Also in phase 4f: the 1-NN's
   library yardstick ``torch.cdist(s, t).min(-1)`` at B = 1 (24.2 GB of
   distances; at B = 8 it would need 193 GB and is not run).

Each path of phases 5-13 is driven with every kernel's launch count set to 0
just before it and read just after; the placement wrapper counts its exact
and its packed rule apart, the wrap-pad its forward and backward. A path
fails unless each of its kernels launched as often as the path should launch
it and every other kernel not at all. The wrap-pad launches in every eager
forward and backward of the model and in every replay of a trainer's step
graph, in none of a served forward's graph; it is held to 18 forward and 17
backward launches a step on phase 6's main path and recorded on the others.
A replayed step runs no wrapper: the trainer adds the launches its capture
recorded to each counter, so those counts are inferred. The paths that
``run_training`` drives (main, recipe, brute) are therefore run under the
profiler too, and the launches its device trace shows, by kernel name, are
held to the same counts (``traced_launches``).

Phase 12c's processes read their own counts and hand them back.

The last lines are the card (nvidia-smi), the kernel table as one JSON object
(every row with its launches by path, as read in those runs, the exact
placement's row with its preprocessing shape, and the 1-NN's with its B = 1
yardstick), and ``{"ok": true, "device":
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
import re
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
# The backbone's wrap-pad a train step: 17 ConvCirc and the max-pool forward;
# backward one fewer, the stem's input (the images) takes no gradient.
PAD_LAUNCHES_A_STEP = {"circular_pad": 18, "circular_pad_grad": 17}
# The wrap-pad at the default model's shapes in the benchmark's train step
# (B = 32, 64x720, bf16): [B, C, H, W], pad_w, pad_h and the rows' value.
PAD_CASES = (("max-pool", (32, 64, 64, 360), 1, 1, -math.inf),
             ("stage-1 conv", (32, 64, 64, 180), 1, 0, 0.0),
             ("stage-4 conv", (32, 512, 32, 23), 1, 0, 0.0))
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
        else:
            timing["library_ms_b1"] = nn_library_ms(args[0], args[1], card)
    return timing, err


def nn_library_ms(src, tgt, card) -> float:
    """The 1-NN's one-call PyTorch yardstick at B = 1, ``torch.cdist(s,
    t).min(-1)`` over every target slot (CUDA events); at the train batch
    its distances would pass the card's memory, so it is not run there."""
    S, T = src.shape[1], tgt.shape[1]
    torch.cuda.empty_cache()
    lib_ms = cuda_ms(lambda: torch.cdist(src, tgt).min(-1), reps=3, inner=1)
    torch.cuda.empty_cache()
    say(f"nn_search yardstick B=1: torch.cdist(s, t).min(-1) over all {T} target slots "
        f"({S * T * 4 / 1e9:.1f} GB of distances) {lib_ms:.3f} ms; at B={TRAIN_B} it would "
        f"hold {TRAIN_B * S * T * 4 / 1e9:.0f} GB of distances, more than the card has: not "
        f"run, on {card}")
    return lib_ms


def check_circular_pad(card):
    """Phase 4g: the backbone's wrap-pad at :data:`PAD_CASES`, channels-last
    bf16: the padded tensor and the input gradient bit-equal to the plain
    version's (``torch.cat`` + ``F.pad`` and their autograd), one launch each
    way; a call's time (CUDA events) and the kernels' device time
    (torch.profiler) each way, against the plain version's and the bytes'
    bound. -> the max-pool case's timing and the largest difference."""
    import torch.nn.functional as F

    from delora_tpu_torch.ops.cuda.circular_pad import circular_pad, circular_pad_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    err, timing = 0.0, None
    for name, shape, pad_w, pad_h, value in PAD_CASES:
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        B, C, Hh, Ww = shape
        grad = torch.randn((B, C, Hh + 2 * pad_h, Ww + 2 * pad_w), generator=g,
                           device=dev).to(torch.bfloat16).contiguous(
                               memory_format=torch.channels_last)
        before = (circular_pad.launches_forward, circular_pad.launches_backward)
        out = circular_pad(x, pad_w, pad_h, value)
        (gx,) = torch.autograd.grad(out, x, grad, retain_graph=True)
        launched = (circular_pad.launches_forward - before[0],
                    circular_pad.launches_backward - before[1])
        ref = circular_pad_plain(x, pad_w, pad_h, value)
        (gref,) = torch.autograd.grad(ref, x, grad, retain_graph=True)
        torch.cuda.synchronize()
        if launched != (1, 1) or not (out.is_contiguous(memory_format=torch.channels_last)
                                      and gx.is_contiguous(memory_format=torch.channels_last)):
            raise RuntimeError(f"circular_pad {name}: launches {launched}, channels-last out "
                               f"{out.is_contiguous(memory_format=torch.channels_last)}, "
                               f"gradient {gx.is_contiguous(memory_format=torch.channels_last)}")
        err = max(err, require_equal(f"circular_pad {name}", (out, gx), (ref, gref)))

        def forward():
            with torch.no_grad():
                circular_pad(x, pad_w, pad_h, value)

        def plain():
            with torch.no_grad():
                circular_pad_plain(x, pad_w, pad_h, value)

        def backward():
            torch.autograd.grad(out, x, grad, retain_graph=True)

        def plain_backward():
            torch.autograd.grad(ref, x, grad, retain_graph=True)

        ms, plain_ms = cuda_ms(forward), cuda_ms(plain, reps=10, inner=5)
        grad_ms, grad_plain_ms = cuda_ms(backward), cuda_ms(plain_backward, reps=10, inner=5)
        dev_ms = profiled_device_ms(forward, ("wrap_pad_nhwc",))
        grad_dev_ms = profiled_device_ms(backward, ("wrap_pad_nhwc_grad",))
        library_ms = None
        if pad_h == 0:
            library_ms = cuda_ms(lambda: F.pad(x.detach(), (pad_w, pad_w, 0, 0),
                                               mode="circular"), reps=10, inner=5)
        # Each way reads one of the two tensors once and writes the other once.
        moved = (x.numel() + grad.numel()) * x.element_size()
        bound_ms = moved / HBM_BYTES_PER_S * 1e3

        def us(v):
            return "not measured" if v is None else f"{v * 1e3:.2f} us"

        say(f"circular_pad {name} {shape} bf16 channels-last, pads ({pad_w}, {pad_h}), rows "
            f"{value}: padded tensor and input gradient bit-equal to plain, one launch each "
            f"way | forward: call {us(ms)}, device {us(dev_ms)}, plain {us(plain_ms)}; "
            f"backward: call {us(grad_ms)}, device {us(grad_dev_ms)}, plain (autograd) "
            f"{us(grad_plain_ms)}; bound {us(bound_ms)} each way ({moved} B at 3.35 TB/s)"
            + ("" if library_ms is None else f"; F.pad circular (W only) {us(library_ms)}")
            + f" on {card}")
        if timing is None:
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          device_ms=dev_ms, grad_ms=grad_ms, grad_device_ms=grad_dev_ms,
                          grad_plain_ms=grad_plain_ms, shape=list(shape))
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
    The placement wrapper counts its two winner rules apart, the wrap-pad
    its forward and backward; a trainer's replayed step graph adds what its
    capture recorded to each."""
    from delora_tpu_torch.ops.cuda.launches import launch_counters

    return launch_counters()


# Path -> each kernel's launches in that path's run (see path_launches).
PATH_LAUNCHES = {}
# The backbone's wrap-pad launches in every eager forward and backward of the
# model on the card (18 and 17 a train step at the default widths) and in
# every replay of a trainer's step graph, not in a served forward's graph: a
# path's count is held where the path states it and recorded everywhere.
MODEL_COUNTERS = ("circular_pad", "circular_pad_grad")


def wanted(counts, expected) -> dict:
    """Each counter's launches as ``expected`` states them: 0 if unstated,
    except the model's (:data:`MODEL_COUNTERS`), which are then as read."""
    return {name: expected.get(name, counts[name] if name in MODEL_COUNTERS else 0)
            for name in counts}


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for wrapper, attr in counters().values():
        setattr(wrapper, attr, 0)


def path_launches(path: str, expected) -> dict:
    """The launches since :func:`reset_launches`, read just after ``path``
    was driven and kept as its own: fails unless each kernel named in
    ``expected`` launched that often and every other kernel not at all (the
    model's wrap-pad as read, unless named: see :data:`MODEL_COUNTERS`).
    -> the kernels that launched, with their counts."""
    counts = {name: getattr(wrapper, attr) for name, (wrapper, attr) in counters().items()}
    want = wanted(counts, expected)
    if counts != want:
        raise RuntimeError(f"{path}: kernel launches {counts}, expected {want}")
    PATH_LAUNCHES[path] = counts
    return {name: n for name, n in counts.items() if n}


# Each kernel row's device kernels as a trace names them: group -> (kernel
# names, the rows they launch for). One `write_and_reset` ends every call of
# either placement rule; the hard and the index matcher share a kernel.
TRACED_KERNELS = {
    "placement": (("write_and_reset",), ("placement", "placement_packed")),
    "window_match_hard": (("window_match_hard",), ("window_match", "window_match_index")),
    "window_match_soft": (("window_match_soft_halo", "window_match_soft_global"),
                          ("window_match_soft",)),
    "nn_search": (("nn_search",), ("nn_search",)),
    "wrap_pad_nhwc": (("wrap_pad_nhwc",), ("circular_pad",)),
    "wrap_pad_nhwc_grad": (("wrap_pad_nhwc_grad",), ("circular_pad_grad",)),
}


def traced_launches(prof, path: str, expected):
    """The hand-written kernels' launches that the device trace ``prof`` of
    ``path``'s run shows, by :data:`TRACED_KERNELS` group, after
    :func:`path_launches` has read the counters: fails unless each group's
    count is what ``expected`` states for its rows (the wrap-pad's as its
    counters read where unstated), so a replayed graph's launches are
    measured in the run. -> the groups that launched, with their counts;
    None where the trace came back with no device activity at all."""
    from torch.autograd import DeviceType

    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not names:
        say(f"{path}: the profiler's trace holds no device activity; launches not traced")
        return None
    kernel_group = {k: g for g, (kernels, _) in TRACED_KERNELS.items() for k in kernels}
    counts = dict.fromkeys(TRACED_KERNELS, 0)
    for name in names:
        for token in set(re.findall(r"[A-Za-z_]\w*", name)) & kernel_group.keys():
            counts[kernel_group[token]] += 1
    rows = wanted(PATH_LAUNCHES[path], expected)
    want = {g: sum(rows[r] for r in counted) for g, (_, counted) in TRACED_KERNELS.items()}
    if counts != want:
        raise RuntimeError(f"{path}: traced kernel launches {counts}, expected {want}")
    return {g: n for g, n in counts.items() if n}


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
    ``label`` under the profiler (CUDA activity) and check its kernel
    launches, by the counters and by the trace (:func:`traced_launches`):
    ``per_step`` maps a kernel row to its launches a step, every other
    kernel launches none. -> steady-state pairs/s, the profiler's cost
    included."""
    from torch.profiler import ProfilerActivity, profile

    reset_launches()
    steps, history = 0, []
    # The warmup's own switch (epoch loss < 1e-2) would take hundreds of steps
    # at lr 1e-5 from random weights, so the run switches after 2 epochs.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        torch.cuda.synchronize()
    expected = {name: k * steps for name, k in per_step.items()}
    launches = path_launches(label, expected)
    traced = traced_launches(prof, label, expected)
    steady = history[3:]
    pairs_per_s = (sum(h["steps"] for h in steady) * trainer.batch_size
                   / sum(h["epoch_seconds"] for h in steady))
    say(f"{label} B={trainer.batch_size}: {steps} steps (4 supervised), every step's metrics "
        f"finite{''.join(f', {k} > 0' for k in positive)}, overflow tiles 0, launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()) + f" for {steps} steps, traced "
        + ("not measured" if traced is None else ", ".join(f"{k} {v}" for k, v in traced.items()))
        + f", steps {dict(trainer.graph_counts)} | steady state (epochs 3-{epochs - 1}, host "
        f"clock, one readback an epoch, profiled) {pairs_per_s:.1f} pairs/s on {card}")
    return pairs_per_s


def model_images(trainer, batch):
    """The model's two input images of a batch (the raw source projected on
    the cached-target and raw feeds, the raw target on the raw feed)."""
    from delora_tpu_torch.ops.projection import project_compact_exact_batch, project_scan_batch

    if trainer.feed == "full":
        return batch.image_1, batch.image_2
    spec = trainer.feeds["kitti"].spec
    image_2 = project_compact_exact_batch(batch.points_2, batch.valid_2, spec).image
    if trainer.feed == "cached":
        return batch.image_1, image_2
    return project_scan_batch(batch.points_1, batch.valid_1, spec).image, image_2


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


def check_fp32_step(trainer, label, overrides=None, batch_size=None):
    """One fp32 step (TF32 off) on the card against the CPU's plain path,
    on the trainer's first batch (its first ``batch_size`` pairs if given)
    and fresh seeded params; with augmentation both steps take the same
    rotations, drawn once from a seeded CPU generator."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.training.state import make_optimizer
    from delora_tpu_torch.training.step import StepConfig, augment_rotations, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = default_config({"compute_dtype": "float32", **(overrides or {})},
                           base=trainer.config)
    step_cfg = StepConfig.from_config(cfg32, supervised=False)
    model = OdometryModel(ModelConfig.from_config(cfg32),
                          torch.Generator().manual_seed(SEED + 1)).to(trainer.device)
    model_cpu = copy.deepcopy(model).cpu()
    batch = first_batch(trainer)
    batch = type(batch)(*(t[:batch_size] for t in batch))
    batch_size = batch[0].shape[0]
    batch_cpu = type(batch)(*(t.cpu() for t in batch))
    rotations = None
    if step_cfg.augment:
        rotations = augment_rotations(step_cfg, batch_size,
                                      torch.Generator().manual_seed(SEED + 7))
    out = train_step(model, make_optimizer(cfg32, model.parameters(), batch_size)[0],
                     batch, step_cfg,
                     rotations=None if rotations is None else rotations.to(trainer.device))
    t0 = time.perf_counter()
    ref = train_step(model_cpu, make_optimizer(cfg32, model_cpu.parameters(), batch_size)[0],
                     batch_cpu, step_cfg, rotations=rotations)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for key, value in ref.items():
        a, b = float(out[key]), float(value)
        rel = abs(a - b) / max(abs(b), 1e-6)
        worst = max(worst, rel)
        if rel > FP32_RTOL:
            raise RuntimeError(f"{label} fp32 step: {key} card {a} vs CPU {b} (rel {rel:.2e} > "
                               f"{FP32_RTOL})")
    same = ", the same rotations" if rotations is not None else ""
    say(f"{label} fp32 (TF32 off) card vs CPU step on the same batch (B={batch_size}{same}) "
        f"and params: loss {float(out['loss']):.6f} vs {float(ref['loss']):.6f}, grad_norm "
        f"{float(out['grad_norm']):.6f} vs {float(ref['grad_norm']):.6f}, pairs "
        f"{float(out['num_po2pl_pairs']):.1f} vs {float(ref['num_po2pl_pairs']):.1f}, rev "
        f"{float(out['loss_po2pl_rev']):.6f} vs {float(ref['loss_po2pl_rev']):.6f}; worst "
        f"relative difference over {len(ref)} values {worst:.2e} (limit {FP32_RTOL}); CPU step "
        f"{cpu_s:.1f} s")


def start_at_identity(model) -> None:
    """Set the model where the supervised warmup leaves it: the heads' last
    layers output translation 0 and quaternion (0, 0, 0, 1)."""
    with torch.no_grad():
        for head, bias in ((model.fully_connected_rotation, (0.0, 0.0, 0.0, 1.0)),
                           (model.fully_connected_translation, (0.0, 0.0, 0.0))):
            head[-1].weight.zero_()
            head[-1].bias.copy_(torch.tensor(bias))


def check_loss_falls(trainer):
    """Gradients reach the loss: Adam on one fixed batch lowers loss_pc."""
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.training.state import make_optimizer
    from delora_tpu_torch.training.step import StepConfig, train_step

    config = dict(trainer.config, learning_rate=LOSS_LR, lr_schedule="constant")
    model = OdometryModel(ModelConfig.from_config(config),
                          torch.Generator().manual_seed(SEED + 2))
    # From a random pose the hard-matched loss jumps between basins under
    # any step that moves all 11.9 M parameters.
    start_at_identity(model)
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


# Phase 10: the paths of augmentation, the cached-target feed, projective
# correspondence, the raw feed at 64x1024 and remat + fused_adam. Each path's
# settings over the default config and batch size, its launches a step, and
# whether its fp32 card step is checked against the CPU (the batch size of
# that check; 64x1024 at B=2: its CPU step projects three full clouds).
NEW_PATHS = (
    ("augment_full", {"random_point_cloud_rotations": True},
     {"placement": 1, "placement_packed": 1, "window_match": 1}, None),
    ("augment_cached", {"random_point_cloud_rotations": True,
                        "cache_source_projections": False},
     {"placement": 1, "placement_packed": 1, "window_match": 1}, TRAIN_B),
    ("projective", {"random_point_cloud_rotations": True, "cache_source_projections": False,
                    "correspondence": "projective"}, {"placement": 1}, TRAIN_B),
    ("raw_64x1024", {"cache_target_projections": False, "kitti": {"horizontal_cells": 1024}},
     {"placement": 3, "window_match": 1}, 2),
    ("remat", {"remat": True, "fused_adam": True},
     {"placement_packed": 1, "window_match": 1}, None),
)
NEW_PATH_EPOCHS = 3
# remat against no remat on the card, set before the first run: the
# recomputed forward issues the same convolutions on the same inputs, so the
# gradients should be bit-equal; a difference beyond this share of a
# tensor's largest gradient fails.
REMAT_RTOL = 1e-5
# Augmentation's draw: +-magnitude/2 with the default 4 degrees.
MAX_AUGMENT_DEG = 2.0


def record_rotations(trainer, drawn):
    """Wrap ``trainer.step`` so that each step's rotations land in ``drawn``:
    the draw is replayed from the augmentation generator's state before the
    step, and the generator must stand where the replay left it (the step
    drew once, with ``augment_rotations``)."""
    from delora_tpu_torch.training.step import augment_rotations

    step = trainer.step

    def wrapped(batch, cfg):
        state = trainer.augment_generator.get_state()
        out = step(batch, cfg)
        replay = torch.Generator(trainer.device)
        replay.set_state(state)
        drawn.append(augment_rotations(cfg, batch[0].shape[0], replay))
        if not torch.equal(replay.get_state(), trainer.augment_generator.get_state()):
            raise RuntimeError("the step drew its rotations some other way")
        return out

    trainer.step = wrapped


def check_rotations(label, drawn, steps):
    """Every step's rotations: within +-MAX_AUGMENT_DEG, none the identity,
    no two steps alike."""
    if len(drawn) != steps:
        raise RuntimeError(f"{label}: {len(drawn)} draws for {steps} steps")
    R = torch.stack(drawn).double().cpu()
    cos = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    deg = torch.rad2deg(torch.arccos(cos))
    eye = torch.eye(3, dtype=R.dtype)
    if (deg > MAX_AUGMENT_DEG + 1e-3).any() or (R == eye).all(-1).all(-1).any():
        raise RuntimeError(f"{label}: rotations out of range or the identity: {deg.tolist()}")
    if any(torch.equal(R[i], R[i + 1]) for i in range(len(R) - 1)):
        raise RuntimeError(f"{label}: two steps drew the same rotations")
    return float(deg.min()), float(deg.max())


def run_new_path(trainer, card, label, per_step):
    """NEW_PATH_EPOCHS unsupervised epochs as the path ``label``, from the
    identity pose (where the warmup would leave the model), every step with
    correspondences; its launch counts as :func:`run_training` checks them.
    -> (steps, pairs/s of the epochs after the first)."""
    start_at_identity(trainer.model)
    reset_launches()
    trainer.supervised = False
    steps, history = 0, []
    for epoch in range(NEW_PATH_EPOCHS):
        metrics = trainer.train_epoch(epoch)
        check_steps(trainer, epoch, positive=("loss_pc", "num_po2pl_pairs", "grad_norm"))
        steps += metrics["steps"]
        history.append(metrics)
        say(f"{label} epoch {epoch}: {metrics['steps']} steps, loss {metrics['loss']:.6f}, "
            f"po2pl {metrics['loss_po2pl']:.6f}, pl2pl {metrics['loss_pl2pl']:.6f}, pairs "
            f"{metrics['num_po2pl_pairs']:.1f}, grad_norm {metrics['grad_norm']:.4e}, "
            f"{metrics['epoch_seconds'] * 1e3:.1f} ms")
    launches = path_launches(label, {name: k * steps for name, k in per_step.items()})
    later = history[1:]
    pairs_per_s = (sum(h["steps"] for h in later) * trainer.batch_size
                   / sum(h["epoch_seconds"] for h in later))
    say(f"{label} B={trainer.batch_size}, feed {trainer.feed}: {steps} steps, every step's "
        f"metrics finite, overflow tiles 0, launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()) + f" for {steps} steps | epochs "
        f"1-{NEW_PATH_EPOCHS - 1} (host clock, one readback an epoch) {pairs_per_s:.1f} pairs/s "
        f"on {card}")
    return steps, pairs_per_s


def check_remat(trainer, card):
    """remat against no remat on the card: the fp32 loss and gradients of one
    step on the same batch and params (TF32 off), and the peak memory of one
    bf16 train step of each."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.training.state import make_optimizer
    from delora_tpu_torch.training.step import StepConfig, loss_and_metrics_fullcached, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = first_batch(trainer)
    grads, losses = [], []
    for remat in (False, True):
        cfg32 = default_config({"compute_dtype": "float32", "remat": remat},
                               base=trainer.config)
        model = OdometryModel(ModelConfig.from_config(cfg32),
                              torch.Generator().manual_seed(SEED + 8))
        start_at_identity(model)
        model.to(trainer.device)
        loss, _ = loss_and_metrics_fullcached(model, batch,
                                              StepConfig.from_config(cfg32, supervised=False))
        loss.backward()
        losses.append(loss.detach())
        grads.append([p.grad for p in model.parameters()])
    equal = torch.equal(losses[0], losses[1]) and all(
        torch.equal(a, b) for a, b in zip(*grads))
    worst = max(((a - b).abs().max() / a.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(*grads))
    if not losses[0] > 0 or not torch.equal(losses[0], losses[1]) or worst > REMAT_RTOL:
        raise RuntimeError(f"remat: loss {losses[1].item()} vs {losses[0].item()}, gradients "
                           f"differ by {worst:.3e} of their largest (limit {REMAT_RTOL})")
    say(f"remat fp32 (TF32 off) on the card against no remat, same batch and params: loss "
        f"{losses[1].item():.6f} vs {losses[0].item():.6f}, gradients "
        f"{'bit-equal' if equal else f'largest difference {worst:.3e} of a tensor max'} "
        f"on {card}")

    peaks = {}
    for remat in (False, True):
        config = default_config({"remat": remat}, base=trainer.config)
        model = OdometryModel(ModelConfig.from_config(config),
                              torch.Generator().manual_seed(SEED + 8)).to(trainer.device)
        optimizer, _ = make_optimizer(config, model.parameters(), TRAIN_B)
        cfg = StepConfig.from_config(config, supervised=False)
        train_step(model, optimizer, batch, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        train_step(model, optimizer, batch, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[remat] = (peak / 2**20, (peak - before) / 2**20)
        del model, optimizer
    say(f"remat peak memory of one bf16 train step (B={TRAIN_B}, "
        f"torch.cuda.max_memory_allocated; the trainer's tables and models included): "
        f"{peaks[True][0]:.1f} MiB with remat ({peaks[True][1]:.1f} MiB above the step's "
        f"start), {peaks[False][0]:.1f} MiB without ({peaks[False][1]:.1f} MiB) on {card}")


def run_new_paths(drive_scans, card) -> None:
    """Phase 10: each of NEW_PATHS at full width, B=8, on the drive."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.training.trainer import Trainer

    for i, (label, overrides, per_step, check_b) in enumerate(NEW_PATHS):
        t0 = time.perf_counter()
        trainer = Trainer(default_config({"batch_size": TRAIN_B, **overrides}), drive_scans,
                          device="cuda", generator=torch.Generator().manual_seed(SEED + 10 + i))
        spec = trainer.feeds["kitti"].spec
        say(f"{label}: {overrides}, feed {trainer.feed}, {spec.height}x{spec.width}, "
            f"B={TRAIN_B}, bf16, set-up {time.perf_counter() - t0:.1f} s")
        drawn = []
        if trainer.augment_generator is not None:
            record_rotations(trainer, drawn)
        steps, _ = run_new_path(trainer, card, label, per_step)
        if trainer.augment_generator is not None:
            low, high = check_rotations(label, drawn, steps)
            say(f"{label}: {steps} steps' rotations within {low:.4f}-{high:.4f} degrees (limit "
                f"{MAX_AUGMENT_DEG}), none the identity, each step its own")
        step_split(trainer, card, label)
        if check_b is not None:
            if check_b < TRAIN_B:
                say(f"{label} fp32 check at B={check_b}: the CPU's plain step at B={TRAIN_B} "
                    f"would project {TRAIN_B} x 3 padded clouds")
            check_fp32_step(trainer, label, batch_size=check_b)
        if label == "remat":
            check_remat(trainer, card)
        del trainer
        torch.cuda.empty_cache()


# Phase 11: the sixth slice's path. A drive written by the port's synthetic
# writer, preprocessed and trained from JSON config files on the raw feed
# streamed through the C++ pair batcher, one epoch traced, the weights
# exported to the DeLORA .pth layout and served from it, and the training
# panels on the card against the CPU.
SYNTH_SCANS, SYNTH_RINGS, SYNTH_STEPS = 24, 64, 2000
NATIVE_EPOCHS = 3
NATIVE_OVERRIDES = ["native_io=true", "cache_target_projections=false",
                    "store_dataset_in_RAM=false", "profile_epochs=[1]", "visualize_images=true"]
# The raw feed's step: the target and the source projected under the exact
# rule, the warped source under the packed rule, one hard matcher launch.
NATIVE_PER_STEP = {"placement": 2, "placement_packed": 1, "window_match": 1}
# The panels: both scans under the exact rule, the transformed source under
# the packed rule, one hard matcher launch.
PANEL_LAUNCHES = {"placement": 2, "placement_packed": 1, "window_match": 1}
# The panels' fp32 card values against the CPU's plain path on the same
# weights and pair, set before the first run: the card's atan2 and conv sums
# differ from the CPU's in the last bits, so the pose differs within float32
# rounding (rtol 1e-4 after a squared residual), and a point that crosses a
# pixel boundary moves a whole pixel; at most 0.5% of a panel's pixels may.
PANEL_ATOL, PANEL_RTOL, PANEL_SHARE = 1e-5, 1e-4, 0.995
SERVE_SCANS = 12


class Tee:
    """Standard output copied into a buffer while it is printed."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def write_synthetic_drive(root: str) -> None:
    """The port's ``write_kitti_layout`` in a child process: it forks a
    process pool for more than 8 scans, and this process holds CUDA."""
    import os

    code = ("import sys; from delora_tpu_torch.data.synthetic import write_kitti_layout; "
            "write_kitti_layout(sys.argv[1], n_scans=int(sys.argv[2]), rings=int(sys.argv[3]), "
            "azimuth_steps=int(sys.argv[4]), seed=int(sys.argv[5]))")
    subprocess.run([sys.executable, "-c", code, root, str(SYNTH_SCANS), str(SYNTH_RINGS),
                    str(SYNTH_STEPS), str(SEED)],
                   cwd=os.path.dirname(os.path.abspath(__file__)), check=True, timeout=600)


def trace_kernel_names(path: str):
    with open(path) as f:
        return {str(e.get("name")) for e in json.load(f)["traceEvents"]}


def feed_rate(loader, epochs: int) -> float:
    """Pairs/s of ``loader``'s batches reaching the card alone (host clock,
    ``epochs`` epochs, no training)."""
    t0 = time.perf_counter()
    pairs = 0
    for epoch in range(epochs):
        for batch in loader.epoch(epoch):
            pairs += batch.points_1.shape[0]
    torch.cuda.synchronize()
    return pairs / (time.perf_counter() - t0)


def panel_shares(card_panels, cpu_panels):
    """Each panel's share of pixels whose values agree within PANEL_ATOL +
    PANEL_RTOL x |cpu|, and its max abs difference."""
    out = []
    for a, b in zip(card_panels, cpu_panels):
        a = a.float().cpu().double()
        b = b.double()
        close = (a - b).abs() <= PANEL_ATOL + PANEL_RTOL * b.abs()
        close = close.reshape(close.shape[0], close.shape[1], -1).all(-1)
        out.append((close.double().mean().item(), (a - b).abs().max().item()))
    return out


def run_sixth_slice(card) -> None:
    """Phase 11 (see the module docstring)."""
    import importlib.util
    import os
    import shutil
    import tempfile

    from delora_tpu_torch import cli
    from delora_tpu_torch.config import default_config, default_settings, write_config_file
    from delora_tpu_torch.data.dataset import BatchLoader
    from delora_tpu_torch.data.kitti import read_velodyne_bin
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.ops.projection import ProjectionSpec
    from delora_tpu_torch.serving.stream import StreamingOdometry
    from delora_tpu_torch.training.checkpoint import load_checkpoint
    from delora_tpu_torch.training.trainer import training_panels
    from delora_tpu_torch.utils.torch_import import load_reference_checkpoint

    root = tempfile.mkdtemp(prefix="chip_smoke_sixth_")
    try:
        # a. The drive and its config file.
        t0 = time.perf_counter()
        write_synthetic_drive(os.path.join(root, "raw"))
        velodyne = os.path.join(root, "raw", "sequences", "00", "velodyne")
        raw_scans = [read_velodyne_bin(os.path.join(velodyne, n))
                     for n in sorted(os.listdir(velodyne))]
        settings = default_settings()
        settings["kitti"].update({
            "data_path": os.path.join(root, "raw", "sequences"),
            "preprocessed_path": os.path.join(root, "preprocessed"),
            "pose_data_path": os.path.join(root, "raw", "poses"),
            "training_identifiers": [0], "testing_identifiers": [0]})
        settings.update({"batch_size": TRAIN_B, "unsupervised_at_start": True,
                         "log_dir": os.path.join(root, "runs"),
                         "checkpoint_dir": os.path.join(root, "ckpt")})
        cfg_path = os.path.join(root, "cfg.json")
        write_config_file(cfg_path, settings)
        say(f"synthetic drive (child process, the port's write_kitti_layout): "
            f"{len(raw_scans)} scans of {SYNTH_RINGS} rings x {SYNTH_STEPS} azimuth steps, "
            f"{min(map(len, raw_scans))}-{max(map(len, raw_scans))} points each, "
            f"{time.perf_counter() - t0:.1f} s; config file {cfg_path}")

        # b. Preprocess from the config file: one exact placement a scan.
        reset_launches()
        t0 = time.perf_counter()
        cli.main(["preprocess", "--config", cfg_path])
        torch.cuda.synchronize()
        pre_launches = path_launches("synthetic_preprocess", {"placement": len(raw_scans)})
        pspec = ProjectionSpec.from_config(default_config(files=[cfg_path]), "kitti",
                                           preprocessing=True)
        say(f"synthetic preprocess (cli --config, card, {pspec.height}x{pspec.width}): "
            f"{len(raw_scans)} scans in {time.perf_counter() - t0:.2f} s, launches "
            f"{pre_launches}")

        # c. Train on the raw feed streamed through the C++ batcher.
        render = importlib.util.find_spec("matplotlib") is not None
        steps = NATIVE_EPOCHS * ((len(raw_scans) - 1) // TRAIN_B)
        expected = {k: v * steps + (PANEL_LAUNCHES[k] if render else 0)
                    for k, v in NATIVE_PER_STEP.items()}
        say(f"native train: expecting {steps} steps and launches {expected} (matplotlib "
            f"{'present: one image logging' if render else 'absent: images skipped'})")
        tee = Tee(sys.stdout)
        sys.stdout = tee
        reset_launches()
        try:
            trainer = cli.main(["train", "--config", cfg_path, "--epochs", str(NATIVE_EPOCHS),
                                "--run-name", "native", "--set"] + NATIVE_OVERRIDES)
            torch.cuda.synchronize()
        finally:
            sys.stdout = tee.stream
        train_launches = path_launches("native_train", expected)
        loader = trainer.feeds["kitti"].loader
        if trainer.feed != "raw" or loader is None or not loader.use_native \
                or loader._native_loader is None:
            raise RuntimeError(f"native train: feed {trainer.feed}, the C++ batcher did not "
                               f"engage")
        records = epoch_records(trainer)
        if len(records) != NATIVE_EPOCHS or not all(
                np.isfinite(v) for r in records for v in r.values()):
            raise RuntimeError(f"native train: epoch metrics {records}")
        skipped = "[trainer] image logging skipped:" in tee.text()
        images = [n for n in os.listdir(os.path.join(trainer.logger.run_dir, "artifacts"))
                  if n.startswith("images_")]
        if render != bool(images) or render == skipped:
            raise RuntimeError(f"native train: images {images}, skip line printed {skipped}, "
                               f"matplotlib present {render}")
        trace_path = os.path.join(trainer.logger.run_dir, "artifacts", "profile",
                                  "epoch_00001.pt.trace.json")
        names = trace_kernel_names(trace_path)
        found = {k: any(k in n for n in names)
                 for k in PLACEMENT_KERNELS + MATCHER_KERNELS + ("train_step", "batch")}
        if not all(found.values()):
            raise RuntimeError(f"native train: trace {trace_path} names {found}")
        say(f"native train (cli --config, card, B={TRAIN_B}, bf16, raw feed through the C++ "
            f"batcher): set-up {trainer.setup_seconds:.2f} s; epochs " + "; ".join(
                f"{r['step']}: loss {r['loss']:.6f}, {r['steps']:.0f} steps, "
                f"{r['scan_pairs_per_sec']:.1f} pairs/s" for r in records)
            + f"; launches {train_launches}; epoch 1 traced "
            f"({os.path.getsize(trace_path)} bytes, names {sorted(found)}); images: "
            + (f"{images}" if render else "skip line printed, nothing launched") + f" on {card}")
        python = BatchLoader(trainer.pair_datasets["kitti"], TRAIN_B, device="cuda",
                             seed=trainer.seed, native=False)
        for epoch in (0, 1):
            native_batches, python_batches = list(loader.epoch(epoch)), list(python.epoch(epoch))
            if len(native_batches) != len(python_batches) or not all(
                    torch.equal(a, b) for nb, pb in zip(native_batches, python_batches)
                    for a, b in zip(nb, pb)):
                raise RuntimeError(f"native batches differ from the Python producer's "
                                   f"(epoch {epoch})")
        # The feed alone, alternated: to the card, and on the host only (the
        # same loaders with CPU tensors: no copy to the card).
        feeds = {"native": loader, "python": python}
        for label, native in (("native_host", True), ("python_host", False)):
            feeds[label] = BatchLoader(trainer.pair_datasets["kitti"], TRAIN_B, device="cpu",
                                       seed=trainer.seed, native=native)
        rates = {}
        for label in ("native", "python", "python", "native", "native_host", "python_host",
                      "python_host", "native_host"):
            rates.setdefault(label, []).append(feed_rate(feeds[label], 3))
        say(f"native batches of epochs 0 and 1 bit-equal to the Python producer's "
            f"({len(native_batches)} batches an epoch, {TRAIN_B} x {loader.dataset.max_points} "
            f"points); the feed alone, 3 epochs each, alternated, pairs/s: to the card native "
            f"{rates['native']}, Python producer {rates['python']}; on the host only native "
            f"{rates['native_host']}, Python producer {rates['python_host']} on {card}")

        # d. Export the checkpoint's live weights to the DeLORA layout, serve them.
        latest = os.path.join(root, "ckpt", "latest")
        pth = os.path.join(root, "model.pth")
        cli.main(["export-torch", "--checkpoint", latest, "--out", pth])
        live = load_checkpoint(latest)["state"]["model"]
        from_pth = load_reference_checkpoint(pth)
        if set(from_pth) != set(live) or not all(torch.equal(from_pth[k], live[k])
                                                 for k in live):
            raise RuntimeError("export-torch: the .pth weights are not the checkpoint's live "
                               "weights")
        serve_cfg = default_config(base=torch.load(pth, weights_only=True)["parameters"])
        poses = {}
        for label, params in (("serve_pth", from_pth), ("serve_direct", live)):
            engine = StreamingOdometry(serve_cfg, params=params, device="cuda")
            reset_launches()
            outs = [engine.push_scan(scan) for scan in raw_scans[:SERVE_SCANS]]
            torch.cuda.synchronize()
            path_launches(label, {"placement": SERVE_SCANS})
            poses[label] = [o[0] for o in outs[1:]]
            for T in poses[label]:
                check_rigid(T)
        if not all(np.array_equal(a, b) for a, b in zip(poses["serve_pth"],
                                                         poses["serve_direct"])):
            raise RuntimeError("serving from the .pth differs from serving the weights directly")
        say(f"export-torch -> {os.path.getsize(pth)} bytes, weights bit-equal to the "
            f"checkpoint's live weights; served from the .pth: {SERVE_SCANS} scans, one exact "
            f"placement each, {len(poses['serve_pth'])} poses finite, rigid and bit-equal to "
            f"serving the weights directly (last translation "
            f"{np.round(poses['serve_pth'][-1][:3, 3], 4).tolist()}) on {card}")

        # e. The training panels on the card against the CPU, fp32, TF32 off.
        fp32 = default_config({"compute_dtype": "float32"}, base=trainer.config)
        spec = ProjectionSpec.from_config(fp32, "kitti")
        window = tuple(fp32["projective_window"])
        pair = trainer.pair_datasets["kitti"].get_pair(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        models = {}
        for dev in ("cuda", "cpu"):
            model = OdometryModel(ModelConfig.from_config(fp32))
            model.load_state_dict(live)
            models[dev] = model.to(dev)
        reset_launches()
        card_panels = training_panels(models["cuda"], pair, spec, window, torch.device("cuda"))
        torch.cuda.synchronize()
        panel_launches = path_launches("panels", PANEL_LAUNCHES)
        cpu_panels = training_panels(models["cpu"], pair, spec, window, torch.device("cpu"))
        shares = panel_shares(card_panels, cpu_panels)
        labels = ("target range", "source range", "transformed source range", "po2pl",
                  "target normals", "transformed source normals")
        if min(share for share, _ in shares) < PANEL_SHARE:
            raise RuntimeError(f"panels card vs CPU: {dict(zip(labels, shares))}")
        say("training panels (fp32, TF32 off) card vs CPU plain path on the checkpoint's "
            f"weights and pair 0: launches {panel_launches}; share of pixels within atol "
            f"{PANEL_ATOL} + rtol {PANEL_RTOL} (limit {PANEL_SHARE}), max abs diff: " + "; ".join(
                f"{k} {s:.5f}, {d:.3e}" for k, (s, d) in zip(labels, shares))
            + f"; occupied transformed-source pixels {int((card_panels[2] > 0).sum())}, "
            f"po2pl pixels {int((card_panels[3] > 0).sum())} on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 12: the seventh slice's paths. The ROS bridge under stub ROS modules,
# a rosbag-type dataset (the drive exported as .npy and as a stub bag,
# preprocessed and trained as ``darpa`` at its published 64x512), and
# data-parallel training through ``parallel/multiprocess.py``: a group of one
# over NCCL, and two gloo processes sharing the one card.
ROS_SCANS = 12
ROS_EPOCHS = 3
DIST_EPOCHS = 3
# Phase 12c's runs start where the supervised warmup leaves the model (the
# heads at the identity pose) and take the card's deterministic kernels
# (``multiprocess.train_run``): from random weights a step's correspondences
# change with the last bit of the pose, and under cuDNN's default kernels the
# plain trainer differs from itself from its second step on. Their fp32
# per-step losses are compared with the plain trainer's. A group of one over
# NCCL takes the same steps with identity collectives (an all-reduce of one,
# a broadcast from itself): bit for bit.
DIST_ONE_RTOL = 0.0
# Two processes each run half of every global batch and the gradients are
# summed in another order: within the CPU test's 1e-5.
DIST_TWO_RTOL = 1e-5
DIST_TIMEOUT = 600.0
# Phase 12c's step witness, from random weights (tolerances set before its
# first run). Each of two gloo processes steps on its half of the global batch
# and the all-reduce averages the halves' gradients; the reference is the
# plain step on each half in one process, averaged by hand. The same kernels
# on the same shapes: predicted bit-equal, held within the CPU test's 1e-5 of
# each tensor's largest gradient (and 1e-5 relative on every metric), which a
# missing or doubled division by the world size (a factor 2) cannot pass.
DIST_HALVES_RTOL = 1e-5
# The same step against the plain step on the whole batch: the convolutions
# may sum in another order at B / 2 than at B, a pose moves by an ulp and a
# few matches change hands, each moving a mean by about 1 / (number of
# pairs); the gradients held within 1e-2 norm-wise, the loss within 1e-2.
DIST_WHOLE_RTOL = 1e-2


def published_values(bridge):
    """Each published pair: (Odometry position + quaternion, TF translation +
    rotation, Odometry frame, TF frames, stamp seconds)."""
    out = []
    for odom, tfm in zip(bridge.pub.published, bridge.tf_broadcaster.sent):
        p, q = odom.pose.pose.position, odom.pose.pose.orientation
        t, r = tfm.transform.translation, tfm.transform.rotation
        out.append(([p.x, p.y, p.z, q.x, q.y, q.z, q.w], [t.x, t.y, t.z, r.x, r.y, r.z, r.w],
                    odom.header.frame_id, (tfm.header.frame_id, tfm.child_frame_id),
                    odom.header.stamp.to_sec()))
    return out


def run_ros_bridge(scans, card) -> None:
    """Phase 12a: ``RosOdometryBridge`` under the stub ROS modules with the
    default KITTI model (64x720, bf16, seeded weights) on phase 3's first
    scans, against ``StreamingOdometry`` fed the same scans directly."""
    import importlib
    from types import SimpleNamespace as NS

    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.serving import ros_bridge, ros_stubs
    from delora_tpu_torch.serving.stream import StreamingOdometry

    remove = ros_stubs.install()
    try:
        importlib.reload(ros_bridge)
        if not ros_bridge.ROS_AVAILABLE:
            raise RuntimeError("ros bridge: the stub ROS modules did not import")
        config = default_config()
        bridge = ros_bridge.RosOdometryBridge(config, device="cuda")
        scans = scans[:ROS_SCANS]
        reset_launches()
        callback_s, engine_s = [], []
        for k, scan in enumerate(scans):
            msg = ros_stubs.PointCloud2(NS(stamp=ros_stubs.Time(0.1 * k),
                                           frame_id="velodyne"), [], scan)
            t0 = time.perf_counter()
            bridge._callback(msg)
            callback_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches = path_launches("ros_bridge", {"placement": len(scans)})
        got = published_values(bridge)
        direct = StreamingOdometry(config, device="cuda")
        want = []
        for k, scan in enumerate(scans):
            out = direct.push_scan(scan)
            if out is None:
                continue
            T, pose, latency = out
            engine_s.append(latency)
            want.append(([float(v) for v in T[:3, 3]] + list(ros_bridge.rotmat_to_quat_np(
                T[:3, :3])), [float(v) for v in pose[:3, 3]] + list(
                ros_bridge.rotmat_to_quat_np(pose[:3, :3])), "lidar", ("world", "lidar"),
                0.1 * k))
        if len(got) != len(scans) - 1 or got != want:
            raise RuntimeError(f"ros bridge: {len(got)} published pairs differ from "
                               f"StreamingOdometry's {len(want)}")
        if not all(np.isfinite(v).all() for g in got for v in g[:2]):
            raise RuntimeError("ros bridge: published poses not finite")
        lat = sorted(callback_s[1:])
        say(f"ros bridge (stub ROS, default KITTI model, bf16, {len(scans)} scans of phase 3): "
            f"{len(got)} Odometry + TF pairs bit-equal to StreamingOdometry fed the same "
            f"scans, frames lidar / world->lidar, stamps 0.1 s apart; launches {launches}; "
            f"callback latency (host clock, the stub's read_points included) p50 "
            f"{statistics.median(lat) * 1e3:.2f} ms, max {lat[-1] * 1e3:.2f} ms; the "
            f"engine's own p50 {statistics.median(engine_s) * 1e3:.2f} ms, max "
            f"{max(engine_s) * 1e3:.2f} ms; last translation "
            f"{np.round(got[-1][1][:3], 4).tolist()} on {card}")
    finally:
        remove()
        importlib.reload(ros_bridge)


def run_rosbag_dataset(root, card) -> None:
    """Phase 12b: phase 3's drive (a KITTI layout under ``root/kitti``)
    exported by the port's exporter as ``.npy`` (sequence 0) and as a stub bag
    on the darpa topic (sequence 1), preprocessed as ``darpa`` at 64x512
    (both sequences' files bit-equal), then 3 epochs of training at full
    width, B = 8, on sequence 0."""
    import os

    from delora_tpu_torch import cli
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.data.export_sequence import (
        export_sequence,
        filtered_scans,
        velodyne_files,
        write_bag,
    )
    from delora_tpu_torch.serving import ros_stubs

    remove = ros_stubs.install()
    try:
        velodyne = os.path.join(root, "kitti", "sequences", "00", "velodyne")
        data = os.path.join(root, "darpa")
        t0 = time.perf_counter()
        export_sequence(velodyne, data, sequence="00")
        topic = default_config()["darpa"]["topic"]
        n_bag = write_bag(filtered_scans(velodyne_files(velodyne), keep_intensity=True),
                          os.path.join(data, "1.bag"), topic=topic)
        export_s = time.perf_counter() - t0
        darpa = {"training_identifiers": [0], "testing_identifiers": [1],
                 "data_path": data, "preprocessed_path": os.path.join(root, "darpa_pre")}
        common = ['datasets=["darpa"]', f"darpa={json.dumps(darpa)}",
                  f"log_dir={json.dumps(os.path.join(root, 'runs'))}"]
        reset_launches()
        t0 = time.perf_counter()
        pre = cli.main(["preprocess", "--set"] + common)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        n_scans = len(os.listdir(velodyne))
        pre_launches = path_launches("rosbag_preprocess", {"placement": 2 * n_scans})
        config = default_config({"datasets": ["darpa"], "darpa": darpa})
        spec = config["darpa"]
        base = spec["preprocessed_path"]
        survivors = []
        for k in range(n_scans):
            a, b = (np.load(os.path.join(base, seq, "scans", f"{k:06d}.npy"))
                    for seq in ("00", "01"))
            if not np.array_equal(a, b) or not np.array_equal(
                    *(np.load(os.path.join(base, seq, "normals", f"{k:06d}.npy"))
                      for seq in ("00", "01"))):
                raise RuntimeError(f"rosbag preprocess: scan {k} from the bag differs from "
                                   f"the export's")
            survivors.append(len(a))
        say(f"rosbag export: {n_scans} scans as .npy and {n_bag} PointCloud2 messages on "
            f"{topic} in a stub bag, {export_s:.2f} s; preprocess (cli, card, darpa "
            f"{spec['vertical_cells']}x{spec['horizontal_cells_preprocessing']}, max_points "
            f"{spec['max_points']}): {2 * n_scans} scans in {pre_s:.2f} s ("
            + ", ".join(f"{k} {v / (2 * n_scans) * 1e3:.2f} ms" for k, v in pre.seconds.items())
            + f" a scan), {min(survivors)}-{max(survivors)} survivors a scan, the bag's files "
            f"bit-equal to the export's; launches {pre_launches} on {card}")

        steps = ROS_EPOCHS * ((n_scans - 1) // TRAIN_B)
        reset_launches()
        trainer = cli.main(["train", "--epochs", str(ROS_EPOCHS), "--run-name", "darpa",
                            "--set"] + common + [
            f"batch_size={TRAIN_B}", "unsupervised_at_start=true", "visualize_images=false",
            f"checkpoint_dir={json.dumps(os.path.join(root, 'ckpt_darpa'))}"])
        torch.cuda.synchronize()
        launches = path_launches("rosbag_train", {"placement_packed": steps,
                                                  "window_match": steps})
        records = epoch_records(trainer)
        if len(records) != ROS_EPOCHS or not all(np.isfinite(v) for r in records
                                                 for v in r.values()):
            raise RuntimeError(f"rosbag train: epoch metrics {records}")
        if trainer.feeds["darpa"].tables is None:
            raise RuntimeError("rosbag train: the darpa tables are not on the card")
        say(f"rosbag train (cli, card, darpa 64x512, full width, B={TRAIN_B}, bf16, tables on "
            f"the card): epochs " + "; ".join(
                f"{r['step']}: loss {r['loss']:.6f}, {r['steps']:.0f} steps, "
                f"{r['scan_pairs_per_sec']:.1f} pairs/s" for r in records)
            + f"; launches {launches} for {steps} steps on {card}")
    finally:
        remove()


def record_launches(path: str, counts, expected) -> dict:
    """:func:`path_launches` for counts read in another process."""
    want = wanted(counts, expected)
    if counts != want:
        raise RuntimeError(f"{path}: kernel launches {counts}, expected {want}")
    PATH_LAUNCHES[path] = dict(counts)
    return {name: n for name, n in counts.items() if n}


def first_step_worker(device, config, init_weights):
    """Phase 12c's step witness, in each process of a run: the disk
    trainer's first step of epoch 0 from ``init_weights``, deterministic
    kernels, TF32 off -> its metrics, its gradients (averaged over the group
    in a group) and a digest of the weights after it. Without a group it
    also takes the plain step on each half (rows r::2) of the global batch,
    each from the same weights, and the largest gap between each half's model
    forward (B / 2) and the same rows of the whole batch's forward (B)."""
    import hashlib

    from delora_tpu_torch.parallel import dist as pdist
    from delora_tpu_torch.parallel.multiprocess import deterministic_kernels
    from delora_tpu_torch.training.state import make_optimizer
    from delora_tpu_torch.training.step import StepConfig, forward_pose, train_step
    from delora_tpu_torch.training.trainer import Trainer

    deterministic_kernels()
    trainer = Trainer(config, device=device, run_name="first_step")
    trainer.model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                   for k, v in init_weights.items()})
    dataset = trainer.datasets[0]
    cfg = StepConfig.from_config(config, dataset, supervised=trainer.supervised)
    batch = next(trainer.batches(0, dataset))

    def grads(model):
        return [p.grad.detach().cpu().numpy() for p in model.parameters()]

    out = {"rank": pdist.rank(), "halves": []}
    if not pdist.active():
        with torch.no_grad():
            whole = forward_pose(trainer.model, batch.image_1, batch.image_2,
                                 deterministic=True)
        for r in range(2):
            half = type(batch)(*(x[r::2] for x in batch))
            with torch.no_grad():
                T = forward_pose(trainer.model, half.image_1, half.image_2, deterministic=True)
            model = copy.deepcopy(trainer.model)
            optimizer, _ = make_optimizer(config, model.parameters(), trainer.batch_size)
            metrics = train_step(model, optimizer, half, cfg)
            out["halves"].append({"metrics": {k: float(v) for k, v in metrics.items()},
                                  "grads": grads(model),
                                  "forward_gap": float((T - whole[r::2]).abs().max())})
    metrics = trainer.step(batch, cfg)
    digest = hashlib.sha256()
    for value in trainer.model.state_dict().values():
        digest.update(value.detach().cpu().numpy().tobytes())
    out.update(metrics={k: float(v) for k, v in metrics.items()}, grads=grads(trainer.model),
               weights=digest.hexdigest())
    return out


def check_first_step(root, config, init, card) -> None:
    """Phase 12c's step witness: :func:`first_step_worker` in one process and
    in two gloo processes on the card, from the same random weights. The two
    processes' gradients and weights after the step agree bit for bit; their
    gradients and metrics against the mean of the plain step's on the two
    halves within :data:`DIST_HALVES_RTOL`, and against the plain step on the
    whole batch within :data:`DIST_WHOLE_RTOL` (norm-wise)."""
    import os

    from delora_tpu_torch.parallel.dist import SUMMED_METRICS

    target = "chip_smoke:first_step_worker"
    kwargs = dict(config=config, init_weights=init)
    plain = run_group_on_card(target, 1, kwargs, os.path.join(root, "step_plain"))[0]
    two = run_group_on_card(target, 2, kwargs, os.path.join(root, "step_gloo_2"),
                            backend="gloo", single_process_group=True)
    for r in two[1:]:
        if r["weights"] != two[0]["weights"] or r["metrics"] != two[0]["metrics"] or \
                not all(np.array_equal(a, b) for a, b in zip(r["grads"], two[0]["grads"])):
            raise RuntimeError("dist step: the two processes disagree after the step")
    h0, h1 = plain["halves"]
    half_mean = [(a + b) / np.float32(2) for a, b in zip(h0["grads"], h1["grads"])]
    got = two[0]["grads"]
    gap = max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
              for g, w in zip(got, half_mean))
    bit_equal = sum(np.array_equal(g, w) for g, w in zip(got, half_mean))
    metric_gap = {}
    for key, value in two[0]["metrics"].items():
        if key == "grad_norm":
            want = float(np.sqrt(sum(float((w.astype(np.float64) ** 2).sum())
                                     for w in half_mean)))
        elif key in SUMMED_METRICS:
            want = h0["metrics"][key] + h1["metrics"][key]
        else:
            want = float((np.float32(h0["metrics"][key]) + np.float32(h1["metrics"][key]))
                         / np.float32(2))
        metric_gap[key] = abs(value - want) / max(abs(want), 1e-12)
    whole = plain["grads"]
    whole_gap = float(np.sqrt(sum(float(((g.astype(np.float64) - w) ** 2).sum())
                                  for g, w in zip(got, whole))
                              / sum(float((w.astype(np.float64) ** 2).sum()) for w in whole)))
    loss_gap = abs(two[0]["metrics"]["loss"] - plain["metrics"]["loss"]) / abs(
        plain["metrics"]["loss"])
    say(f"dist step witness (full width, fp32, deterministic kernels, random weights seeded "
        f"{SEED}, global B={TRAIN_B}): first-step loss plain B={TRAIN_B} "
        f"{plain['metrics']['loss']!r}, 2 gloo processes {two[0]['metrics']['loss']!r}, "
        f"plain halves (B={TRAIN_B // 2}) {h0['metrics']['loss']!r} and "
        f"{h1['metrics']['loss']!r}; the model forward of each half against the same rows "
        f"of the whole batch's: max |gap| {h0['forward_gap']:.3e} and "
        f"{h1['forward_gap']:.3e}; the 2 processes' gradients against the mean of the "
        f"halves': {bit_equal} of {len(got)} tensors bit-equal, largest gap {gap:.3e} of a "
        f"tensor's largest gradient (limit {DIST_HALVES_RTOL}), metrics' largest relative "
        f"gap {max(metric_gap.values()):.3e}; against the whole batch's step: gradients "
        f"{whole_gap:.3e} norm-wise (limit {DIST_WHOLE_RTOL}), loss {loss_gap:.3e}; both "
        f"processes' gradients and weights after the step bit-equal on {card}")
    if gap > DIST_HALVES_RTOL or max(metric_gap.values()) > DIST_HALVES_RTOL:
        raise RuntimeError(f"dist step: 2 processes against the halves' mean: gradients "
                           f"{gap:.3e}, metrics {metric_gap} (limit {DIST_HALVES_RTOL})")
    if whole_gap > DIST_WHOLE_RTOL or loss_gap > DIST_WHOLE_RTOL:
        raise RuntimeError(f"dist step: 2 processes against the whole batch's step: "
                           f"gradients {whole_gap:.3e}, loss {loss_gap:.3e} (limit "
                           f"{DIST_WHOLE_RTOL})")


def run_group_on_card(target, nproc, kwargs, workdir, backend=None,
                      single_process_group=False):
    """``multiprocess.run_group`` with every process on ``cuda:0``."""
    from delora_tpu_torch.parallel.multiprocess import run_group

    return run_group(target, nproc, kwargs, workdir=workdir, device="cuda:0",
                     backend=backend, single_process_group=single_process_group,
                     timeout=DIST_TIMEOUT)


def run_distributed(root, card) -> None:
    """Phase 12c: the disk trainer through ``parallel/multiprocess.py`` on
    phase 3's drive preprocessed as KITTI, at full width, fp32 (TF32 off),
    global B = 8. The step witness (:func:`check_first_step`) from random
    weights; then the plain trainer in one process, a group of one over
    NCCL, and two gloo processes sharing the card, from the identity pose,
    and the plain trainer and two gloo processes from the random weights:
    each run 3 epochs on device tables (split over the group's processes),
    then a resume from ``latest`` on every process for one epoch streamed
    from the host."""
    import os
    import shutil

    from delora_tpu_torch import cli
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.parallel.multiprocess import MODULE, check_run, relative_drift

    kitti = {"data_path": os.path.join(root, "kitti", "sequences"),
             "preprocessed_path": os.path.join(root, "kitti_pre"),
             "pose_data_path": os.path.join(root, "kitti", "poses"),
             "training_identifiers": [0], "testing_identifiers": [0]}
    reset_launches()
    cli.main(["preprocess", "--set", f"kitti={json.dumps(kitti)}"])
    torch.cuda.synchronize()
    n_scans = len(os.listdir(os.path.join(kitti["preprocessed_path"], "00", "scans")))
    path_launches("dist_preprocess", {"placement": n_scans})
    config = default_config({
        "kitti": kitti, "batch_size": TRAIN_B, "compute_dtype": "float32",
        "unsupervised_at_start": True, "visualize_images": False,
        "checkpoint_dir": os.path.join(root, "ckpt_dist"),
        "log_dir": os.path.join(root, "runs_dist")})
    model = OdometryModel(ModelConfig.from_config(config), torch.Generator().manual_seed(SEED))
    random_init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    check_first_step(root, config, random_init, card)
    start_at_identity(model)
    identity_init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    steps = (n_scans - 1) // TRAIN_B
    per_step = {"placement_packed": 1, "window_match": 1}
    runs = {}
    for label, nproc, backend, group, init in (
            ("plain", 1, None, False, identity_init),
            ("nccl_1", 1, "nccl", True, identity_init),
            ("gloo_2", 2, "gloo", True, identity_init),
            ("plain_random", 1, None, False, random_init),
            ("gloo_2_random", 2, "gloo", True, random_init)):
        for key in ("checkpoint_dir", "log_dir"):
            shutil.rmtree(config[key], ignore_errors=True)
        t0 = time.perf_counter()
        results = run_group_on_card(
            f"{MODULE}:train_run", nproc,
            dict(config=config, epochs=DIST_EPOCHS, run_name=label, init_weights=init),
            os.path.join(root, f"dist_{label}"), backend=backend,
            single_process_group=group)
        wall = time.perf_counter() - t0
        check_run(results, DIST_EPOCHS)
        for r in results:
            if r["world"] != nproc or not (r["resident"] and r["streamed"]):
                raise RuntimeError(f"dist {label}: rank {r['rank']} world {r['world']}, "
                                   f"resident {r['resident']}, streamed {r['streamed']}")
            if not all(np.isfinite(v) for m in r["metrics"] for v in m.values()):
                raise RuntimeError(f"dist {label}: metrics not finite {r['metrics']}")
            suffix = f"_rank{r['rank']}" if nproc > 1 else ""
            record_launches(f"dist_{label}{suffix}_train", r["launches_train"],
                            {k: v * DIST_EPOCHS * steps for k, v in per_step.items()})
            record_launches(f"dist_{label}{suffix}_resume", r["launches_resume"],
                            {k: v * steps for k, v in per_step.items()})
        if results[0]["checkpoint_files"] != ["epoch_00000", "latest"] or \
                results[0]["writes"] != DIST_EPOCHS + 1:
            raise RuntimeError(f"dist {label}: checkpoints {results[0]['checkpoint_files']}, "
                               f"rank 0 wrote {results[0]['writes']}")
        runs[label] = results
        rates = [m["scan_pairs_per_sec"] for m in results[0]["metrics"]]
        say(f"dist {label} ({nproc} process{'es' if nproc > 1 else ''}"
            + (f", {backend}" if backend else ", no group")
            + (", 2 ranks sharing one card" if nproc > 1 else "")
            + f"; full width, fp32, global B={TRAIN_B}, from "
            + ("random weights" if init is random_init else "the identity")
            + f"): losses {results[0]['losses']} identical on every rank; "
            f"pairs/s by epoch {[round(x, 1) for x in rates]} (the last streamed after the "
            f"resume); checkpoint files written by rank {[r['writes'] for r in results]}; "
            f"resumed at epoch {results[0]['start_epoch']} on every rank with the saved "
            f"weights; launches a rank: train {results[0]['launches_train']}, resume "
            f"{results[0]['launches_resume']}; {wall:.1f} s with start-up on {card}")

    def step_losses(label):
        return [x for epoch in runs[label][0]["step_losses"] for x in epoch]

    plain = step_losses("plain")
    one = relative_drift(plain, step_losses("nccl_1"))
    two = relative_drift(plain, step_losses("gloo_2"))
    if len(plain) != (DIST_EPOCHS + 1) * steps or one > DIST_ONE_RTOL \
            or two > DIST_TWO_RTOL:
        raise RuntimeError(f"dist: {len(plain)} per-step losses drift {one:.3e} from the plain "
                           f"trainer's (NCCL, one process; limit {DIST_ONE_RTOL}) and "
                           f"{two:.3e} (2 gloo processes; limit {DIST_TWO_RTOL})")
    random_steps = (step_losses("plain_random"), step_losses("gloo_2_random"))
    random_epochs = (runs["plain_random"][0]["losses"], runs["gloo_2_random"][0]["losses"])
    say(f"dist fp32 per-step losses ({len(plain)} steps) against the plain trainer from the "
        f"identity: a group of one over NCCL max relative drift {one:.3e} (limit "
        f"{DIST_ONE_RTOL}), 2 gloo processes on one card {two:.3e} (limit {DIST_TWO_RTOL}); "
        f"from random weights (not held: the halves' forwards differ from the whole "
        f"batch's in the last bits, see the step witness, and training from random "
        f"weights amplifies that): 2 gloo processes' per-step losses {random_steps[1]} "
        f"against the plain trainer's {random_steps[0]}, max relative drift "
        f"{relative_drift(*random_steps):.3e}, per epoch {relative_drift(*random_epochs):.3e}; "
        f"NCCL across two cards is not checked (one card) on {card}")


def run_seventh_slice(scans, card) -> None:
    """Phase 12 (see the module docstring)."""
    import os
    import shutil
    import tempfile

    run_ros_bridge(scans, card)
    root = tempfile.mkdtemp(prefix="chip_smoke_seventh_")
    try:
        write_kitti_layout(os.path.join(root, "kitti"), scans)
        run_rosbag_dataset(root, card)
        run_distributed(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 13: the bench (``delora_tpu_torch/bench.py``) through ``python -m
# delora_tpu_torch.cli bench`` in a fresh process at full width, then its
# headline once more in this process with exact launch counts.
BENCH_B, BENCH_K = 8, 20
SCAN_PERIOD_MS = 100.0
BENCH_TIMEOUT = 600.0


def closed_form_flops(convs, linears) -> int:
    """Forward 2 x MACs of every Conv2d and Linear; backward twice that, less
    the first layer's input gradient (the images carry no gradient)."""
    forward = [2 * out.numel() * m.in_channels // m.groups * math.prod(m.kernel_size)
               for m, out in convs]
    forward += [2 * inp.numel() * m.out_features for m, inp in linears]
    return 3 * sum(forward) - forward[0]


def counted_flops(b) -> tuple:
    """(FlopCounterMode's count of one headline step, the closed form over
    the shapes that step's Conv2d and Linear layers saw)."""
    convs, linears = [], []

    def hook(module, inputs, output):
        if isinstance(module, torch.nn.Conv2d):
            convs.append((module, output))
        else:
            linears.append((module, inputs[0]))

    handles = [m.register_forward_hook(hook) for m in b.model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        flops = b.step_flops()
    finally:
        for h in handles:
            h.remove()
    return flops, closed_form_flops(convs, linears)


def run_bench(card) -> None:
    """Phase 13 (see the module docstring)."""
    import os

    from delora_tpu_torch import bench

    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    command = [sys.executable, "-m", "delora_tpu_torch.cli", "bench", str(BENCH_B),
               str(BENCH_K)]
    t0 = time.perf_counter()
    proc = subprocess.run(command, cwd=root, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        say(f"bench stderr: {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(command[1:])} exited {proc.returncode}; stdout tail: "
                           f"{proc.stdout[-2000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    say(f"bench ({' '.join(command[2:])}, a fresh process, {wall:.1f} s with start-up): "
        f"{json.dumps(result)} on {card}")
    if tuple(result) != bench.JSON_KEYS:
        raise RuntimeError(f"bench: keys {list(result)}, expected {list(bench.JSON_KEYS)}")
    numbers = [result[k] for k in bench.JSON_KEYS
               if k not in ("metric", "unit", "kernel_parity_max_abs_diff")]
    if not all(isinstance(x, (int, float)) and math.isfinite(x) for x in numbers) \
            or result["value"] <= 0:
        raise RuntimeError(f"bench: a number is not finite, or the headline is not > 0: {result}")
    if not (result["inference_p50_ms"] < SCAN_PERIOD_MS and
            result["serving_p50_ms"] < SCAN_PERIOD_MS):
        raise RuntimeError(f"bench: p50s {result['inference_p50_ms']} and "
                           f"{result['serving_p50_ms']} ms, limit the {SCAN_PERIOD_MS} ms scan "
                           f"period")
    if not 0 < result["mfu"] <= 1:
        raise RuntimeError(f"bench: mfu {result['mfu']} outside (0, 1]")
    parity = result["kernel_parity_max_abs_diff"]
    rows = ("placement_packed", "placement_compact", "window_matcher", "window_matcher_soft")
    if parity is None or sorted(parity) != sorted(rows) or any(parity[r] != 0.0 for r in rows):
        raise RuntimeError(f"bench: kernel parity {parity}, expected 0.0 in each of {rows}")
    if result["augment_overflow_tiles"] != 0:
        raise RuntimeError(f"bench: {result['augment_overflow_tiles']} overflowing tiles")

    b = bench.Bench(BENCH_B, BENCH_K, "cuda")
    flops, closed = counted_flops(b)
    if not result["flops_per_step"] == flops == closed:
        raise RuntimeError(f"bench: flops_per_step {result['flops_per_step']}, FlopCounterMode "
                           f"here {flops}, the closed form over the layers' shapes {closed}")
    reset_launches()
    rate, steps, step_s = b.headline()
    launched = path_launches("bench", {"placement_packed": steps, "window_match": steps})
    say(f"bench headline in this process: {steps} steps (warm-up included), {rate:.1f} pairs/s "
        f"({step_s * 1e3:.2f} ms a timed step); launches {launched}; flops_per_step "
        f"{flops} = FlopCounterMode here = the closed form; on {card}")


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
    builds = cuda_build.build_all(["placement", "window_match", "nn_search", "circular_pad",
                                   "delora_io"])
    say(f"build: {time.perf_counter() - t0:.2f} s for all five, one compiler each started "
        f"together (nvcc {' '.join(cuda_build.NVCC_FLAGS)}; the host IO library "
        f"{cuda_build.host_compiler()} {' '.join(cuda_build.HOST_FLAGS)})")
    for lib, (log, seconds, built) in builds.items():
        say(f"build {lib}: {seconds:.2f} s{'' if built else ' (already built)'}")
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
    pad, err_pad = check_circular_pad(card)

    run_serving(config, scans[:12], spec, card)
    run_training(trainer, card, "main", 12, {"placement_packed": 1, "window_match": 1,
                                             **PAD_LAUNCHES_A_STEP})
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

    # Phase 10: augmentation, the cached-target feed, projective
    # correspondence, the raw feed at 64x1024, remat and fused_adam.
    run_new_paths(drive_scans, card)

    # Phase 11: config files, the synthetic drive, the C++ batcher, profiling,
    # the .pth export and serving from it, the training panels.
    run_sixth_slice(card)

    # Phase 12: the ROS bridge, a rosbag-type dataset, data-parallel training.
    run_seventh_slice(scans, card)

    # Phase 13: the bench, in a fresh process and its headline here.
    run_bench(card)

    def row(name_, source, replaces, err, t, counted=None):
        names = counted or (name_,)
        by_path = {path: sum(counts.get(n, 0) for n in names)
                   for path, counts in PATH_LAUNCHES.items()}
        by_path = {path: n for path, n in by_path.items() if n}
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t.get("bound_by", "bytes"),
                "library_ms": t["library_ms"], "device_ms": t["device_ms"],
                "launches_by_path": by_path,
                **{k: t[k] for k in ("floor_ms", "floor_instructions_per_candidate",
                                     "preprocess_shape", "library_ms_b1", "grad_ms",
                                     "grad_device_ms", "grad_plain_ms", "shape") if k in t}}

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
        row("circular_pad", "delora_tpu_torch/csrc/circular_pad.cu",
            "delora_tpu/models/resnet.py:38 (no kernel: a concatenate and pad XLA fuses)",
            err_pad, pad, counted=MODEL_COUNTERS),
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
