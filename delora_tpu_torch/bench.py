"""The bench: full-train-step throughput on one card, KITTI-shaped data.

    python -m delora_tpu_torch.cli bench [B] [K] [--device DEV]
    python -m delora_tpu_torch.bench [B] [K] [--device DEV]

The port of the root ``bench.py``: the same inputs and sections, measured on
the card, and one JSON line on stdout with the same keys:

  {"metric": "scan_pairs_per_sec_per_chip", "value": N, "unit": "pairs/s",
   "vs_baseline": R, "inference_p50_ms": ..., "serving_p50_ms": ...,
   "flops_per_step": ..., "achieved_tflops": ..., "mfu": ...,
   "kernel_parity_max_abs_diff": {...}, "augment_pairs_per_sec": ...,
   "augment_overflow_tiles": ...}

Inputs (bench.py:80-124): B scan pairs (``B``, default 8) of N = 131,072
points of which the first 110,000 are valid, drawn from
``np.random.default_rng(0)`` exactly as the reference draws them, projected
to 64x720 (16x64, N = 4,096, 3,000 valid under ``BENCH_SMOKE``, for the CPU
tests). The model is the default KITTI model at full width in bf16 autocast,
its weights drawn from a seeded ``torch.Generator``; Adam at lr 1e-5.

Sections, in order:

1. headline: the trainer's default path, ``training/step.py::train_step`` on
   a ``FullyCachedBatch`` gathered on the card from the 2B scans' artifact
   tables (targets ``t = arange(B)``, sources ``t + B``) every step: one
   packed placement and one hard matcher launch a step. The reference's
   ``lax.scan`` of ``BENCH_KS`` steps a dispatch only amortized the TPU's
   dispatch, so it has no port and ``BENCH_KS`` is not read; its default
   step counts are kept: 2 x 32 warm-up steps, then a window of
   32 x max(5, K // 32) steps timed on the host clock between two
   synchronizations. ``value`` = steps x B / seconds; ``vs_baseline`` =
   value / 10, the reference's single-GPU figure (bench.py:21-29).
   ``BENCH_HEADLINE_ONLY`` prints the four headline keys and stops;
2. latency: ``inference_p50_ms``, ``infer_step`` on the first pair at B=1
   (both scans projected under the exact rule), and ``serving_p50_ms``, the
   new scan's ``project_image`` plus ``forward_pose`` against the previous
   image kept on the card; 20 timed calls each after one warm call, each
   call ending in a synchronization;
3. FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one headline
   step, counting the model's convolutions and linears, forward and backward
   (XLA's cost analysis has no counterpart); ``achieved_tflops`` = FLOPs /
   the headline's seconds a step, ``mfu`` = that over the card's dense bf16
   tensor-core peak (:data:`PEAK_BF16_TFLOPS` by ``torch.cuda.
   get_device_name``, or ``BENCH_PEAK_TFLOPS``; an unknown device without
   the override raises);
4. ``kernel_parity_max_abs_diff`` (the reference's
   ``pallas_parity_max_abs_diff``): each kernel's wrapper against its plain
   version on the same card tensors at B=2: ``placement_packed`` and
   ``placement_compact`` (the exact rule on the raw clouds), ``window_matcher``
   (hard, window (5,9)) and ``window_matcher_soft`` (sigma 0.3). ``null`` on
   the CPU, where no kernel exists;
5. augmentation: the fully-cached step with ``augment``, rotations drawn by
   ``augment_rotations`` from the bench's generator, K timed steps after 2:
   ``augment_pairs_per_sec`` and ``augment_overflow_tiles``.

The JSON line is printed, then diagnostics go to stderr, each skipped with a
line saying so when less than :data:`DIAGNOSTIC_MIN_S` seconds remain of
``BENCH_DEADLINE_S`` (default 480, counted from the start of :func:`main`):
the fully-cached step on one fixed batch, the soft matcher (sigma 0.3), the
cached-target step, projective correspondence on the cached feed and the
uncached step (both raw clouds projected on the card), each K timed steps
after 2.

Every timed step is a whole train step, the Adam update included, as the
trainer runs it. A section that raises ends the run (after the JSON line if
it was printed): no field is silently nulled. The bench runs on CUDA unless
given another device; the CPU (``--device cpu``) is for the tests.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from delora_tpu_torch import resolve_device
from delora_tpu_torch.losses.icp import IcpLossConfig
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.ops.cuda.placement import placement, placement_plain
from delora_tpu_torch.ops.cuda.window_match import (
    window_match,
    window_match_plain,
    window_match_soft,
    window_match_soft_plain,
)
from delora_tpu_torch.ops.projection import ProjectionSpec, _pixel_coords, project_image
from delora_tpu_torch.ops.projection_host import scan_artifacts_np
from delora_tpu_torch.training.state import make_optimizer
from delora_tpu_torch.training.step import (
    CachedTargetBatch,
    FullyCachedBatch,
    ScanPairBatch,
    StepConfig,
    forward_pose,
    infer_step,
    train_step,
)

# The reference's single-GPU training figure, the denominator of vs_baseline.
BASELINE_PAIRS_PER_S = 10.0
# The reference's default steps a dispatch (BENCH_KS), kept as the unit of
# the headline's step counts.
STEPS_PER_DISPATCH = 32
WARMUP_DISPATCHES = 2
LATENCY_CALLS = 20
DIAGNOSTIC_MIN_S = 120.0
DEFAULT_DEADLINE_S = 480.0
SEED = 0
MATCH_WINDOW = (5, 9)
SOFT_SIGMA = 0.3
# Dense bf16 tensor-core peak by torch.cuda.get_device_name: the H100 SXM5's
# 989.4 TFLOP/s at its 700 W limit, from NVIDIA's H100 data sheet (1,979 with
# sparsity). A card set below 700 W runs slower under load: the bench logs
# nvidia-smi's name and power limit beside its numbers.
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}
# The model's convolutions and linears, forward and backward, as
# FlopCounterMode names them; the step's other matrix products (the
# per-pixel 7x7 affine, a batched product) are not the model's.
MODEL_FLOP_OPS = ("convolution", "convolution_backward", "addmm", "mm")
JSON_KEYS = ("metric", "value", "unit", "vs_baseline", "inference_p50_ms", "serving_p50_ms",
             "flops_per_step", "achieved_tflops", "mfu", "kernel_parity_max_abs_diff",
             "augment_pairs_per_sec", "augment_overflow_tiles")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Shapes(NamedTuple):
    batch: int
    height: int
    width: int
    points: int             # N, KITTI's max_points
    valid: int              # points that survive preprocessing in a typical scan


def bench_shapes(batch: int, smoke: bool) -> Shapes:
    """The reference's shapes (bench.py:82-89), or its tiny ones."""
    if smoke:
        return Shapes(batch, 16, 64, 4096, 3000)
    return Shapes(batch, 64, 720, 131072, 110000)


def projection_spec(shapes: Shapes) -> ProjectionSpec:
    """KITTI's fields of view at the bench's image size (bench.py:99-103)."""
    return ProjectionSpec(
        height=shapes.height, width=shapes.width,
        fov_down=float(np.deg2rad(-24.5)), fov_up=float(np.deg2rad(2.0)),
        fov_left=float(np.deg2rad(-179.9)), fov_right=float(np.deg2rad(179.9)))


def draw_scans(shapes: Shapes) -> Tuple[np.ndarray, ...]:
    """(points_1, normals_1, valid_1, points_2, normals_2, valid_2) as numpy
    arrays, drawn from ``default_rng(0)`` as the reference's ``scan()``
    (bench.py:108-117) draws them, target scans first."""
    rng = np.random.default_rng(0)
    B, N, valid_n = shapes.batch, shapes.points, shapes.valid

    def scan():
        pts = rng.normal(size=(B, N, 3)).astype(np.float32)
        pts *= np.array([12.0, 12.0, 1.0], np.float32)
        pts[..., 2] -= 1.6
        valid = np.zeros((B, N), bool)
        valid[:, :valid_n] = True
        nrm = rng.normal(size=(B, N, 3)).astype(np.float32)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        nrm[~valid] = 0.0
        return pts, nrm, valid

    return (*scan(), *scan())


def artifact_tables(scans: Sequence[np.ndarray], spec: ProjectionSpec
                    ) -> Tuple[np.ndarray, ...]:
    """The 2B scans' artifacts (targets, then sources) stacked as the six
    tables of bench.py:168-175: image, normal image, mean range (float32),
    compacted source points, normals and validity."""
    p1, n1, v1, p2, n2, v2 = scans
    arts = ([scan_artifacts_np(p1[b], n1[b], v1[b], spec) for b in range(len(p1))]
            + [scan_artifacts_np(p2[b], n2[b], v2[b], spec) for b in range(len(p2))])
    return (np.stack([a.image for a in arts]),
            np.stack([a.normal_image for a in arts]),
            np.asarray([a.mean_range for a in arts], np.float32),
            np.stack([a.src_points for a in arts]),
            np.stack([a.src_normals for a in arts]),
            np.stack([a.src_valid for a in arts]))


def gather_batch(tables: Sequence[torch.Tensor], t: torch.Tensor, s: torch.Tensor
                 ) -> FullyCachedBatch:
    """The pairs (t[i], s[i]) gathered from the tables (bench.py:187-190)."""
    img, nimg, mr, pts, nrm, val = tables
    return FullyCachedBatch(img[t], nimg[t], mr[t], img[s], pts[s], nrm[s], val[s], mr[s])


def peak_flops_per_s(device: torch.device) -> float:
    """The device's dense bf16 peak: ``BENCH_PEAK_TFLOPS`` if set, else the
    card's entry in :data:`PEAK_BF16_TFLOPS`; any other device raises."""
    override = os.environ.get("BENCH_PEAK_TFLOPS")
    if override:
        return float(override) * 1e12
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    if name not in PEAK_BF16_TFLOPS:
        raise ValueError(f"no bf16 peak known for {name!r} (known: {sorted(PEAK_BF16_TFLOPS)}); "
                         "set BENCH_PEAK_TFLOPS")
    return PEAK_BF16_TFLOPS[name] * 1e12


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, equal values (infinities included) counting 0; inf
    where one side is infinite and the other is not."""
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


class Bench:
    """The bench's inputs, model and optimizer on one device."""

    def __init__(self, batch: int, steps: int, device: Union[str, torch.device, None] = None,
                 smoke: bool = False):
        self.device = resolve_device(device)
        self.shapes = bench_shapes(batch, smoke)
        self.steps = steps
        self.spec = projection_spec(self.shapes)
        self.cfg = StepConfig(proj=self.spec, icp=IcpLossConfig())
        self.model = OdometryModel(ModelConfig(compute_dtype=torch.bfloat16),
                                   torch.Generator().manual_seed(SEED)).to(self.device)
        self.optimizer, _ = make_optimizer({"learning_rate": 1e-5}, self.model.parameters(),
                                           batch)
        self.generator = torch.Generator(self.device).manual_seed(SEED)
        scans = draw_scans(self.shapes)
        self.raw = ScanPairBatch(*(torch.from_numpy(x).to(self.device) for x in scans))
        self.tables = tuple(torch.from_numpy(x).to(self.device)
                            for x in artifact_tables(scans, self.spec))
        self.t = torch.arange(batch, device=self.device)
        self.s = self.t + batch
        self.fixed = gather_batch(self.tables, self.t, self.s)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> Dict[str, torch.Tensor]:
        """One headline step: the batch gathered on the device, then
        ``train_step``."""
        return train_step(self.model, self.optimizer, gather_batch(self.tables, self.t, self.s),
                          self.cfg)

    def headline(self) -> Tuple[float, int, float]:
        """-> (pairs/s, steps run with warm-up, seconds a timed step)."""
        warm = WARMUP_DISPATCHES * STEPS_PER_DISPATCH
        timed = STEPS_PER_DISPATCH * max(5, self.steps // STEPS_PER_DISPATCH)
        t0 = time.perf_counter()
        for _ in range(warm):
            m = self.step()
        self.sync()
        log(f"headline warm-up ({warm} steps): "
            f"{time.perf_counter() - t0:.1f} s; loss={float(m['loss']):.5f}")
        t0 = time.perf_counter()
        for _ in range(timed):
            m = self.step()
        self.sync()
        elapsed = time.perf_counter() - t0
        B = self.shapes.batch
        pairs_per_sec = timed * B / elapsed
        log(f"headline (fully cached, image matcher, gathered on the device): {timed} steps x "
            f"{B} pairs in {elapsed:.2f} s -> {pairs_per_sec:.2f} pairs/s "
            f"({elapsed / timed * 1000:.2f} ms/step); loss={float(m['loss']):.5f}")
        return pairs_per_sec, warm + timed, elapsed / timed

    def _p50_ms(self, call) -> float:
        call()
        self.sync()
        lat = []
        for _ in range(LATENCY_CALLS):
            t0 = time.perf_counter()
            call()
            self.sync()
            lat.append(time.perf_counter() - t0)
        return float(np.percentile(lat, 50) * 1000)

    @torch.no_grad()
    def latency(self) -> Tuple[float, float]:
        """-> (inference p50 ms, serving p50 ms)."""
        b1 = ScanPairBatch(*(x[:1] for x in self.raw))
        infer = self._p50_ms(lambda: infer_step(self.model, b1, self.cfg))
        log(f"single-pair inference p50: {infer:.2f} ms (budget 100 ms)")

        prev = [project_image(self.raw.points_1[0], self.raw.valid_1[0], self.spec)[None]]

        def serve():
            img = project_image(self.raw.points_2[0], self.raw.valid_2[0], self.spec)[None]
            forward_pose(self.model, prev[0], img, deterministic=True)
            prev[0] = img

        serving = self._p50_ms(serve)
        log(f"serving steady-state p50: {serving:.2f} ms/scan (budget 100 ms)")
        return infer, serving

    def step_flops(self) -> int:
        """The model's FLOPs in one headline step, counted by FlopCounterMode."""
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            self.step()
        self.sync()
        return sum(int(n) for op, n in counter.get_flop_counts()["Global"].items()
                   if str(op).split(".")[-1] in MODEL_FLOP_OPS)

    def kernel_parity(self) -> Optional[Dict[str, float]]:
        """Each kernel's wrapper against its plain version on the same card
        tensors, B=2; None off CUDA."""
        if self.device.type != "cuda":
            log(f"kernel parity: null on {self.device}: the CUDA kernels run only on a CUDA "
                "device, and the CPU path is their plain versions")
            return None
        H, W = self.spec.height, self.spec.width
        fb = FullyCachedBatch(*(x[:2] for x in self.fixed))
        r, _, _, _, pix = _pixel_coords(fb.src_points, fb.src_valid, self.spec)
        args = (pix.contiguous(), r.contiguous(),
                torch.cat([fb.src_points, fb.src_normals], dim=-1).contiguous(), H, W)
        packed = placement(*args, packed=True)
        d_packed = max_abs_diff(packed, placement_plain(*args, packed=True))

        raw = ScanPairBatch(*(x[:2] for x in self.raw))
        r, _, _, _, pix = _pixel_coords(raw.points_1, raw.valid_1, self.spec)
        args = (pix.contiguous(), r.contiguous(),
                torch.cat([raw.points_1, raw.normals_1], dim=-1).contiguous(), H, W)
        d_compact = max_abs_diff(placement(*args), placement_plain(*args))

        match_args = (packed[..., 0:3], fb.image_1[..., 0:3], fb.normal_image_1, MATCH_WINDOW)
        d_match = max(map(max_abs_diff, window_match(*match_args),
                          window_match_plain(*match_args)))
        d_soft = max(map(max_abs_diff, window_match_soft(*match_args, SOFT_SIGMA),
                         window_match_soft_plain(*match_args, SOFT_SIGMA)))
        out = {"placement_packed": d_packed, "placement_compact": d_compact,
               "window_matcher": d_match, "window_matcher_soft": d_soft}
        log(f"kernel-vs-plain parity on the card: {out}")
        return out

    def timed_steps(self, label: str, batch, cfg: StepConfig, steps: int,
                    augment_generator: Optional[torch.Generator] = None
                    ) -> Tuple[float, Dict[str, torch.Tensor]]:
        """2 warm-up steps, then ``steps`` timed ones of ``batch`` under
        ``cfg`` -> (pairs/s, the last step's metrics)."""
        t0 = time.perf_counter()
        for _ in range(2):
            m = train_step(self.model, self.optimizer, batch, cfg,
                           augment_generator=augment_generator)
        self.sync()
        log(f"{label} warm-up: {time.perf_counter() - t0:.1f} s; loss={float(m['loss']):.5f}")
        t0 = time.perf_counter()
        for _ in range(steps):
            m = train_step(self.model, self.optimizer, batch, cfg,
                           augment_generator=augment_generator)
        self.sync()
        elapsed = time.perf_counter() - t0
        B = self.shapes.batch
        log(f"{label}: {steps} steps x {B} pairs in {elapsed:.2f} s -> "
            f"{steps * B / elapsed:.2f} pairs/s ({elapsed / steps * 1000:.1f} ms/step); "
            f"loss={float(m['loss']):.5f}")
        return steps * B / elapsed, m

    def augment(self) -> Tuple[float, float]:
        """-> (augmented pairs/s, the last step's overflowing tiles)."""
        rate, m = self.timed_steps("fully cached + augment", self.fixed,
                                   self.cfg._replace(augment=True), self.steps,
                                   augment_generator=self.generator)
        return rate, float(m["placement_overflow_tiles"])

    def diagnostics(self, remaining) -> None:
        """The stderr-only sections; ``remaining()`` -> seconds left."""
        cached = CachedTargetBatch(self.fixed.image_1, self.fixed.normal_image_1,
                                   self.fixed.mean_range_1, self.raw.points_2,
                                   self.raw.normals_2, self.raw.valid_2)
        sections = (
            ("fully cached, one fixed batch", self.fixed, self.cfg),
            (f"soft match (fully cached, sigma={SOFT_SIGMA})", self.fixed,
             self.cfg._replace(soft_match_sigma=SOFT_SIGMA)),
            ("cached target", cached, self.cfg),
            ("projective (cached target)", cached,
             self.cfg._replace(correspondence="projective")),
            ("uncached (both scans projected on the device)", self.raw, self.cfg),
        )
        for label, batch, cfg in sections:
            left = remaining()
            if left <= DIAGNOSTIC_MIN_S:
                log(f"diagnostic skipped: {label}: {left:.1f} s left of the deadline, "
                    f"a section needs {DIAGNOSTIC_MIN_S:.0f}")
                continue
            self.timed_steps(label, batch, cfg, self.steps)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None, device: Union[str, torch.device, None] = None
         ) -> Dict[str, object]:
    """Run the bench: ``argv`` = [B] [K] (default 8 and 20), ``device`` the
    device (CUDA if None). Prints the JSON line and returns it as a dict."""
    start = time.perf_counter()
    deadline = float(os.environ.get("BENCH_DEADLINE_S", DEFAULT_DEADLINE_S))
    argv = list(argv or ())
    batch = int(argv[0]) if argv else 8
    steps = int(argv[1]) if len(argv) > 1 else 20
    dev = resolve_device(device)
    headline_only = bool(os.environ.get("BENCH_HEADLINE_ONLY"))
    peak = None if headline_only else peak_flops_per_s(dev)
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(dev)} | nvidia-smi: {card_line()} | "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
    else:
        log(f"device: {dev} (no card: every number below is the CPU's)")

    t0 = time.perf_counter()
    bench = Bench(batch, steps, dev, smoke=bool(os.environ.get("BENCH_SMOKE")))
    sh = bench.shapes
    log(f"bench config: B={sh.batch} H={sh.height} W={sh.width} N={sh.points} "
        f"valid={sh.valid} K={steps}; inputs, tables and model in "
        f"{time.perf_counter() - t0:.1f} s")

    pairs_per_sec, _, step_s = bench.headline()
    result: Dict[str, object] = {
        "metric": "scan_pairs_per_sec_per_chip",
        "value": round(pairs_per_sec, 3),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_S, 3),
    }
    if headline_only:
        print(json.dumps(result), flush=True)
        return result

    infer_ms, serving_ms = bench.latency()
    result["inference_p50_ms"] = round(infer_ms, 2)
    result["serving_p50_ms"] = round(serving_ms, 2)

    flops = bench.step_flops()
    achieved = flops / step_s
    result["flops_per_step"] = flops
    result["achieved_tflops"] = round(achieved / 1e12, 3)
    result["mfu"] = round(achieved / peak, 4)
    log(f"MFU: {flops / 1e9:.2f} GFLOP/step (the model's convolutions and linears, forward "
        f"and backward) @ {step_s * 1000:.2f} ms -> {achieved / 1e12:.2f} TFLOP/s = "
        f"{achieved / peak * 100:.2f}% of {peak / 1e12:.1f} TFLOP/s dense bf16 peak")

    result["kernel_parity_max_abs_diff"] = bench.kernel_parity()

    aug_rate, overflow = bench.augment()
    result["augment_pairs_per_sec"] = round(aug_rate, 3)
    result["augment_overflow_tiles"] = overflow

    print(json.dumps(result), flush=True)
    bench.diagnostics(lambda: deadline - (time.perf_counter() - start))
    return result


if __name__ == "__main__":
    from delora_tpu_torch.cli import main as cli_main

    cli_main(["bench", *sys.argv[1:]])
