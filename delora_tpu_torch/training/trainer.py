"""A trainer that takes its steps from in-memory scans.

The port of the device-resident path of ``delora_tpu/training/trainer.py``:

- the feed is chosen as the reference's (trainer.py:67-90,
  ``config.py::training_feed``): "full" for the image matcher with the
  projection caches on, "raw" for brute correspondence or with the target
  cache off;
- full feed: every scan's projection artifacts are computed once on the host
  (``ops/projection_host.py::scan_artifacts_np``, scans truncated and padded
  to ``max_points`` as the reference's dataset does) and stacked as tables
  on the device (reference trainer.py:120-191, one device, no mesh); raw
  feed: the padded points, normals and validity masks are the tables, and
  the step projects them;
- pairs are consecutive scans and never cross sequences;
- each epoch's order is ``np.random.default_rng(seed + epoch).permutation``
  truncated to whole batches (reference data/dataset.py:281-296), and
  batches are gathered on the device by index (trainer.py:329-352);
- metrics stay on the device until the epoch ends and are read back once
  (trainer.py:552-568);
- the supervised identity warmup switches to unsupervised when an epoch's
  mean loss falls below 1e-2 (trainer.py:617-620); ``unsupervised_at_start``
  skips it;
- with ``ema_decay`` > 0 the parameter EMA follows every step, and
  :meth:`Trainer.deploy_model` is the model to evaluate or serve
  (trainer.py:241-247); with ``use_dropout`` the trainer owns the dropout
  masks' generator, on its device, seeded from its initialisation generator.

A plain Python loop takes the steps: the reference's ``lax.scan`` over
``steps_per_dispatch`` steps only amortizes the TPU's dispatch round trip, so
the port does not read that key. Checkpoints, evaluation, training images and
resume wait for the host-feed slice, as does reading scans from disk.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from delora_tpu_torch import resolve_device
from delora_tpu_torch.config import training_feed, validate
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.ops.projection import ProjectionSpec
from delora_tpu_torch.ops.projection_host import ScanArtifacts, scan_artifacts_np
from delora_tpu_torch.training.state import deploy_model, make_optimizer, make_param_ema
from delora_tpu_torch.training.step import (
    FullyCachedBatch,
    ScanPairBatch,
    StepConfig,
    train_step,
)

WARMUP_LOSS = 1e-2

Scan = Tuple[np.ndarray, np.ndarray]       # (points [N, >=3], normals [N, 3])


def padded_scan(points: np.ndarray, normals: np.ndarray, max_points: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One scan truncated and zero-padded to ``max_points`` -> (points
    [max_points, 3], normals [max_points, 3], validity mask), as the
    reference's dataset pads it."""
    n = min(len(points), max_points)
    pts = np.zeros((max_points, 3), np.float32)
    nrm = np.zeros((max_points, 3), np.float32)
    valid = np.zeros(max_points, bool)
    pts[:n] = np.asarray(points, np.float32)[:n, :3]
    nrm[:n] = np.asarray(normals, np.float32)[:n, :3]
    valid[:n] = True
    return pts, nrm, valid


def padded_artifacts(points: np.ndarray, normals: np.ndarray, max_points: int,
                     spec: ProjectionSpec) -> ScanArtifacts:
    """One scan's artifacts, the scan padded by :func:`padded_scan`, as the
    reference's dataset feeds ``scan_artifacts_np``."""
    return scan_artifacts_np(*padded_scan(points, normals, max_points), spec)


class Trainer:
    """Trains the odometry model from in-memory scans (see the module
    docstring). ``sequences`` holds, per sequence, a list of
    (points, normals) arrays; a zero normal means "no normal". ``generator``
    seeds the initialisation (and the dropout generator's seed). It is not
    yet the whole reference trainer: checkpoints, evaluation, training
    images, resume and the disk feed wait for the host-feed slice."""

    def __init__(self, config, sequences: Sequence[Sequence[Scan]], *,
                 device: Optional[Union[str, torch.device]] = None,
                 dataset: str = "kitti", generator: Optional[torch.Generator] = None):
        validate(config)
        self.config = dict(config)
        self.device = resolve_device(device)
        self.dataset = dataset
        self.batch_size = int(config["batch_size"])
        self.seed = int(config.get("seed", 0))
        self.supervised = not bool(config["unsupervised_at_start"])
        self.spec = ProjectionSpec.from_config(config, dataset)
        self.feed = training_feed(config)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.model = OdometryModel(ModelConfig.from_config(config), generator).to(self.device)
        self.model.train()
        self.optimizer, self.schedule = make_optimizer(
            config, self.model.parameters(), self.batch_size)
        self.ema = make_param_ema(config, self.model)
        self.dropout_generator = None
        if config["use_dropout"]:
            seed = int(torch.randint(0, 2**62, (), generator=generator))
            self.dropout_generator = torch.Generator(self.device).manual_seed(seed)

        max_points = int(config[dataset]["max_points"])
        rows: List[tuple] = []
        tgt, src = [], []
        for scans in sequences:
            first = len(rows)
            if self.feed == "full":
                rows.extend(padded_artifacts(p, n, max_points, self.spec) for p, n in scans)
            else:
                rows.extend(padded_scan(p, n, max_points) for p, n in scans)
            tgt.extend(range(first, len(rows) - 1))
            src.extend(range(first + 1, len(rows)))
        if len(tgt) < self.batch_size:
            raise ValueError(f"{len(tgt)} scan pairs make no batch of {self.batch_size}")
        leaves = [self._table(leaf) for leaf in zip(*rows)]
        # Full feed: ScanArtifacts of every scan; raw feed: (points, normals,
        # valid) of every scan.
        self.tables = ScanArtifacts(*leaves) if self.feed == "full" else tuple(leaves)
        self.pair_target = np.asarray(tgt, np.int64)
        self.pair_source = np.asarray(src, np.int64)
        self.last_steps: Dict[str, np.ndarray] = {}

    def _table(self, leaf) -> torch.Tensor:
        """Stack one artifact over all scans, on the device (mean ranges,
        Python floats, as float32)."""
        arr = np.stack([np.asarray(x) for x in leaf])
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(arr).to(self.device)

    @property
    def num_pairs(self) -> int:
        return len(self.pair_target)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The epoch's pair order, truncated to whole batches."""
        perm = np.random.default_rng(self.seed + epoch).permutation(self.num_pairs)
        return perm[: (self.num_pairs // self.batch_size) * self.batch_size]

    def batch(self, tgt: torch.Tensor, src: torch.Tensor
              ) -> Union[FullyCachedBatch, ScanPairBatch]:
        """Gather the batch of pairs (tgt[i], src[i]) from the device tables."""
        t = self.tables
        if self.feed == "raw":
            return ScanPairBatch(*(x[tgt] for x in t), *(x[src] for x in t))
        return FullyCachedBatch(t.image[tgt], t.normal_image[tgt], t.mean_range[tgt],
                                t.image[src], t.src_points[src], t.src_normals[src],
                                t.src_valid[src], t.mean_range[src])

    def step(self, batch: Union[FullyCachedBatch, ScanPairBatch], cfg: StepConfig
             ) -> Dict[str, torch.Tensor]:
        """One train step of the trainer's model, optimizer, schedule, EMA and
        dropout generator."""
        return train_step(self.model, self.optimizer, batch, cfg, self.schedule, self.ema,
                          self.dropout_generator)

    def deploy_model(self) -> torch.nn.Module:
        """The model to evaluate or serve: the EMA weights when tracked."""
        return deploy_model(self.model, self.ema)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch -> the mean of each step metric, with ``steps``,
        ``epoch_seconds`` and ``scan_pairs_per_sec``. Each step's values stay
        in ``last_steps`` (metric -> numpy array over the epoch's steps)."""
        cfg = StepConfig.from_config(self.config, self.dataset, supervised=self.supervised)
        order = self.epoch_indices(epoch).reshape(-1, self.batch_size)
        tgt = torch.from_numpy(self.pair_target[order]).to(self.device)
        src = torch.from_numpy(self.pair_source[order]).to(self.device)
        t0 = time.perf_counter()
        per_step = [self.step(self.batch(ti, si), cfg) for ti, si in zip(tgt, src)]
        keys = list(per_step[0])
        # One readback for the whole epoch.
        mat = torch.stack([torch.stack([m[k] for k in keys]) for m in per_step]).cpu().numpy()
        self.last_steps = {k: mat[:, i] for i, k in enumerate(keys)}
        out = {k: float(mat[:, i].mean()) for i, k in enumerate(keys)}
        out["steps"] = len(per_step)
        out["epoch_seconds"] = time.perf_counter() - t0
        out["scan_pairs_per_sec"] = len(per_step) * self.batch_size / out["epoch_seconds"]
        return out

    def train(self, epochs: Optional[int] = None) -> List[Dict[str, float]]:
        """Epochs 0 .. ``epochs`` - 1 (the config's ``epochs`` if None) ->
        each epoch's metrics, with ``supervised`` as 1.0 or 0.0."""
        history = []
        for epoch in range(int(epochs if epochs is not None else self.config["epochs"])):
            metrics = self.train_epoch(epoch)
            metrics["supervised"] = float(self.supervised)
            history.append(metrics)
            print(f"[epoch {epoch:05d}] loss={metrics['loss']:.6f} "
                  f"pc={metrics['loss_pc']:.6f} po2pl={metrics['loss_po2pl']:.6f} "
                  f"pl2pl={metrics['loss_pl2pl']:.6f} "
                  f"pairs/s={metrics['scan_pairs_per_sec']:.1f} "
                  f"supervised={self.supervised}", flush=True)
            if self.supervised and metrics["loss"] < WARMUP_LOSS:
                self.supervised = False
                print("[trainer] warmup converged: switching to unsupervised", flush=True)
        return history
