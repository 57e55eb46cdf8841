"""Evaluation: sequential inference, pose chaining, trajectory files and
KITTI metrics.

The port of ``delora_tpu/training/tester.py``. Each test sequence's
consecutive pairs are predicted in batches (the last batch padded by
repeating its last pair), the relative transforms are chained into world
poses, and ``poses_<dataset>_<seq>.txt`` (KITTI rows),
``transformations_*.npy`` and ``poses_*.npy`` are written to the run's
artifacts. Where ground truth exists the KITTI t_rel / r_rel over 100..800 m
subsequences are reported, or the per-step relative pose error for a shorter
trajectory. With ``inference_only`` false the mean losses over the sequence
are evaluated too. The reference's trajectory plots (matplotlib) are not
ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from delora_tpu_torch import resolve_device
from delora_tpu_torch.data.dataset import ScanPairDataset, batch_to_device
from delora_tpu_torch.data.pose_data import load_kitti_poses
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.training.checkpoint import deploy_weights, load_checkpoint
from delora_tpu_torch.training.step import (
    StepConfig,
    forward_pose,
    infer_step,
    loss_and_metrics,
)
from delora_tpu_torch.utils import poses as pose_utils
from delora_tpu_torch.utils.metrics import MetricsLogger


class Tester:
    """Evaluates ``model`` (else the deploy weights of the checkpoint at
    ``config["checkpoint"]``: the EMA's when it holds one) on each dataset's
    ``data_identifiers``, on ``device`` (CUDA unless the caller names
    another)."""

    def __init__(self, config, *, model: Optional[torch.nn.Module] = None, device=None,
                 run_name: Optional[str] = None):
        self.config = dict(config)
        self.device = resolve_device(device)
        self.datasets = list(config["datasets"])
        self.batch_size = int(config.get("eval_batch_size", config["batch_size"]))
        self.run_name = run_name or config.get("run_name", "test")
        if model is None:
            if not config.get("checkpoint"):
                raise ValueError("Testing requires a checkpoint")
            model = OdometryModel(ModelConfig.from_config(config))
            model.load_state_dict(deploy_weights(load_checkpoint(config["checkpoint"])["state"]))
            model.eval()
        self.model = model.to(self.device)
        self.logger = MetricsLogger(config.get("log_dir", "./runs"),
                                    config.get("experiment", "default"), self.run_name,
                                    use_mlflow=bool(config.get("use_mlflow", False)))
        self._datasets: Dict[str, ScanPairDataset] = {}
        self.cached_projections = bool(self.config.get("cache_target_projections", True))

    def _dataset(self, dataset: str) -> ScanPairDataset:
        if dataset not in self._datasets:
            self._datasets[dataset] = ScanPairDataset(self.config, dataset)
        return self._datasets[dataset]

    def _chunks(self, pair_ids: List[int]):
        """Batches of pair ids, the last padded by repeating its last pair ->
        (ids, number of real pairs)."""
        B = self.batch_size
        for start in range(0, len(pair_ids), B):
            chunk = pair_ids[start:start + B]
            yield chunk + [chunk[-1]] * (B - len(chunk)), len(chunk)

    @torch.no_grad()
    def predict_sequence(self, dataset: str, sequence_index: int) -> np.ndarray:
        """All relative transforms of one sequence -> [K, 4, 4].

        Cached (``cache_target_projections``, the default): each scan is
        projected once on the host (``ScanPairDataset.scan_artifacts``) and
        inference is the model forward on the cached images. Else each batch
        of raw pairs is projected on the device (``step.infer_step``)."""
        ds = self._dataset(dataset)
        cfg = StepConfig.from_config(self.config, dataset, supervised=False)
        pair_ids = [i for i, (si, _) in enumerate(ds.pairs) if si == sequence_index]
        out: List[np.ndarray] = []
        if not self.cached_projections:
            for ids, n in self._chunks(pair_ids):
                batch = batch_to_device(ds.make_batch(ids), self.device)
                out.extend(infer_step(self.model, batch, cfg).cpu().numpy()[:n])
            return np.stack(out)

        n_scans = len(ds.scan_files[sequence_index])
        arts = [ds.scan_artifacts(sequence_index, k) for k in range(n_scans)]
        images = np.stack([a.image for a in arts])
        mean_r = np.asarray([a.mean_range for a in arts], np.float32)
        first = pair_ids[0] if pair_ids else 0
        for ids, n in self._chunks(pair_ids):
            sel = np.asarray(ids) - first            # scan index of each pair's target
            img1 = torch.from_numpy(images[sel]).to(self.device)
            img2 = torch.from_numpy(images[sel + 1]).to(self.device)
            scale = torch.from_numpy(0.5 * (mean_r[sel] + mean_r[sel + 1])).to(self.device)
            if cfg.normalization_scaling:
                img1 = img1 / scale[:, None, None, None]
                img2 = img2 / scale[:, None, None, None]
            T = forward_pose(self.model, img1, img2, deterministic=True)
            if cfg.normalization_scaling:
                T[:, :3, 3] *= scale[:, None]
            out.extend(T.cpu().numpy()[:n])
        return np.stack(out)

    def test(self) -> Dict[str, Dict[int, Optional[tuple]]]:
        """Evaluate every configured test sequence -> metrics by dataset and
        sequence id: (t_rel %, r_rel deg/100m) when the trajectory has
        100 m subsequences, else (RPE m/step, RPE deg/step), or None without
        ground truth."""
        results: Dict[str, Dict[int, Optional[tuple]]] = {}
        for dataset in self.datasets:
            spec = self.config[dataset]
            results[dataset] = {}
            for seq_pos, seq_id in enumerate(spec["data_identifiers"]):
                rel = self.predict_sequence(dataset, seq_pos)
                poses = pose_utils.compute_poses(list(rel))
                tag = f"{dataset}_{seq_id:02d}"
                pose_utils.write_poses_to_text_file(
                    self.logger.artifact_path(f"poses_{tag}.txt"), poses)
                np.save(self.logger.artifact_path(f"transformations_{tag}.npy"), rel)
                np.save(self.logger.artifact_path(f"poses_{tag}.npy"), poses)

                metrics = None
                gt = load_kitti_poses(self.config, dataset, seq_id)
                if gt is not None:
                    metrics = pose_utils.kitti_benchmark_summary(gt, poses)
                    if metrics is not None:
                        t_rel, r_rel = metrics
                        print(f"[test] {tag}: t_rel={t_rel:.3f}%  r_rel={r_rel:.4f} deg/100m",
                              flush=True)
                        self.logger.log_metrics({f"t_rel_{tag}": t_rel,
                                                 f"r_rel_{tag}": r_rel}, step=0)
                    else:
                        # Too short for 100 m KITTI segments: per-step RPE.
                        metrics = pose_utils.relative_pose_errors_summary(gt, poses)
                        if metrics is not None:
                            rpe_t, rpe_r = metrics
                            print(f"[test] {tag}: RPE t={rpe_t:.4f} m/step  "
                                  f"r={rpe_r:.4f} deg/step (seq < 100 m)", flush=True)
                            self.logger.log_metrics({f"rpe_t_{tag}": rpe_t,
                                                     f"rpe_r_{tag}": rpe_r}, step=0)
                print("[test] plotting skipped: the trajectory plots are not ported", flush=True)

                if not self.config.get("inference_only", True):
                    losses = self.evaluate_losses(dataset, seq_pos)
                    print(f"[test] {tag} losses: "
                          + ", ".join(f"{k}={v:.5f}" for k, v in losses.items()), flush=True)
                    self.logger.log_metrics({f"{k}_{tag}": v for k, v in losses.items()},
                                            step=0)
                results[dataset][seq_id] = metrics
        return results

    @torch.no_grad()
    def evaluate_losses(self, dataset: str, sequence_index: int) -> Dict[str, float]:
        """Mean losses and metrics over a sequence's batches of raw pairs,
        without dropout."""
        ds = self._dataset(dataset)
        cfg = StepConfig.from_config(self.config, dataset,
                                     supervised=False)._replace(deterministic=True)
        pair_ids = [i for i, (si, _) in enumerate(ds.pairs) if si == sequence_index]
        sums: Dict[str, float] = {}
        count = 0
        for ids, _ in self._chunks(pair_ids):
            batch = batch_to_device(ds.make_batch(ids), self.device)
            _, metrics = loss_and_metrics(self.model, batch, cfg)
            count += 1
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        return {k: v / max(count, 1) for k, v in sums.items()}
