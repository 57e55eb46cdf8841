"""Metric and artifact logging: ``<log_dir>/<experiment>/<run_name>/``
holds ``metrics.jsonl`` (one record a call), ``params.json`` and
``artifacts/``. The port of ``delora_tpu/utils/metrics.py``; with
``use_mlflow`` the records are mirrored to mlflow when it imports."""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, log_dir: str, experiment: str, run_name: str,
                 use_mlflow: bool = False):
        self.run_dir = os.path.join(log_dir, experiment, run_name)
        os.makedirs(os.path.join(self.run_dir, "artifacts"), exist_ok=True)
        self._metrics_file = open(os.path.join(self.run_dir, "metrics.jsonl"), "a",
                                  buffering=1)
        self._mlflow = None
        if use_mlflow:
            try:
                import mlflow

                exp = mlflow.set_experiment(experiment)
                mlflow.start_run(experiment_id=exp.experiment_id, run_name=run_name)
                self._mlflow = mlflow
            except Exception as e:  # mlflow is optional: report and keep the JSONL
                print(f"[metrics] mlflow unavailable ({e}); JSONL only")

    def log_params(self, config: Dict[str, Any]) -> None:
        with open(os.path.join(self.run_dir, "params.json"), "w") as f:
            json.dump(config, f, default=str, indent=2)
        if self._mlflow:
            self._mlflow.log_params({k: str(v) for k, v in config.items()
                                     if not isinstance(v, dict)})

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._metrics_file.write(json.dumps(record) + "\n")
        if self._mlflow:
            self._mlflow.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def log_artifact(self, path: str) -> None:
        dest = self.artifact_path(os.path.basename(path))
        if os.path.abspath(path) != os.path.abspath(dest):
            shutil.copyfile(path, dest)
        if self._mlflow:
            self._mlflow.log_artifact(path)

    def artifact_path(self, name: str) -> str:
        return os.path.join(self.run_dir, "artifacts", name)

    def close(self) -> None:
        self._metrics_file.close()
        if self._mlflow:
            self._mlflow.end_run()
