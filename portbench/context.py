"""What every driver is handed: the cell, the run's arguments, the
program's configuration, and the inputs the benchmark makes from the seed."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

from portbench import weights as weights_mod
from portbench.cell import Cell
from portbench.reference import geometry, model


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Context:
    """One run of one cell. ``variant`` plants a fault in the program or
    puts the reference in its place (``calibrate.py`` and the tests only)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float, variant: Optional[str] = None):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device, self.t_start, self.variant = device, t_start, variant
        self.config = cell.config
        self.traffic = cell.traffic
        self.dataset = cell.config["dataset"]
        self.arch = model.Arch.from_config(cell.config["model"])
        self.spec = geometry.Spec.from_config(cell.config)
        self.max_points = int(cell.config["block"]["max_points"])
        self._weights: Optional[Dict] = None

    def program_config(self) -> Dict:
        """The program's configuration: its defaults under this cell's keys."""
        from delora_tpu_torch.config import default_config

        c = self.config
        overrides = {"datasets": [self.dataset], self.dataset: dict(c["block"]),
                     "horizontal_field_of_view": list(c["horizontal_field_of_view"]),
                     **c["model"], **c.get("training", {}), "seed": self.seed}
        if "batch_size" in self.traffic:
            overrides["batch_size"] = int(self.traffic["batch_size"])
        return default_config(overrides)

    def weights(self):
        """The network's weights from the seed, on the device (made once)."""
        if self._weights is None:
            self._weights = weights_mod.make(model.param_specs(self.arch), self.seed,
                                             self.device, self.arch.activation)
        return self._weights

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start


def record(**fields) -> SimpleNamespace:
    """What the metric readers read (``metrics/*.py``); a field a run did not
    take is None."""
    base = dict(kind=None, setup_s=None, window_s=None, steps=None, pairs=None,
                latencies=None, late=None, step_times=None, flops=None, peaks=None,
                trace=None, launches=None, shapes=None, model_device_ms=None,
                attempted=0, failed=0, on_card=False)
    base.update(fields)
    return SimpleNamespace(**base)
