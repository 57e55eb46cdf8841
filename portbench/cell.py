"""Finding a cell's files by the names ``BENCHMARK.json`` gives them.

- ``configs/<config>.json``: the configuration (the dataset block as run, the
  model and training keys, the sensor, the scene, the source, ``reduced`` and
  ``assumed``);
- ``traffic/<mix>.json``: the traffic mix's parameters; its ``kind`` names
  the driver, ``drivers/<kind>.py``;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``;
- ``metrics/<metric>.py``: the reader of each metric, ``read(record)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


class Metric(NamedTuple):
    name: str
    unit: str


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Metric]    # reported with --trace 0
    per_layer: List[Metric]     # reported with --trace 1


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return _json(Path(root) / "BENCHMARK.json")


def load(workload: str, root: Path = ROOT) -> Cell:
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]

    def listed(m) -> bool:
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    e2e_names = {m["name"] for m in e2e}
    # A per-layer metric without a list is reported wherever the end-to-end
    # metric it moves is.
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(workload, int(w["chips"]), _json(PACKAGE / "configs" / f"{w['config']}.json"),
                _json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
                _json(PACKAGE / "limits" / f"{workload}.json"),
                [Metric(m["name"], m["unit"]) for m in e2e],
                [Metric(m["name"], m["unit"]) for m in per_layer])


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str):
    """``metrics/<metric>.py`` (a name may hold dots, so it is loaded by path)."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
