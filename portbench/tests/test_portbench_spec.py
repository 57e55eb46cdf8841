"""BENCHMARK.json against the contract, and discovery of every file by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import cell

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + WORKLOADS + [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for w in SPEC["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_bounds_and_metric_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for w in m.get("workloads", []):
            moves = e2e[m["moves"]]
            assert "workloads" not in moves or w in moves["workloads"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_is_found_and_reports_enough(workload):
    c = cell.load(workload)
    assert "setup_s" in [m.name for m in c.end_to_end] and len(c.end_to_end) >= 2
    assert c.per_layer
    assert c.traffic["kind"] in ("train", "serve")
    cell.driver(c.traffic["kind"])
    for m in c.end_to_end + c.per_layer:
        assert callable(cell.reader(m.name).read)
    assert c.limits and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_configurations(config):
    path = ROOT / config["file"]
    assert path.parent == ROOT / "portbench" / "configs"
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert set(config["reduced"]) <= set(data["assumed"])
    assert data["model"]["factor_fewer_resnet_channels"] == 1
    assert data["model"]["resnet_stage_width_multipliers"] == [1.0] * 4
    from portbench import scenes

    scenes.scene(data["scene"])
