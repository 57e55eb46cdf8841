"""Whole runs of every cell on the CPU at a tiny size, the control and the
faults planted in the program, and the import guard.

Each run goes through ``run.main`` as the command line does, with the look for
a card skipped (``device="cpu"``) and the cell shrunk (``tests/tiny.py``). The
program runs its kernels' plain versions here."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import cell, device as device_mod, run
from portbench.tests.tiny import shrinker

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 17          # larger than a signed 32-bit integer holds


def last_line(capsys, workload, trace=0, seconds="1", dtype=None, variant=None, seed=SEED):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", seconds,
                   "--trace", str(trace)], device="cpu", shrink=shrinker(dtype),
                  variant=variant)
    assert rc == 0
    captured = capsys.readouterr()
    result = json.loads(captured.out.strip().splitlines()[-1])
    return result, captured.err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_prints_a_well_formed_line(capsys, workload, trace):
    result, err = last_line(capsys, workload, trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool) and result["attempted"] > 0
    c = cell.load(workload)
    wanted = c.per_layer if trace else c.end_to_end
    for name, m in result["metrics"].items():
        assert name in [w.name for w in wanted]
        assert m["unit"] == next(w.unit for w in wanted if w.name == name)
        assert isinstance(m["value"], float) and m["value"] == m["value"]
    if not trace:
        assert set(result["metrics"]) == {m.name for m in c.end_to_end}
    else:
        # On the CPU no device metric is reported.
        assert not any("roofline" in k or "idle" in k or "device" in k for k in result["metrics"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["platform"] == "cpu"
    assert set(result["checks"]) == set(c.limits)
    tail = err.strip().splitlines()[-len(c.limits):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_program_is_correct(capsys, workload):
    result, _ = last_line(capsys, workload, dtype="float32")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(capsys, workload):
    """The reference in float8 (the precision below the cell's bfloat16) in
    the program's place fails the limits."""
    result, _ = last_line(capsys, workload, variant="control")
    assert not result["correct"], result["checks"]


FAULTS = [(w, f) for w in WORKLOADS for f in
          (("half_batch", "unchanged") if "train" in w else ("altered",))]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_fault_in_the_timed_path_is_not_correct(capsys, workload, fault):
    """A step that leaves the state unchanged, a step over half its batch, or
    one answer altered where it is produced: each fails the check."""
    result, _ = last_line(capsys, workload, dtype="float32", variant=fault)
    assert not result["correct"], result["checks"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"])
    assert rc == run.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


def test_forbidden_names_compare_whole():
    assert device_mod.forbidden_modules(["delora_tpu_torch.training", "torch", "jaxtyping",
                                         "portbench.run"]) == []
    assert device_mod.forbidden_modules(["jax.numpy", "delora_tpu.cli", "optax"]) == [
        "delora_tpu", "jax", "optax"]


def test_no_module_of_a_run_loads_jax():
    """Every portbench module and the program modules a run reaches, imported
    in a fresh process: none of JAX, its libraries or the JAX package."""
    modules = sorted("portbench." + str(p.relative_to(ROOT / "portbench"))[:-3].replace("/", ".")
                     for p in (ROOT / "portbench").rglob("*.py")
                     if "tests" not in p.parts and "metrics" not in p.parts
                     and p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "from portbench import cell\n"
            "for m in [p.stem for p in (cell.PACKAGE / 'metrics').glob('*.py')]: cell.reader(m)\n"
            "import delora_tpu_torch.training.trainer, delora_tpu_torch.serving.stream\n"
            "from portbench.device import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    """The plain reference, the yardstick's counts and the generators load
    neither the program nor JAX."""
    code = ("import sys\n"
            "import portbench.reference.compare, portbench.reference.serve\n"
            "import portbench.reference.train, portbench.flops, portbench.roofline\n"
            "import portbench.scenes.street, portbench.scenes.tunnel, portbench.weights\n"
            "names = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(names & {'delora_tpu_torch', 'delora_tpu', 'jax', 'jaxlib', 'flax',"
            " 'optax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
