"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the drive ray-cast and the weights drawn from the seed, the
program built and warmed up), the measured window, with ``--trace 1`` a short
profiled span after it, then the check against the plain reference. The last
line of standard output is the result; the numbers compared, each with its
limit, are the last lines of standard error. Exits 3 without a card (or with
fewer than the cell asks for) and 4 if JAX or the JAX package was loaded, in
both cases without a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, Optional, Sequence  # noqa: E402

from portbench import cell as cell_mod, device as device_mod  # noqa: E402
from portbench.context import Context, log, record  # noqa: E402
from portbench.stats import intersect, length  # noqa: E402

EXIT_NO_CARD = 3
EXIT_FORBIDDEN_IMPORT = 4


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(cell, device):
    """The card to run on, or None (with the reason on stderr)."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is false): no result")
        return None
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present: "
            f"no result")
        return None
    dev = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}; "
        f"nvidia-smi name, power limit, SM clock: "
        f"{device_mod.smi('name,power.limit,clocks.sm')}")
    return dev


def device_block(torch, dev, rec) -> Dict:
    out = device_mod.describe(torch, dev)
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    if rec.trace is not None and rec.on_card:
        window = rec.trace.spans("portbench.window")[0]
        span = [(window.start, window.end)]
        out["busy_s"] = length(intersect(rec.trace.busy(), span))
        out["window_s"] = window.end - window.start
    return out


def breakdown(rec) -> Dict:
    window = rec.trace.spans("portbench.window")[0]
    return {"device_ops": rec.trace.top_ops(10),
            "idle_gaps": rec.trace.idle_gaps((window.start, window.end), window.tid, 10)}


def main(argv: Optional[Sequence[str]] = None, *, device=None,
         shrink: Optional[Callable] = None, variant: Optional[str] = None) -> int:
    """One run. ``device`` skips the look for a card (tests run on the CPU);
    ``shrink`` rewrites the cell before the run (tests shrink it to a tiny
    size); ``variant`` plants a fault (see ``calibrate.py``)."""
    args = parse(argv)
    cell = cell_mod.load(args.workload)
    if shrink is not None:
        cell = shrink(cell)
    device_mod.keep_caches_in(cell_mod.ROOT)
    import torch

    dev = card(cell, device)
    if dev is None:
        return EXIT_NO_CARD
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
    log(f"torch {torch.__version__} imported, card ready at {time.perf_counter() - T_START:.3f} s")
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), dev, T_START, variant)
    drv = cell_mod.driver(cell.traffic["kind"])
    state = drv.setup(ctx)
    rec = record(on_card=dev.type == "cuda")
    drv.window(ctx, state, rec)
    if ctx.trace:
        drv.span(ctx, state, rec)
    dev_block = device_block(torch, dev, rec)
    outs = drv.outputs(ctx, state)
    del state
    gc.collect()
    t0 = time.perf_counter()
    numbers = check(drv, ctx, outs)
    log(f"check against the reference took {time.perf_counter() - t0:.3f} s")
    limits = cell.limits
    correct = all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                  for k in limits)
    metrics = {}
    for m in (cell.per_layer if ctx.trace else cell.end_to_end):
        value = cell_mod.reader(m.name).read(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    forbidden = device_mod.forbidden_modules()
    if forbidden:
        log(f"forbidden modules were loaded: {forbidden}; no result")
        return EXIT_FORBIDDEN_IMPORT
    result = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": dev_block}
    if ctx.trace:
        result["breakdown"] = breakdown(rec)
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    for k in sorted(set(numbers) - set(limits)):
        log(f"reading {k} {numbers[k]!r} (not compared)")
    for k in limits:
        print(f"check {k} {numbers.get(k)!r} limit {limits[k]!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def check(drv, ctx: Context, outs) -> Dict[str, float]:
    """The comparison with the plain reference in float32, TF32 off for its
    duration; for the control, the reference in the precision below the
    configuration's takes the program's place."""
    import torch

    from portbench.reference.model import control_quant

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        if ctx.variant == "control":
            outs = drv.reference(ctx, outs, control_quant(ctx.config["model"]["compute_dtype"]))
        return drv.compare_outputs(outs, drv.reference(ctx, outs))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


if __name__ == "__main__":
    sys.exit(main())
