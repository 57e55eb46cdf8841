"""The readings that the limits of ``limits/<workload>.json`` are set from:
the program's numbers on many seeds, the control's (the reference in the
precision below the configuration's, in the program's place), and the
faults' planted in the program, all at the cell's own sizes, in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--faults half_batch unchanged] [--out file.jsonl]

On the control seeds it also reads ``nhwc``: the reference in the
configuration's bfloat16 with NHWC activations (other convolution kernels)
in the program's place, a sound computation that the limits must admit.

Each seed makes its drive and weights, builds and warms up the program as a
run does (no window: what is compared does not depend on it; a serving
stream is pushed back to back), and compares each reading against the
reference following it. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Optional, Sequence

from portbench import cell as cell_mod, device as device_mod
from portbench.context import Context, log


def main(argv: Optional[Sequence[str]] = None, *, device=None, shrink=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = cell_mod.load(args.workload)
    if shrink is not None:
        cell = shrink(cell)
    device_mod.keep_caches_in(cell_mod.ROOT)
    import torch

    from portbench.reference.model import control_quant

    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    seconds = cell_mod.benchmark()["run_seconds"]
    drv = cell_mod.driver(cell.traffic["kind"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out_file = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            ctx = Context(cell, seed, seconds, False, dev, t0)
            st = drv.setup(ctx)
            readings = {}
            if cell.traffic["kind"] == "serve":
                drv.drain(st)
                outs = drv.outputs(ctx, st)
                for fault in args.faults if seed in args.control_seeds else ():
                    fctx = Context(cell, seed, seconds, False, dev, t0, fault)
                    fst = drv.setup(fctx)
                    drv.drain(fst)
                    readings[fault] = drv.outputs(fctx, fst)
            else:
                outs = drv.outputs_kept(ctx, st)
                for fault in args.faults if seed in args.control_seeds else ():
                    readings[fault] = drv.rerun(ctx, st, fault)
                st.trainer = st.capture = None
            del st
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            readings = {"program": outs, **readings}
            if seed in args.control_seeds:
                readings["control"] = drv.reference(
                    ctx, outs, control_quant(cell.config["model"]["compute_dtype"]))
                readings["nhwc"] = drv.reference(ctx, outs, nhwc=True)
            for name, subject in readings.items():
                line = {"workload": cell.name, "seed": seed, "reading": name,
                        "numbers": drv.compare_outputs(subject, drv.reference(ctx, subject)),
                        "seconds": time.perf_counter() - t0}
                print(json.dumps(line), flush=True)
                if out_file:
                    out_file.write(json.dumps(line) + "\n")
                    out_file.flush()
            del outs, readings
            gc.collect()
    finally:
        if out_file:
            out_file.close()
    forbidden = device_mod.forbidden_modules()
    if forbidden:
        log(f"forbidden modules were loaded: {forbidden}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
