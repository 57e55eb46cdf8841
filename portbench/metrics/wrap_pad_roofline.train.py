"""The wrap-pad's share of its roofline over a training step, in percent: the
least time of every pad of a step, forward and backward (``pad_work.py``:
each call's input read once and its padded output written once, over the
memory bandwidth), times the traced steps (the trainer's ``train_step``
spans), over the traced device seconds of the kernels ``wrap_pad_nhwc`` and
``wrap_pad_nhwc_grad``.

The record holds no configuration: the network is that of the
configurations of the cells this metric is listed for whose training FLOPs
at the run's shapes equal the run's (``flops.py``); where those give no
single pad work, nothing is read."""

import json

from portbench import cell, flops
from portbench.pad_work import train_step_pad_work
from portbench.reference.model import Arch
from portbench.roofline import bound_s

NAME = "wrap_pad_roofline.train"
KERNEL = "wrap_pad_nhwc"        # and wrap_pad_nhwc_grad


def _pad_bytes(rec):
    spec = cell.benchmark()
    metric = next(m for m in spec["per_layer"] if m["name"] == NAME)
    listed = metric.get("workloads", [w["name"] for w in spec["workloads"]])
    names = {w["config"] for w in spec["workloads"] if w["name"] in listed}
    s = rec.shapes
    found = set()
    for name in sorted(names):
        model = json.loads((cell.PACKAGE / "configs" / f"{name}.json").read_text())["model"]
        arch = Arch.from_config(model)
        if flops.train_step_flops(arch, s["batch"], s["height"], s["width"]) == rec.flops:
            # The program computes in bfloat16 where a block does not say.
            found.add(train_step_pad_work(arch, model.get("compute_dtype", "bfloat16"),
                                          s["batch"], s["height"], s["width"]).bytes)
    return found.pop() if len(found) == 1 else None


def read(rec):
    if not (rec.on_card and rec.kind == "train" and rec.trace is not None
            and rec.peaks is not None and rec.shapes and rec.flops):
        return None
    steps = len(rec.trace.spans("train_step"))
    seconds = rec.trace.kernel_seconds(KERNEL)
    nbytes = _pad_bytes(rec)
    if not steps or seconds <= 0 or nbytes is None:
        return None
    least, _ = bound_s(nbytes, 0, rec.peaks)
    return least * steps / seconds * 100.0
