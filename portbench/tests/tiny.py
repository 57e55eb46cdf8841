"""A cell shrunk to a size the CPU runs in seconds: a 16 x 128 image, a
16 x 256 sensor, 13 scans, batches of 4, three warm-up scans. The network's
widths are not cut. ``dtype`` sets the network's compute type: at float32 the
program agrees with the plain reference to rounding (a sound run is correct
under the cell's limits), at the cell's bfloat16 the tiny images leave too
few pixels to average the rounding out."""

from __future__ import annotations

import copy
from typing import Optional

from portbench.cell import Cell


def shrinker(dtype: Optional[str] = None):
    def shrink(cell: Cell) -> Cell:
        config = copy.deepcopy(cell.config)
        config["block"].update(vertical_cells=16, horizontal_cells=128, max_points=4096)
        config["sensor"].update(beams=16, azimuth_steps=256)
        config["scans"] = 13
        if dtype is not None:
            config["model"]["compute_dtype"] = dtype
        traffic = dict(cell.traffic)
        if traffic["kind"] == "train":
            traffic.update(batch_size=4)
        else:
            traffic.update(warmup_scans=3, trace_scans=2)
        return cell._replace(config=config, traffic=traffic)

    return shrink
