"""A car on a city street (KITTI-like), after ``chip_smoke.py::drive``.

The sensor rides 1.73 m above a flat road (z = -1.73), between facades at
y = -7 m and y = +9 m, past two rows of round pillars (radius 0.6 m, every
12 m, at y = -5.5 m and y = +7.5 m). The car moves 1 m a scan along x while
the sensor's heading turns 0.01 rad a scan, and it weaves within +-1 m of
y = 1 m over 200 scans. The seed draws where along the pillar rows the drive
starts, the weave's phase and the first heading. The street repeats along x,
so a drive of any length stays on it.
"""

from __future__ import annotations

import math

import torch

from portbench.scenes import cylinder, nearest, plane, rotation_zyx

GROUND, FACADES = -1.73, (-7.0, 9.0)
PILLAR_ROWS, PILLAR_EVERY, PILLAR_RADIUS, PILLAR_PHASE = (-5.5, 7.5), 12.0, 0.6, -20.0
SPEED, YAW_RATE, WEAVE, WEAVE_SCANS = 1.0, 0.01, 1.0, 200.0
REACH = 84.0


def poses(n: int, gen: torch.Generator, device):
    start, phase, heading = torch.rand(3, generator=gen, device=device, dtype=torch.float64)
    k = torch.arange(n, dtype=torch.float64, device=device)
    x = start * PILLAR_EVERY + SPEED * k
    y = 1.0 + WEAVE * torch.sin(2 * math.pi * (k / WEAVE_SCANS + phase))
    origins = torch.stack([x, y, torch.zeros_like(k)], -1)
    yaw = (2 * heading - 1) * math.pi + YAW_RATE * k
    zero = torch.zeros_like(k)
    return origins, rotation_zyx(yaw, zero, zero)


def intersect(o: torch.Tensor, d: torch.Tensor):
    hits = [(plane(o, d, 2, GROUND), torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype,
                                                 device=d.device))]
    for level in FACADES:
        hits.append((plane(o, d, 1, level), torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype,
                                                        device=d.device)))
    first = torch.floor((o[:, 0] - REACH - PILLAR_PHASE) / PILLAR_EVERY)
    for m in range(int(2 * REACH / PILLAR_EVERY) + 2):
        cx = PILLAR_PHASE + (first + m) * PILLAR_EVERY
        for row in PILLAR_ROWS:
            hits.append(cylinder(o, d, cx, torch.full_like(cx, row), PILLAR_RADIUS))
    return nearest(hits)
