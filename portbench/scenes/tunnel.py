"""A legged robot walking a mine tunnel (DARPA SubT-like, DeLORA's ANYmal).

A box-section corridor 4 m wide and 3 m tall (walls at y = +-2 m, floor
0.6 m below the sensor, ceiling 2.4 m above it), with a side gallery every
20 m on alternating walls (a 3 m opening into a bay 4 m deep) and timber
posts (radius 0.12 m) along both walls every 5 m. The robot walks 0.1 m a
scan along x, drifts within +-0.3 m of the axis, turns its heading within
+-0.08 rad, and its trot rolls the body +-3 degrees and pitches it +-2
degrees with a period of 6 scans, bobbing 2 cm. The seed draws where along
the tunnel it starts and the phases of its motion.
"""

from __future__ import annotations

import math

import torch

from portbench.scenes import cylinder, nearest, plane, rotation_zyx

FLOOR, CEILING, WALL, BAY_DEPTH = -0.6, 2.4, 2.0, 6.0
BAY_EVERY, BAY_WIDTH, BAY_START = 20.0, 3.0, (8.0, 18.0)     # left (+y), right (-y)
POST_EVERY, POST_PHASE, POST_Y, POST_RADIUS = 5.0, 2.5, 1.7, 0.12
SPEED, GAIT_SCANS = 0.1, 6.0
ROLL, PITCH, BOB = math.radians(3.0), math.radians(2.0), 0.02
REACH = 84.0


def poses(n: int, gen: torch.Generator, device):
    start, drift, turn, gait = torch.rand(4, generator=gen, device=device, dtype=torch.float64)
    k = torch.arange(n, dtype=torch.float64, device=device)
    step = 2 * math.pi * (k / GAIT_SCANS + gait)
    x = start * BAY_EVERY + SPEED * k
    y = 0.3 * torch.sin(2 * math.pi * (k / 300.0 + drift))
    z = BOB * torch.sin(2 * step)
    yaw = 0.08 * torch.sin(2 * math.pi * (k / 400.0 + turn))
    return torch.stack([x, y, z], -1), rotation_zyx(yaw, PITCH * torch.cos(step),
                                                    ROLL * torch.sin(step))


def _in_bay(x: torch.Tensor, side: int) -> torch.Tensor:
    return torch.remainder(x - BAY_START[side], BAY_EVERY) < BAY_WIDTH


def intersect(o: torch.Tensor, d: torch.Tensor):
    def unit(axis):
        n = torch.zeros(3, dtype=d.dtype, device=d.device)
        n[axis] = 1.0
        return n

    def at(t):
        return o[:, None, :] + t[..., None] * d

    hits = [(plane(o, d, 2, FLOOR), unit(2)), (plane(o, d, 2, CEILING), unit(2))]
    for side, sign in ((0, 1.0), (1, -1.0)):
        t = plane(o, d, 1, sign * WALL)
        t = torch.where(_in_bay(at(t)[..., 0], side), math.inf, t)
        hits.append((t, unit(1)))
        t = plane(o, d, 1, sign * BAY_DEPTH)
        t = torch.where(_in_bay(at(t)[..., 0], side), t, math.inf)
        hits.append((t, unit(1)))
        first = torch.floor((o[:, 0] - REACH - BAY_START[side]) / BAY_EVERY)
        for m in range(int(2 * REACH / BAY_EVERY) + 2):
            for edge in (0.0, BAY_WIDTH):
                x0 = BAY_START[side] + (first + m) * BAY_EVERY + edge
                t = (x0[:, None] - o[:, None, 0]) / d[..., 0]
                y = at(t)[..., 1] * sign
                t = torch.where((t > 0) & (y > WALL) & (y < BAY_DEPTH), t, math.inf)
                hits.append((t, unit(0)))
    first = torch.floor((o[:, 0] - REACH - POST_PHASE) / POST_EVERY)
    for m in range(int(2 * REACH / POST_EVERY) + 2):
        cx = POST_PHASE + (first + m) * POST_EVERY
        for y in (-POST_Y, POST_Y):
            hits.append(cylinder(o, d, cx, torch.full_like(cx, y), POST_RADIUS))
    return nearest(hits)
