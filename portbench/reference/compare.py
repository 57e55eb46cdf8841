"""The numbers that decide ``correct``: gaps between the program's readings
and the plain reference's."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

# A leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone, and is not compared.
QUIET_LEAF = 1e-3


def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in leaves.items()}


def _worst_leaf(program: Mapping[str, torch.Tensor], reference: Mapping[str, torch.Tensor],
                names: Sequence[str]) -> float:
    """Over ``names``: the largest gap between the program's norm of a leaf
    and the reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    p, r = _norms({k: program[k] for k in names}), _norms({k: reference[k] for k in names})
    median = float(np.median([r[k] for k in names]))
    return max(abs(p[k] - r[k]) / max(r[k], median) for k in names)


def _angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """The angle of Ra^T Rb, from |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2),
    which keeps its precision near 0."""
    d = np.sqrt(((Ra - Rb) ** 2).sum(axis=(-2, -1)))
    return 2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def _gaps(T: np.ndarray, T_ref: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each row's rotation gap (rad) and translation gap (m)."""
    return (_angle(T[:, :3, :3], T_ref[:, :3, :3]),
            np.linalg.norm(T[:, :3, 3] - T_ref[:, :3, 3], axis=-1))


def pose_gaps(T: np.ndarray, T_ref: np.ndarray, T_rounded: np.ndarray) -> Dict[str, float]:
    """Rows of ``[n, 4, 4]`` transforms against the reference's (float32),
    each row's gap in units of how far the same network in bfloat16 (the
    configuration's type) moves that row, or the median row, whichever is
    larger. A network of random weights answers some inputs with a
    transform that rounding moves far (a raw quaternion of small norm, a
    feature near a saturated unit), so the widest raw gap swings from seed to
    seed; in these units rounding reads about 1 on every row, a computation
    in a lower type reads many times that, and a wrong answer reads wide
    wherever it lies. ``rot``, ``trans``: the widest such gap;
    ``rot_raw``, ``trans_raw``: the widest raw gaps (rad, m; not compared)."""
    rot, trans = _gaps(T, T_ref)
    rot_u, trans_u = _gaps(T_rounded, T_ref)
    return {"rot": float((rot / np.maximum(rot_u, np.median(rot_u))).max()),
            "trans": float((trans / np.maximum(trans_u, np.median(trans_u))).max()),
            "rot_raw": float(rot.max()), "trans_raw": float(trans.max())}


def training(subject, ref) -> Dict[str, float]:
    """A run's first steps (``losses``, ``poses``, ``first_grad``,
    ``change``) against the reference's following them: each step's loss,
    the first step's transforms, the first gradient and the weights' change
    after the last step, each leaf's by the worst leaf."""
    if not all(np.isfinite(x) for x in subject.losses):
        return {k: math.inf for k in TRAINING}
    ref_g = _norms(ref.first_grad)
    median = float(np.median(list(ref_g.values())))
    names = [k for k in ref.first_grad if ref_g[k] >= QUIET_LEAF * median]
    # The first step's transforms: both networks hold the same weights there.
    # Later steps' weights differ by the first updates, and a network of
    # random weights answers a change of 1e-5 in every weight (Adam's first
    # step) with a transform that differs by up to a radian.
    first = subject.poses[0]
    n = len(first)
    gaps = pose_gaps(*(x.double().cpu().numpy() for x in (first, ref.poses[0][:n],
                                                          ref.rounded[:n])))
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(subject.losses, ref.losses)),
        "pose_rot_gap": gaps["rot"],
        "pose_trans_gap": gaps["trans"],
        "pose_rot_gap_raw": gaps["rot_raw"],
        "pose_trans_gap_raw": gaps["trans_raw"],
        "grad_gap": _worst_leaf(subject.first_grad, ref.first_grad, names),
        "change_gap": _worst_leaf(subject.change, ref.change, names),
    }


TRAINING = ("loss_gap", "pose_rot_gap", "pose_trans_gap", "pose_rot_gap_raw",
            "pose_trans_gap_raw", "grad_gap", "change_gap")
SERVING = ("rel_rot_gap", "rel_trans_gap", "pose_rot_gap", "pose_trans_gap",
           "rel_rot_gap_raw", "rel_trans_gap_raw")


def serving(relative: np.ndarray, poses: np.ndarray, ref_relative: np.ndarray,
            ref_rounded: np.ndarray) -> Dict[str, float]:
    """Each scan's relative transform, and each step of the integrated pose
    (the previous pose's inverse times the new one), against the
    reference's transform of the pair."""
    if not (np.isfinite(relative).all() and np.isfinite(poses).all()):
        return {k: math.inf for k in SERVING}
    steps = np.concatenate([poses[:1], np.linalg.inv(poses[:-1]) @ poses[1:]])
    rel = pose_gaps(relative, ref_relative, ref_rounded)
    pose = pose_gaps(steps, ref_relative, ref_rounded)
    return {"rel_rot_gap": rel["rot"], "rel_trans_gap": rel["trans"],
            "pose_rot_gap": pose["rot"], "pose_trans_gap": pose["trans"],
            "rel_rot_gap_raw": rel["rot_raw"], "rel_trans_gap_raw": rel["trans_raw"]}
