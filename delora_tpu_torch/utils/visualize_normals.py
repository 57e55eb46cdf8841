"""Inspect a preprocessed scan's normals: a headless 3D quiver render.

The port's copy of ``scripts/visualize_normals.py`` (the reference looked at
them in RViz): a gray sample of the scan's points, red arrows on up to 800 of
the points with a normal, and the share of normals that face the sensor
(n . p <= 0), which should be close to 1.

    python -m delora_tpu_torch.utils.visualize_normals <preprocessed_seq_dir> [scan] [out]

``python -m delora_tpu_torch.cli visualize-normals`` calls :func:`render`.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np


def render(seq_dir: str, idx: int = 0, out: Optional[str] = None) -> Tuple[str, float]:
    """Render scan ``idx`` of ``seq_dir`` (its ``scans/`` and ``normals/``)
    into ``out`` (else ``normals_<idx>.png`` in the working directory) ->
    (the path, the sensor-facing share of its normals)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = out or f"normals_{idx:06d}.png"
    scan = np.load(os.path.join(seq_dir, "scans", f"{idx:06d}.npy"))
    normals = np.load(os.path.join(seq_dir, "normals", f"{idx:06d}.npy"))
    has_n = np.linalg.norm(normals, axis=-1) > 0
    print(f"scan {idx}: {len(scan)} points, {has_n.sum()} with normals "
          f"({100.0 * has_n.mean():.1f}%)")

    # A sample, for a legible quiver plot.
    rng = np.random.default_rng(0)
    sel = rng.choice(np.nonzero(has_n)[0], size=min(800, has_n.sum()), replace=False)
    p, n = scan[sel], normals[sel]

    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(projection="3d")
    bg = scan[rng.choice(len(scan), size=min(5000, len(scan)), replace=False)]
    ax.scatter(bg[:, 0], bg[:, 1], bg[:, 2], s=0.3, c="gray", alpha=0.4)
    ax.quiver(p[:, 0], p[:, 1], p[:, 2], n[:, 0], n[:, 1], n[:, 2],
              length=1.0, color="red", linewidth=0.5)
    ax.set_title(f"scan {idx}: normals ({has_n.sum()}/{len(scan)})")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"wrote {out}")

    # Normals should mostly face the sensor (n . p <= 0).
    dots = np.sum(scan[has_n] * normals[has_n], axis=-1)
    facing = float((dots <= 1e-5).mean())
    print(f"sensor-facing fraction: {facing:.3f} (should be ~1.0)")
    return out, facing


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        sys.exit(1)
    render(argv[0], int(argv[1]) if len(argv) > 1 else 0, argv[2] if len(argv) > 2 else None)


if __name__ == "__main__":
    main()
