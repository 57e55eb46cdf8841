"""The port's preprocessing preview (``Preprocessor.preview_images``)
against the arrays the JAX package's ``Preprocessor.preview`` hands to its
plotting function, on the same raw drive; the PNGs of ``preprocess
--preview`` and ``visualize-normals``.

Tolerance: the reference's preview runs its projection and normals eagerly,
unjitted: its pixel coordinates are formed without the compiler's folded
constant and its moments without the fused multiply-adds the port
reproduces, so the preview's ranges agree on all but 0.5% of pixels and its
normals within 1e-4 on all but 1% of the pixels where both have one.
"""

import json
import os

import numpy as np
import pytest
import torch

from delora_tpu.config import load_config
from delora_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from delora_tpu_torch import cli
from delora_tpu_torch.config import default_config
from delora_tpu_torch.data.preprocess import Preprocessor
from tests.test_torch_plotting import near_share
from tests.test_torch_preprocess import overrides, write_drive

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def raw_drive(tmp_path_factory):
    root = tmp_path_factory.mktemp("preview")
    write_drive(str(root))
    return root


def test_preview_matches_the_jax_preprocessor(raw_drive, monkeypatch):
    from delora_tpu.utils import plotting as jax_plotting

    root = raw_drive
    captured = []
    monkeypatch.setattr(jax_plotting, "plot_range_image_grid",
                        lambda images, labels, path: captured.append(images))
    JaxPreprocessor(load_config(overrides(root), mode="preprocessing")).preview(
        "kitti", out_path=str(root / "jax_preview.png"))
    ranges, normals = Preprocessor(default_config(overrides(root), mode="preprocessing"),
                                   device="cpu").preview_images("kitti")
    want = [np.asarray(x) for x in captured[0]]
    assert ranges.shape == want[0].shape == (16, 360)
    assert near_share(ranges[..., None], want[0][..., None], 0.0) >= 0.995
    both = (np.abs(normals).sum(-1) > 0) & (np.abs(np.stack(want[1:], -1)).sum(-1) > 0)
    assert both.sum() > 1000
    diff = np.abs(normals - np.stack(want[1:], -1)).max(-1)[both]
    assert (diff <= 1e-4).mean() >= 0.99


def test_preview_and_visualize_normals_write_pngs(raw_drive, capsys):
    root = raw_drive
    sets = ["--device", "cpu", "--set"] + [
        f"{k}={json.dumps(v)}" for k, v in overrides(root).items()]
    cli.main(["preprocess", "--preview"] + sets)
    preview = root / "runs" / "preprocess_preview.png"
    assert preview.stat().st_size > 1000
    assert not (root / "preprocessed").exists()          # the preview writes no scans
    cli.main(["preprocess", "--max-scans", "2"] + sets)
    out = str(root / "normals.png")
    path, facing = cli.main(["visualize-normals", str(root / "preprocessed" / "00"),
                             "--scan", "1", "--out", out])
    assert path == out and os.path.getsize(out) > 1000 and facing > 0.9
    assert "sensor-facing fraction" in capsys.readouterr().out
