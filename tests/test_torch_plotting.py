"""Images of the port's trainer and tester: the training panels
(``training/trainer.py::training_panels``) against the arrays the JAX
package's ``Trainer.log_images`` hands to its plotting function, on the same
params, files and pair; the trainer's PNGs; and with matplotlib masked, one
skip line and nothing computed. (The preprocessing preview and
``visualize-normals``: ``tests/test_torch_preview.py``.)

Tolerances: the panels that involve no model (both range images, the
target's normal map) are bit-equal to the jitted reference's. The three that
follow the predicted pose (the transformed source's range and normals, the
po2pl map) agree within rtol 1e-4 / atol 1e-5 on all but 0.5% of pixels: the
two models agree within float32 rounding (rtol 1e-4), a squared residual
amplifies that where the residual cancels (measured: 2e-5 relative), and a
warped point that lands on the other side of a pixel boundary moves a whole
pixel (none did here).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from delora_tpu.config import load_config
from delora_tpu.training.trainer import Trainer as JaxTrainer
from delora_tpu_torch.config import default_config
from delora_tpu_torch.ops.projection import ProjectionSpec
from delora_tpu_torch.training import trainer as trainer_module
from delora_tpu_torch.training import tester as tester_module
from delora_tpu_torch.training.trainer import Trainer, training_panels
from delora_tpu_torch.utils.params import params_from_jax
from tests.test_torch_dataset import dataset_overrides, write_preprocessed

torch.set_num_threads(1)


def near_share(a, b, atol, rtol=0.0):
    """The share of pixels whose values all agree within ``atol`` + ``rtol``
    x |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    close = np.abs(a - b) <= atol + rtol * np.abs(b)
    return close.reshape(close.shape[:2] + (-1,)).all(-1).mean()


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    root = tmp_path_factory.mktemp("plotting")
    write_preprocessed(str(root))
    return root


def test_training_panels_match_the_jax_trainer(preprocessed, monkeypatch):
    from delora_tpu.utils import plotting as jax_plotting

    root = preprocessed
    captured = []
    monkeypatch.setattr(jax_plotting, "plot_training_panels",
                        lambda panels, path, iteration=0: captured.append(panels))
    ref = JaxTrainer(load_config(dataset_overrides(
        root, checkpoint_dir=str(root / "jax_ckpt"), log_dir=str(root / "jax_runs"))),
        run_name="jax")
    ref.log_images(0, "kitti")
    assert len(captured) == 1, "the JAX trainer skipped its images"
    want = [np.asarray(array) for _, _, array in captured[0]]

    config = default_config(dataset_overrides(root, checkpoint_dir=str(root / "ckpt")))
    port = Trainer(config, device="cpu", run_name="port")
    port.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, ref.state.params)))
    got = [x.numpy() for x in training_panels(
        port.model, port.pair_datasets["kitti"].get_pair(0),
        ProjectionSpec.from_config(config, "kitti"), tuple(config["projective_window"]),
        torch.device("cpu"))]
    assert [g.shape for g in got] == [w.shape for w in want]
    for i in (0, 1, 4):
        np.testing.assert_array_equal(got[i], want[i], err_msg=captured[0][i][0])
    for i in (2, 3, 5):
        assert near_share(got[i], want[i], 1e-5, 1e-4) >= 0.995, captured[0][i][0]
    assert (got[3] > 0).sum() > 10 and (got[2] > 0).sum() > 50


def test_trainer_renders_its_images(preprocessed):
    root = preprocessed
    config = default_config(dataset_overrides(
        root, checkpoint_dir=str(root / "ckpt_png"), visualize_images=True,
        visualize_every_epochs=2))
    trainer = Trainer(config, device="cpu", run_name="png")
    trainer.train(3)
    artifacts = os.path.join(trainer.logger.run_dir, "artifacts")
    pngs = sorted(n for n in os.listdir(artifacts) if n.startswith("images_"))
    assert pngs == ["images_kitti_00000.png", "images_kitti_00002.png"]
    assert all(os.path.getsize(os.path.join(artifacts, n)) > 1000 for n in pngs)


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib unimportable, and the port's plotting module imported
    afresh."""
    import delora_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "delora_tpu_torch.utils.plotting", raising=False)
    monkeypatch.delattr(delora_tpu_torch.utils, "plotting", raising=False)


def test_without_matplotlib_images_and_plots_skip(preprocessed, no_matplotlib, monkeypatch,
                                                  capsys):
    root = preprocessed
    config = default_config(dataset_overrides(
        root, checkpoint_dir=str(root / "ckpt_skip"), visualize_images=True))

    def never(*args, **kwargs):
        raise AssertionError("the panels were computed without matplotlib")

    monkeypatch.setattr(trainer_module, "training_panels", never)
    trainer = Trainer(config, device="cpu", run_name="skip")
    trainer.train(1)
    out = capsys.readouterr().out
    assert out.count("[trainer] image logging skipped:") == 1
    assert not [n for n in os.listdir(os.path.join(trainer.logger.run_dir, "artifacts"))
                if n.endswith(".png")]

    tester = tester_module.Tester(dict(config, inference_only=True), model=trainer.model, device="cpu",
                    run_name="skip_test")
    tester.plot_sequence("kitti_00", np.tile(np.eye(4), (3, 1, 1)),
                         np.tile(np.eye(4), (4, 1, 1)), None)
    assert capsys.readouterr().out.count("[test] plotting skipped:") == 1
