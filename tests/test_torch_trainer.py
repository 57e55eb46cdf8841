"""The port's trainer on the CPU: a tiny world of in-memory scans, tables on
the device (here the CPU), the warmup switch, the epoch order of the
reference's loader, pairs that never cross sequences, the raw feed (brute
correspondence), and the quality recipe (soft matching, reverse po2pl, EMA,
dropout)."""

import math

import numpy as np
import pytest
import torch

from delora_tpu_torch.config import default_config
from delora_tpu_torch.training.trainer import Trainer

SMALL = {"kitti": {"max_points": 1024, "vertical_cells": 8, "horizontal_cells": 32},
         "resnet_outputs": 8, "layers": [1, 1, 1, 1], "factor_fewer_resnet_channels": 16,
         "compute_dtype": "float32", "batch_size": 1, "learning_rate": 0.01}


def tiny_world(lengths, seed=0, n=600):
    """Sequences of random scans over the sensor's field of view, with unit
    normals (a fifth of them zero: no normal)."""
    rng = np.random.default_rng(seed)

    def scan():
        az = rng.uniform(-math.pi, math.pi, n)
        el = rng.uniform(-0.4, 0.03, n)
        r = rng.uniform(2.0, 30.0, n)
        pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                        r * np.sin(el)], -1).astype(np.float32)
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm[rng.random(n) < 0.2] = 0.0
        return pts, nrm

    return [[scan() for _ in range(k)] for k in lengths]


def test_trainer_leaves_warmup_and_trains_unsupervised():
    trainer = Trainer(default_config(SMALL), tiny_world([10, 4]), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    history = trainer.train(3)
    assert [h["supervised"] for h in history] == [1.0, 1.0, 0.0]
    assert history[1]["loss"] < 1e-2 < history[0]["loss"]
    # Unsupervised, the loss is the ICP loss.
    assert history[2]["loss"] == pytest.approx(history[2]["loss_pc"])
    for h in history:
        assert h["steps"] == 12 and h["placement_overflow_tiles"] == 0.0
        assert all(np.isfinite(v) for v in h.values())
        assert h["num_po2pl_pairs"] > 10


def test_pairs_stay_inside_sequences_and_epochs_follow_the_loader():
    config = default_config({**SMALL, "batch_size": 4, "unsupervised_at_start": True})
    trainer = Trainer(config, tiny_world([5, 3, 4]), device="cpu")
    assert not trainer.supervised
    # Scans 0-4, 5-7, 8-11: no pair (4, 5) or (7, 8).
    assert trainer.feeds["kitti"].pair_target.tolist() == [0, 1, 2, 3, 5, 6, 8, 9, 10]
    assert trainer.feeds["kitti"].pair_source.tolist() == [1, 2, 3, 4, 6, 7, 9, 10, 11]
    for epoch in (0, 3):
        expected = np.random.default_rng(epoch).permutation(9)[:8]
        np.testing.assert_array_equal(trainer.epoch_indices(epoch), expected)
    assert trainer.feeds["kitti"].tables.image.shape == (12, 8, 32, 4)
    assert trainer.feeds["kitti"].tables.src_points.shape == (12, 8 * 32, 3)
    assert trainer.feeds["kitti"].tables.mean_range.dtype == torch.float32


def test_trainer_needs_a_whole_batch():
    with pytest.raises(ValueError):
        Trainer(default_config({**SMALL, "batch_size": 8}), tiny_world([4]), device="cpu")


def test_trainer_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(default_config(SMALL), tiny_world([3]))


def test_raw_feed_trains_brute_correspondence():
    config = default_config({**SMALL, "correspondence": "brute", "batch_size": 2,
                             "unsupervised_at_start": True})
    trainer = Trainer(config, tiny_world([4, 3]), device="cpu")
    assert trainer.feed == "raw" and len(trainer.feeds["kitti"].tables) == 3
    points, normals, valid = trainer.feeds["kitti"].tables
    assert points.shape == (7, 1024, 3) and valid.dtype == torch.bool
    assert valid.sum(1).tolist() == [600] * 7
    history = trainer.train(2)
    for h in history:
        assert h["steps"] == 2 and all(np.isfinite(v) for v in h.values())
        assert h["num_po2pl_pairs"] > 10 and h["loss"] == pytest.approx(h["loss_pc"])
    np.testing.assert_array_equal(trainer.epoch_indices(1),
                                  np.random.default_rng(1).permutation(5)[:4])


def test_raw_feed_truncates_to_max_points():
    config = default_config({**SMALL, "cache_target_projections": False,
                             "kitti": {"max_points": 500}})
    trainer = Trainer(config, tiny_world([2]), device="cpu")
    assert trainer.feed == "raw" and trainer.feeds["kitti"].tables[0].shape == (2, 500, 3)
    assert trainer.feeds["kitti"].tables[2].all()


def test_quality_recipe_trains_and_deploys_the_ema():
    recipe = {**SMALL, "soft_match_sigma": 0.3, "lambda_reverse_po2pl": 1.0,
              "ema_decay": 0.9, "use_dropout": True, "unsupervised_at_start": True}

    def run():
        trainer = Trainer(default_config(recipe), tiny_world([4]), device="cpu",
                          generator=torch.Generator().manual_seed(3))
        return trainer, trainer.train(2)

    trainer, history = run()
    assert trainer.feed == "full" and trainer.dropout_generator is not None
    for h in history:
        assert all(np.isfinite(v) for v in h.values()) and h["loss_po2pl_rev"] > 0
    deployed = trainer.deploy_model()
    assert deployed is not trainer.model and not deployed.training
    live = dict(trainer.model.named_parameters())
    for name, value in deployed.named_parameters():
        assert torch.isfinite(value).all()
        assert value.data_ptr() != live[name].data_ptr()
    assert not torch.equal(deployed.resnet.fc.weight, trainer.model.resnet.fc.weight)
    # The dropout masks come from the trainer's seeded generator.
    _, again = run()
    assert [h["loss"] for h in again] == [h["loss"] for h in history]


def test_without_ema_the_deploy_model_is_the_model():
    trainer = Trainer(default_config(SMALL), tiny_world([3]), device="cpu")
    assert trainer.ema is None and trainer.deploy_model() is trainer.model


# The step as a CUDA graph (``training/graphed.py``): on the CPU nothing is
# captured and the optimizer is the default Adam; the rule that decides
# graphing is a function of what the trainer observes, held here condition
# by condition for a CUDA device.

def test_cpu_trainer_captures_nothing():
    trainer = Trainer(default_config({**SMALL, "unsupervised_at_start": True}),
                      tiny_world([4]), device="cpu")
    history = trainer.train(2)
    assert sum(h["steps"] for h in history) == 6
    assert trainer.graph_counts == {"captures": 0, "replays": 0, "eager": 6}


def test_cpu_optimizer_is_the_default_adam_with_a_float_rate():
    config = default_config({**SMALL, "lr_schedule": "cosine", "lr_decay_steps": 4})
    trainer = Trainer(config, tiny_world([3]), device="cpu")
    group = trainer.optimizer.param_groups[0]
    assert isinstance(trainer.optimizer, torch.optim.Adam) and not group["capturable"]
    assert type(group["lr"]) is float and type(group["initial_lr"]) is float
    assert all(type(b) is float for b in trainer.schedule.base_lrs)
    trainer.train(1)
    assert type(group["lr"]) is float and group["lr"] < 0.01
    state = trainer.optimizer.state[next(trainer.model.parameters())]
    assert state["step"].device.type == "cpu" and float(state["step"]) == 2.0


def rule_case(case):
    """(device, StepConfig, model, undo) of one case of the graphing rule,
    every condition met but the one ``case`` names."""
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.training.step import StepConfig

    config = default_config(SMALL)
    model = OdometryModel(ModelConfig.from_config(config))
    cfg = StepConfig.from_config(config, supervised=False)
    device = torch.device("cuda")
    conv = next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    param = next(model.parameters())
    module_hooks = torch.nn.modules.module
    handle = None
    if case == "cpu":
        device = torch.device("cpu")
    elif case == "brute":
        cfg = cfg._replace(correspondence="brute")
    elif case == "forward_hook":
        handle = model.register_forward_hook(lambda *a: None)
    elif case == "forward_pre_hook":
        handle = conv.register_forward_pre_hook(lambda *a: None)
    elif case == "backward_hook":
        handle = conv.register_full_backward_hook(lambda *a: None)
    elif case == "gradient_hook":
        handle = param.register_hook(lambda g: g)
    elif case == "accumulate_hook":
        handle = param.register_post_accumulate_grad_hook(lambda p: None)
    elif case == "global_hook":
        handle = module_hooks.register_module_forward_hook(lambda *a: None)
    return device, cfg, model, handle


@pytest.mark.parametrize("case", ["cpu", "brute", "forward_hook", "forward_pre_hook",
                                  "backward_hook", "gradient_hook", "accumulate_hook",
                                  "global_hook"])
def test_graphing_rule_declines_each_condition(case):
    from delora_tpu_torch.training.graphed import graphable

    device, cfg, model, handle = rule_case(case)
    try:
        assert not graphable(device, cfg, model)
    finally:
        if handle is not None:
            handle.remove()
    assert graphable(torch.device("cuda"), cfg._replace(correspondence="image"), model)


def test_graphing_rule_declines_in_a_process_group(monkeypatch):
    from delora_tpu_torch.parallel import dist as pdist
    from delora_tpu_torch.training.graphed import graphable

    device, cfg, model, _ = rule_case("none")
    assert graphable(device, cfg, model)
    assert graphable(device, cfg._replace(correspondence="projective"), model)
    monkeypatch.setattr(pdist, "active", lambda: True)
    assert not graphable(device, cfg, model)


def test_step_key_tells_apart_what_a_capture_fixed():
    """A graph is kept under its key: the phase, the matcher, the batch's
    type, leaf shapes and dtypes, and the model's mode each make another
    key; another batch of the same shapes does not."""
    from delora_tpu_torch.training.graphed import step_key

    trainer = Trainer(default_config({**SMALL, "batch_size": 2}), tiny_world([5]), device="cpu")
    _, cfg, model, _ = rule_case("none")
    feed = trainer.feeds["kitti"]

    def batch(rows):
        idx = np.asarray(rows)
        return trainer.batch(torch.as_tensor(feed.pair_target[idx]),
                             torch.as_tensor(feed.pair_source[idx]))

    key = step_key(batch([0, 1]), cfg, model)
    assert step_key(batch([2, 3]), cfg, model) == key
    half = batch([0])
    double = type(half)(*(x.double() if x.is_floating_point() else x for x in batch([0, 1])))
    assert len({key, step_key(batch([0, 1]), cfg._replace(supervised=True), model),
                step_key(batch([0, 1]), cfg._replace(correspondence="projective"), model),
                step_key(half, cfg, model), step_key(double, cfg, model),
                step_key(tuple(batch([0, 1])), cfg, model)}) == 6
    model.eval()
    assert step_key(batch([0, 1]), cfg, model) != key


def test_optimizer_state_keeps_each_optimizer_kind():
    """A CPU trainer's state loaded into an optimizer of the card's kind
    (capturable, device rates: here a capturable Adam on the CPU) keeps that
    kind, its very rate tensors filled; and back: the CPU's keeps floats."""
    from delora_tpu_torch.training.state import load_optimizer_state

    config = default_config({**SMALL, "lr_schedule": "cosine", "lr_decay_steps": 4})
    trainer = Trainer(config, tiny_world([3]), device="cpu")
    trainer.train(1)
    saved = {"optimizer": trainer.optimizer.state_dict(),
             "schedule": trainer.schedule.state_dict()}
    rate = float(trainer.optimizer.param_groups[0]["lr"])

    params = list(trainer.model.parameters())
    card = torch.optim.Adam(params, lr=torch.tensor(0.5), capturable=True)
    schedule = torch.optim.lr_scheduler.LambdaLR(card, lambda count: 1.0)
    group = card.param_groups[0]
    lr, initial, base = group["lr"], group["initial_lr"], schedule.base_lrs[0]
    load_optimizer_state(card, schedule, saved["optimizer"], saved["schedule"])
    assert group["capturable"] and group["lr"] is lr and group["initial_lr"] is initial
    assert schedule.base_lrs[0] is base and float(base) == pytest.approx(0.01)
    assert float(lr) == pytest.approx(rate) and schedule.last_epoch == 2
    card_state = {"optimizer": card.state_dict(), "schedule": schedule.state_dict()}
    assert torch.is_tensor(card_state["optimizer"]["param_groups"][0]["lr"])

    load_optimizer_state(trainer.optimizer, trainer.schedule, card_state["optimizer"],
                         card_state["schedule"])
    group = trainer.optimizer.param_groups[0]
    assert not group["capturable"] and type(group["lr"]) is float
    assert type(group["initial_lr"]) is float and type(trainer.schedule.base_lrs[0]) is float
    assert group["lr"] == pytest.approx(rate)
    trainer.train(2)
