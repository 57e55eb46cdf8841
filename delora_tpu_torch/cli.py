"""Command line of the port: ``python -m delora_tpu_torch.cli
preprocess|train|test|serve``.

The port of ``delora_tpu/cli.py``'s ``preprocess``, ``train``, ``test`` and
``serve``. ``--set KEY=VALUE`` overrides (JSON values, fields of view in
degrees) go over the defaults, or, with ``--checkpoint``, over the config
embedded in the checkpoint, which is thus rehydrated and re-overridden
(reference cli.py:43-53); the mode (training, testing, preprocessing) sets
each dataset's ``data_identifiers``. Every command runs on CUDA unless given
``--device cpu``. Not ported: ``--config`` YAML files, ``preprocess
--preview``, ``bench``, ``export-torch`` and ``visualize-normals``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional

from delora_tpu_torch.config import default_config


def _parse_overrides(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


def _build_config(args, mode: str) -> Dict[str, Any]:
    """The config of a run: ``--set`` overrides and ``--checkpoint`` over
    the checkpoint's embedded config (else the defaults), in ``mode``."""
    from delora_tpu_torch.training.checkpoint import CheckpointManager

    overrides = _parse_overrides(args.overrides)
    base = None
    if args.checkpoint:
        overrides["checkpoint"] = args.checkpoint
        base = CheckpointManager.embedded_config(args.checkpoint)
    return default_config(overrides, base=base, mode=mode)


def serve_config(checkpoint: Optional[str], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """The served config: ``overrides`` (fields of view in degrees) over the
    checkpoint's embedded config (already in radians), else over the defaults."""
    from delora_tpu_torch.serving.stream import load_serving_checkpoint

    base = load_serving_checkpoint(checkpoint)[0] if checkpoint else None
    return default_config(overrides, base=base)


def cmd_preprocess(args):
    from delora_tpu_torch.data.preprocess import Preprocessor

    config = _build_config(args, "preprocessing")
    pre = Preprocessor(config, device=args.device)
    for dataset in config["datasets"]:
        n = pre.run_dataset(dataset, max_scans=args.max_scans)
        print(f"[preprocess] {dataset}: {n} scans written", flush=True)
    return pre


def cmd_train(args):
    from delora_tpu_torch.training.trainer import Trainer

    config = _build_config(args, "training")
    config.setdefault("training_run_name", args.run_name or "run")
    trainer = Trainer(config, device=args.device, run_name=args.run_name)
    trainer.train(args.epochs)
    return trainer


def cmd_test(args):
    from delora_tpu_torch.training.tester import Tester

    config = _build_config(args, "testing")
    config["inference_only"] = True
    results = Tester(config, device=args.device, run_name=args.run_name).test()
    print(json.dumps({d: {str(s): m for s, m in v.items()} for d, v in results.items()},
                     indent=2), flush=True)
    return results


def cmd_serve(args):
    from delora_tpu_torch.serving.stream import StreamingOdometry

    config = serve_config(args.checkpoint, _parse_overrides(args.overrides))
    engine = StreamingOdometry(config, checkpoint=args.checkpoint,
                               device=args.device, dataset=args.dataset)
    engine.serve_stdin()


def main(argv: Optional[list] = None):
    """Parse ``argv`` and run the command -> what the command returns (the
    Preprocessor, the Trainer, the test results)."""
    parser = argparse.ArgumentParser(prog="python -m delora_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name, fn, help_, checkpoint_help):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--set", dest="overrides", nargs="*", default=[], metavar="KEY=VALUE",
                       help="config overrides, e.g. --set batch_size=8 "
                            "'kitti={\"data_path\": \"...\"}'")
        p.add_argument("--checkpoint", default=None, help=checkpoint_help)
        p.add_argument("--device", default=None, help="torch device (default: cuda)")
        p.set_defaults(fn=fn)
        return p

    p = command("preprocess", cmd_preprocess, "raw scans -> deduplicated points + normals",
                "checkpoint whose embedded config is the base")
    p.add_argument("--max-scans", type=int, default=None)
    p = command("train", cmd_train, "self-supervised training",
                "checkpoint to resume from (its embedded config is the base)")
    p.add_argument("--run-name", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p = command("test", cmd_test, "sequential evaluation -> trajectories and metrics",
                "checkpoint to evaluate (its deploy weights; its embedded config is the base)")
    p.add_argument("--run-name", default=None)
    p = command("serve", cmd_serve, "streaming odometry, JSONL over stdin/stdout",
                "trainer or serving checkpoint (its embedded config is the base)")
    p.add_argument("--dataset", default="kitti")
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
