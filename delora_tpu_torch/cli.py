"""Command line of the port: ``python -m delora_tpu_torch.cli
preprocess|train|test|serve|export-torch|visualize-normals``.

The port of ``delora_tpu/cli.py``. ``--config FILE...`` (JSON) replaces the
packaged defaults with the files, deep-merged in order, as the reference's
``--config`` replaces its YAML stack (JSON is YAML, so the same files work
there). ``--set KEY=VALUE`` overrides (JSON values, fields of view in
degrees) go over the defaults or the files, or, with ``--checkpoint``, over
the config embedded in the checkpoint, which is thus rehydrated, deep-merged
and re-overridden (reference cli.py:43-53); the mode (training, testing,
preprocessing) sets each dataset's ``data_identifiers``. ``preprocess
--preview`` renders the first scan's range and normal images and stops;
``export-torch`` writes a trainer checkpoint's live weights in the original
DeLORA ``.pth`` layout (reference cli.py:105-135); ``visualize-normals``
renders a preprocessed scan's normals. Every command runs on CUDA unless
given ``--device cpu``. ``train`` runs data-parallel under ``torchrun
--nproc_per_node N``: one process a card (``cuda:LOCAL_RANK``, NCCL), or
processes on the CPU over gloo with ``--device cpu``. Not ported: ``bench``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

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
    return default_config(overrides, base=base, mode=mode, files=getattr(args, "config", None))


def serve_config(checkpoint: Optional[str], overrides: Dict[str, Any],
                 files: Optional[List[str]] = None) -> Dict[str, Any]:
    """The served config: ``overrides`` (fields of view in degrees) over the
    checkpoint's embedded config (already in radians), else over the config
    files or the defaults."""
    from delora_tpu_torch.serving.stream import load_serving_checkpoint

    base = load_serving_checkpoint(checkpoint)[0] if checkpoint else None
    return default_config(overrides, base=base, files=files)


def cmd_preprocess(args):
    from delora_tpu_torch.data.preprocess import Preprocessor

    config = _build_config(args, "preprocessing")
    pre = Preprocessor(config, device=args.device)
    for dataset in config["datasets"]:
        if args.preview:
            pre.preview(dataset)
            continue
        n = pre.run_dataset(dataset, max_scans=args.max_scans)
        print(f"[preprocess] {dataset}: {n} scans written", flush=True)
    return pre


def cmd_train(args):
    """Train; under ``torchrun`` (``WORLD_SIZE`` above 1) each process joins
    the group first and trains data-parallel on ``cuda:LOCAL_RANK`` (or the
    CPU with ``--device cpu``, over gloo), as the reference's ``cmd_train``
    initializes its hosts (reference cli.py:59-72)."""
    from delora_tpu_torch.parallel import dist as pdist
    from delora_tpu_torch.training.trainer import Trainer

    config = _build_config(args, "training")
    config.setdefault("training_run_name", args.run_name or "run")
    device = args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = pdist.initialize_distributed(device=args.device)
    try:
        trainer = Trainer(config, device=device, run_name=args.run_name)
        trainer.train(args.epochs)
    finally:
        pdist.shutdown()
    return trainer


def cmd_test(args):
    from delora_tpu_torch.training.tester import Tester

    config = _build_config(args, "testing")
    config["inference_only"] = True
    results = Tester(config, device=args.device, run_name=args.run_name).test()
    print(json.dumps({d: {str(s): m for s, m in v.items()} for d, v in results.items()},
                     indent=2), flush=True)
    return results


def cmd_export_torch(args):
    """A trainer checkpoint -> its live weights (``state["model"]``, not the
    EMA's, as the reference exports ``state.params``), embedded config,
    epoch and loss in the DeLORA ``.pth`` layout at ``--out``."""
    from delora_tpu_torch.training.checkpoint import load_checkpoint
    from delora_tpu_torch.utils.torch_import import save_reference_checkpoint

    if not args.checkpoint:
        raise SystemExit("--checkpoint is required")
    config = _build_config(args, "testing")
    payload = load_checkpoint(args.checkpoint)
    meta = payload["meta"]
    save_reference_checkpoint(args.out, payload["state"]["model"],
                              config=meta.get("parameters", config),
                              epoch=int(meta.get("epoch", 0)), loss=float(meta.get("loss", 0.0)))
    print(f"[export-torch] wrote {args.out}", flush=True)
    return args.out


def cmd_visualize_normals(args):
    from delora_tpu_torch.utils.visualize_normals import render

    return render(args.sequence_dir, args.scan, args.out)


def cmd_serve(args):
    from delora_tpu_torch.serving.stream import StreamingOdometry

    config = serve_config(args.checkpoint, _parse_overrides(args.overrides), args.config)
    engine = StreamingOdometry(config, checkpoint=args.checkpoint,
                               device=args.device, dataset=args.dataset)
    engine.serve_stdin()


def main(argv: Optional[list] = None):
    """Parse ``argv`` and run the command -> what the command returns (the
    Preprocessor, the Trainer, the test results, the written path)."""
    parser = argparse.ArgumentParser(prog="python -m delora_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name, fn, help_, checkpoint_help):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--config", nargs="*", default=None, metavar="FILE",
                       help="JSON config files, merged in order (default: the packaged "
                            "defaults)")
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
    p.add_argument("--preview", action="store_true",
                   help="render the first scan's range and normal images and stop")
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
    p = command("export-torch", cmd_export_torch,
                "trainer checkpoint -> the original DeLORA .pth layout",
                "trainer checkpoint to export (its live weights)")
    p.add_argument("--out", required=True, help="output .pth path")
    p = sub.add_parser("visualize-normals",
                       help="render a preprocessed scan's normals (3D quiver)")
    p.add_argument("sequence_dir", help="preprocessed sequence dir (holds scans/ and normals/)")
    p.add_argument("--scan", type=int, default=0)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_visualize_normals)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
