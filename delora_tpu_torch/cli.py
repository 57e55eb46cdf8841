"""Command line of the port: ``python -m delora_tpu_torch.cli serve``.

Only the ``serve`` subcommand is ported: streaming odometry as JSONL over
stdin/stdout. ``--set`` overrides, in the YAML's units, go over a
checkpoint's embedded config; without a checkpoint, over the defaults, and the
model is the seeded initialisation.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional

import torch

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


def serve_config(checkpoint: Optional[str], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """The served config: ``overrides`` (fields of view in degrees) over the
    checkpoint's embedded config (already in radians), else over the defaults."""
    base = None
    if checkpoint:
        base = torch.load(checkpoint, map_location="cpu", weights_only=True)["config"]
    return default_config(overrides, base=base)


def cmd_serve(args):
    from delora_tpu_torch.serving.stream import StreamingOdometry

    config = serve_config(args.checkpoint, _parse_overrides(args.overrides))
    engine = StreamingOdometry(config, checkpoint=args.checkpoint,
                               device=args.device, dataset=args.dataset)
    engine.serve_stdin()


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(prog="python -m delora_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("serve", help="streaming odometry, JSONL over stdin/stdout")
    p.add_argument("--checkpoint", default=None, help="port checkpoint (.pt)")
    p.add_argument("--set", dest="overrides", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides, e.g. --set compute_dtype=float32")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--dataset", default="kitti")
    p.set_defaults(fn=cmd_serve)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
