"""delora_tpu_torch — the PyTorch/CUDA port of delora_tpu.

The JAX package ``delora_tpu`` is the reference; this package computes the
same functions in PyTorch, with hand-written CUDA kernels for Hopper where the
reference has Pallas kernels. It imports no JAX and nothing of
``delora_tpu``.

Ported so far: the serving path (``serving/stream.py::StreamingOdometry``);
the training step of the main path, the quality recipe and brute
correspondence (``training/step.py``); the trainer, from in-memory scans or
from disk with checkpoints, resume and evaluation
(``training/trainer.py::Trainer``); preprocessing (``data/preprocess.py``),
the scan-pair dataset (``data/dataset.py``) and the ``Tester``
(``training/tester.py``); the command line ``python -m delora_tpu_torch.cli
preprocess|train|test|serve``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present: the port never falls back to the CPU on its own.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            'pass device="cpu" to run on the CPU'
        )
    return device
