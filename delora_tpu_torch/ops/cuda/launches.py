"""Every hand-written kernel's launch counter, in one table.

Each wrapper counts its launches in an attribute of its own function (the
placement its two winner rules apart, the wrap-pad its two directions). A
replayed CUDA graph launches what it captured without running the wrappers,
so its owner adds the counts read during the capture at each replay
(``training/graphed.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple


def launch_counters() -> Dict[str, Tuple[object, str]]:
    """Each kernel's launch counter, by kernel: name -> (wrapper, attribute)."""
    from delora_tpu_torch.ops.cuda.circular_pad import circular_pad
    from delora_tpu_torch.ops.cuda.nn_search import nn_search
    from delora_tpu_torch.ops.cuda.placement import placement
    from delora_tpu_torch.ops.cuda.window_match import (
        window_match,
        window_match_indices,
        window_match_soft,
    )

    return {"placement": (placement, "launches_exact"),
            "placement_packed": (placement, "launches_packed"),
            "window_match": (window_match, "launches"),
            "window_match_soft": (window_match_soft, "launches"),
            "window_match_index": (window_match_indices, "launches"),
            "nn_search": (nn_search, "launches"),
            "circular_pad": (circular_pad, "launches_forward"),
            "circular_pad_grad": (circular_pad, "launches_backward")}


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches so far in this process, by kernel."""
    return {name: getattr(w, attr) for name, (w, attr) in launch_counters().items()}
