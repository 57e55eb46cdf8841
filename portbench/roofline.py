"""The card's published peaks and each kernel's least work, as functions of
the shapes of a call.

A roofline share is the least time the card could take for a call, the larger
of its bytes over the memory bandwidth and its float32 operations over the
float32 rate, divided by the call's measured device time. Each input byte is
counted read once and each output byte written once, whatever the kernel
reads again; where the work depends on the data, only what any input of
these shapes needs is counted, so a share is never overstated.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple


class Peaks(NamedTuple):
    bf16_flops: float          # dense tensor-core bf16 FLOP/s
    fp32_flops: float          # float32 outside the tensor cores
    hbm_bytes: float           # bytes/s


# NVIDIA's H100 data sheet, SXM part, dense rates, at its 700 W limit.
PEAKS: Dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(989.4e12, 67e12, 3.35e12),
}


def peaks(device_name: str) -> Optional[Peaks]:
    return PEAKS.get(device_name)


def bound_s(bytes_moved: float, fp32_ops: float, peak: Peaks) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations": which sets it)."""
    by_bytes = bytes_moved / peak.hbm_bytes
    by_ops = fp32_ops / peak.fp32_flops
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def placement_work(batch: int, points: int, height: int, width: int, channels_out: int
                   ) -> Tuple[int, int]:
    """(bytes, operations) of one placement call: every point's pixel id and
    range read (8 B), the image of ``channels_out`` float32 channels written.
    The winners' payload reads depend on the data and are left out."""
    return batch * points * 8 + batch * height * width * channels_out * 4, 0


def window_match_work(batch: int, height: int, width: int, window: Tuple[int, int]
                      ) -> Tuple[int, int]:
    """(bytes, operations) of one hard window-match call: the source xyz,
    target xyz and target normal read once (36 B a pixel), the squared
    distance, xyz and normal written once (28 B a pixel); three operations
    (row test, column wrap, occupancy test) on each in-image candidate. The
    distances of occupied candidates depend on the data and are left out."""
    wv, wu = window
    a = wv // 2
    rows = sum(min(height - 1, h + a) - max(0, h - a) + 1 for h in range(height))
    visited = batch * rows * width * wu
    return batch * height * width * 64, 3 * visited
