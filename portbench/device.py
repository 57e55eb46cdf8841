"""The card the run measures, the caches it keeps, and the import guard."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

# Top-level modules that no run may load: JAX, its libraries and the JAX
# package that the program is a port of. Compared whole, so the program's
# own name, which begins with the last, passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "delora_tpu")


def forbidden_modules(modules=None) -> List[str]:
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def keep_caches_in(root: Path) -> None:
    """Point every kernel and build cache a library may keep at fixed
    directories inside the checkout (the program's own nvcc builds already go
    to ``delora_tpu_torch/build/``)."""
    cache = Path(root) / ".portbench" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def smi(fields: str) -> str:
    """One line of ``nvidia-smi --query-gpu`` for the first card, or a note
    that it could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def describe(torch, device) -> Dict:
    """The result's ``device`` block (without the peak, read later)."""
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}
