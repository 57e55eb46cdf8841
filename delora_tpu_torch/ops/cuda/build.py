"""Build the CUDA sources of ``delora_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared
library with a plain ``extern "C"`` interface, loaded with ``ctypes``. No
PyTorch headers are involved, so a build takes seconds. Libraries go to
``delora_tpu_torch/build/`` (ignored by git), named by a hash of the source
and the flags, so an edited source is rebuilt at its next use. Building
happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or the standard install."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def library_path(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills),
    empty when the library was already built; raises if ``nvcc`` fails."""
    target = library_path(name)
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(".tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA build of {name} failed: nvcc exited {proc.returncode}\n"
                           f"{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def build_all(names: Sequence[str]) -> Dict[str, Tuple[str, float]]:
    """Compile several sources at once, one ``nvcc`` each, all started
    together -> {name: (compiler output, seconds)}; raises if any fails."""
    def timed(name: str) -> Tuple[str, float]:
        start = time.perf_counter()
        log = build(name)
        return log, time.perf_counter() - start

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
    return {name: future.result() for name, future in futures.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
