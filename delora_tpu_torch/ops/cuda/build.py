"""Build the sources of ``delora_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain ``extern "C"`` interface, loaded with ``ctypes``; each host source
``csrc/<name>.cpp`` (the IO runtime) is compiled the same way by the host's
C++ compiler (``$CXX``, else ``c++``). No PyTorch headers are involved, so a
build takes seconds. Libraries go to ``delora_tpu_torch/build/`` (ignored by
git), named by a hash of the source and the flags, so an edited source is
rebuilt at its next use; each build writes a temporary file of its own
process and thread and renames it into place, so processes that build the
same library at once do not clash. Building happens at first use, never at
import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
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
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or the standard install."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def host_compiler() -> str:
    """The host's C++ compiler: ``$CXX``, else ``c++`` or ``g++`` from PATH."""
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no C++ compiler found ($CXX, c++, g++)")
    return found


def source_path(name: str) -> Path:
    """``csrc/<name>.cu``, else the host source ``csrc/<name>.cpp``."""
    cuda = CSRC_DIR / f"{name}.cu"
    return cuda if cuda.exists() else CSRC_DIR / f"{name}.cpp"


def _flags(source: Path) -> Tuple[str, ...]:
    return NVCC_FLAGS if source.suffix == ".cu" else HOST_FLAGS


def library_path(name: str) -> Path:
    source = source_path(name)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(_flags(source)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (``nvcc``) or ``csrc/<name>.cpp`` (the host
    compiler) unless its library exists. Returns the compiler's output (for
    ``nvcc``, ``-Xptxas -v``: registers, shared memory, spills), empty when
    the library was already built; raises if the compiler fails."""
    target = library_path(name)
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    source = source_path(name)
    compiler = nvcc_path() if source.suffix == ".cu" else host_compiler()
    cmd = [compiler, *_flags(source), "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build of {source.name} failed: {Path(compiler).name} exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def build_all(names: Sequence[str]) -> Dict[str, Tuple[str, float, bool]]:
    """Compile several sources at once, one compiler each, all started
    together -> {name: (compiler output, seconds, whether it was built now
    rather than found built)}; raises if any fails."""
    def timed(name: str) -> Tuple[str, float, bool]:
        start = time.perf_counter()
        built = not library_path(name).exists()
        log = build(name)
        return log, time.perf_counter() - start, built

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
    return {name: future.result() for name, future in futures.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
