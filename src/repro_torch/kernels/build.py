"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` into a shared library
with a plain C interface, named by a hash of the source and the flags, in
``build/`` at the repository root, and loaded with :mod:`ctypes`. A later
process that finds the library with the same hash loads it without
compiling. Nothing here runs at import time:
the CPU-only test host imports this module but never builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# one lock per source: threads of one process (batched BO prices a
# batch's points from a thread per card) build it one at a time
_BUILD_LOCKS: dict[str, threading.Lock] = {}
_BUILD_LOCKS_LOCK = threading.Lock()


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin); the CUDA kernels need the CUDA "
                       "toolkit")


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{Path(source).stem}_{digest[:16]}.so"


def compile_source(source: str) -> Path:
    """Compile ``csrc/<source>`` unless the hashed library exists; returns
    its path. The output is written under a temporary name of this process
    and renamed, so concurrent builds never load a half-written file; the
    threads of one process take the source's lock, so the second finds
    the first's library instead of writing the same temporary file."""
    out = library_path(source)
    with _BUILD_LOCKS_LOCK:
        lock = _BUILD_LOCKS.setdefault(source, threading.Lock())
    with lock:
        if out.exists():
            return out
        nvcc = find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{source}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        return out


def load(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built first if need be."""
    return ctypes.CDLL(str(compile_source(source)))
