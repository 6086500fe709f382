"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each library is compiled at first use into ``metaopt_tpu_torch/_build/``,
keyed by a hash of its sources and flags, so an edited source rebuilds and
an unchanged one loads in milliseconds. The sources expose a plain C
interface: no PyTorch headers, so a build takes seconds, not minutes.
``nvcc -Xptxas=-v`` output (registers, shared memory, spills per kernel) is
kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from PATH, ``$CUDA_HOME`` or ``/usr/local/cuda``; raises if absent."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built on a machine with the CUDA toolkit"
    )


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the library for these exact sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into one shared library unless it is built already."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build (if needed) and load one library; cached per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _LOADED[name] = lib
        return lib
