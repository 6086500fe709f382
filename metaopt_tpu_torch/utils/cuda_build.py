"""Build the port's native sources and load them with ``ctypes``.

Two compilers share one hashing and caching scheme: :func:`build` runs
``nvcc`` over the CUDA sources of ``csrc/``, and :func:`build_host` runs
``g++`` over host-only C++ (the ledgerstore engine of ``native/``). Each
library is compiled at first use into ``metaopt_tpu_torch/_build/``, keyed
by a hash of its sources and flags, so an edited source rebuilds and an
unchanged one loads in milliseconds. Every build writes a per-process
temporary file and publishes it with one ``os.link`` to the hashed name,
which fails if another process published first; that process's file is
then kept. So concurrent first uses (test workers, CLI workers) never
load half a library, and a published library, which another process may
have mapped, is never replaced under it. The sources expose a plain C
interface: no PyTorch headers, so a build takes seconds, not minutes.
The compiler's output (for ``nvcc``, ``-Xptxas=-v``: registers, shared
memory, spills per kernel) is kept beside each library as
``<name>.log``. This module imports nothing outside the standard
library.
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
    # optimize and assemble the kernels in parallel on every core: the
    # build counts against chip_smoke.py's time limit (its [build] line);
    # ptxas still reports each kernel's lines together
    "--split-compile=0",
]

#: host-only C++ (``g++``): the native ledger engine
HOST_FLAGS: List[str] = ["-O2", "-shared", "-fPIC", "-std=c++17"]

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


def find_gxx() -> str:
    """``g++`` from PATH; raises if absent."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native ledger "
                           "engine is built with it")
    return gxx


def _hashed_path(name: str, flags: Sequence[str], files: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the CUDA library for these exact sources and flags lives."""
    return _hashed_path(name, NVCC_FLAGS,
                        [*sources, *sorted(CSRC_DIR.glob("*.cuh"))])


def host_library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the host (``g++``) library for these exact sources lives."""
    return _hashed_path(name, HOST_FLAGS, sources)


def _compile(name: str, out: Path, cmd_of, timeout=None) -> Path:
    """Run ``cmd_of(tmp)`` into a per-process temporary file, then publish it."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = cmd_of(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        log = Path(tmp).with_suffix(".log")
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.replace(log, out.with_suffix(".log"))
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed for {name} (exit "
                f"{proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        try:
            # atomic, and never over a published file: a concurrent loader
            # sees no half library, and no process's mapping loses its name
            os.link(tmp, out)
        except FileExistsError:
            pass  # another process published the same sources first
    finally:
        os.unlink(tmp)
    return out


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile CUDA ``sources`` into one shared library unless it is built already."""
    return _compile(name, library_path(name, sources), lambda tmp: [
        find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)])


def build_host(name: str, sources: Sequence[Path]) -> Path:
    """Compile host C++ ``sources`` with ``g++`` unless it is built already."""
    return _compile(name, host_library_path(name, sources), lambda tmp: [
        find_gxx(), *HOST_FLAGS, *map(str, sources), "-o", tmp], timeout=120)


def load(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build (if needed) and load one library; cached per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _LOADED[name] = lib
        return lib
