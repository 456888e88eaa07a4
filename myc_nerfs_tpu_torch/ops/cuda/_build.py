"""Builds the port's CUDA C++ sources with nvcc into csrc/build/.

Each source is compiled on first use into a shared library with a plain C
interface (loaded with ctypes by its wrapper module), keyed by a hash of
the source, the repository headers it includes (``#include "..."``, found
beside it, followed recursively) and the flags, so a changed source, header
or flag builds anew and an unchanged one is reused. A failed build raises
with nvcc's output.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence, Tuple

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA sources")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(source: Path) -> list:
    """``source`` and every header it includes with quotes, found relative
    to the including file, each once, in the order first reached."""
    seen, todo = [], [Path(source).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / name.decode()).resolve()
            if dep.exists():
                todo.append(dep)
    return seen


def build_key(source: Path, flags: Sequence[str]) -> str:
    """The hash that names a build: every file of sources(source), each
    with its name, and the flags."""
    h = hashlib.sha256()
    for path in sources(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(source: Path, extra_flags: Sequence[str] = ()) -> Tuple[Path, float]:
    """Compile ``source`` into csrc/build/ unless a library built from the
    same source and flags is already there. Returns (path, seconds spent
    compiling; 0.0 when it was already built). Safe to call from several
    threads or processes at once: each compiles to a temporary file and
    renames it into place."""
    source = Path(source)
    flags = (*NVCC_FLAGS, *extra_flags)
    lib = BUILD_DIR / f"lib{source.stem}_{build_key(source, flags)}.so"
    if lib.exists():
        return lib, 0.0
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builds agree on one file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, time.perf_counter() - t0
