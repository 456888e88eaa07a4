"""The one seam between the port's CUDA C++ sources and Python: how a
source is built, loaded and launched, and what its error codes mean.

Every ``csrc/*.cu`` is a kernel source (``kernel_sources``). Each is
compiled with nvcc into csrc/build/ as a shared library with a plain C
interface, keyed by a hash of the source, the repository headers it
includes (``#include "..."``, found beside it, followed recursively) and
the flags, so a changed source, header or flag builds anew and an unchanged
one is reused; a failed build raises with nvcc's output. A wrapper module
under ops/cuda/ declares its source's entry points once in a ``Library``,
which builds and loads the library on first use, and launches an entry
point on torch's current stream with ``Library.launch``.

Every entry point returns a C int: 0, -1 for arguments outside what the
kernel takes, or a ``cudaError_t`` code; every library exports
``kernel_error_string`` (csrc/error_text.cuh), the text of a code.
Adding a kernel: a ``.cu`` in csrc/ that includes error_text.cuh, its
``Library`` (entry-point table) and checks in ops/cuda/<name>.py, and its
``launch.<counter>`` in utils/profiling.COUNTERS.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ...utils.profiling import count

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


def kernel_sources() -> List[Path]:
    """Every kernel source: the ``.cu`` files of csrc/, by name."""
    return sorted(CSRC.glob("*.cu"))


def build_all() -> Dict[str, Tuple[Path, float]]:
    """build() every kernel source, one nvcc process each, all at once.
    Returns {source file name: (library path, seconds spent compiling)};
    the first failed build raises."""
    srcs = kernel_sources()
    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(zip((s.name for s in srcs), pool.map(build, srcs)))


# argument types of the entry-point tables; STREAM is the cudaStream_t
# every launched entry point takes last
PTR, I32, I64, F32, STREAM = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                              ctypes.c_void_p)


class Library:
    """The shared library of one kernel source, built and loaded on first
    use (``load``). ``entries`` maps each entry point's name to its
    argument types; each is declared once, returning ``c_int``. An entry
    point that ``launch`` calls takes the stream (``STREAM``) last.
    ``on_load(functions, path)``, if given, runs once after loading (a
    layout check) and may raise."""

    def __init__(self, source: Path, entries: Dict[str, Sequence],
                 on_load: Optional[Callable[[Dict[str, Callable], Path], None]] = None):
        self.source = Path(source)
        self.entries = dict(entries)
        self.on_load = on_load
        self._functions: Optional[Dict[str, Callable]] = None

    def load(self) -> Dict[str, Callable]:
        """{entry point name: ctypes function}, and ``kernel_error_string``;
        builds the source first where it is not built yet. Calls that
        launch nothing (a plan query, a one-time init) take their function
        from here."""
        if self._functions is None:
            path, _ = build(self.source)
            lib = ctypes.CDLL(str(path))
            functions = {}
            for name, argtypes in self.entries.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
                functions[name] = fn
            text = lib.kernel_error_string
            text.argtypes, text.restype = [ctypes.c_int], ctypes.c_char_p
            functions["kernel_error_string"] = text
            if self.on_load is not None:
                self.on_load(functions, path)
            self._functions = functions
        return self._functions

    def error_text(self, code: int) -> str:
        return self.load()["kernel_error_string"](code).decode()

    def launch(self, name: str, device, *args, counter: str) -> None:
        """Call entry point ``name`` with ``args`` and torch's current
        stream on ``device``, inside ``torch.cuda.device(device)``. A
        non-zero code raises: -1 ``ValueError``, any other ``RuntimeError``,
        each with the library's text. Only a call that returned 0 adds one
        to ``counter`` (a ``launch.<kernel>`` of utils/profiling.COUNTERS)."""
        fn = (self._functions or self.load())[name]
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            kind = ValueError if err == -1 else RuntimeError
            raise kind(f"{name} kernel launch failed (error {err}: {self.error_text(err)})")
        count(counter, 1)
