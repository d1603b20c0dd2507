"""Build and load the port's hand-written CUDA kernels.

Each source ``protnote_tpu_torch/csrc/<name>.cu`` exposes a plain C
interface.  The first call to :func:`load_kernel_library` compiles it with
``nvcc`` for ``sm_90a`` into a shared library under
``protnote_tpu_torch/_build/`` (listed in ``.gitignore``), named after a hash
of the source, every shared header ``csrc/*.cuh`` and the flags, so that an
edited source or header is rebuilt, and loads it with ``ctypes``.  Nothing
is built at import time: the CPU tests import every module of the port on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was found
    build_log: str  # nvcc/ptxas output: registers, shared memory, spills


_locks_guard = threading.Lock()
_locks: Dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_loaded: Dict[str, KernelLibrary] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source at first use and need the CUDA toolkit"
    )


def source_digest(name: str) -> str:
    """The build's name tag: a hash of ``csrc/<name>.cu``, every
    ``csrc/*.cuh`` (a source may include any of them) and the nvcc flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_kernel_library(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` if needed, load it, and return it.  Calls
    for different names may run at once (each runs its own nvcc)."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}_{source_digest(name)}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
            os.replace(tmp, out)
        _loaded[name] = KernelLibrary(ctypes.CDLL(str(out)), out, seconds, log)
        return _loaded[name]


_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def kernel_function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name`` (built at first
    use), its ctypes signature (``argtypes``, an int result: the CUDA error)
    set once, when it is first looked up, not on every launch."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load_kernel_library(name).lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def call_on_stream(device, fn, *args) -> int:
    """``fn(*args, stream)``: a C entry point called with the raw handle of
    the current stream of ``device`` (a ``torch.device`` or its index), the
    thread's device switched only where it is another (the launch goes to
    the thread's device).  The handle comes from
    ``torch._C._cuda_getCurrentRawStream``, which builds no Python stream
    object: a launch's host time is mostly such lookups."""
    idx = device if isinstance(device, int) else device.index
    if idx is None:
        idx = torch.cuda.current_device()
    if torch._C._cuda_getDevice() == idx:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
