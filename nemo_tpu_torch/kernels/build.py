"""Build and load the port's CUDA kernels.

Each source ``nemo_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  Libraries go to ``nemo_tpu_torch/build/`` (listed in
``.gitignore``), named by a digest of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing is built at import:
the first call that launches a kernel builds it, and ``build()`` builds
several sources at once, one ``nvcc`` process each, all started together.
``load`` and ``build`` hold one process-wide lock, so that two threads'
first launches build and open a library once.

``KernelError`` is the type of a wrapper's failed launch (CUDA's error
string in its text) and ``BuildError`` that of a failed build, so that the
scheduler never reads a kernel's fault or a compiler's "out of memory" as a
lane's out-of-memory failure; ``count_launch`` bumps a wrapper's
``launches`` count under a lock, since two lanes may launch at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

#: Every kernel source of the port, by name (csrc/<name>.cu).
SOURCES = ("closure", "edge_wave")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()
#: per thread: the libraries this thread built or opened (``thread_loads``)
_TLS = threading.local()
_COUNT_LOCK = threading.Lock()


class BuildError(RuntimeError):
    """A kernel or host library could not be built or loaded (the
    compiler's output in the text)."""


class KernelError(RuntimeError):
    """A kernel wrapper's launch failed: the kernel's own error return,
    never an out-of-memory of the lane (a RuntimeError subclass, so callers
    that caught RuntimeError still do)."""


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``: its ``launches`` attribute + 1, locked."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def thread_loads() -> int:
    """How many kernel libraries this thread has built or opened: a change
    across a call says the call paid for a build or a load."""
    return getattr(_TLS, "loads", 0)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found (no CUDA toolkit on PATH or under /usr/local/cuda)")


def source_digest(name: str) -> str:
    """The build digest of csrc/<name>.cu: its source and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    return hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_digest(name)}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, all in parallel.
    Returns name -> the compiler's report (ptxas register/shared-memory
    lines; "" for a library that was already built).  Raises on any
    compiler failure, with its output."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names: tuple[str, ...]) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        output, _ = proc.communicate()
        reports[name] = output
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise BuildError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                build((name,))
                lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
                _TLS.loads = thread_loads() + 1
    return lib
