"""Build and load the port's host C++ libraries (g++, not nvcc).

A source under ``nemo_tpu_torch/csrc/host/`` is compiled with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into ``nemo_tpu_torch/build/`` (listed
in ``.gitignore``), named by a digest of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  The build writes to
a temporary name and renames, so several processes may race to build the
same library safely.  Nothing is built at import: the first load builds.

Unlike the JAX package's loader, nothing here degrades: a missing source, a
compiler failure (its output included), a library that does not load or an
ABI mismatch raises ``BuildError`` (a RuntimeError).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import uuid
from pathlib import Path
from typing import Callable

from nemo_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, BuildError

HOST_SRC_DIR = CSRC_DIR / "host"

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build_shared_lib(src: Path) -> Path:
    """Compile ``src`` into the build directory unless its library is there
    already; returns the library's path.  Raises with the compiler's output
    on failure."""
    src = Path(src)
    try:
        code = src.read_bytes()
    except OSError as ex:
        raise BuildError(f"host library source {src} unreadable: {ex}") from ex
    digest = hashlib.sha256(code + "\0".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as ex:
        raise BuildError(f"g++ could not run for {src.name}: {ex}") from ex
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(
            f"g++ failed for {src.name} (rc {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


class NativeLib:
    """One host library: built, loaded, ABI-checked and bound on first
    ``load()``, then cached.  Every failure raises."""

    def __init__(
        self, src: Path, bind: Callable[[ctypes.CDLL], None], abi_symbol: str, abi_version: int
    ) -> None:
        self.src = Path(src)
        self._bind = bind
        self._abi_symbol = abi_symbol
        self._abi_version = abi_version
        self._lib: ctypes.CDLL | None = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            path = build_shared_lib(self.src)
            try:
                lib = ctypes.CDLL(str(path))
                abi = getattr(lib, self._abi_symbol)
            except (OSError, AttributeError) as ex:
                raise BuildError(f"host library {path} does not load: {ex}") from ex
            abi.restype = ctypes.c_int
            got = abi()
            if got != self._abi_version:
                raise BuildError(
                    f"host library {path}: ABI {got}, expected {self._abi_version}"
                )
            self._bind(lib)
            self._lib = lib
        return self._lib
