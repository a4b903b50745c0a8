"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/*.cu`` file is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. Libraries are cached in ``<repo>/build/torch_kernels/`` under a
name that carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: str) -> tuple[Path, str]:
    """Compiles ``csrc/<source>`` unless a library of the same source and
    flags exists. Returns the library's path and the compiler's report
    (registers and spills per kernel; empty when the library was cached)."""
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    with _lock:
        if source not in _loaded:
            path, _ = build(source)
            _loaded[source] = ctypes.CDLL(str(path))
        return _loaded[source]


class Kernel:
    """One CUDA entry point of ``csrc/<source>`` with its launch count (a
    plain integer the wrappers add one to per launch). The C function takes
    ``n_ptr`` pointers, ``n_int`` ints and the stream, and returns the
    CUDA error of the launch."""

    def __init__(self, source: str, symbol: str, n_ptr: int, n_int: int):
        self.source = source
        self.symbol = symbol
        self.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                         + [ctypes.c_void_p])
        self.launches = 0
        self._fn = None

    def function(self):
        """The bound C function, built and loaded at first use. Calling it
        directly launches without the wrapper's checks and counts nothing
        (for timing the kernel alone)."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, ptrs, ints, device):
        import torch

        self.function()
        stream = torch.cuda.current_stream(device).cuda_stream
        if device.index is None or device.index == torch.cuda.current_device():
            err = self._fn(*ptrs, *ints, stream)
        else:
            with torch.cuda.device(device):
                err = self._fn(*ptrs, *ints, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
