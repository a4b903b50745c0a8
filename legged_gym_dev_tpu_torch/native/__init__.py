"""Native (C++) host runtime of the port, driven through ctypes.

Counterpart of ``legged_gym_dev_tpu/native/__init__.py``: the tube-training
data loader (``csrc/tube_dataloader.cc``, the port's copy of the JAX
package's source with the same C ABI). The library is built with ``g++``
at first use into ``<repo>/build/native/``, under a name that carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. ``load_dataloader()`` returns None where
it cannot be built or loaded; callers then take the numpy loader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tube_dataloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the built library of the current source and flags lies."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtube_dataloader_{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_dataloader():
    """The ctypes-configured loader library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        lib.tdl_open.restype = ctypes.c_void_p
        lib.tdl_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.tdl_rows.restype = ctypes.c_int64
        lib.tdl_rows.argtypes = [ctypes.c_void_p]
        lib.tdl_row_dim.restype = ctypes.c_int
        lib.tdl_row_dim.argtypes = [ctypes.c_void_p]
        lib.tdl_target_dim.restype = ctypes.c_int
        lib.tdl_target_dim.argtypes = [ctypes.c_void_p]
        lib.tdl_start_epoch.restype = None
        lib.tdl_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.tdl_next_batch.restype = ctypes.c_int
        lib.tdl_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.tdl_close.restype = None
        lib.tdl_close.argtypes = [ctypes.c_void_p]
        lib.tdl_error.restype = ctypes.c_char_p
        lib.tdl_error.argtypes = []
        _lib = lib
        return _lib
