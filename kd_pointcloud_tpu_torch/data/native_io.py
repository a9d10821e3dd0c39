"""ctypes bindings for the native IO core (native/kdpc_io.cpp).

The port's copy of kd_pointcloud_tpu/data/native_io.py. At first use it
compiles native/kdpc_io.cpp with the host's C++ compiler into
build/native/ at the root of the checkout (listed in .gitignore; the file
name carries the source's hash), and exposes:
  * npy_info(path) -> shape tuple
  * npy_read(path) -> float32 ndarray
  * read_batch(paths) -> list of float32 ndarrays, read by a C++ thread
    pool with the GIL released.

This is host IO, not a kernel: when no compiler or library is available it
falls back to numpy, which reads the same arrays; available() says which
reader runs. Imports no torch, so data-loader workers never touch CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "kdpc_io.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build() -> Path:
    """Compile the source once per content hash; returns the library."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libkdpc_io_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++ or c++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    tmp.replace(out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return None
    lib.kdpc_npy_info.restype = ctypes.c_int
    lib.kdpc_npy_info.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_long),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.kdpc_npy_read_f32.restype = ctypes.c_long
    lib.kdpc_npy_read_f32.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_long]
    lib.kdpc_read_batch_f32.restype = ctypes.c_int
    lib.kdpc_read_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native reader runs, False on the numpy fallback."""
    return _load() is not None


def npy_info(path: str) -> Tuple[int, ...]:
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, _, _ = np.lib.format._read_array_header(f, version)
        return shape
    shape = (ctypes.c_long * 8)()
    ndim = ctypes.c_int()
    rc = lib.kdpc_npy_info(path.encode(), shape, ctypes.byref(ndim))
    if rc != 0:
        raise IOError(f"kdpc_npy_info({path}) failed: {rc}")
    return tuple(shape[i] for i in range(ndim.value))


def npy_read(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        return np.load(path).astype(np.float32)
    shape = npy_info(path)
    out = np.empty(shape, dtype=np.float32)
    n = lib.kdpc_npy_read_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size)
    if n != out.size:
        raise IOError(f"kdpc_npy_read_f32({path}) returned {n}")
    return out


def read_batch(paths: Sequence[str], n_threads: int = 8) -> List[np.ndarray]:
    """Read many npy files concurrently (C++ thread pool)."""
    lib = _load()
    if lib is None:
        return [np.load(p).astype(np.float32) for p in paths]
    shapes = [npy_info(p) for p in paths]
    outs = [np.empty(s, dtype=np.float32) for s in shapes]
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for o in outs])
    caps = (ctypes.c_long * n)(*[o.size for o in outs])
    counts = (ctypes.c_long * n)()
    rc = lib.kdpc_read_batch_f32(c_paths, n, c_outs, caps, counts, n_threads)
    if rc != 0:
        bad = [paths[i] for i in range(n) if counts[i] < 0]
        raise IOError(f"native batch read failed for {bad}")
    return outs
