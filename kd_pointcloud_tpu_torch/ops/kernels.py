"""Build and bind the port's hand-written CUDA kernels.

The sources under ``csrc/`` expose a plain C interface. They are compiled by
one ``nvcc`` call into one shared library, at first use, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
and bound with ``ctypes``. No PyTorch header is included, so the build takes
seconds, not the minutes a ``torch.utils.cpp_extension`` build would.

Each C entry point takes device pointers, sizes and the CUDA stream, launches
on that stream, does not synchronise, and returns ``cudaGetLastError()``; the
wrappers in ``ops/`` raise if it is not 0.

``LAUNCHES`` counts the launches of each kernel. A wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that a path really
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"fps": 0, "knn": 0, "pool": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: (argtypes) of each extern "C" entry point; every one returns
# a cudaError_t as int
_SIGNATURES = {
    # xyz, B, N, M, out_idx, stream
    "kdpc_fps": (_P, _I, _I, _I, _P, _P),
    # query, keys, B, S, N, K, out_idx, out_d2, stream
    "kdpc_knn": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    # u, idx, v, w, bias, B, N1, N2, K, C, out, stream
    "kdpc_pool": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return str(path)


def build() -> Path:
    """Compile every source into one library (once per content hash)."""
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libkdpc_kernels_{digest.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True,
                          log=log.read_text() if log.exists() else "")
        return out
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{text}")
    tmp.replace(out)
    log.write_text(text)
    BUILD_INFO.update(path=str(out), seconds=seconds, cached=False, log=text)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call entry point ``kdpc_<name>`` on the current stream and count it."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), f"kdpc_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int) -> None:
    """Validate a tensor handed to a kernel wrapper, on any device: the
    kernels take contiguous tensors of one dtype and rank, and the plain
    versions are held to the same contract so the CPU tests catch a caller
    that would break the kernel."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def check_on_card(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take tensors on the current CUDA device only."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{t.device}")
        if t.device.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"{name}: tensor is on {t.device}, current "
                             f"device is cuda:{torch.cuda.current_device()}")
