"""Build and bind the port's hand-written CUDA kernels.

The sources under ``csrc/`` expose a plain C interface. At first use each is
compiled by its own ``nvcc`` process, all started together, and one more
``nvcc`` call links the objects into one shared library in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
bound with ``ctypes``. No PyTorch header is included, so the build takes
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

LAUNCHES = {"fps": 0, "knn": 0, "pool": 0, "pool_bwd": 0, "fps_pruned": 0,
            "cross_pool": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: (argtypes) of each extern "C" entry point; every one returns
# a cudaError_t as int
_SIGNATURES = {
    # xyz, B, N, M, blocks a cloud (G), out_idx, stream
    "kdpc_fps": (_P, _I, _I, _I, _I, _P, _P),
    # G, out count (no stream: an occupancy query)
    "kdpc_fps_clusters": (_I, _P),
    # as kdpc_fps: the rounds without their distance pass, for timing
    "kdpc_fps_skeleton": (_P, _I, _I, _I, _I, _P, _P),
    # query, keys, B, S, N, K, lanes, queries a block, out_idx, out_d2,
    # stream
    "kdpc_knn": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # u, idx, v, w, bias, B, N1, N2, K, C, out, stream
    "kdpc_pool": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    # u, idx, v, w, bias, ct, B, N1, N2, K, C, d_u, d_v, d_w, d_bias,
    # sel, share and hsign scratch, stream
    "kdpc_pool_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                      _P, _P, _P, _P, _P),
    # planes, pidx, centers, radii, xyz, B, N, M, out_idx, dirty, stream
    "kdpc_fps_pruned": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    # u, idx, v, wt, bias, B, N1, N2, K, C, L, out, stream
    "kdpc_cross_pool": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
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
    """Compile every source into one library (once per content hash): one
    nvcc process a source, all at once, then one link."""
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    work = BUILD_DIR / f"{out.stem}.tmp{os.getpid()}"
    work.mkdir(exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        obj, text = work / f"{src.stem}.o", work / f"{src.stem}.txt"
        with open(text, "w") as fd:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, text, subprocess.Popen(
                cmd, stdout=fd, stderr=subprocess.STDOUT)))
    logs = []
    for cmd, _, text, proc in jobs:
        rc = proc.wait()
        logs.append(text.read_text())
        if rc != 0:
            for *_, other in jobs:
                other.wait()
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                               f"{logs[-1]}")
    tmp = work / out.name
    cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(j[1]) for j in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    tmp.replace(out)
    shutil.rmtree(work, ignore_errors=True)
    text = "".join(logs)
    log.write_text(text)
    BUILD_INFO.update(path=str(out), seconds=seconds, cached=False, log=text)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is not None:
        return _lib
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
    current = None
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{t.device}")
        if current is None:
            current = torch.cuda.current_device()
        if t.device.index not in (None, current):
            raise ValueError(f"{name}: tensor is on {t.device}, current "
                             f"device is cuda:{current}")
