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
went through the kernels. A kernel built for several channel widths also
counts each launch under its width in ``WIDTH_LAUNCHES`` (key
``"<name> C=<width>"``), so a run can show which instances it went through.
A CUDA graph's capture launches nothing: its launches are taken back out of
the counters (``restore_launches``) and added again at each replay
(``add_launches``), so the counters keep counting kernels that ran.
``EVAL_GRAPHS`` counts how the eval forward (eval/graphs.py) answered its
requests: captures of a graph, requests answered by a replay (a capture's
own request among them) and requests run eagerly.

``kernel_work`` gives the operations and bytes a kernel's call needs on its
inputs (each input read once, each output written once), the numbers its
roofline bound is made of; also for the plain PyTorch cost volume
(nn/experimental.py PointConvFlow, "cost_volume"), which reports itself.
Inside ``counting()`` every kernel wrapper reports its launch's work with
``report``, and every plain version (marked with ``plain``) reports the same
numbers for its call while the aten ops it is made of are hidden from
dispatch modes such as FlopCounterMode: a count of a model's operations is
then the same on the CPU as on the card, where a ``ctypes`` launch is
invisible to dispatch. The pool backward's plain version is autograd of
``pool_plain``, which reports nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
WIDTH_LAUNCHES: dict = {}
EVAL_GRAPHS = {"captures": 0, "replays": 0, "eager": 0}

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
    # as kdpc_fps_pruned: the rounds without sphere tests and updates, for
    # timing (dirty not written)
    "kdpc_fps_pruned_skeleton": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                 _P),
    # u, idx, v, wt, bias, B, N1, N2, K, C, L, out, stream
    "kdpc_cross_pool": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}
_count = None          # the WorkCount of the innermost counting() block


def reset_launches() -> None:
    """Zero the launch counters and EVAL_GRAPHS."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    WIDTH_LAUNCHES.clear()
    for name in EVAL_GRAPHS:
        EVAL_GRAPHS[name] = 0


def restore_launches(before: tuple) -> tuple:
    """Set LAUNCHES and WIDTH_LAUNCHES back to before, a (LAUNCHES,
    WIDTH_LAUNCHES) pair of copies; returns what they counted since, as
    such a pair (a graph's capture: launches that did not run)."""
    launches = {n: c - before[0][n] for n, c in LAUNCHES.items()
                if c != before[0][n]}
    widths = {n: c - before[1].get(n, 0) for n, c in WIDTH_LAUNCHES.items()
              if c != before[1].get(n, 0)}
    LAUNCHES.update(before[0])
    WIDTH_LAUNCHES.clear()
    WIDTH_LAUNCHES.update(before[1])
    return launches, widths


def add_launches(counts: tuple) -> None:
    """Add restore_launches' pair to the counters (a graph's replay)."""
    for name, c in counts[0].items():
        LAUNCHES[name] += c
    for key, c in counts[1].items():
        WIDTH_LAUNCHES[key] = WIDTH_LAUNCHES.get(key, 0) + c


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


def launch(name: str, *args, width: int | None = None) -> None:
    """Call entry point ``kdpc_<name>`` on the current stream and count it,
    also under its channel width when one is given."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), f"kdpc_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
    if width is not None:
        key = f"{name} C={width}"
        WIDTH_LAUNCHES[key] = WIDTH_LAUNCHES.get(key, 0) + 1


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


def mask_entries(u, idx, v, weight, bias) -> int:
    """The (query, neighbour, output channel) entries of a pool call where
    leaky(p) is its query's max over the neighbours: B N1 C without ties."""
    from .gather import group_points
    from .pool_fused import leaky

    with torch.no_grad():
        p = leaky(torch.nn.functional.linear(
            leaky(group_points(u, idx) + v[:, :, None, :]), weight, bias))
        return int((p == p.amax(dim=2, keepdim=True)).sum())


def kernel_work(name: str, *args) -> tuple:
    """(operations, bytes) that kernel ``name`` needs on these arguments
    (those of its wrapper; fps_pruned also takes the sub-block updates its
    data needed): each input read once, each output written once."""
    if name == "fps":
        xyz, m = args
        B, N, _ = xyz.shape
        # per point and round: 3 sub, 3 mul, 2 add, 1 min, 1 compare
        return B * (m - 1) * N * 10, B * N * 12 + B * m * 4
    if name == "knn":
        k, xyz, q = args
        B, S, N = q.shape[0], q.shape[1], xyz.shape[1]
        # per pair: 3 mul + 2 add (q.k), 1 mul, 1 sub, 1 add, 1 compare
        return B * S * N * 9, (B * S + B * N) * 12 + B * S * k * 8
    if name == "fps_pruned":
        # dirty: the sub-block updates this run's data needed (all clouds);
        # per round and sub-block the sphere test (3 sub, 5 mul, 4 add,
        # sqrt, compare) and the fold's compare, per point of an updated
        # sub-block FPS's 10
        xyz, m, dirty = args
        B, N, _ = xyz.shape
        return (B * (m - 1) * (N // 128) * 15 + dirty * 128 * 10,
                B * N * 12 + B * m * 4)
    if name == "cross_pool":
        # per (query, neighbour): C add + C leaky, L x (C x C multiply-add,
        # C bias, C leaky), C max; reads u, v, idx, L weights and biases
        u, v, idx, ws = args[:4]
        B, N2, C = u.shape
        N1, K = idx.shape[1:]
        L = len(ws)
        return (B * N1 * K * (3 * C + L * (2 * C * C + 2 * C)),
                (B * N2 * C + 2 * B * N1 * C + L * (C * C + C) + B * N1 * K)
                * 4)
    if name == "cost_volume":
        # nn/experimental.py PointConvFlow, plain PyTorch: its two kNN
        # searches (cloud 2, then cloud 1's own); per (query, neighbour)
        # both directions (3 sub each), the MLP over [g1, g2, dxyz] (each
        # layer's multiply-add, bias, leaky), two WeightNets 3 -> 8 -> 8 ->
        # C (multiply-add, bias, ReLU) and two weighted sums (2 C each).
        # Reads both clouds, both feature maps and the weights, writes the
        # (B, N1, C) cost.
        k, widths, xyz1, xyz2, points1 = args
        B, N1, D = points1.shape
        N2 = xyz2.shape[1]
        C = widths[-1]
        dims = [2 * D + 3, *widths]
        mlp = sum(2 * a * b + 2 * b for a, b in zip(dims, dims[1:]))
        wn = sum(2 * a * b + 2 * b for a, b in zip((3, 8, 8), (8, 8, C)))
        params = (sum(a * b + b for a, b in zip(dims, dims[1:]))
                  + 2 * (3 * 8 + 8 + 8 * 8 + 8 + 8 * C + C))
        return (9 * B * N1 * (N2 + N1) + B * N1 * k * (6 + mlp + 2 * wn
                                                       + 4 * C),
                (B * (N1 + N2) * (3 + D) + params + B * N1 * C) * 4)
    if name not in ("pool", "pool_bwd"):
        raise ValueError(f"no work count for kernel {name!r}")
    u, idx, v, w, b = args[:5]
    B, N2, C = u.shape
    N1, K = idx.shape[1:]
    if name == "pool":
        # per (query, neighbour): C add + C leaky, C x C multiply-add,
        # C bias + C leaky + C max
        return (B * N1 * K * (2 * C * C + 5 * C),
                (B * N2 * C + 2 * B * N1 * C + C * C + C + B * N1 * K) * 4)
    # pool_bwd. Dense, per (query, neighbour): the forward's 2 C^2 + 5 C
    # again (recomputed: the forward saves only its inputs), the max mask
    # (C compares, C counts) and d_g = d_h0 leaky', d_v, d_u (3 C). d_p is
    # nonzero only in the mask -- one neighbour a (query, output channel),
    # more only where maxima tie exactly -- so d_h0 = d_p w, d_w += d_p^T h0
    # (2 C each) and d_bias (1) count at the mask's entries on these inputs.
    # Reads u, idx, v, w, bias, ct, writes d_u, d_v, d_w, d_bias.
    return (B * N1 * K * (2 * C * C + 10 * C) + mask_entries(*args[:5])
            * (4 * C + 1),
            (2 * B * N2 * C + B * N1 * K + 3 * B * N1 * C + 2 * C * C
             + 2 * C) * 4)


# reported calls of plain PyTorch whose operations dispatch modes see
# (FlopCounterMode counts their products): counted by name, left out of
# the totals, which are the kernels' work that dispatch cannot see
VISIBLE = ("cost_volume",)


class WorkCount:
    """Calls, operations and bytes by kernel name, from kernel_work, of the
    kernel launches and plain-version calls inside one counting() block
    (and of the VISIBLE calls, outside the totals)."""

    def __init__(self):
        self.calls: dict = {}
        self.ops: dict = {}
        self.bytes: dict = {}

    def add(self, name: str, ops: int, nbytes: int) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.ops[name] = self.ops.get(name, 0) + ops
        self.bytes[name] = self.bytes.get(name, 0) + nbytes

    @property
    def total_ops(self) -> int:
        return sum(v for n, v in self.ops.items() if n not in VISIBLE)

    @property
    def total_bytes(self) -> int:
        return sum(v for n, v in self.bytes.items() if n not in VISIBLE)


@contextlib.contextmanager
def counting():
    """Count the work of every kernel launch and plain-version call in the
    block; yields the WorkCount. Blocks nest; the innermost one counts."""
    global _count
    outer, _count = _count, WorkCount()
    try:
        yield _count
    finally:
        _count = outer


@contextlib.contextmanager
def uncounted():
    """While a count is on, hide the block's aten ops from dispatch modes
    (FlopCounterMode): a plain version's ops are its kernel's work, which
    it reports itself."""
    if _count is None:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def is_counting() -> bool:
    """Whether a counting() block is on."""
    return _count is not None


def report(name: str, *args) -> None:
    """Add kernel_work(name, *args) to the active count, if there is one."""
    if _count is not None:
        with uncounted():
            _count.add(name, *kernel_work(name, *args))


def plain(name: str):
    """Mark fn as kernel ``name``'s plain version: inside counting() it
    reports kernel_work(name, *its arguments) and runs uncounted."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args):
            if _count is None:
                return fn(*args)
            report(name, *args)
            with uncounted():
                return fn(*args)
        return run
    return wrap
