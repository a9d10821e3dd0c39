"""Time this tree's kernels against an earlier design's, at the call sites of
the eval forward (batch 1), the train step (batch 3) and the KD step (batch
8), on one card, in turns.

    python -m kd_pointcloud_tpu_torch.ops.kernel_ab --other DIR \\
        [--kernels fps,pool] [--out ab.json]

DIR holds the other design's sources of the kernels named (``fps.cu`` and
``pool_fused.cu`` by default; ``knn.cu`` and ``pool_fused_bwd.cu`` for
``--kernels knn,pool_bwd``; ``fps_pruned.cu`` and ``cross_pool.cu`` for
the attic kernels, ``--kernels fps_pruned,cross_pool``), e.g. the files of
an earlier commit written out with ``git show``. Their entry points are
bound as ``OTHER_SIGNATURES`` says: ``kdpc_fps`` without the
blocks-a-cloud argument, ``kdpc_pool`` as now, ``kdpc_knn`` /
``kdpc_pool_bwd`` as they were before the kNN launch plan and the sign
scratch, and ``kdpc_fps_pruned`` / ``kdpc_cross_pool`` as now. They are
compiled by their own ``nvcc`` processes into a second library beside the
port's.

The call sites are recorded from a teacher (seed 0) on seeded synthetic
8192-point pairs: those of a batch-1 inference forward and of batch-3 and
batch-8 train-mode forwards (seeded cotangents for the pool backward). A
KD step runs the batch-8 forward sites twice (teacher and student share
the shapes and the clouds) and the pool backward once. At each site the
other design and this one are held against each other (FPS, kNN and the
pool forward bit for bit; the pool backward within 1e-4 of each output's
max |other|: both sum by float atomics) and timed with CUDA events, REPS
launches after a warm-up each, in the order other, this, this, other; a
design's time is the mean of its two turns. Beside those event times, each
design's device time at the site (its own kernels, by torch.profiler over
REPS calls), which the host does not set. The other design is called with
its own wrapper's host work (checks, output buffers), so sites that are
too small to keep the card busy compare like with like. At the pool
forward's sites the plain composition (pool_plain: gather, cuBLAS linear,
amax) is timed too; at the FPS sites every cluster size G and the rounds'
synchronisation skeleton (kdpc_fps_skeleton, no distance pass: the chain)
at each G. The attic kernels, which no path runs, are timed where the
path kernels they stand beside run: pruned FPS at each path's FPS site
(indices and sub-block updates held equal; beside it the FPS kernel and
the pruned rounds' skeleton, kdpc_fps_pruned_skeleton, its chain), the
cross pool at L = 1 at the eval forward's pool sites (also held bit-equal
to the pool kernel, which is timed beside it) and at L = 2 at one of them
a width (a seeded second layer); the plain version at each. Last, one call
of this design at every site of a path runs under torch.profiler, for its
device time by kernel name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..attic import cross_pool as cross_mod
from ..attic import fps_pruned as pruned_mod
from . import fps as fps_mod
from . import kernels
from . import knn as knn_mod
from . import pool_fused as pool_mod

REPS = 20
TOL = 1e-4
KERNELS = ("fps", "knn", "pool", "pool_bwd", "fps_pruned", "cross_pool")
SOURCES = {"fps": "fps.cu", "knn": "knn.cu", "pool": "pool_fused.cu",
           "pool_bwd": "pool_fused_bwd.cu", "fps_pruned": "fps_pruned.cu",
           "cross_pool": "cross_pool.cu"}
_P, _I = ctypes.c_void_p, ctypes.c_int
OTHER_SIGNATURES = {
    # xyz, B, N, M, out_idx, stream
    "fps": ("kdpc_fps", (_P, _I, _I, _I, _P, _P)),
    # query, keys, B, S, N, K, out_idx, out_d2, stream
    "knn": ("kdpc_knn", (_P, _P, _I, _I, _I, _I, _P, _P, _P)),
    # u, idx, v, w, bias, B, N1, N2, K, C, out, stream
    "pool": ("kdpc_pool", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P)),
    # u, idx, v, w, bias, ct, B, N1, N2, K, C, d_u, d_v, d_w, d_bias, sel,
    # share, stream
    "pool_bwd": ("kdpc_pool_bwd", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _P, _P, _P, _P, _P, _P, _P)),
    # planes, pidx, centers, radii, xyz, B, N, M, out_idx, dirty, stream
    "fps_pruned": ("kdpc_fps_pruned", (_P, _P, _P, _P, _P, _I, _I, _I, _P,
                                       _P, _P)),
    # u, idx, v, wt, bias, B, N1, N2, K, C, L, out, stream
    "cross_pool": ("kdpc_cross_pool", (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _P, _P)),
}
# a kernel's own CUDA kernels by name (the profiler's demangled names)
NAME_RE = {"fps": r"(?<![A-Za-z_])fps_kernel",
           "knn": r"(?<![A-Za-z_])knn_kernel",
           "pool": r"(?<![A-Za-z_])pool_kernel",
           "pool_bwd": r"(?<![A-Za-z_])pool_bwd",
           "fps_pruned": r"(?<![A-Za-z_])fps_pruned_kernel",
           "cross_pool": r"(?<![A-Za-z_])cross_pool_kernel"}
# launches a step of each path at a recorded site (the attic kernels, on
# no path: one a site)
COUNTS = {"eval forward": dict(fps=1, knn=1, pool=1, pool_bwd=1),
          "train step": dict(fps=1, knn=1, pool=1, pool_bwd=1),
          "KD step": dict(fps=2, knn=2, pool=2, pool_bwd=1)}
ATTIC_COUNT = 1
# the rows of a kernel: the cross pool's at L = 1 and at L = 2
ROWS = {"cross_pool": ("cross_pool", "cross_pool L=2")}


def build_other(src_dir: Path, names) -> ctypes.CDLL:
    """The other design's sources in one library, one nvcc a source."""
    out = kernels.BUILD_DIR.parent / "kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    objs, procs = [], []
    for name in names:
        obj = out / f"other_{name}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(obj),
             str(src_dir / SOURCES[name])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other design:\n{text}")
    lib_path = out / "libother.so"
    subprocess.run([nvcc, *kernels.LINK_FLAGS, "-o", str(lib_path), *objs],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in names:
        entry, argtypes = OTHER_SIGNATURES[name]
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _call(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"other design: cudaError {err}")


def other_fps(lib, xyz, npoint):
    """The earlier wrapper's host work (checks, outputs) around the other
    library's kernel, so that host-bound sites compare like with like."""
    fps_mod._check(xyz, npoint)
    kernels.check_on_card("fps", xyz)
    B, N, _ = xyz.shape
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    _call(lib.kdpc_fps, xyz.data_ptr(), B, N, npoint, out.data_ptr())
    return out


def other_knn(lib, k, xyz, query):
    knn_mod._check(k, xyz, query)
    kernels.check_on_card("knn", xyz, query)
    if k not in knn_mod.KERNEL_K:
        raise ValueError(f"knn kernel takes 1 <= k <= {knn_mod.MAX_K}, "
                         f"got {k}")
    B, N, _ = xyz.shape
    S = query.shape[1]
    idx = torch.empty(B, S, k, dtype=torch.int32, device=xyz.device)
    d2 = torch.empty(B, S, k, dtype=torch.float32, device=xyz.device)
    _call(lib.kdpc_knn, query.data_ptr(), xyz.data_ptr(), B, S, N, k,
          idx.data_ptr(), d2.data_ptr())
    return d2, idx


def other_pool(lib, u, idx, v, weight, bias):
    pool_mod._check(u, idx, v, weight, bias)
    kernels.check_on_card("pool", u, idx, v, weight, bias)
    B, N2, C = u.shape
    _, N1, K = idx.shape
    out = torch.empty(B, N1, C, dtype=torch.float32, device=u.device)
    _call(lib.kdpc_pool, u.data_ptr(), idx.data_ptr(), v.data_ptr(),
          weight.data_ptr(), bias.data_ptr(), B, N1, N2, K, C,
          out.data_ptr())
    return out


def other_pool_bwd(lib, u, idx, v, weight, bias, ct):
    pool_mod._check(u, idx, v, weight, bias)
    kernels.check_tensor("pool_bwd ct", ct, torch.float32, 3)
    kernels.check_on_card("pool_bwd", u, idx, v, weight, bias, ct)
    B, N2, C = u.shape
    _, N1, K = idx.shape
    f32 = dict(dtype=torch.float32, device=u.device)
    d_u, d_v = torch.zeros(B, N2, C, **f32), torch.empty(B, N1, C, **f32)
    d_w, d_b = torch.zeros(C, C, **f32), torch.zeros(C, **f32)
    sel = torch.empty(B, N1, C, 2, dtype=torch.int32, device=u.device)
    share = torch.empty(B, N1, C, **f32)
    _call(lib.kdpc_pool_bwd, u.data_ptr(), idx.data_ptr(), v.data_ptr(),
          weight.data_ptr(), bias.data_ptr(), ct.data_ptr(), B, N1, N2, K, C,
          d_u.data_ptr(), d_v.data_ptr(), d_w.data_ptr(), d_b.data_ptr(),
          sel.data_ptr(), share.data_ptr())
    return d_u, d_v, d_w, d_b


def other_fps_pruned(lib, xyz, npoint):
    pruned_mod._check(xyz, npoint)
    kernels.check_on_card("fps_pruned", xyz)
    B, N, _ = xyz.shape
    lay = pruned_mod.spatial_permutation(xyz)
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    dirty = torch.zeros(B, dtype=torch.int32, device=xyz.device)
    _call(lib.kdpc_fps_pruned, lay.planes.data_ptr(), lay.pidx.data_ptr(),
          lay.centers.data_ptr(), lay.radii.data_ptr(), xyz.data_ptr(), B, N,
          npoint, out.data_ptr(), dirty.data_ptr())
    return out, dirty.long()


def other_cross_pool(lib, u, v, idx, weights, biases):
    cross_mod._check(u, v, idx, weights, biases)
    B, N2, C = u.shape
    _, N1, K = idx.shape
    wt = torch.stack([w.t() for w in weights]).float().contiguous()
    bias = torch.stack(list(biases)).float().contiguous()
    kernels.check_on_card("cross_pool", u, v, idx, wt, bias)
    out = torch.empty(B, N1, C, dtype=torch.float32, device=u.device)
    _call(lib.kdpc_cross_pool, u.data_ptr(), idx.data_ptr(), v.data_ptr(),
          wt.data_ptr(), bias.data_ptr(), B, N1, N2, K, C, len(weights),
          out.data_ptr())
    return out


def fps_pruned_skeleton(xyz, npoint, lay=None):
    """The pruned FPS rounds' folds, slots and barriers without sphere tests
    and updates: its chain. lay: the clouds' layout, made here unless
    given (the layout's torch ops take more host time than the chain)."""
    B, N, _ = xyz.shape
    lay = pruned_mod.spatial_permutation(xyz) if lay is None else lay
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    err = kernels.lib().kdpc_fps_pruned_skeleton(
        lay.planes.data_ptr(), lay.pidx.data_ptr(), lay.centers.data_ptr(),
        lay.radii.data_ptr(), xyz.data_ptr(), B, N, npoint, out.data_ptr(),
        None, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fps_pruned skeleton: cudaError {err}")
    return out


def fps_skeleton(xyz, npoint, blocks):
    """The FPS rounds' synchronisation without their distance pass."""
    B, N, _ = xyz.shape
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    err = kernels.lib().kdpc_fps_skeleton(
        xyz.data_ptr(), B, N, npoint, blocks, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fps skeleton: cudaError {err}")
    return out


def record_sites(model, batch, train: bool):
    """{kernel: [arguments of each call]} of one teacher forward on a
    seeded batch."""
    from ..train.overfit import synthetic_batches

    data = synthetic_batches(1, batch, 8192, 100 + batch, "cuda")[0]
    store = {"fps": [], "knn": [], "pool": []}
    entries = {"fps": (fps_mod, "_fps_cuda"), "knn": (knn_mod, "_knn_cuda"),
               "pool": (pool_mod, "_pool_card")}
    saved = {n: getattr(m, a) for n, (m, a) in entries.items()}

    def recorder(name):
        def run(*args):
            store[name].append(tuple(a.detach().clone() if torch.is_tensor(a)
                                     else a for a in args))
            return saved[name](*args)
        return run

    try:
        for n, (m, a) in entries.items():
            setattr(m, a, recorder(n))
        model.train(train)
        with torch.no_grad():
            model(data["pos1"], data["pos2"], data["norm1"], data["norm2"])
    finally:
        for n, (m, a) in entries.items():
            setattr(m, a, saved[n])
    return store


def cuda_ms(fn, reps=REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def site_name(name, args) -> str:
    if name in ("fps", "fps_pruned"):
        return f"B={args[0].shape[0]} {args[0].shape[1]}->{args[1]}"
    if name == "knn":
        k, xyz, q = args
        return f"k={k} B={q.shape[0]} {q.shape[1]}x{xyz.shape[1]}"
    if name == "cross_pool":
        u, _, idx, ws = args[:4]
        return (f"B={u.shape[0]} N={idx.shape[1]} K={idx.shape[2]} "
                f"C={u.shape[2]} L={len(ws)}")
    u, idx = args[0], args[1]
    return (f"B={u.shape[0]} N={idx.shape[1]} K={idx.shape[2]} "
            f"C={u.shape[2]}")


def compare(name, args, new, other):
    """Hold the two designs against each other at one site; returns the
    max abs difference."""
    with torch.inference_mode(name != "pool_bwd"):
        a, b = new(*args), other(*args)
    if name != "pool_bwd":
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"{name} {site_name(name, args)}: the designs "
                               "differ")
        return 0.0
    worst = 0.0
    for x, y in zip(a, b):
        err = float((x - y).abs().max())
        if err > TOL * float(y.abs().max()):
            raise RuntimeError(f"pool_bwd {site_name(name, args)}: {err}")
        worst = max(worst, err)
    return worst


def device_ms(fn, pattern, reps=REPS) -> float:
    """Device time a call of the CUDA kernels whose names match pattern
    (every kernel where it is None), from torch.profiler over reps calls:
    the kernels' time without the host's, which sets the event time of the
    smallest sites. A trace that lost events reads low: its kernel count
    is not a whole number of calls, or its time is short; so the larger of
    two traces with whole counts is taken (up to 5 tries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    totals = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (pattern is None or re.search(pattern, e.key))]
        launches = sum(e.count for e in rows)
        if launches and launches % reps == 0:
            totals.append(sum(e.self_device_time_total for e in rows))
            if len(totals) == 2:
                break
    if not totals:
        raise RuntimeError("the profiler lost events in every trace")
    return max(totals) / 1e3 / reps


def device_ms_by_kernel(fns, sites, names):
    """This design's device time by CUDA kernel name over one call at each
    site, from torch.profiler (a wrapper may launch more than one
    kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pattern = "|".join(NAME_RE[n] for n in names)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name in names:
            with torch.no_grad():
                for a in sites[name]:
                    fns[name](*a)
        torch.cuda.synchronize()
    out = {e.key: e.self_device_time_total / 1e3
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and re.search(pattern, e.key)}
    for key, ms in sorted(out.items(), key=lambda kv: -kv[1]):
        print(f"    device {ms:8.4f} ms  {key[:100]}", flush=True)
    return out


def extra_fps(args, pattern):
    """Every cluster size at one FPS site (device ms, bit-identical to the
    plan's choice) and the synchronisation skeleton's device ms at each."""
    xyz, m = args
    want = fps_mod._fps_cuda(xyz, m)
    by_g, skeleton = {}, {}
    for g in fps_mod.CLUSTER_SIZES:
        if g * xyz.shape[0] > fps_mod.SMS:
            continue
        got = fps_mod._fps_cuda(xyz, m, g)
        if not torch.equal(got, want):
            raise RuntimeError(f"fps G={g} {site_name('fps', args)} differs")
        by_g[g] = device_ms(lambda: fps_mod._fps_cuda(xyz, m, g), pattern)
        skeleton[g] = device_ms(lambda: fps_skeleton(xyz, m, g), pattern)
    print(f"    fps by G (device ms): {by_g}; skeleton: {skeleton}",
          flush=True)
    return dict(device_ms_by_g=by_g, skeleton_device_ms_by_g=skeleton,
                plan_g=fps_mod.fps_plan(xyz.shape[0], xyz.shape[1],
                                        fps_mod.card_clusters))


def extra_pool(args):
    """The plain composition at one pool site: event and device ms."""
    fn = lambda: pool_mod.pool_plain(*args)     # noqa: E731
    return dict(plain_ms=cuda_ms(fn), plain_device_ms=device_ms(fn, None))


def extra_fps_pruned(args):
    """Beside pruned FPS at one site: the path's FPS kernel there (its
    indices held equal; event and device ms) and the pruned rounds'
    skeleton (device ms: the chain)."""
    xyz, m = args
    fps = lambda: fps_mod._fps_cuda(xyz, m)     # noqa: E731
    if not torch.equal(fps(), pruned_mod._fps_pruned_cuda(xyz, m)):
        raise RuntimeError(f"fps_pruned {site_name('fps', args)}: differs "
                           "from the FPS kernel")
    return dict(fps_kernel_ms=cuda_ms(fps),
                fps_kernel_device_ms=device_ms(fps, NAME_RE["fps"]),
                chain_device_ms=device_ms(
                    lambda: fps_pruned_skeleton(xyz, m),
                    NAME_RE["fps_pruned"]))


def extra_cross_pool(args):
    """Beside the cross pool at one site: its plain version (event and
    device ms) and, at L = 1, the pool kernel, held bit-equal to it."""
    u, v, idx, ws, bs = args
    plain = lambda: cross_mod.cross_pool_plain(*args)     # noqa: E731
    out = dict(plain_ms=cuda_ms(plain), plain_device_ms=device_ms(plain, None))
    if len(ws) == 1:
        pool = lambda: pool_mod._pool_cuda(u, idx, v, ws[0], bs[0])  # noqa
        if not torch.equal(pool(), cross_mod._cross_pool_cuda(*args)):
            raise RuntimeError(f"cross_pool {site_name('cross_pool', args)}: "
                               "differs from the pool kernel at L = 1")
        out.update(pool_kernel_ms=cuda_ms(pool),
                   pool_kernel_device_ms=device_ms(pool, NAME_RE["pool"]))
    return out


def attic_sites(sites, path, gen):
    """The attic kernels' sites beside a path's recorded ones: pruned FPS at
    its FPS sites; the cross pool at L = 1 at the eval forward's pool sites
    and at L = 2 at the last of them of each width, with a seeded second
    layer."""
    out = {"fps_pruned": list(sites["fps"]), "cross_pool": [],
           "cross_pool L=2": []}
    if path != "eval forward":
        return out
    out["cross_pool"] = [(u, v, idx, [w], [b])
                         for u, idx, v, w, b in sites["pool"]]
    for c, (u, v, idx, ws, bs) in sorted(
            {a[0].shape[2]: a for a in out["cross_pool"]}.items()):
        w2 = torch.randn(c, c, device="cuda", generator=gen) / c ** 0.5
        b2 = 0.1 * torch.randn(c, device="cuda", generator=gen)
        out["cross_pool L=2"].append((u, v, idx, ws + [w2], bs + [b2]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="directory with the other design's sources")
    ap.add_argument("--kernels", default="fps,pool",
                    help=f"comma-separated, of {KERNELS}")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON result here too")
    args = ap.parse_args(argv)
    names = [n for n in KERNELS if n in args.kernels.split(",")]
    if not names or len(names) != len(args.kernels.split(",")):
        ap.error(f"--kernels takes names of {KERNELS}")
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    from ..device import use_full_fp32
    from ..models import PRESETS, BidPointFlowNet

    use_full_fp32()
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kernels.lib()
    lib = build_other(args.other, names)
    print("fps clusters resident at once, by G: "
          + str({g: fps_mod.card_clusters(g)
                 for g in fps_mod.CLUSTER_SIZES}), flush=True)
    new = {"fps": fps_mod._fps_cuda, "knn": knn_mod._knn_cuda,
           "pool": pool_mod._pool_cuda, "pool_bwd": pool_mod._pool_bwd_cuda,
           "fps_pruned": lambda xyz, m: pruned_mod._fps_pruned_cuda(
               xyz, m, True),
           "cross_pool": cross_mod._cross_pool_cuda}
    other = {"fps": lambda *a: other_fps(lib, *a),
             "knn": lambda *a: other_knn(lib, *a),
             "pool": lambda *a: other_pool(lib, *a),
             "pool_bwd": lambda *a: other_pool_bwd(lib, *a),
             "fps_pruned": lambda *a: other_fps_pruned(lib, *a),
             "cross_pool": lambda *a: other_cross_pool(lib, *a)}
    extras = {"fps": lambda a: extra_fps(a, NAME_RE["fps"]),
              "pool": extra_pool, "fps_pruned": extra_fps_pruned,
              "cross_pool": extra_cross_pool}
    model = BidPointFlowNet(PRESETS["teacher"], device="cuda",
                            generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    paths = {}
    for path, batch, train in (("eval forward", 1, False),
                               ("train step", 3, True),
                               ("KD step", 8, True)):
        sites = record_sites(model, batch, train)
        sites["pool_bwd"] = [] if not train else [
            (*a, torch.randn(a[2].shape, device="cuda", generator=gen))
            for a in sites["pool"]]
        sites.update(attic_sites(sites, path, gen))
        rows = {}
        for name, row in ((n, r) for n in names for r in ROWS.get(n, (n,))):
            tot = dict(other_ms=0.0, new_ms=0.0, other_device_ms=0.0,
                       new_device_ms=0.0, launches=0, sites=[])
            count = COUNTS[path].get(name, ATTIC_COUNT)
            for a in sites[row]:
                err = compare(name, a, new[name], other[name])
                ctx = (torch.no_grad() if name == "pool_bwd"
                       else torch.inference_mode())
                with ctx:
                    t = [cuda_ms(lambda: f(*a)) for f in (
                        other[name], new[name], new[name], other[name])]
                    dev = [device_ms(lambda: f(*a), NAME_RE[name])
                           for f in (other[name], new[name])]
                    extra = extras[name](a) if name in extras else {}
                o_ms, n_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                tot["other_ms"] += count * o_ms
                tot["new_ms"] += count * n_ms
                tot["other_device_ms"] += count * dev[0]
                tot["new_device_ms"] += count * dev[1]
                tot["launches"] += count
                beside = {k: v for k, v in extra.items()
                          if k.endswith("_ms") and isinstance(v, float)}
                for key, val in beside.items():
                    tot[key] = tot.get(key, 0.0) + count * val
                tot["sites"].append(dict(
                    site=site_name(name, a), other_ms=t[0::3],
                    new_ms=t[1:3], ratio=n_ms / o_ms, other_device_ms=dev[0],
                    new_device_ms=dev[1], device_ratio=dev[1] / dev[0],
                    max_abs_diff=err, **extra))
                print(f"  {path} {row} {site_name(name, a)}: other "
                      f"{t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / "
                      f"{t[2]:.4f} ms, ratio {n_ms / o_ms:.3f}; device "
                      f"other {dev[0]:.4f}, this {dev[1]:.4f} ms, ratio "
                      f"{dev[1] / dev[0]:.3f}"
                      + "".join(f"; {k} {v:.4f}" for k, v in beside.items()),
                      flush=True)
            if tot["launches"]:
                tot["ratio"] = tot["new_ms"] / tot["other_ms"]
                tot["device_ratio"] = (tot["new_device_ms"]
                                       / tot["other_device_ms"])
                tot["worst_site_ratio"] = max(x["ratio"]
                                              for x in tot["sites"])
                tot["worst_site_device_ratio"] = max(
                    x["device_ratio"] for x in tot["sites"])
                print(f"{path} {row}: {tot['launches']} launches, other "
                      f"{tot['other_ms']:.4f} ms, this {tot['new_ms']:.4f} "
                      f"ms, ratio {tot['ratio']:.3f}; device other "
                      f"{tot['other_device_ms']:.4f}, this "
                      f"{tot['new_device_ms']:.4f} ms, ratio "
                      f"{tot['device_ratio']:.3f}; worst site "
                      f"{tot['worst_site_ratio']:.3f} (device "
                      f"{tot['worst_site_device_ratio']:.3f})", flush=True)
                rows[row] = tot
        rows["device_ms_by_kernel"] = device_ms_by_kernel(new, sites, names)
        paths[path] = rows
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  reps=REPS, seconds=time.perf_counter() - t0,
                  fps_clusters={g: fps_mod.card_clusters(g)
                                for g in fps_mod.CLUSTER_SIZES},
                  paths=paths)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({p: {n: {key: r[key] for key in (
        "other_ms", "new_ms", "ratio", "other_device_ms", "new_device_ms",
        "device_ratio", "worst_site_ratio", "worst_site_device_ratio")}
                          for n, r in rows.items()
                          if n != "device_ms_by_kernel"}
                      for p, rows in paths.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
