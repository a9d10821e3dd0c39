#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kd_pointcloud_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs 1 card

It drives the port's main path -- the teacher's eval forward at batch 1
with 8192 points per cloud, through eval.evaluate_model -- and holds each
hand-written kernel against its plain PyTorch version. Phases, each printing
flushed lines as it goes:

  1. device: name, count, power limit (nvidia-smi), torch and CUDA versions;
  2. build: one nvcc call over csrc/*.cu, its seconds, and the registers,
     shared memory and spills that ptxas reports per kernel;
  3. kernels against plain versions, on the inputs that one forward hands
     each kernel (1 FPS, 19 kNN, 12 pool call sites): FPS bit-identical,
     kNN rows with equal index sets >= 99.9 % at every site (rows that
     differ: sorted recomputed distances within 1e-5 relative), pool within
     1e-4 x max|plain|;
  4. the main path: evaluate_model over 3 seeded synthetic pairs with
     seeded random weights, launch counts per forward (FPS 1, kNN 19,
     pool 12), flows[0..3] against the same model with every kernel swapped
     for its plain version (max abs diff <= 1e-3, median <= 1e-5), and the
     metrics (random weights: a sanity line only);
  5. timing: each kernel at each call site with CUDA events (20 launches
     after warm-up) beside its plain version (5), the bound from the shapes,
     the forward's ms/pair and pairs/s over 10 pairs, peak device memory,
     then 2 pairs under torch.profiler: device time a pair by kernel name,
     launches a pair and the device's busy share of the profiled wall;
  6. one {"kernels": [...]} line;
  7. the nvidia-smi line again, then {"ok": true, "device": {...}} last.

Every number is measured in this run. Float32 products run in full float32
(no TF32). It exits non-zero, printing no result, when there is no card,
outside a checkout, or when any phase fails; a watchdog ends it after
BUDGET_S seconds, the build included.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUDGET_S = 300
SEED = 0
N_POINTS = 8192
N_METRIC_PAIRS = 3
N_TIMED_PAIRS = 10
N_PROFILED_PAIRS = 2
PROFILE_TOP = 12
REPS, PLAIN_REPS = 20, 5
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 on the CUDA
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
PER_FORWARD = {"fps": 1, "knn": 19, "pool": 12}

KERNEL_META = {
    "fps": dict(source="kd_pointcloud_tpu_torch/csrc/fps.cu",
                replaces="kd_pointcloud_tpu/ops/pallas/fps_pallas.py:212"),
    "knn": dict(source="kd_pointcloud_tpu_torch/csrc/knn.cu",
                replaces="kd_pointcloud_tpu/ops/pallas/knn_fused.py:319"),
    "pool": dict(source="kd_pointcloud_tpu_torch/csrc/pool_fused.cu",
                 replaces="kd_pointcloud_tpu/ops/pallas/pool_fused.py:173"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def ptxas_summary(text: str):
    """One line per compiled kernel: registers, shared memory, spills."""
    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(fps|knn|pool)_kernel(?:ILi(\d+)E)?", m.group(1))
            name = f"{k.group(1)}_kernel<{k.group(2)}>" if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{smem.group(1) if smem else 0} B static smem, "
                       f"{spill}")
            name, spill = None, ""
    return out


def profile_forward(fwd, pairs) -> None:
    """Where the forward's time goes on the card: device time a pair by
    kernel name (the port's own kernels marked *), launches a pair, and the
    device's busy share of the profiled wall (one stream, so kernels do not
    overlap). The profiler's own host cost lowers that share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for p in pairs:
            fwd(*p[:4])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / len(pairs)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    log(f"  profile: {len(pairs)} pairs under torch.profiler, "
        f"{wall:.3f} ms a pair of wall")
    if not rows:
        log("  profile: device time not measured (the profiler saw no "
            "CUDA kernels)")
        return
    dev = {e.key: e.self_device_time_total / 1e3 / len(pairs) for e in rows}
    calls = {e.key: e.count / len(pairs) for e in rows}
    total = sum(dev.values())
    own = sum(t for k, t in dev.items()
              if re.search(r"(fps|knn|pool)_kernel<", k))
    log(f"  profile: device time {total:.3f} ms a pair over "
        f"{sum(calls.values()):.0f} kernel launches; busy share "
        f"{total / wall:.3f} of the profiled wall; the port's kernels "
        f"{own:.3f} ms")
    for key in sorted(dev, key=dev.get, reverse=True)[:PROFILE_TOP]:
        mark = "*" if re.search(r"(fps|knn|pool)_kernel<", key) else " "
        log(f"   {mark} {dev[key]:8.3f} ms {calls[key]:6.1f}x  {key[:90]}")


def main() -> int:
    t0 = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from kd_pointcloud_tpu_torch.device import use_full_fp32
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    from kd_pointcloud_tpu_torch.eval import (evaluate_model,
                                              make_eval_forward,
                                              synthetic_pairs)
    from kd_pointcloud_tpu_torch.models import PRESETS, BidPointFlowNet
    from kd_pointcloud_tpu_torch.ops import fps as fps_mod
    from kd_pointcloud_tpu_torch.ops import group_points, kernels
    from kd_pointcloud_tpu_torch.ops import knn as knn_mod
    from kd_pointcloud_tpu_torch.ops import pool_fused as pool_mod

    # the watchdog ends the process even if a kernel hangs the main thread
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)

    def deadline(phase: str) -> None:
        spent = time.monotonic() - t0
        check(spent <= BUDGET_S, f"{phase}: {spent:.0f} s > {BUDGET_S} s")

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[1/7 device] {kind}, count {count}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit:")
    log(smi)
    use_full_fp32()
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---------------------------------------------------------------- 2
    kernels.lib()
    info = kernels.BUILD_INFO
    log(f"[2/7 build] {len(kernels.sources())} sources, one nvcc call, "
        f"{info['seconds']:.1f} s{' (cached)' if info['cached'] else ''}")
    for line in ptxas_summary(info["log"]):
        log(f"  {line}")
    deadline("build")

    # ---------------------------------------------------------------- 3
    mods = {"fps": (fps_mod, "_fps_cuda", fps_mod.fps_plain),
            "knn": (knn_mod, "_knn_cuda", knn_mod.knn_plain),
            "pool": (pool_mod, "_pool_cuda", pool_mod.pool_plain)}
    cuda_fns = {n: getattr(m, a) for n, (m, a, _) in mods.items()}
    plain_fns = {n: p for n, (_, _, p) in mods.items()}

    @contextlib.contextmanager
    def swapped(make):
        """Replace each kernel launcher by make(name, launcher, plain)."""
        try:
            for n, (m, a, p) in mods.items():
                setattr(m, a, make(n, cuda_fns[n], p))
            yield
        finally:
            for n, (m, a, _) in mods.items():
                setattr(m, a, cuda_fns[n])

    calls = {n: [] for n in mods}

    def recorder(name, launcher, _plain):
        def run(*args):
            calls[name].append(tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
            return launcher(*args)
        return run

    model = BidPointFlowNet(PRESETS["teacher"], device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
    model.eval()
    pairs = synthetic_pairs(N_METRIC_PAIRS + N_TIMED_PAIRS + 1, N_POINTS,
                            seed=SEED)
    dev_pairs = [[torch.from_numpy(a)[None].cuda() for a in p] for p in pairs]
    with swapped(recorder), torch.inference_mode():
        model(*dev_pairs[0][:4])
    torch.cuda.synchronize()
    got = {n: len(c) for n, c in calls.items()}
    check(got == PER_FORWARD, f"call sites per forward {got}, "
          f"expected {PER_FORWARD}")
    log(f"[3/7 kernels vs plain] call sites of one forward: {got}")

    def site(name, args):
        if name == "fps":
            return f"B={args[0].shape[0]} {args[0].shape[1]}->{args[1]}"
        if name == "knn":
            k, xyz, q = args
            return f"k={k} B={q.shape[0]} {q.shape[1]}x{xyz.shape[1]}"
        u, idx = args[0], args[1]
        return (f"B={u.shape[0]} N={idx.shape[1]} K={idx.shape[2]} "
                f"C={u.shape[2]}")

    results = {n: dict(max_abs_err=0.0) for n in mods}
    with torch.inference_mode():
        for args in calls["fps"]:
            k_out, p_out = cuda_fns["fps"](*args), plain_fns["fps"](*args)
            bad = int((k_out != p_out).sum())
            log(f"  fps {site('fps', args)}: {bad} indices differ")
            check(bad == 0, "fps kernel is not bit-identical to fps_plain")
        results["fps"]["match"] = "bit-identical"

        worst_rows = 1.0
        for args in calls["knn"]:
            k, xyz, q = args
            (dk, ik), (dp, ip) = cuda_fns["knn"](*args), plain_fns["knn"](*args)
            same_rows = (ik.sort(-1).values == ip.sort(-1).values).all(-1)
            frac = float(same_rows.float().mean())
            worst_rows = min(worst_rows, frac)
            err = float((dk - dp).abs().max())
            results["knn"]["max_abs_err"] = max(
                results["knn"]["max_abs_err"], err)
            rel = 0.0
            if not bool(same_rows.all()):
                def recomputed(i):
                    d = ((group_points(xyz, i) - q[:, :, None]) ** 2).sum(-1)
                    return d[~same_rows].sort(-1).values
                a, b = recomputed(ik), recomputed(ip)
                rel = float(((a - b).abs()
                             / a.abs().clamp_min(1e-30)).max())
            log(f"  knn {site('knn', args)}: index-set rows equal "
                f"{frac:.6f}, order equal "
                f"{float((ik == ip).all(-1).float().mean()):.6f}, "
                f"max |d2 kernel - plain| {err:.3g}, differing rows' "
                f"recomputed d2 rel {rel:.3g}")
            check(frac >= 0.999, f"knn {site('knn', args)}: {frac}")
            check(rel <= 1e-5, f"knn {site('knn', args)}: rel {rel}")
        results["knn"]["match"] = f"index-set rows >= {worst_rows:.6f}"

        worst_ratio = 0.0
        for args in calls["pool"]:
            ok_, op = cuda_fns["pool"](*args), plain_fns["pool"](*args)
            err = float((ok_ - op).abs().max())
            scale = float(op.abs().max())
            worst_ratio = max(worst_ratio, err / scale)
            results["pool"]["max_abs_err"] = max(
                results["pool"]["max_abs_err"], err)
            log(f"  pool {site('pool', args)}: max abs err {err:.3g}, "
                f"max |plain| {scale:.3g}")
            check(err <= 1e-4 * scale, f"pool {site('pool', args)}: {err}")
        results["pool"]["match"] = f"max err / max|plain| {worst_ratio:.3g}"
    torch.cuda.synchronize()
    log("  verdict: fps bit-identical, knn and pool within bounds")
    deadline("kernels vs plain")

    # ---------------------------------------------------------------- 4
    kernels.reset_launches()
    metrics = evaluate_model(model, pairs[:N_METRIC_PAIRS])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {n: c * N_METRIC_PAIRS for n, c in PER_FORWARD.items()}
    log(f"[4/7 main path] evaluate_model over {N_METRIC_PAIRS} pairs of "
        f"{N_POINTS} points: launches {launches} (per forward "
        f"{ {n: c / N_METRIC_PAIRS for n, c in launches.items()} })")
    check(launches == want, f"launches {launches}, expected {want}")
    log("  metrics (random weights, sanity only): " + ", ".join(
        f"{k} {v:.6f}" for k, v in metrics.items()))
    check(all(v == v and abs(v) < 1e6 for v in metrics.values()),
          f"metrics not finite: {metrics}")

    with torch.inference_mode():
        out_k = model(*dev_pairs[0][:4])
        with swapped(lambda n, launcher, plain: plain):
            out_p = model(*dev_pairs[0][:4])
    for lvl in range(4):
        fk, fp = out_k["flows"][lvl], out_p["flows"][lvl]
        n_lvl = PRESETS["teacher"].npoints[lvl]
        check(tuple(fk.shape) == (1, n_lvl, 3), f"flow{lvl} {fk.shape}")
        check(bool(torch.isfinite(fk).all()), f"flow{lvl} not finite")
        diff = (fk - fp).abs()
        mx, med = float(diff.max()), float(diff.median())
        log(f"  flow{lvl} {tuple(fk.shape)}: kernels vs plain versions max "
            f"abs {mx:.3g}, median {med:.3g}")
        check(mx <= 1e-3 and med <= 1e-5, f"flow{lvl}: {mx}, {med}")
    for key in ("fps_idx1", "fps_idx2"):
        check(all(torch.equal(a, b) for a, b in zip(out_k[key], out_p[key])),
              f"{key} differs from the plain versions'")
    deadline("main path")

    # ---------------------------------------------------------------- 5
    def cuda_ms(fn, reps, warmup):
        for _ in range(warmup):
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

    def work(name, args):
        """(operations, bytes) the function needs on these inputs."""
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
        u, idx, v, w, b = args
        B, N2, C = u.shape
        N1, K = idx.shape[1:]
        # per (query, neighbour): C add + C leaky, C x C multiply-add,
        # C bias + C leaky + C max
        return (B * N1 * K * (2 * C * C + 5 * C),
                (B * N2 * C + 2 * B * N1 * C + C * C + C + B * N1 * K) * 4)

    kernel_rows = []
    log(f"[5/7 timing] CUDA events, {REPS} launches after warm-up "
        f"(plain: {PLAIN_REPS}); bound = max(ops / {PEAK_FP32_FLOPS:.3g}, "
        f"bytes / {PEAK_BYTES_S:.3g}) per call site")
    with torch.inference_mode():
        for name in mods:
            tot = dict(ms=0.0, plain_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
                       bound_ms=0.0)
            for args in calls[name]:
                ms = cuda_ms(lambda: cuda_fns[name](*args), REPS, 3)
                pms = cuda_ms(lambda: plain_fns[name](*args), PLAIN_REPS, 1)
                ops, nbytes = work(name, args)
                ops_ms = ops / PEAK_FP32_FLOPS * 1e3
                bytes_ms = nbytes / PEAK_BYTES_S * 1e3
                tot["ms"] += ms
                tot["plain_ms"] += pms
                tot["ops_ms"] += ops_ms
                tot["bytes_ms"] += bytes_ms
                tot["bound_ms"] += max(ops_ms, bytes_ms)
                log(f"  {name} {site(name, args)}: {ms:.4f} ms, plain "
                    f"{pms:.4f} ms, bound {max(ops_ms, bytes_ms):.5f} ms "
                    f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
            log(f"  {name} per forward: {tot['ms']:.4f} ms, plain "
                f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
            kernel_rows.append(dict(
                name=name, route="cuda", **KERNEL_META[name],
                launches=launches[name],
                launches_per_forward=launches[name] // N_METRIC_PAIRS,
                max_abs_err=results[name]["max_abs_err"],
                ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"],
                bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                          else "bytes"),
                library_ms=None, match=results[name]["match"]))
    deadline("kernel timing")

    fwd = make_eval_forward(model)
    fwd(*dev_pairs[N_METRIC_PAIRS][:4])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = dev_pairs[N_METRIC_PAIRS + 1:]
    per_pair = []
    t_all = time.perf_counter()
    for p in timed:
        t = time.perf_counter()
        fwd(*p[:4])
        torch.cuda.synchronize()
        per_pair.append((time.perf_counter() - t) * 1e3)
    total_s = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated()
    log(f"  forward: {len(timed)} pairs in {total_s:.4f} s: "
        f"{total_s / len(timed) * 1e3:.3f} ms/pair, "
        f"{len(timed) / total_s:.3f} pairs/s (per pair median "
        f"{statistics.median(per_pair):.3f} ms, min {min(per_pair):.3f}, "
        f"max {max(per_pair):.3f}); peak memory {peak / 2**20:.1f} MiB")
    deadline("forward timing")
    profile_forward(fwd, timed[:N_PROFILED_PAIRS])
    deadline("forward profile")

    # ---------------------------------------------------------------- 6, 7
    log("[6/7 kernels]")
    log(json.dumps({"kernels": kernel_rows}))
    log(f"[7/7 done] {time.monotonic() - t0:.1f} s wall; nvidia-smi:")
    log(smi)
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
