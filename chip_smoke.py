#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kd_pointcloud_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs 1 card

It drives the port's three paths -- the teacher's eval forward at batch 1
with 8192 points per cloud, through eval.evaluate_model; the teacher's
train step at batch 3, through train.make_train_step; and knowledge
distillation of a lighttoken_res student from the frozen teacher at batch
8 (configs/distill_kd.yaml), through train.make_distill_step -- and holds
each hand-written kernel against its plain PyTorch version. Phases, each
printing flushed lines as it goes:

  1. device: name, count, power limit (nvidia-smi), torch and CUDA versions;
  2. build: one nvcc process a csrc/*.cu source, all at once, and one link;
     the seconds, and the registers, shared memory and spills that ptxas
     reports per kernel;
  3. kernels against plain versions, on the inputs that one eval forward
     hands each kernel (1 FPS, 19 kNN, 12 pool call sites): FPS
     bit-identical, with its launch plan (blocks a cloud, from the card's
     cluster occupancy), also on duplicated points (ties across lanes,
     warps and blocks) and at N = 8000 (padding), at every cluster size;
     kNN bit-identical (indices in order and d2) at every site, with its
     launch plan (lanes a query, queries a block); pool within 1e-4 x
     max|plain|, also at K = 9 with N1 off every query tile;
  4. the eval path: evaluate_model over 3 seeded synthetic pairs with
     seeded random weights, launch counts per forward (FPS 1, kNN 19,
     pool 12), flows[0..3] against the same model with every kernel swapped
     for its plain version (max abs diff <= 1e-3, median <= 1e-5), and the
     metrics and eval loss (random weights: a sanity line only);
  5. eval timing: each kernel at each call site with CUDA events (20
     launches after warm-up) beside its plain version (5), the bound from
     the shapes, the forward's ms/pair and pairs/s over 10 pairs, peak
     device memory, then 2 pairs under torch.profiler: device time a pair
     by kernel name, launches a pair and the device's busy share;
  6. pool backward against plain: the 12 pool call sites of a batch-3
     and the 12 of a batch-8 (the KD step's) train forward, seeded
     cotangents, d_u / d_v / d_weight / d_bias of the
     kernel against torch.autograd of pool_plain within POOL_BWD_TOL of
     each output's max |plain| (the kernel sums d_u, d_weight and d_bias
     with float atomics, in an order that changes from run to run), and a
     crafted tie case per width (equal rows of u, repeated neighbours, zero
     pre-activations) that must split the cotangent as the plain version,
     and a ragged case per width (K = 16, N1 off every tile); d_v asked
     alone bit-equal to the full call's at both batches;
  7. the train path: one train step of the teacher (seed 0) through the
     kernels and of its copy through the plain versions, on the same
     batch: loss within 1e-5 relative, every gradient leaf within GRAD_TOL
     of the leaf's max |plain| (leaves whose true gradient is 0 below 1e-5
     of the largest gradient), BatchNorm running statistics within 1e-5,
     and the launches of the step (FPS 1, kNN 19, pool 12, pool_bwd 12);
  8. train timing: 10 steps on one fixed batch after a warm-up, ms a step
     (median, mean), steps/s, peak device memory, the loss of every step
     (it must fall: a sanity check, not a convergence claim), 2 more steps
     under torch.profiler as in phase 5, and each kernel at the step's
     call sites with CUDA events beside its plain version and its bound
     (FPS and kNN first held bit for bit against fps_plain and knn_plain
     at each site; FPS's chain, the rounds without their distance pass,
     timed beside it);
  9. the attic kernels, on no path, against their plain versions: pruned
     FPS at 8192 -> 2048 on the stacked clouds of the eval, train and KD
     forwards (batches 2, 6, 16) and a clustered cloud, bit-identical to
     fps_plain and to the FPS kernel, with the skipped sub-block updates
     equal to the plain version's, timed beside the FPS kernel; the
     L-layer cross pool at L = 1 on the 12 pool sites of an eval forward,
     bit-equal to the pool kernel and within 1e-4 x max|plain| of
     pool_plain, and at L = 2 at each width, within 1e-4 x max|plain|;
 10. the KD path: one distill step of the student (lighttoken_res, seed 0)
     from the frozen teacher (seed 1), batch 8, 8192 points,
     biDirection_loss_ht through make_named_loss (gamma 0.3, beta 0.8,
     hint layers [2, 3]), Adam lr 1e-3, weight decay 1e-4, through the
     kernels and, on a copy of the student, through the plain versions:
     loss within 1e-5 relative, every student gradient leaf within
     GRAD_TOL, BatchNorm statistics within 1e-5, the teacher's parameters
     and statistics bit-unchanged, and the launches of the step (FPS 2,
     kNN 38, pool 24, pool_bwd 12: the frozen teacher adds no backward);
 11. KD timing: 10 steps after a warm-up as in phase 8, 2 more under
     torch.profiler, and each kernel at the KD step's call sites (FPS and
     kNN bit-identical at each, as in phase 8);
 12. one bridge KD step (a 512-channel Bridge on the teacher's layer-3
     features, its own Adam) through the kernels and through the plain
     versions: loss within 1e-5 relative, student and bridge gradients
     within GRAD_TOL, and the bridge's parameters moved;
 13. a checkpoint round trip of the distilled student: saved with its
     optimizer, restored into a fresh model and optimizer, the eval flows
     of both bit-equal;
 14. one {"kernels": [...]} line (times per KD step for the kernels of
     the paths, the train step's and the eval forward's beside them; the
     attic kernels at their phase-9 shapes);
 15. the nvidia-smi line again, then {"ok": true, "device": {...}} last.

Every number is measured in this run. Float32 products run in full float32
(no TF32). It exits non-zero, printing no result, when there is no card,
outside a checkout, or when any phase fails; a watchdog ends it after
BUDGET_S seconds, the build included.
"""

from __future__ import annotations

import contextlib
import copy
import faulthandler
import json
import re
import shutil
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
N_PROFILED_PAIRS = N_PROFILED_STEPS = 2
PROFILE_TOP = 12
REPS, PLAIN_REPS = 20, 5
TRAIN_BATCH = 3
N_TRAIN_WARMUP, N_TRAIN_STEPS = 2, 10
# configs/distill_kd.yaml: batch 8, biDirection_loss_ht, gamma 0.3, beta
# 0.8, hint layers [2, 3], Adam lr 1e-3, weight decay 1e-4
KD_BATCH = 8
KD_LOSS = "biDirection_loss_ht"
KD_ARGS = dict(gamma=0.3, beta=0.8, hint_layers=[2, 3])
TEACHER_SEED, STUDENT_SEED = 1, 0
FPS_PRUNED_BATCHES = (2, 6, 16)    # stacked clouds: eval, train, KD forward
ATTIC_TOL = 1e-4                   # x max|plain|: float32 sums, other order
# the backward kernel adds d_u, d_weight and d_bias with float atomics, in
# an order that changes from run to run: float32 rounding of sums over up
# to B * N1 * K = 786432 rows, not bit-equality
POOL_BWD_TOL = 1e-4
# a train step through the kernels against the plain versions: the same
# math, but those atomic sums in another order, carried through the whole
# backward; per leaf, relative to the leaf's max |plain gradient|
GRAD_TOL = 1e-3
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 on the CUDA
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
PER_FORWARD = {"fps": 1, "knn": 19, "pool": 12, "pool_bwd": 0,
               "fps_pruned": 0, "cross_pool": 0}
PER_TRAIN_STEP = dict(PER_FORWARD, pool_bwd=12)
PER_KD_STEP = {"fps": 2, "knn": 38, "pool": 24, "pool_bwd": 12,
               "fps_pruned": 0, "cross_pool": 0}
PATH_KERNELS = ("fps", "knn", "pool", "pool_bwd")
# a kernel's name, not the tail of a longer one (cross_pool_kernel is not
# pool_kernel); mangled names put the name's length (digits) before it
KERNEL_RE = (r"(?<![A-Za-z_])(fps_pruned|fps|knn|pool_bwd_mask|pool_bwd"
             r"|pool|cross_pool)_kernel")

KERNEL_META = {
    "fps": dict(source="kd_pointcloud_tpu_torch/csrc/fps.cu",
                replaces="kd_pointcloud_tpu/ops/pallas/fps_pallas.py:212",
                design="second: a cluster of G blocks a cloud (fps_plan), "
                       "st.async exchange counted on an mbarrier, redux.sync "
                       "argmax of packed keys"),
    "knn": dict(source="kd_pointcloud_tpu_torch/csrc/knn.cu",
                replaces="kd_pointcloud_tpu/ops/pallas/knn_fused.py:319",
                design="second: L lanes a query (knn_plan), one sorted list "
                       "a group with an entry a lane, ballot-ordered exact "
                       "merge"),
    "pool": dict(source="kd_pointcloud_tpu_torch/csrc/pool_fused.cu",
                 replaces="kd_pointcloud_tpu/ops/pallas/pool_fused.py:173",
                 design="second: all C channels a block, 8 x 8 register "
                        "tiles, w streamed in i-tiles at C >= 128, one "
                        "wave"),
    "pool_bwd": dict(source="kd_pointcloud_tpu_torch/csrc/pool_fused_bwd.cu",
                     replaces="kd_pointcloud_tpu/ops/pallas/pool_fused.py:269",
                     design="second: register-tiled recompute of p, mask "
                            "kernel with d_w / d_bias fused, mask-indexed "
                            "d_h0"),
    "fps_pruned": dict(source="kd_pointcloud_tpu_torch/csrc/fps_pruned.cu",
                       replaces="attic/fps_pruned.py:329",
                       design="first: bounding-sphere pruning of sub-blocks"),
    "cross_pool": dict(source="kd_pointcloud_tpu_torch/csrc/cross_pool.cu",
                       replaces="attic/cross_pool.py:90",
                       design="first: L layers in shared memory"),
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
            k = re.search(KERNEL_RE + r"(?:I((?:L[ib]\d+E)+)E)?",
                          m.group(1))
            targs = ", ".join(re.findall(r"L[ib](\d+)E", k.group(2) or "")
                              ) if k else ""
            name = f"{k.group(1)}_kernel<{targs}>" if k else m.group(1)
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


def profile_device(run, n: int, what: str) -> None:
    """Where the time goes on the card: run(i) for i < n under
    torch.profiler; device time a {what} by kernel name (the port's own
    kernels marked *), launches a {what}, and the device's busy share of the
    profiled wall (one stream, so kernels do not overlap). The profiler's
    own host cost lowers that share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    # kernels only: a user annotation on the device (the optimizer's
    # step, for one) spans kernels that are counted on their own
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    log(f"  profile: {n} of them under torch.profiler, {wall:.3f} ms a "
        f"{what} of wall")
    if not rows:
        log("  profile: device time not measured (the profiler saw no "
            "CUDA kernels)")
        return
    dev = {e.key: e.self_device_time_total / 1e3 / n for e in rows}
    calls = {e.key: e.count / n for e in rows}
    total = sum(dev.values())
    own = sum(t for k, t in dev.items() if re.search(KERNEL_RE + "<", k))
    log(f"  profile: device time {total:.3f} ms a {what} over "
        f"{sum(calls.values()):.0f} kernel launches; busy share "
        f"{total / wall:.3f} of the profiled wall; the port's kernels "
        f"{own:.3f} ms")
    for key in sorted(dev, key=dev.get, reverse=True)[:PROFILE_TOP]:
        mark = "*" if re.search(KERNEL_RE + "<", key) else " "
        log(f"   {mark} {dev[key]:8.3f} ms {calls[key]:6.1f}x  {key[:90]}")


def work(name: str, args):
    """(operations, bytes) the function needs on these inputs: each input
    read once, each output written once."""
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


def mask_entries(u, idx, v, weight, bias) -> int:
    """The (query, neighbour, output channel) entries where leaky(p) is its
    query's max over the neighbours: B N1 C without ties."""
    import torch
    from kd_pointcloud_tpu_torch.ops import group_points, leaky

    with torch.no_grad():
        p = leaky(torch.nn.functional.linear(
            leaky(group_points(u, idx) + v[:, :, None, :]), weight, bias))
        return int((p == p.amax(dim=2, keepdim=True)).sum())


def pool_bwd_plain(u, idx, v, weight, bias, ct):
    """(d_u, d_v, d_weight, d_bias) of pool_plain by torch.autograd."""
    import torch
    from kd_pointcloud_tpu_torch.ops.pool_fused import pool_plain

    ts = [t.detach().requires_grad_() for t in (u, v, weight, bias)]
    with torch.enable_grad():
        out = pool_plain(ts[0], idx, ts[1], ts[2], ts[3])
        return torch.autograd.grad(out, ts, ct)


def tie_case(u, idx, v, weight, bias, ct):
    """Pool inputs with exact ties: in the first quarter of the queries
    every neighbour alternates between rows 0 and 1 of u, made equal; in
    the second quarter all neighbours are one row and v cancels it, so the
    first leaky's input is exactly 0 and every p_k is the bias, which is
    exactly 0 in every fourth channel."""
    from kd_pointcloud_tpu_torch.ops import gather_points

    u, idx, v, bias = u.clone(), idx.clone(), v.clone(), bias.clone()
    q = idx.shape[1] // 4
    u[:, 1] = u[:, 0]
    idx[:, :q, 0::2], idx[:, :q, 1::2] = 0, 1
    idx[:, q:2 * q, :] = idx[:, q:2 * q, :1]
    v[:, q:2 * q] = -gather_points(u, idx[:, q:2 * q, 0].contiguous())
    bias[::4] = 0.0
    return u, idx, v, weight, bias, ct


def ragged_case(u, idx, v, weight, bias, ct):
    """Pool inputs off the path's grid: K = 16 neighbours (slots left
    empty in the backward kernel) and N1 not a multiple of any query
    tile."""
    n = idx.shape[1] - 5
    return (u, idx[:, :n, :16].contiguous(), v[:, :n].contiguous(), weight,
            bias, ct[:, :n].contiguous())


def zero_gradient_leaf(name: str) -> bool:
    """The Dense bias feeding a flow head's BatchNorm: the batch mean
    removes it, so its true gradient is 0 and any float32 value is
    rounding noise."""
    return (name.startswith("flow") and ".convs." in name
            and name.endswith("dense.bias"))


def compare_grads(model_k, model_p) -> tuple:
    """Every gradient leaf of model_k (a step through the kernels) against
    model_p's (the plain versions): error / the leaf's max |plain| within
    GRAD_TOL, zero-gradient leaves below 1e-5 of the largest gradient.
    Returns (worst ratio, its leaf, median ratio, leaves, zero leaves,
    largest gradient)."""
    import torch

    grads_p = {n: p.grad for n, p in model_p.named_parameters()}
    top = max(float(g.abs().max()) for g in grads_p.values())
    rels, zero_leaves = {}, 0
    for name, p in model_k.named_parameters():
        gk, gp = p.grad, grads_p[name]
        check(gk is not None and bool(torch.isfinite(gk).all()),
              f"gradient of {name} missing or not finite")
        if zero_gradient_leaf(name):
            zero_leaves += 1
            check(max(float(gk.abs().max()), float(gp.abs().max()))
                  <= 1e-5 * top, f"{name}: a zero gradient is not ~0")
            continue
        rels[name] = (float((gk - gp).abs().max())
                      / max(float(gp.abs().max()), 1e-30))
    worst = max(rels, key=rels.get)
    check(rels[worst] <= GRAD_TOL, f"gradient {worst}: {rels[worst]}")
    return (rels[worst], worst, statistics.median(rels.values()), len(rels),
            zero_leaves, top)


def compare_stats(model_k, model_p) -> float:
    """BatchNorm running statistics of model_k against model_p's: the
    largest error / max |plain| of a buffer."""
    stats_p = dict(model_p.named_buffers())
    err = 0.0
    for name, buf in model_k.named_buffers():
        if ".running_" in name:
            want = stats_p[name]
            err = max(err, float((buf - want).abs().max())
                      / max(float(want.abs().max()), 1e-30))
    return err


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
    from kd_pointcloud_tpu_torch.attic import cross_pool as cross_mod
    from kd_pointcloud_tpu_torch.attic import fps_pruned as pruned_mod
    from kd_pointcloud_tpu_torch.eval import (evaluate_model,
                                              make_eval_forward,
                                              synthetic_pairs)
    from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                                Bridge)
    from kd_pointcloud_tpu_torch.ops import fps as fps_mod
    from kd_pointcloud_tpu_torch.ops import kernels
    from kd_pointcloud_tpu_torch.ops.kernel_ab import fps_skeleton
    from kd_pointcloud_tpu_torch.ops import knn as knn_mod
    from kd_pointcloud_tpu_torch.ops import pool_fused as pool_mod
    from kd_pointcloud_tpu_torch.train import (apply_frozen, best_checkpoint,
                                               full_state_tree,
                                               make_bridge_distill_step,
                                               make_distill_step,
                                               make_eval_step,
                                               make_named_loss,
                                               make_optimizer,
                                               make_train_step,
                                               restore_train_state,
                                               save_checkpoint)
    from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

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
    log(f"[1/15 device] {kind}, count {count}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit:")
    log(smi)
    use_full_fp32()
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---------------------------------------------------------------- 2
    kernels.lib()
    info = kernels.BUILD_INFO
    log(f"[2/15 build] {len(kernels.sources())} sources, one nvcc process "
        f"each, all at once, and one link: {info['seconds']:.1f} s"
        f"{' (cached)' if info['cached'] else ''}")
    for line in ptxas_summary(info["log"]):
        log(f"  {line}")
    deadline("build")

    # ---------------------------------------------------------------- 3
    # where the model reaches each kernel: swapped for a recorder or for
    # the plain version (the pool's point carries its backward kernel too)
    points = {"fps": (fps_mod, "_fps_cuda", fps_mod.fps_plain),
              "knn": (knn_mod, "_knn_cuda", knn_mod.knn_plain),
              "pool": (pool_mod, "_pool_card", pool_mod.pool_plain)}
    originals = {n: getattr(m, a) for n, (m, a, _) in points.items()}
    cuda_fns = {"fps": fps_mod._fps_cuda, "knn": knn_mod._knn_cuda,
                "pool": pool_mod._pool_cuda,
                "pool_bwd": pool_mod._pool_bwd_cuda,
                "fps_pruned": pruned_mod._fps_pruned_cuda,
                "cross_pool": cross_mod._cross_pool_cuda}
    plain_fns = {"fps": fps_mod.fps_plain, "knn": knn_mod.knn_plain,
                 "pool": pool_mod.pool_plain, "pool_bwd": pool_bwd_plain,
                 "fps_pruned": pruned_mod.fps_pruned_plain,
                 "cross_pool": cross_mod.cross_pool_plain}

    @contextlib.contextmanager
    def swapped(make):
        """Replace each kernel entry by make(name, entry, plain)."""
        try:
            for n, (m, a, p) in points.items():
                setattr(m, a, make(n, originals[n], p))
            yield
        finally:
            for n, (m, a, _) in points.items():
                setattr(m, a, originals[n])

    def recorder(store):
        def make(name, entry, _plain):
            def run(*args):
                store[name].append(tuple(
                    a.detach().clone() if torch.is_tensor(a) else a
                    for a in args))
                return entry(*args)
            return run
        return make

    calls = {n: [] for n in points}
    model = BidPointFlowNet(PRESETS["teacher"], device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
    model.eval()
    pairs = synthetic_pairs(N_METRIC_PAIRS + N_TIMED_PAIRS + 1, N_POINTS,
                            seed=SEED)
    dev_pairs = [[torch.from_numpy(a)[None].cuda() for a in p] for p in pairs]
    with swapped(recorder(calls)), torch.inference_mode():
        model(*dev_pairs[0][:4])
    torch.cuda.synchronize()
    got = {n: len(c) for n, c in calls.items()}
    want_sites = {n: PER_FORWARD[n] for n in points}
    check(got == want_sites, f"call sites per forward {got}, "
          f"expected {want_sites}")
    log(f"[3/15 kernels vs plain] call sites of one eval forward: {got}")

    def site(name, args):
        if name in ("fps", "fps_pruned"):
            return f"B={args[0].shape[0]} {args[0].shape[1]}->{args[1]}"
        if name == "knn":
            k, xyz, q = args
            return f"k={k} B={q.shape[0]} {q.shape[1]}x{xyz.shape[1]}"
        if name == "cross_pool":
            u, idx, ws = args[0], args[2], args[3]
            return (f"L={len(ws)} B={u.shape[0]} N={idx.shape[1]} "
                    f"K={idx.shape[2]} C={u.shape[2]}")
        u, idx = args[0], args[1]
        return (f"B={u.shape[0]} N={idx.shape[1]} K={idx.shape[2]} "
                f"C={u.shape[2]}")

    results = {n: dict(max_abs_err=0.0) for n in cuda_fns}

    def knn_identical(args):
        """The kNN kernel against knn_plain at one call site: indices equal
        in order and d2 equal, bit for bit."""
        k, xyz, q = args
        with torch.inference_mode():
            (dk, ik), (dp, ip) = (cuda_fns["knn"](*args),
                                  plain_fns["knn"](*args))
        lanes, qpb = knn_mod.knn_plan(q.shape[0], q.shape[1], xyz.shape[1],
                                      k)
        same_idx, same_d2 = torch.equal(ik, ip), torch.equal(dk, dp)
        results["knn"]["max_abs_err"] = max(results["knn"]["max_abs_err"],
                                            float((dk - dp).abs().max()))
        log(f"  knn {site('knn', args)} (lanes {lanes}, {qpb} queries a "
            f"block): indices equal in order {same_idx}, d2 equal "
            f"{same_d2}")
        check(same_idx and same_d2,
              f"knn {site('knn', args)} is not bit-identical to knn_plain")
    def fps_identical(args, label="", every_g=False):
        """The FPS kernel against fps_plain at one site, bit for bit: at
        the plan's G and, with every_g, at every G whose clusters fit the
        card's SMs."""
        xyz, m = args
        B, N = xyz.shape[:2]
        plan = fps_mod.fps_plan(B, N, fps_mod.card_clusters)
        gs = [g for g in fps_mod.CLUSTER_SIZES if every_g and B * g
              <= fps_mod.SMS and (g > 1 or N <= fps_mod.ONE_BLOCK_POINTS)]
        with torch.inference_mode():
            want = plain_fns["fps"](*args)
            bad = {g: int((fps_mod._fps_cuda(xyz, m, g) != want).sum())
                   for g in gs}
            bad["plan"] = int((cuda_fns["fps"](*args) != want).sum())
        log(f"  fps {label}{site('fps', args)} (plan G={plan}): indices "
            f"differing from fps_plain by G {bad}")
        check(not any(bad.values()),
              f"fps {label}{site('fps', args)} is not bit-identical")

    log("  fps: clusters of G blocks resident at once on this card "
        + str({g: fps_mod.card_clusters(g) for g in fps_mod.CLUSTER_SIZES})
        + "; plan G at B = 2, 6, 16: "
        + str({b: fps_mod.fps_plan(b, N_POINTS, fps_mod.card_clusters)
               for b in (2, 6, 16)}))
    xyz0, m0 = calls["fps"][0]
    for args in calls["fps"]:
        fps_identical(args, every_g=True)
    # ties: 512 points repeated 16 times, so equal distances fall in other
    # lanes, warps and blocks; padding: N = 8000, off every multiple of 1024
    tied = xyz0[:, :512].repeat(1, N_POINTS // 512, 1).contiguous()
    fps_identical((tied, m0), "tie case ", every_g=True)
    fps_identical((xyz0[:, :8000].contiguous(), 2000), "N=8000 ",
                  every_g=True)
    results["fps"]["match"] = (
        "bit-identical at every eval, train and KD site, on duplicated "
        "points and at N = 8000, at every cluster size")

    with torch.inference_mode():

        for args in calls["knn"]:
            knn_identical(args)
        results["knn"]["match"] = ("bit-identical (index order and d2) at "
                                   "every eval, train and KD site")

        worst_ratio = 0.0
        # K = 9: slots left empty in the kernel's tile of 32; N1 off every
        # pass of queries
        ragged = [(u, idx[:, :-5, :9].contiguous(), v[:, :-5].contiguous(),
                   w, b) for u, idx, v, w, b in {
                       a[0].shape[2]: a for a in calls["pool"]}.values()]
        for args in calls["pool"] + ragged:
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
    log("  verdict: fps and knn bit-identical, pool within bounds")
    deadline("kernels vs plain")

    # ---------------------------------------------------------------- 4
    kernels.reset_launches()
    metrics = evaluate_model(model, pairs[:N_METRIC_PAIRS])
    torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)
    want = {n: PER_FORWARD.get(n, 0) * N_METRIC_PAIRS for n in eval_launches}
    log(f"[4/15 eval path] evaluate_model over {N_METRIC_PAIRS} pairs of "
        f"{N_POINTS} points: launches {eval_launches} (per forward "
        f"{ {n: c / N_METRIC_PAIRS for n, c in eval_launches.items()} })")
    check(eval_launches == want, f"launches {eval_launches}, expected {want}")
    log("  metrics and eval loss (random weights, sanity only): " + ", ".join(
        f"{k} {v:.6f}" for k, v in metrics.items()))
    check(all(v == v and abs(v) < 1e6 for v in metrics.values()),
          f"metrics not finite: {metrics}")

    with torch.inference_mode():
        out_k = model(*dev_pairs[0][:4])
        with swapped(lambda n, entry, plain: plain):
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
    deadline("eval path")

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

    def time_sites(name, sites, works=None):
        """Kernel and plain ms and the bound, summed over call sites;
        works: the (operations, bytes) of each site where the call's
        arguments alone do not give them."""
        tot = dict(ms=0.0, plain_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
                   bound_ms=0.0)
        for i, args in enumerate(sites):
            ms = cuda_ms(lambda: cuda_fns[name](*args), REPS, 3)
            pms = cuda_ms(lambda: plain_fns[name](*args), PLAIN_REPS, 1)
            ops, nbytes = work(name, args) if works is None else works[i]
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
        tot["bound_by"] = ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                           else "bytes")
        return tot

    log(f"[5/15 eval timing] CUDA events, {REPS} launches after warm-up "
        f"(plain: {PLAIN_REPS}); bound = max(ops / {PEAK_FP32_FLOPS:.3g}, "
        f"bytes / {PEAK_BYTES_S:.3g}) per call site")
    eval_times = {}
    with torch.inference_mode():
        for name in points:
            eval_times[name] = time_sites(name, calls[name])
            t = eval_times[name]
            log(f"  {name} per forward: {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms")
    deadline("eval kernel timing")

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
    profile_device(lambda i: fwd(*timed[i][:4]), N_PROFILED_PAIRS, "pair")
    del model, fwd, out_k, out_p
    deadline("forward profile")

    # ---------------------------------------------------------------- 6
    tmodel = BidPointFlowNet(PRESETS["teacher"], device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
    pmodel = copy.deepcopy(tmodel)
    batch = synthetic_batches(1, TRAIN_BATCH, N_POINTS, SEED + 1, "cuda")[0]
    tcalls = {n: [] for n in points}
    rec_model = copy.deepcopy(tmodel).train()
    with swapped(recorder(tcalls)), torch.no_grad():
        rec_model(batch["pos1"], batch["pos2"], batch["norm1"],
                  batch["norm2"])
    del rec_model
    got = {n: len(c) for n, c in tcalls.items()}
    check(got == want_sites, f"call sites per train forward {got}")
    # the KD step's batch, and the pool sites of a batch-8 train forward
    # (the student has the teacher's shapes)
    kd_batch = synthetic_batches(1, KD_BATCH, N_POINTS, SEED + 2, "cuda")[0]
    kd_pool = {n: [] for n in points}
    rec_model = copy.deepcopy(tmodel).train()
    with swapped(recorder(kd_pool)), torch.no_grad():
        rec_model(kd_batch["pos1"], kd_batch["pos2"], kd_batch["norm1"],
                  kd_batch["norm2"])
    del rec_model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bwd_sites = [(*args, torch.randn(args[2].shape, device="cuda",
                                     generator=gen))
                 for args in tcalls["pool"]]
    kd_bwd_sites = [(*args, torch.randn(args[2].shape, device="cuda",
                                        generator=gen))
                    for args in kd_pool["pool"]]
    check(len(kd_bwd_sites) == PER_FORWARD["pool"],
          f"pool sites of a batch-{KD_BATCH} forward {len(kd_bwd_sites)}")
    log(f"[6/15 pool backward vs plain] {len(bwd_sites)} pool call sites of "
        f"a batch-{TRAIN_BATCH} and {len(kd_bwd_sites)} of a batch-"
        f"{KD_BATCH} train forward, seeded cotangents; error / max|plain| of "
        f"d_u, d_v, d_weight, d_bias (bound {POOL_BWD_TOL})")
    widths = {}
    for args in bwd_sites:
        widths.setdefault(args[0].shape[2], args)
    cases = ([("", a) for a in bwd_sites + kd_bwd_sites]
             + [("tie case ", tie_case(*a)) for a in widths.values()]
             + [("ragged case ", ragged_case(*a)) for a in widths.values()])
    worst_ratio = 0.0
    for label, args in cases:
        fwd_err = float((cuda_fns["pool"](*args[:5])
                         - plain_fns["pool"](*args[:5])).abs().max())
        got_k, got_p = cuda_fns["pool_bwd"](*args), pool_bwd_plain(*args)
        ratios = []
        for a, x in zip(got_k, got_p):
            err = float((a - x).abs().max())
            ratios.append(err / max(float(x.abs().max()), 1e-30))
            results["pool_bwd"]["max_abs_err"] = max(
                results["pool_bwd"]["max_abs_err"], err)
        worst_ratio = max(worst_ratio, *ratios)
        log(f"  pool_bwd {label}{site('pool_bwd', args)}: "
            + " ".join(f"{r:.3g}" for r in ratios)
            + f" (forward max abs err {fwd_err:.3g})")
        check(max(ratios) <= POOL_BWD_TOL,
              f"pool_bwd {label}{site('pool_bwd', args)}: {ratios}")
    results["pool_bwd"]["match"] = f"max err / max|plain| {worst_ratio:.3g}"
    # autograd asks only for the gradients it needs: d_v alone (the mask
    # kernel skips d_w and d_bias, the second kernel its scatter into d_u)
    # is the full call's d_v, which is summed in a fixed order
    for args in (bwd_sites[0], kd_bwd_sites[0]):
        full = cuda_fns["pool_bwd"](*args)
        part = cuda_fns["pool_bwd"](*args, need=(False, True, False, False))
        check(part[0] is None and part[2] is None and part[3] is None
              and torch.equal(part[1], full[1]), "pool_bwd with d_v alone")
    log("  pool_bwd asked for d_v alone: equal to the full call's d_v "
        f"(batches {TRAIN_BATCH} and {KD_BATCH})")
    del kd_bwd_sites, kd_pool
    deadline("pool backward vs plain")

    # ---------------------------------------------------------------- 7
    opt_k, opt_p = make_optimizer(tmodel), make_optimizer(pmodel)
    step_k = make_train_step(tmodel, opt_k)
    step_p = make_train_step(pmodel, opt_p)
    kernels.reset_launches()
    loss_k = float(step_k(batch))
    train_launches = dict(kernels.LAUNCHES)
    log(f"[7/15 train path] one train step at batch {TRAIN_BATCH}, "
        f"{N_POINTS} points: launches {train_launches}")
    check(train_launches == PER_TRAIN_STEP,
          f"launches {train_launches}, expected {PER_TRAIN_STEP}")
    with swapped(lambda n, entry, plain: plain):
        loss_p = float(step_p(batch))
    check(kernels.LAUNCHES == train_launches,
          "the plain train step launched a kernel")
    log(f"  loss kernels {loss_k:.9g}, plain {loss_p:.9g}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "train loss differs")
    worst, leaf, median, n_leaves, zero_leaves, top = compare_grads(tmodel,
                                                                    pmodel)
    log(f"  gradients: {n_leaves} leaves, error / max|plain| worst "
        f"{worst:.3g} ({leaf}), median {median:.3g} (bound {GRAD_TOL}); "
        f"{zero_leaves} zero-gradient leaves below 1e-5 of the largest "
        f"gradient {top:.3g}")
    bn_err = compare_stats(tmodel, pmodel)
    log(f"  BatchNorm running statistics: error / max|plain| {bn_err:.3g}")
    check(bn_err <= 1e-5, f"BatchNorm statistics differ: {bn_err}")
    del pmodel, opt_p, step_p
    deadline("train path")

    # ---------------------------------------------------------------- 8
    def time_steps(step, batch, phase, what, batch_size):
        """N_TRAIN_STEPS timed steps of one fixed batch after warm-up, the
        peak memory, the loss of each step (it must fall), then a profile
        of N_PROFILED_STEPS."""
        for _ in range(N_TRAIN_WARMUP):
            step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step, losses = [], []
        t_all = time.perf_counter()
        for _ in range(N_TRAIN_STEPS):
            t = time.perf_counter()
            losses.append(float(step(batch)))     # float() synchronises
            per_step.append((time.perf_counter() - t) * 1e3)
        total_s = time.perf_counter() - t_all
        peak = torch.cuda.max_memory_allocated()
        log(f"[{phase}] {N_TRAIN_STEPS} steps after {N_TRAIN_WARMUP + 1} "
            f"warm-up, batch {batch_size}, {N_POINTS} points, one fixed "
            f"batch: {total_s * 1e3 / N_TRAIN_STEPS:.3f} ms a step mean, "
            f"median {statistics.median(per_step):.3f} ms (min "
            f"{min(per_step):.3f}, max {max(per_step):.3f}), "
            f"{N_TRAIN_STEPS / total_s:.3f} steps/s; peak memory "
            f"{peak / 2**20:.1f} MiB")
        log("  loss per step: " + " ".join(f"{v:.6f}" for v in losses))
        check(all(v == v for v in losses) and losses[-1] < losses[0],
              f"the loss did not fall over the timed {what}s")
        profile_device(lambda i: step(batch), N_PROFILED_STEPS, what)

    def time_path(sites, what):
        """Each path kernel timed at its call sites of one step; the FPS
        and kNN kernels first held bit for bit against fps_plain and
        knn_plain at each of them (the launch plans change with B); FPS's
        chain (its rounds without the distance pass, at the plan's G)
        timed beside it."""
        for args in sites["fps"]:
            fps_identical(args)
        for args in sites["knn"]:
            knn_identical(args)
        chain = 0.0
        for xyz, m in sites["fps"]:
            g = fps_mod.fps_plan(xyz.shape[0], xyz.shape[1],
                                 fps_mod.card_clusters)
            chain += cuda_ms(lambda: fps_skeleton(xyz, m, g), REPS, 3)
        times = {}
        for name in PATH_KERNELS:
            with (torch.inference_mode() if name != "pool_bwd"
                  else contextlib.nullcontext()):
                times[name] = time_sites(name, sites[name])
            t = times[name]
            log(f"  {name} per {what}: {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
                f"({t['bound_by']})")
        times["fps"]["chain_ms"] = chain
        log(f"  fps chain (the rounds' synchronisation alone) per {what}: "
            f"{chain:.4f} ms")
        return times

    time_steps(step_k, batch, "8/15 train timing", "train step", TRAIN_BATCH)
    train_times = time_path(dict(tcalls, pool_bwd=bwd_sites), "train step")
    del tmodel, opt_k, step_k, batch
    deadline("train timing")

    # ---------------------------------------------------------------- 9
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    clustered = (torch.randn(1, 16, 1, 3, device="cuda", generator=gen) * 20
                 + torch.randn(1, 16, N_POINTS // 16, 3, device="cuda",
                               generator=gen)).reshape(1, N_POINTS, 3)
    m = PRESETS["teacher"].npoints[1]
    fps_sites = {2: calls["fps"][0][0], 6: tcalls["fps"][0][0],
                 16: torch.cat([kd_batch["pos1"], kd_batch["pos2"]]),
                 "clustered": clustered}
    check(all(fps_sites[b].shape[0] == b for b in FPS_PRUNED_BATCHES),
          "the stacked clouds of the three forwards")
    log(f"[9/15 attic kernels vs plain] pruned FPS {N_POINTS} -> {m}: "
        "indices against fps_plain and the FPS kernel, skipped sub-block "
        "updates against the plain version")
    attic = {"fps_pruned": {}, "cross_pool": {}}
    with torch.inference_mode():
        for key, xyz in fps_sites.items():
            got, dirty = pruned_mod._fps_pruned_cuda(xyz, m, True)
            plain, p_dirty = pruned_mod.fps_pruned_plain(xyz, m, True)
            bad = [int((got != ref).sum()) for ref in (
                plain, fps_mod.fps_plain(xyz, m), cuda_fns["fps"](xyz, m))]
            rounds = xyz.shape[0] * (m - 1) * (N_POINTS // pruned_mod.SUB)
            share = float(dirty.sum()) / rounds
            log(f"  fps_pruned {site('fps_pruned', (xyz, m))} ({key}): "
                f"indices differing from fps_pruned_plain / fps_plain / "
                f"the FPS kernel {bad}; sub-block updates made "
                f"{int(dirty.sum())} of {rounds} ({share:.4f}), plain "
                f"{int(p_dirty.sum())}")
            check(bad == [0, 0, 0], "pruned fps is not bit-identical")
            check(torch.equal(dirty, p_dirty),
                  "pruned fps skipped other updates than its plain version")
            ms = cuda_ms(lambda: cuda_fns["fps_pruned"](xyz, m), REPS, 3)
            row1 = cuda_ms(lambda: cuda_fns["fps"](xyz, m), REPS, 3)
            attic["fps_pruned"][key] = dict(
                ms=ms, fps_kernel_ms=row1, updates_share=share,
                work=work("fps_pruned", (xyz, m, int(dirty.sum()))))
            log(f"    {ms:.4f} ms, the FPS kernel {row1:.4f} ms")
        results["fps_pruned"]["match"] = (
            "bit-identical to fps_plain and the FPS kernel at B = 2, 6, 16 "
            "and a clustered cloud")
        kd_site = fps_sites[FPS_PRUNED_BATCHES[-1]]
        fp_times = time_sites("fps_pruned", [(kd_site, m)],
                              [attic["fps_pruned"][16]["work"]])

        log(f"  cross_pool L=1 on the {len(calls['pool'])} pool sites of an "
            "eval forward: against the pool kernel (bit-equal) and "
            f"pool_plain (<= {ATTIC_TOL} x max|plain|)")
        cp_sites = [(u, v, idx, [w], [b])
                    for u, idx, v, w, b in calls["pool"]]
        worst = 0.0
        for args, pargs in zip(cp_sites, calls["pool"]):
            got = cuda_fns["cross_pool"](*args)
            err = float((got - plain_fns["pool"](*pargs)).abs().max())
            scale = float(plain_fns["pool"](*pargs).abs().max())
            same = torch.equal(got, cuda_fns["pool"](*pargs))
            worst = max(worst, err / scale)
            results["cross_pool"]["max_abs_err"] = max(
                results["cross_pool"]["max_abs_err"], err)
            log(f"    {site('cross_pool', args)}: max abs err {err:.3g}, "
                f"bit-equal to the pool kernel {same}")
            check(same, "cross_pool at L=1 differs from the pool kernel")
            check(err <= ATTIC_TOL * scale, f"cross_pool: {err}")
        cp_times = time_sites("cross_pool", cp_sites)
        log(f"  cross_pool L=1 per eval forward: {cp_times['ms']:.4f} ms "
            f"(the pool kernel {eval_times['pool']['ms']:.4f} ms), plain "
            f"{cp_times['plain_ms']:.4f} ms, bound "
            f"{cp_times['bound_ms']:.5f} ms")
        two = []
        for c, (u, v, idx, w, b) in sorted(
                {a[0].shape[2]: a for a in cp_sites}.items()):
            w2 = torch.randn(c, c, device="cuda", generator=gen) / c ** 0.5
            b2 = 0.1 * torch.randn(c, device="cuda", generator=gen)
            args = (u, v, idx, w + [w2], b + [b2])
            got, want = cuda_fns["cross_pool"](*args), cross_mod.\
                cross_pool_plain(*args)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            worst = max(worst, err / scale)
            results["cross_pool"]["max_abs_err"] = max(
                results["cross_pool"]["max_abs_err"], err)
            log(f"    {site('cross_pool', args)}: max abs err {err:.3g}, "
                f"max |plain| {scale:.3g}")
            check(err <= ATTIC_TOL * scale, f"cross_pool L=2: {err}")
            two.append(args)
        cp2_times = time_sites("cross_pool", two)
        results["cross_pool"]["match"] = (
            f"bit-equal to the pool kernel at L=1; max err / max|plain| "
            f"{worst:.3g} at L=1 and 2")
    torch.cuda.synchronize()
    deadline("attic kernels")

    # ---------------------------------------------------------------- 10
    teacher = BidPointFlowNet(
        PRESETS["teacher"], device="cuda",
        generator=torch.Generator().manual_seed(TEACHER_SEED))
    student = BidPointFlowNet(
        PRESETS["lighttoken_res"], device="cuda",
        generator=torch.Generator().manual_seed(STUDENT_SEED))
    p_student = copy.deepcopy(student)
    b_students = [copy.deepcopy(student) for _ in range(2)]
    t_state = {k: v.clone() for k, v in teacher.state_dict().items()}
    kd_loss = make_named_loss(KD_LOSS, KD_ARGS)
    kd_opt = make_optimizer(student, 1e-3, 1e-4)
    kd_step = make_distill_step(teacher, student, kd_opt, loss_fn=kd_loss)
    kd_step_p = make_distill_step(teacher, p_student,
                                  make_optimizer(p_student, 1e-3, 1e-4),
                                  loss_fn=kd_loss)
    kernels.reset_launches()
    loss_k = float(kd_step(kd_batch))
    kd_launches = dict(kernels.LAUNCHES)
    log(f"[10/15 KD path] one distill step, teacher -> lighttoken_res, "
        f"batch {KD_BATCH}, {N_POINTS} points, {KD_LOSS} {KD_ARGS}: "
        f"launches {kd_launches}")
    check(kd_launches == PER_KD_STEP,
          f"launches {kd_launches}, expected {PER_KD_STEP}")
    with swapped(lambda n, entry, plain: plain):
        loss_p = float(kd_step_p(kd_batch))
    check(kernels.LAUNCHES == kd_launches,
          "the plain distill step launched a kernel")
    log(f"  loss kernels {loss_k:.9g}, plain {loss_p:.9g}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "KD loss differs")
    worst, leaf, median, n_leaves, zero_leaves, top = compare_grads(
        student, p_student)
    log(f"  student gradients: {n_leaves} leaves, error / max|plain| worst "
        f"{worst:.3g} ({leaf}), median {median:.3g} (bound {GRAD_TOL}); "
        f"{zero_leaves} zero-gradient leaves below 1e-5 of the largest "
        f"gradient {top:.3g}")
    bn_err = compare_stats(student, p_student)
    log(f"  student BatchNorm statistics: error / max|plain| {bn_err:.3g}")
    check(bn_err <= 1e-5, f"BatchNorm statistics differ: {bn_err}")
    t_same = all(torch.equal(v, t_state[k])
                 for k, v in teacher.state_dict().items())
    log(f"  teacher: parameters and statistics bit-unchanged {t_same}, "
        f"eval mode {not teacher.training}, gradients none "
        f"{all(p.grad is None for p in teacher.parameters())}")
    check(t_same and not teacher.training
          and all(p.grad is None for p in teacher.parameters()),
          "the teacher moved")
    del p_student, kd_step_p
    deadline("KD path")

    # ---------------------------------------------------------------- 11
    time_steps(kd_step, kd_batch, "11/15 KD timing", "KD step", KD_BATCH)
    kd_calls = {n: [] for n in points}
    rec_student = copy.deepcopy(student).train()
    with swapped(recorder(kd_calls)), torch.no_grad():
        apply_frozen(teacher, kd_batch)
        rec_student(kd_batch["pos1"], kd_batch["pos2"], kd_batch["norm1"],
                    kd_batch["norm2"])
    del rec_student
    got = {n: len(c) for n, c in kd_calls.items()}
    check(got == {n: PER_KD_STEP[n] for n in points},
          f"call sites per KD step {got}")
    kd_sites = dict(kd_calls, pool_bwd=[
        (*args, torch.randn(args[2].shape, device="cuda", generator=gen))
        for args in kd_calls["pool"][PER_FORWARD["pool"]:]])
    kd_times = time_path(kd_sites, "KD step")
    del kd_sites, kd_calls
    deadline("KD timing")

    # ---------------------------------------------------------------- 12
    layer = KD_ARGS["hint_layers"][-1]
    width = PRESETS["teacher"].lift_channels[layer]
    bridges = [Bridge(width, 512, device="cuda",
                      generator=torch.Generator().manual_seed(SEED + 4))
               for _ in range(2)]
    bridges[1].load_state_dict(bridges[0].state_dict())
    b_before = {k: v.clone() for k, v in bridges[0].state_dict().items()}
    b_steps = [make_bridge_distill_step(
        teacher, s, br, make_optimizer(s, 1e-3, 1e-4),
        make_optimizer(br, 1e-3, 1e-4), gamma=KD_ARGS["gamma"],
        beta=KD_ARGS["beta"], layer=layer)
        for s, br in zip(b_students, bridges)]
    kernels.reset_launches()
    loss_k = float(b_steps[0](kd_batch))
    b_launches = dict(kernels.LAUNCHES)
    with swapped(lambda n, entry, plain: plain):
        loss_p = float(b_steps[1](kd_batch))
    log(f"[12/15 bridge KD step] Bridge({width} -> 512) on the teacher's "
        f"layer-{layer} features, batch {KD_BATCH}: launches {b_launches}; "
        f"loss kernels {loss_k:.9g}, plain {loss_p:.9g}")
    check(b_launches == PER_KD_STEP and kernels.LAUNCHES == b_launches,
          f"bridge step launches {b_launches}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "bridge loss differs")
    for label, mk, mp in (("bridge", *bridges), ("student", *b_students)):
        worst, leaf, median, n_leaves, _, _ = compare_grads(mk, mp)
        log(f"  {label} gradients: {n_leaves} leaves, error / max|plain| "
            f"worst {worst:.3g} ({leaf}), median {median:.3g} (bound "
            f"{GRAD_TOL})")
    moved = sum(not torch.equal(v, b_before[k])
                for k, v in bridges[0].state_dict().items())
    log(f"  bridge tensors moved by the step: {moved} of {len(b_before)}")
    check(moved == len(b_before), "the bridge did not train")
    check(all(torch.equal(v, t_state[k])
              for k, v in teacher.state_dict().items()), "the teacher moved")
    del bridges, b_students, b_steps
    deadline("bridge step")

    # ---------------------------------------------------------------- 13
    eval_step = make_eval_step(student)
    epe = float(eval_step(kd_batch)[0].mean())
    ckpt_dir = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    path = save_checkpoint(str(ckpt_dir), "S", N_TRAIN_STEPS, epe,
                           full_state_tree(student, kd_opt, N_TRAIN_STEPS,
                                           epe))
    fresh = BidPointFlowNet(PRESETS["lighttoken_res"], device="cuda",
                            generator=torch.Generator().manual_seed(SEED + 5))
    fresh_opt = make_optimizer(fresh, 1e-3, 1e-4)
    epoch, best_epe, _ = restore_train_state(path, fresh, fresh_opt)
    same_state = all(torch.equal(v, fresh.state_dict()[k])
                     for k, v in student.state_dict().items())
    with torch.inference_mode():
        student.eval()
        fresh.eval()
        a = student(*dev_pairs[0][:4])["flows"]
        b = fresh(*dev_pairs[0][:4])["flows"]
    flows_equal = all(torch.equal(x, y) for x, y in zip(a, b))
    opt_equal = (fresh_opt.state_dict()["state"][0]["step"]
                 == kd_opt.state_dict()["state"][0]["step"])
    log(f"[13/15 checkpoint] {Path(path).name}: epoch {epoch}, best EPE "
        f"{best_epe:.4f}, best_checkpoint finds it "
        f"{best_checkpoint(str(ckpt_dir)) == path}; restored state equal "
        f"{same_state}, Adam step counts equal {opt_equal}, eval flows "
        f"bit-equal {flows_equal}")
    check(best_checkpoint(str(ckpt_dir)) == path and same_state
          and opt_equal and flows_equal and epoch == N_TRAIN_STEPS,
          "checkpoint round trip")
    shutil.rmtree(ckpt_dir)
    deadline("checkpoint")

    # ---------------------------------------------------------------- 14, 15
    def timing(t, launches):
        row = dict(launches=launches, ms=t["ms"], plain_ms=t["plain_ms"],
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"])
        if "chain_ms" in t:
            row["chain_ms"] = t["chain_ms"]
        return row

    kernel_rows = []
    for name in PATH_KERNELS:
        t, e = kd_times[name], eval_times.get(name)
        kernel_rows.append(dict(
            name=name, route="cuda", **KERNEL_META[name],
            **timing(t, kd_launches[name]),
            max_abs_err=results[name]["max_abs_err"], library_ms=None,
            match=results[name]["match"],
            per=f"KD step, batch {KD_BATCH}, {N_POINTS} points",
            train_step=timing(train_times[name], train_launches[name]),
            eval_forward=None if e is None else timing(
                e, eval_launches[name] // N_METRIC_PAIRS)))
    kernel_rows.append(dict(
        name="fps_pruned", route="cuda", **KERNEL_META["fps_pruned"],
        **timing(fp_times, kd_launches["fps_pruned"]),
        max_abs_err=0.0, library_ms=None,
        match=results["fps_pruned"]["match"],
        per=f"one call at B=16 (the KD forward's stacked clouds), "
            f"{N_POINTS} -> {m}; on no path",
        by_batch={str(k): dict(ms=v["ms"], fps_kernel_ms=v["fps_kernel_ms"],
                               updates_share=v["updates_share"])
                  for k, v in attic["fps_pruned"].items()}))
    kernel_rows.append(dict(
        name="cross_pool", route="cuda", **KERNEL_META["cross_pool"],
        **timing(cp_times, kd_launches["cross_pool"]),
        max_abs_err=results["cross_pool"]["max_abs_err"], library_ms=None,
        match=results["cross_pool"]["match"],
        per=f"L=1 at the {len(cp_sites)} pool sites of an eval forward; on "
            "no path",
        two_layers=timing(cp2_times, 0)))
    log("[14/15 kernels]")
    log(json.dumps({"kernels": kernel_rows}))
    log(f"[15/15 done] {time.monotonic() - t0:.1f} s wall; nvidia-smi:")
    log(smi)
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
