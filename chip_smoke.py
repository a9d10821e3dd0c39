#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kd_pointcloud_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs 1 card

It drives the port's paths -- the teacher's eval forward at batch 1 with
8192 points per cloud, through eval.evaluate_model; the teacher's train
step at batch 3, through train.make_train_step; knowledge distillation of
a lighttoken_res student from the frozen teacher at batch 8
(configs/distill_kd.yaml), through train.make_distill_step; the same into
the halved-width `student` preset (bottleneck blocks, a C = 16 cost volume
at l0); the eval forwards of the student presets (student, serving_v3's
coarse warp, student2, non_linear); the feature-grouping family's eval
forwards (bifeat, fg) and the fast KD step bifeat -> fg
(configs/fast_distill.yaml), through train.make_fast_distill_step; and
the no_cross and vote eval forwards; then the user's path, the cli
entries from a YAML through the data pipeline and the epoch loops to the
six-metric eval and the checkpoint; then the tooling around the model: the
blocked-FPS relaxation (fps_blocks), the self-supervised loss's backward
through a student, the profile entry, a trace, and raw frames through the
preprocessors to the eval; then the experimental inventory's modules and
the pointnet2 API on the FPS and kNN kernels, the kNN up to k = 64; then
the teacher's train step on a data mesh (an NCCL world of one rank, and a
gloo world of two ranks on the one card) -- and
holds each hand-written kernel against its plain PyTorch version. Phases, each printing flushed lines as
it goes:

  1. device: name, count, power limit (nvidia-smi), torch and CUDA versions;
  2. build: one nvcc process a csrc/*.cu source, all at once, and one link;
     the seconds, and the registers, shared memory and spills that ptxas
     reports per kernel;
  3. kernels against plain versions, on the inputs that one eval forward
     hands each kernel (1 FPS, 19 kNN, 12 pool call sites): FPS
     bit-identical, with its launch plan (blocks a cloud, from the card's
     cluster occupancy), also on duplicated points (ties across lanes,
     warps and blocks), at N = 8000 (padding) and at l2-l4's N (2048 ->
     512 -> 256 -> 64, as nested_fps=False samples), at every cluster size;
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
     a union case per width (the FG layer's 32 slots, every neighbour
     twice: slots 16-31 repeat slots 0-15 reversed) and a ragged case per
     width (K = 16, N1 off every tile); d_v asked alone bit-equal to the
     full call's at both batches;
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
  9. the attic kernels, on no path, against their plain versions: ptxas's
     registers and spills of both; pruned FPS -> 2048 on the stacked
     8192-point clouds of the eval, train and KD forwards (batches 2, 6,
     16), a clustered cloud and two clouds of 32768 points (the most it
     takes: a cluster of 4 blocks a cloud), bit-identical to fps_plain and
     to the FPS kernel, with the skipped sub-block updates equal to the
     plain version's, timed beside the FPS kernel and its chain
     (kdpc_fps_pruned_skeleton); the L-layer cross pool at L = 1 on the 12
     pool sites of an eval forward and the 3 C = 16 sites of a batch-8
     student train forward, bit-equal to the pool kernel and within 1e-4 x
     max|plain| of pool_plain, and at L = 2 at each width, within 1e-4 x
     max|plain|; the Morton-window kNN (attic/morton.py, plain torch) at
     8192^2, k = 32, window 1024: its recall against the kNN kernel;
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
 14. the pool kernels at C = 16, on the three l0 pool sites of a batch-8
     `student` train forward (K = 32, N1 = N2 = 8192) and at K = 9 with N1
     off every query tile: forward within 1e-4 x max|plain|, backward
     within POOL_BWD_TOL, with the tie, union and ragged cases at C = 16
     and d_v
     alone bit-equal; ptxas's registers, shared memory and spills of the
     C = 16 template instances;
 15. the student KD path: one distill step of `student` (seed 0) from the
     frozen teacher (seed 1), batch 8, biDirectionLoss (gamma 0.3, gamma2
     0.3, beta 0.8; flow-only, as the student's features are half the
     teacher's width), Adam lr 1e-3, weight decay 1e-4, through the
     kernels and the plain versions, held as in phase 10;
 16. student KD timing as in phase 11, with the C = 16 sites' sums;
 17. the eval forwards of student, serving_v3, student2 and non_linear at
     batch 1 through evaluate_model: launches (FPS 1, kNN 19, pool 12;
     serving_v3's l0 warp search of 8192 x 8192 replaced by one of 2048 x
     2048), flows against the plain versions as in phase 4; student and
     serving_v3 timed as in phase 5;
 18. the FG family's eval forwards, bifeat (two refinement iterations at
     l0-l2) and fg, batch 1, through evaluate_model: launches a forward
     from the wiring (forward_launches: fps 1, knn 29 / 20, pool 21 / 12),
     every flow level and iteration against the plain versions as in
     phase 4, the feature-space kNN's indices (plain PyTorch on both
     paths) identical between the two runs at each of its 4 sites, FPS and
     kNN bit-identical to their plain versions at each call site, each
     kernel and the feature kNN timed at their sites (CUDA events), and
     the forwards timed as in phase 5;
 19. the fast KD path: one step of make_fast_distill_step, frozen bifeat
     (seed 1) -> fg (seed 0), batch 8, att_iter_loss (gamma 0.6, layers
     [1, 2]), Adam lr 1e-3, weight decay 1e-4, through the kernels and, on
     a copy of the student, the plain versions, held as in phase 10
     (launches fps 2, knn 49, pool 33, pool_bwd 12);
 20. fast KD timing as in phase 11, with the feature kNN's ms a step (its
     8 sites, CUDA events) beside the kernels;
 21. the no_cross and vote eval forwards at batch 1 against the plain
     versions (launches from the wiring: pool 4 and 8; vote's last round
     is plain PyTorch);
 22. the user's path (workflow): the cli entries on seeded HPLFlowNet-
     layout trees written to a temporary directory (16 + 4 FT3D-subset
     scenes of 10240 points, the class's counts lowered to them; KITTI's
     200 scene directories, 3 mapped scenes of 20480 points with ground
     rows, calib files), each from its configs/*.yaml with the tree, the
     epochs and full: true over it: train_teacher_ft3d at batch 3 for 2
     epochs of 2 steps, with loss, eval EPE3D, wall and checkpoint an
     epoch, then a resume from the best checkpoint for one more epoch (its
     epoch the checkpoint's + 1, its best EPE the checkpoint's); the
     loader's ms a batch at 0 and 2 workers; evaluate_kitti with the
     trained checkpoint (all six metrics, launches a pair FPS 1, kNN 19,
     pool 12); the device and host eval paths on KITTI (batch 1) and on
     FT3D val (batch 3, padded last batch), within EVAL_PATHS_RTOL (ACC2D
     as counts: at most one point a scene apart, a threshold tie); and
     distill_kd (batch 8), distill_bridge (both from the trained teacher)
     and fast_distill, 1 epoch of 2 steps each, with the checkpoint
     written; every run's launches counted from 0;
 23. the tooling (tooling): the FPS kernel bit-identical to fps_plain at
     the blocked shapes of fps_blocks=8 (l1's 8192 -> 2048 as 8 blocks of
     1024 -> 256: 16 clouds at batch 1, 128 at the KD step's batch 8), with
     its plan, and timed beside the exact site; the teacher's eval forward
     with fps_blocks=8 through evaluate_model (launches FPS 1, kNN 19, pool
     12) against its plain-version twin as in phase 4, timed in turns with
     the exact teacher; the self-supervised loss
     (losses.multi_scale_chamfer_smooth_curvature) and its backward through
     a `student` train forward at batch 2 (launches FPS 1, kNN 35, pool 12,
     pool_bwd 12) against the plain versions (loss within 1e-5 relative,
     gradient leaves within GRAD_TOL), its kNN kernel bit-identical to
     knn_plain at each of its 16 sites (k = 10, 9, 5 at 8192^2, 2048^2,
     512^2, 256^2) and timed there; cli.profile for teacher, student and
     fg; the operation count of a tiny_config teacher equal on the CPU and
     the card; a perf.trace of one teacher forward holding one record of
     each of its fps, knn and pool launches (beside a bare profiler
     session's and an empty warm-up step's lost records); seeded raw FT3D (540 x 960) and KITTI
     (375 x 1242) frames through the preprocessors' entries (PNGs the
     bundled codec reads: no PIL), then evaluate_model of a seeded teacher
     on each result (the six metrics: a sanity line);
 24. the experimental inventory (inventory): every module of
     nn/experimental.py, the ConvGRU, the two inventory flow heads and the
     pointnet2 API at the teacher's widths, batch 1 -- l1 (2048 points a
     cloud by the FPS kernel from the 8192-point pair, C = 64; feat_nei 16
     for the PointConv kind, flow_nei 32 for the cross layers, so
     CrossLocalTransLayer searches k = 64 over 2048 keys and
     CrossTransLayer attends 2048 x 2048; 9 neighbours and a hidden 128 for
     the heads) and the down-samplers from l0 (8192 -> 2048, C = 32;
     PointnetSAModule at the smallest radius whose median ball holds half
     its nsample, printed); PointnetFPModule 2048 -> 8192. Each module once
     through the kernels (the launch counts set to 0 before and read
     after; FPS and kNN must launch) and once, on a copy, through the plain
     versions: outputs within max abs 1e-3 / median 1e-5, indices equal;
     its launches and forward ms printed. FPS and kNN bit-identical at
     each distinct site, timed there, the k = 64 site beside its plain
     version and bound; then the kNN kernel alone at k = 1, 2, 7, 8, 24,
     31, 33, 48, 63, 64 over the l1 pair (2048^2, B = 2), an l0 cloud
     (8192^2) and duplicated points (ties across lanes and across a lane's
     two entries), each bit-identical, with its plan;
 25. the data mesh (mesh): the teacher's train step through
     parallel/ at full width and 8192 points -- (a) an NCCL process group
     of one rank in this process, batch_size_per_device 3: the mesh step
     (gradients all-reduced over NCCL) against the no-mesh step on the same
     batch and weights, loss within 1e-5 relative, gradients within
     GRAD_TOL, BatchNorm statistics within 1e-5, launches (FPS 1, kNN 19,
     pool 12, pool_bwd 12), and both timed in turns (2 warm-up and 5 timed
     steps each) with dp_step_model's analytic step at 2, 4 and 8 cards;
     (b) a gloo world of two spawned ranks, both on cuda:0 (NCCL refuses
     two ranks a card), global batch 4 (2 a rank): each rank's loss,
     gradients and BatchNorm statistics against one step over the same 4
     rows in this process under the same gates (a gradient leaf within
     GRAD_TOL plus what moving pos1 by one ulp moves that leaf of the
     one-device step: float32 max and kNN choices flip where the forward
     rounds differently), equal on both ranks, and each rank's launches;
 26. one {"kernels": [...], "plain_ops": [...]} line (the mesh step's
     launches beside each path kernel's row; times per KD step
     for the kernels of the paths, the train step's, the eval forward's,
     the student KD step's and the fast KD step's beside them, the pool's
     C = 16 sites, each workflow run's launches, and the tooling phase's
     blocked FPS and self-supervised kNN sites; the attic kernels at their
     phase-9 shapes; the feature kNN, plain PyTorch, per fast KD step and
     FG eval pair; FPS and kNN at the inventory's sites, the k = 64 site,
     and the inventory modules' forwards);
 27. the nvidia-smi line again, then {"ok": true, "device": {...}} last.

Every number is measured in this run. Float32 products run in full float32
(no TF32). It exits non-zero, printing no result, when there is no card,
outside a checkout, or when any phase fails; a watchdog ends it after
BUDGET_S seconds, the build included.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import faulthandler
import importlib.util
import json
import math
import multiprocessing
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# the halved-width student: its features are half the teacher's width, so
# the hint losses do not apply; biDirectionLoss is flow-only (gamma, gamma2
# 0.3, beta 0.8), with the same Adam lr 1e-3, weight decay 1e-4
STUDENT_LOSS = "biDirectionLoss"
STUDENT_LOSS_ARGS = dict(gamma=0.3, gamma2=0.3, beta=0.8)
EVAL_PRESETS = ("student", "serving_v3", "student2", "non_linear")
TIMED_PRESETS = ("student", "serving_v3")
# the feature-grouping family: eval forwards, then the fast KD step of
# configs/fast_distill.yaml (bifeat -> fg, batch 8, att_iter_loss gamma 0.6,
# layers [1, 2], Adam lr 1e-3, weight decay 1e-4)
FG_PRESETS = ("bifeat", "fg")
FAST_TEACHER, FAST_STUDENT = "bifeat", "fg"
FAST_KD_ARGS = dict(gamma=0.6, layers=(1, 2))
ABLATION_PRESETS = ("no_cross", "vote")
FEATURE_REPS = 5
FPS_PRUNED_BATCHES = (2, 6, 16)    # stacked clouds: eval, train, KD forward
# the Morton-window kNN's line in phase 9: k and window of the JAX module's
# recall note (attic/morton.py), at the l0 search of 8192^2
MORTON_K, MORTON_WINDOW = 32, 1024
# FPS at l2-l4 when nested_fps=False: (N, npoint) of each level's call
NESTED_FPS = ((2048, 512), (512, 256), (256, 64))
# the workflow phase's seeded trees: FT3D-subset scenes (batch 3 x 2 train
# steps, batch 8 x 2 KD steps; a padded last val batch at 3) and KITTI's 3
# mapped scenes, rows a scene before sampling to N_POINTS
WORKFLOW_FT3D = dict(train=16, val=4, points=10240)
WORKFLOW_KITTI = dict(mapped=(0, 1, 5), points=20480)
WORKFLOW_STEPS = 2
WORKFLOW_KD_BATCH = 8
# the tooling phase: fps_blocks=8 (l1's FPS as 8 blocks of 1024 -> 256),
# the self-supervised loss through a student at batch 2 (its chamfer holds
# a 2 x 8192 x 8192 distance matrix), the profile entry's presets, and raw
# frames at the datasets' sizes (FT3D 540 x 960, KITTI 375 x 1242)
FPS_BLOCKS = 8
SELFSUP_BATCH = 2
SELFSUP_KNN = 16            # 4 searches a level (k = 10, 10, 9, 5) x 4
PROFILE_PRESETS = ("teacher", "student", "fg")
RAW_FT3D = dict(train=1, val=2, height=540, width=960)
RAW_KITTI = dict(frames=(0, 1, 2), height=375, width=1242)
# the annotation around the traced forward of the tooling phase
TRACED_FORWARD = "teacher eval forward"
# the inventory phase: the flow heads' neighbours, ConvGRU's hidden width,
# the radii tried for PointnetSAModule's ball, timed forwards a module, and
# the k of the kNN sweep (KERNEL_K's edges, 33-64 at two entries a lane)
INVENTORY_HEAD_K = 9
INVENTORY_GRU_HIDDEN = 128
INVENTORY_RADII = (1.0, 1.25, 1.5, 2.0, 2.5, 3.0)
INVENTORY_REPS = 3
KNN_SWEEP = (1, 2, 7, 8, 24, 31, 33, 48, 63, 64)
# the mesh phase: batch_size_per_device 3 on an NCCL world of one rank; a
# gloo world of MESH_RANKS ranks on cuda:0 at a global batch of
# MESH_BATCH; the cards dp_step_model is asked about; every collective and
# join fails after MESH_TIMEOUT_S
MESH_STEPS, MESH_WARMUP = 5, 2
MESH_RANKS, MESH_BATCH = 2, 4
DP_CARDS = (2, 4, 8)
MESH_TIMEOUT_S = 120
# device against host eval path: the same forward, metrics in torch on the
# card against numpy on the host (float32 sums in another order)
EVAL_PATHS_RTOL = 1e-5
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
# a student forward in train mode, the self-supervised loss on its four
# levels and the backward
PER_SELFSUP_STEP = dict(PER_TRAIN_STEP, knn=PER_FORWARD["knn"] + SELFSUP_KNN)
# launches by width of a student KD step at C = 16: the forward and the
# backward of the l0 cross layer's three pools (every other site is wider)
STUDENT_C16 = {"pool C=16": 3, "pool_bwd C=16": 3}
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
                       design="second: 8 warps a cloud (a cluster of 2 or 4 "
                              "blocks above 8192 points), points in shared "
                              "memory, dirty sub-blocks by ballot, cached "
                              "winners with coordinates, one warp's redux "
                              "fold a round"),
    "cross_pool": dict(source="kd_pointcloud_tpu_torch/csrc/cross_pool.cu",
                       replaces="attic/cross_pool.py:90",
                       design="second: the pool kernel's passes and 8 x 8 "
                              "register tiles over L layers written back in "
                              "place, W resident or streamed, one wave"),
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
    torch.profiler (perf.recording, after its warm-up step and settle,
    whose kernels are left out); device time a {what} by kernel name (the
    port's own kernels marked *), launches a {what}, and the device's busy share of the
    profiled wall (one stream, so kernels do not overlap). The profiler's
    own host cost lowers that share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from kd_pointcloud_tpu_torch.perf import recording
    from kd_pointcloud_tpu_torch.perf.trace import SETTLE_KERNEL

    with recording([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    # kernels only: a user annotation on the device (the optimizer's
    # step, for one) spans kernels that are counted on their own
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and SETTLE_KERNEL not in e.key]
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



def _launches(events, within=None) -> list:
    """Kernel launches (runtime or driver calls) of a Chrome trace, in time
    order, each with whether its kernel has a record there; with within,
    only those inside the span of the annotation of that name."""
    kernel = {e.get("args", {}).get("correlation") for e in events
              if e.get("cat") == "kernel"}
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if within is not None and e.get("name") == within
             and e.get("cat") in ("user_annotation", "cpu_op")]
    return [(e, e.get("args", {}).get("correlation") in kernel)
            for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "LaunchKernel" in str(e.get("name"))
            and (within is None
                 or any(a <= e.get("ts", 0) <= b for a, b in spans))]


def unrecorded_launches(events, within=None) -> int:
    """Kernel launches of a Chrome trace (inside the annotation within,
    where given) whose kernel has no record there."""
    return sum(1 for _, recorded in _launches(events, within)
               if not recorded)


def unrecorded_detail(events, within=None) -> str:
    """Where the unrecorded launches are: their place among the trace's
    launches and the innermost CPU op around each."""
    launches = _launches(events, within)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    out = []
    for i, (e, recorded) in enumerate(launches):
        if recorded:
            continue
        t, tid = e.get("ts", 0), e.get("tid")
        around = [o for o in ops if o.get("tid") == tid
                  and o["ts"] <= t <= o["ts"] + o.get("dur", 0)]
        inner = min(around, key=lambda o: o.get("dur", 0))["name"] \
            if around else "-"
        out.append(f"#{i} of {len(launches)} ({e.get('name')}, in "
                   f"{inner})")
    return "; ".join(out)


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


def union_case(u, idx, v, weight, bias, ct):
    """Pool inputs shaped like the FG layer's union of two neighbour
    halves: slots 16-31 repeat slots 0-15 in reverse, so every neighbour
    is in two slots of its query, an exact tie of two slots everywhere."""
    idx = idx.clone()
    idx[:, :, 16:32] = idx[:, :, :16].flip(-1)
    return u, idx, v, weight, bias, ct


def forward_launches(cfg) -> dict:
    """Kernel launches of one forward of cfg, from its wiring. FPS once
    (l1; l2-l4 slice its ordering). kNN: the encoder's groupings (l1-l4,
    and l0's PointConv with encoder="pointconv"), the l4 -> l3 and three
    decoder 3-NN, and per cross-layer call (l3 once, l2-l0 iters times)
    its 3-D search (both directions stacked; the FG layer's Euclidean
    half; no_cross's one direction) and the flow head's self-kNN, and per
    l2-l0 call one warp search (a coarse warp searches one level up
    instead). Pool: 3 a cross-layer call, 2 for vote (its last round is
    plain), 1 for no_cross."""
    calls = 1 + 3 * cfg.iters
    encoder = 4 + (cfg.encoder == "pointconv")
    pools = {"light": 3, "fg": 3, "vote": 2, "nocross": 1}[cfg.cross]
    return {"fps": 1, "knn": encoder + 4 + 2 * calls + 3 * cfg.iters,
            "pool": pools * calls, "pool_bwd": 0, "fps_pruned": 0,
            "cross_pool": 0}


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


def leaf_errors(model_k, model_p) -> tuple:
    """Each gradient leaf of model_k against model_p's: error / the leaf's
    max |model_p|, zero-gradient leaves below 1e-5 of the largest gradient
    (checked, and left out). Returns ({leaf: ratio}, zero leaves, largest
    gradient)."""
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
    return rels, zero_leaves, top


def compare_grads(model_k, model_p, allow=None) -> tuple:
    """Every gradient leaf of model_k (a step through the kernels) against
    model_p's (the plain versions): error / the leaf's max |plain| within
    GRAD_TOL, plus allow[leaf] where given; zero-gradient leaves below 1e-5
    of the largest gradient. Returns (worst ratio, its leaf, median ratio,
    leaves, zero leaves, largest gradient)."""
    rels, zero_leaves, top = leaf_errors(model_k, model_p)
    allow = allow or {}
    for n, r in rels.items():
        bound = GRAD_TOL + allow.get(n, 0.0)
        check(r <= bound, f"gradient {n}: {r} (bound {bound})")
    worst = max(rels, key=rels.get)
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


def mesh_rank(rank: int, world: int, init_file: str, out: str, cfg,
              device: str = "cuda", n_points: int = N_POINTS) -> None:
    """One rank of the mesh phase's gloo world on device (cuda:0 for all
    ranks on the card): the train step of a cfg model (seed SEED) through
    parallel/ on its rows of the global batch; saves its loss, launches,
    gradients and buffers to out."""
    import torch

    sys.path.insert(0, str(ROOT))
    from kd_pointcloud_tpu_torch.models import BidPointFlowNet
    from kd_pointcloud_tpu_torch.ops import kernels
    from kd_pointcloud_tpu_torch.parallel import init_mesh, shard_batch
    from kd_pointcloud_tpu_torch.train import make_optimizer, make_train_step
    from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

    torch.set_num_threads(1)
    dev = "cuda:0" if device == "cuda" else device
    mesh = init_mesh(rank, world, f"file://{init_file}", dev, backend="gloo",
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    model = BidPointFlowNet(cfg, device=dev,
                            generator=torch.Generator().manual_seed(SEED))
    step = make_train_step(model, make_optimizer(model), mesh=mesh)
    batch = shard_batch(mesh, synthetic_batches(1, MESH_BATCH, n_points,
                                                SEED + 5, dev)[0])
    kernels.reset_launches()
    loss = float(step(batch))
    torch.save(dict(loss=loss, launches=dict(kernels.LAUNCHES),
                    rows=batch["pos1"].shape[0],
                    grads={n: p.grad.cpu() for n, p in
                           model.named_parameters()},
                    buffers={n: b.cpu() for n, b in model.named_buffers()}),
               out)


def workflow(device: str, n_points: int = N_POINTS, ft3d=None, kitti=None,
             steps: int = WORKFLOW_STEPS) -> dict:
    """The user's path through the cli entries, on seeded trees written
    under a temporary directory (data.synthetic): an FT3D-subset tree of
    ft3d["train"] + ft3d["val"] scenes (the class's counts lowered to it)
    and a KITTI tree of 200 scene directories, ft3d / kitti["points"] rows
    a scene. Each run reads a kd_pointcloud_tpu/configs YAML with the tree,
    an experiment directory, the epochs and full: true written over it:

      train (2 epochs of `steps` steps, then a resume from the best
      checkpoint for one more epoch), the loader alone (ms a batch at 0 and 2
      workers), evaluate on KITTI with the trained checkpoint, the device
      and host eval paths on KITTI (batch 1) and FT3D val (batch 3, padded
      last batch) from fresh loaders at 0 workers, so both see the same
      points, and distill, distill_bridge (the trained teacher) and
      fast_distill, 1 epoch of `steps` steps each.

    Every run's kernel launches are counted from 0 (set just before it,
    read just after). Returns what it measured; raises on a fault."""
    import torch
    import yaml

    from kd_pointcloud_tpu_torch.cli import (distill, distill_bridge,
                                             evaluate, fast_distill, train)
    from kd_pointcloud_tpu_torch.data import (DataLoader, datasets,
                                              native_io, synthetic)
    from kd_pointcloud_tpu_torch.eval import evaluate_model
    from kd_pointcloud_tpu_torch.ops import kernels
    from kd_pointcloud_tpu_torch.train import (build_datasets, build_model,
                                               load_checkpoint, load_weights)
    from kd_pointcloud_tpu_torch.utils import Config, postprocess

    ft3d = ft3d or WORKFLOW_FT3D
    kitti = kitti or WORKFLOW_KITTI
    cuda = device == "cuda"
    out = dict(runs={}, native_io=native_io.available())
    base = Path(tempfile.mkdtemp(prefix="kdpc_workflow_"))
    cls = datasets.FlyingThings3DSubset
    counts = cls.TRAIN_COUNT, cls.VAL_COUNT

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def config(name, **over):
        raw = yaml.safe_load((ROOT / "kd_pointcloud_tpu" / "configs"
                              / f"{name}.yaml").read_text())
        raw.update(over)
        path = base / f"{name}_{len(list(base.glob('*.yaml')))}.yaml"
        path.write_text(yaml.safe_dump(raw))
        return str(path)

    def run(label, fn):
        sync()
        kernels.reset_launches()
        t = time.perf_counter()
        result = fn()
        sync()
        out["runs"][label] = dict(seconds=time.perf_counter() - t,
                                  launches=dict(kernels.LAUNCHES))
        return result

    def epochs_log(label, history):
        for h in history:
            steps_ = max(h["steps"], 1)
            log(f"  {label} epoch {h['epoch']}: loss {h['loss']:.6f}, eval "
                + ("skipped" if h["epe"] is None else
                   f"EPE3D {h['epe']:.6f}, eval loss {h['eval_loss']:.6f}")
                + f"; wall {h['seconds']:.3f} s (loader wait "
                f"{h['load_s'] * 1e3 / steps_:.3f} ms a step, "
                f"{(h['train_s'] - h['load_s']) * 1e3 / steps_:.3f} ms a "
                f"step else, eval {h['eval_s']:.3f} s); checkpoint "
                f"{Path(h['checkpoint']).name if h['checkpoint'] else '-'}")
            check(all(x is None or math.isfinite(x) for x in
                      (h["loss"], h["epe"], h["eval_loss"])),
                  f"{label} epoch {h['epoch']}: not finite")

    try:
        cls.TRAIN_COUNT, cls.VAL_COUNT = ft3d["train"], ft3d["val"]
        t = time.perf_counter()
        ft_root = synthetic.write_ft3d_tree(str(base / "ft3d"),
                                            ft3d["train"], ft3d["val"],
                                            ft3d["points"], seed=SEED)
        kitti_root, calib = synthetic.write_kitti_tree(
            str(base / "kitti"), kitti["mapped"], kitti["points"],
            seed=SEED)
        log(f"  trees: FT3D {ft3d['train']} train + {ft3d['val']} val "
            f"scenes of {ft3d['points']} points, KITTI 200 scene "
            f"directories, {len(kitti['mapped'])} mapped of "
            f"{kitti['points']} points with ground rows, in "
            f"{time.perf_counter() - t:.3f} s; native reader "
            f"{'built' if out['native_io'] else 'unavailable: numpy'}")
        common = dict(data_root=ft_root, experiment_dir=str(base / "exp"),
                      num_points=n_points, full=True)
        argv = ["--device", device]

        # ---- train, then resume from the best checkpoint
        t_cfg = config("train_teacher_ft3d", epochs=2, **common)
        _, _, best, _, hist = run("train", lambda: train.main(
            [t_cfg, *argv], max_steps_per_epoch=steps))
        epochs_log("train", hist)
        ckpt = [h["checkpoint"] for h in hist if h["checkpoint"]][-1]
        saved = load_checkpoint(ckpt)
        check(best == saved["best_epe"], "best EPE is not the checkpoint's")
        r_cfg = config("train_teacher_ft3d", epochs=saved["epoch"] + 2,
                       pretrain=ckpt, **common)
        _, _, best_r, _, hist_r = run("resume", lambda: train.main(
            [r_cfg, *argv], max_steps_per_epoch=steps))
        epochs_log("resume", hist_r)
        check([h["epoch"] for h in hist_r] == [saved["epoch"] + 1],
              f"resumed at {[h['epoch'] for h in hist_r]}, checkpoint "
              f"epoch {saved['epoch']}")
        check(best_r == min(saved["best_epe"], hist_r[0]["epe"]),
              "the resumed run did not start from the checkpoint's best")
        log(f"  resume: checkpoint epoch {saved['epoch']}, best EPE "
            f"{saved['best_epe']:.6f}; resumed at epoch "
            f"{hist_r[0]['epoch']}, best EPE after it {best_r:.6f}")
        out["train"] = dict(epochs=hist, resume=hist_r)

        # ---- the loader alone: ms a batch, in-process and with the pool
        args = postprocess(Config(yaml.safe_load(Path(t_cfg).read_text())))
        train_ds, _ = build_datasets(args)
        out["loader_ms"] = {}
        for batch in (args.batch_size, WORKFLOW_KD_BATCH):
            for workers in (0, args.workers):
                loader = DataLoader(train_ds, batch, shuffle=True,
                                    drop_last=True, num_workers=workers)
                t = time.perf_counter()
                stamps = [time.perf_counter() for _ in loader]
                loader.close()
                first = (stamps[0] - t) * 1e3
                rest = ((stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
                        if len(stamps) > 1 else float("nan"))
                out["loader_ms"][f"batch {batch}, {workers} workers"] = dict(
                    first=first, then=rest, batches=len(stamps))
                log(f"  loader: batch {batch}, {workers} workers: first "
                    f"batch {first:.3f} ms"
                    + (" (the pool's start included)" if workers else "")
                    + f", then {rest:.3f} ms a batch over "
                    f"{len(stamps) - 1} more")

        # ---- evaluate with the trained checkpoint (KITTI, batch 1)
        e_cfg = config("evaluate_kitti", data_root=kitti_root,
                       pretrain=ckpt, num_points=n_points)
        results = run("evaluate", lambda: evaluate.main([e_cfg, *argv]))
        n_pairs = len(kitti["mapped"])
        per = {k: v / n_pairs for k, v in
               out["runs"]["evaluate"]["launches"].items() if v}
        log("  evaluate (KITTI, 3 scenes, batch 1): " + ", ".join(
            f"{k} {v:.6f}" for k, v in results.items())
            + f"; launches a pair {per}")
        check(all(math.isfinite(v) for v in results.values()),
              f"evaluate: {results}")
        out["evaluate"] = dict(metrics=results, launches_a_pair=per)

        # ---- the device and host paths on the same points
        model = build_model(Config(), device=device)
        model.load_state_dict(load_weights(ckpt), strict=True)
        e_args = postprocess(Config(yaml.safe_load(Path(e_cfg).read_text())))
        out["eval_paths"] = {}
        for label, a, batch, n_real in (
                ("KITTI", e_args, 1, n_pairs),
                ("FT3D val", args, 3, ft3d["val"])):
            sweeps = {}
            for path in ("device", "host"):
                _, val_ds = build_datasets(a, need_train=False)
                loader = DataLoader(val_ds, batch, shuffle=False,
                                    pad_last=True, num_workers=0)
                sweeps[path] = run(f"eval {label} {path}", lambda: (
                    evaluate_model(model, loader, calib_dir=calib,
                                   device_metrics=path == "device")))
                ms = out["runs"][f"eval {label} {path}"]["seconds"] * 1e3
                log(f"  {label} {path} path, batch {batch}, {n_real} "
                    f"scenes ({ms / n_real:.3f} ms a scene): " + ", ".join(
                        f"{k} {v:.6f}" for k, v in sweeps[path].items()))
            dev, host = sweeps["device"], sweeps["host"]
            check(list(dev) == list(host), f"{label}: keys differ")
            for k in dev:
                if k == "acc2d":        # counts of points, ties aside
                    diff = abs(dev[k] - host[k]) * n_points * n_real
                    check(diff <= n_real + 1e-3,
                          f"{label} acc2d counts differ by {diff}")
                else:
                    check(abs(dev[k] - host[k]) <= EVAL_PATHS_RTOL * max(
                        abs(host[k]), 1e-6), f"{label} {k}: {dev[k]} "
                          f"device, {host[k]} host")
            out["eval_paths"][label] = sweeps
        del model

        # ---- the three distillation entries
        teacher = dict(ckpt_dir=str(Path(ckpt).parent),
                       teacher_model=Path(ckpt).name)
        out["distill"] = {}
        for label, entry, name, extra in (
                ("distill", distill, "distill_kd", teacher),
                ("distill_bridge", distill_bridge, "distill_bridge",
                 teacher),
                ("fast_distill", fast_distill, "fast_distill", {})):
            d_cfg = config(name, epochs=1, **common, **extra)
            _, _, best_d, _, hist_d = run(label, lambda: entry.main(
                [d_cfg, *argv], max_steps_per_epoch=steps))
            epochs_log(label, hist_d)
            check(hist_d[0]["checkpoint"] is not None
                  and Path(hist_d[0]["checkpoint"]).exists(),
                  f"{label}: no checkpoint written")
            out["distill"][label] = hist_d
    finally:
        cls.TRAIN_COUNT, cls.VAL_COUNT = counts
        shutil.rmtree(base, ignore_errors=True)
    return out


def preprocess_eval(device: str, n_points: int = N_POINTS, ft3d=None,
                    kitti=None, workers: int = 2) -> dict:
    """Raw frames to the eval: seeded raw FT3D-subset and KITTI frames
    (data.synthetic; ft3d / kitti give their counts and sizes) through the
    preprocessors' entries (data.preprocess.ft3d with the near-points
    filter, data.preprocess.kitti), into the trees the datasets read, then
    evaluate_model of a seeded teacher at batch 1 on each tree (FT3D val,
    KITTI with its calibration). Every raw PNG is one the bundled codec
    reads, so no step needs PIL. Each eval's launches are counted from 0.
    Returns what it measured; raises on a fault."""
    import numpy as np
    import torch

    from kd_pointcloud_tpu_torch.data import (KITTI, DataLoader,
                                              FlyingThings3DSubset,
                                              ProcessData, synthetic)
    from kd_pointcloud_tpu_torch.data.preprocess import ft3d as ft3d_pre
    from kd_pointcloud_tpu_torch.data.preprocess import kitti as kitti_pre
    from kd_pointcloud_tpu_torch.data.preprocess import png16
    from kd_pointcloud_tpu_torch.eval import evaluate_model
    from kd_pointcloud_tpu_torch.models import PRESETS, BidPointFlowNet
    from kd_pointcloud_tpu_torch.ops import kernels

    ft3d = ft3d or RAW_FT3D
    kitti = kitti or RAW_KITTI
    base = Path(tempfile.mkdtemp(prefix="kdpc_preprocess_"))
    out = dict(seconds={}, scenes={}, metrics={}, launches={})
    try:
        t = time.perf_counter()
        raw_ft = synthetic.write_raw_ft3d(
            str(base / "raw_ft3d"), ft3d["train"], ft3d["val"],
            ft3d["height"], ft3d["width"], seed=SEED)
        raw_ki, calib = synthetic.write_raw_kitti(
            str(base / "raw_kitti"), kitti["frames"], kitti["height"],
            kitti["width"], seed=SEED)
        out["seconds"]["raw frames"] = time.perf_counter() - t
        pngs = sorted(base.rglob("*.png"))
        check(pngs and all(png16.decodable(str(f)) for f in pngs),
              "a raw PNG the codec does not read")
        ft_root = base / "ft3d"
        ki_root = base / "kitti"
        for label, entry, argv in (
                ("ft3d", ft3d_pre, ["--raw_data_path", raw_ft,
                                    "--save_path", str(
                                        ft_root / FlyingThings3DSubset.DIRNAME),
                                    "--only_save_near_pts"]),
                ("kitti", kitti_pre, [raw_ki, str(ki_root / "kitti_processed"),
                                      "--calib_root", calib])):
            t = time.perf_counter()
            entry.main(argv + ["--workers", str(workers)])
            out["seconds"][f"preprocess {label}"] = time.perf_counter() - t
        mapped = set(kitti["frames"])
        (ki_root / "KITTI_mapping.txt").write_text("".join(
            ("mapped" if i in mapped else "") + "\n" for i in range(200)))

        model = BidPointFlowNet(PRESETS["teacher"], device=device,
                                generator=torch.Generator().manual_seed(SEED))
        transform = ProcessData(num_points=n_points)
        for label, ds, calib_dir in (
                ("FT3D val", FlyingThings3DSubset(
                    False, transform, str(ft_root), strict_counts=False,
                    num_points=n_points), None),
                ("KITTI", KITTI(False, transform, str(ki_root),
                                strict_counts=False, num_points=n_points),
                 calib)):
            out["scenes"][label] = [int(np.load(Path(d) / "pc1.npy",
                                                mmap_mode="r").shape[0])
                                    for d in ds.samples]
            loader = DataLoader(ds, 1, shuffle=False, pad_last=True,
                                num_workers=0)
            if device == "cuda":
                torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            metrics = evaluate_model(model, loader, calib_dir=calib_dir)
            if device == "cuda":
                torch.cuda.synchronize()
            out["seconds"][f"eval {label}"] = time.perf_counter() - t
            out["launches"][label] = dict(kernels.LAUNCHES)
            out["metrics"][label] = metrics
            check(len(metrics) == 7 and all(math.isfinite(v)
                                            for v in metrics.values()),
                  f"{label}: metrics {metrics}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def mesh_phase(tmp: str, cfg, device: str = "cuda",
               n_points: int = N_POINTS, card: str = "") -> dict:
    """Phase 25: the train step of a cfg model (the teacher) on a data
    mesh. (a) an NCCL world of one rank here (gloo off the card) against
    the no-mesh step, and both timed in turns; (b) a gloo world of
    MESH_RANKS spawned ranks on cuda:0 against one step over the same
    global batch here. card (nvidia-smi's name and power limit) heads the
    timing line. Returns the launches of (a)'s step and of each rank's,
    and (a)'s ms a step."""
    import torch
    import torch.distributed as dist

    from kd_pointcloud_tpu_torch.models import BidPointFlowNet
    from kd_pointcloud_tpu_torch.ops import kernels
    from kd_pointcloud_tpu_torch.parallel import (init_mesh,
                                                  resolve_global_batch,
                                                  shard_batch)
    from kd_pointcloud_tpu_torch.parallel.cost_model import (dp_step_model,
                                                             param_bytes_of)
    from kd_pointcloud_tpu_torch.train import make_optimizer, make_train_step
    from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

    dev = "cuda:0" if device == "cuda" else device

    def teacher():
        return BidPointFlowNet(cfg, device=dev,
                               generator=torch.Generator().manual_seed(SEED))

    # (b)'s ranks start first: each takes seconds to reach the card
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(
        r, MESH_RANKS, f"{tmp}/gloo", f"{tmp}/rank{r}.pt", cfg, device,
        n_points), daemon=True) for r in range(MESH_RANKS)]
    for proc in procs:
        proc.start()
    try:
        # (a) NCCL, world 1, in this process
        mesh = init_mesh(0, 1, f"file://{tmp}/nccl", dev,
                         timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        backend = dist.get_backend(mesh.group)
        global_bs = resolve_global_batch(TRAIN_BATCH, True, mesh.size)
        want_backend = "nccl" if device == "cuda" else "gloo"
        check(mesh.size == 1 and mesh.group is not None
              and backend == want_backend and global_bs == TRAIN_BATCH,
              f"the mesh: size {mesh.size}, backend {backend}, global "
              f"batch {global_bs}")
        batch = synthetic_batches(1, global_bs, n_points, SEED + 1, dev)[0]
        m_mesh = teacher()
        m_none = copy.deepcopy(m_mesh)
        step_mesh = make_train_step(m_mesh, make_optimizer(m_mesh),
                                    mesh=mesh)
        step_none = make_train_step(m_none, make_optimizer(m_none))
        rows = shard_batch(mesh, batch)
        kernels.reset_launches()
        loss_m = float(step_mesh(rows))
        launches = dict(kernels.LAUNCHES)
        loss_n = float(step_none(batch))
        want = (PER_TRAIN_STEP if device == "cuda"
                else dict.fromkeys(kernels.LAUNCHES, 0))
        log(f"[25/27 mesh] (a) {backend} world of {mesh.size} rank, "
            f"batch_size_per_device {TRAIN_BATCH}: the teacher's train step "
            f"through the mesh, {n_points} points, launches {launches}")
        check(launches == want,
              f"mesh step launches {launches}, expected {want}")
        log(f"  loss mesh {loss_m:.9g}, no mesh {loss_n:.9g}")
        check(abs(loss_m - loss_n) <= 1e-5 * abs(loss_n),
              "mesh step loss differs")
        worst, leaf, median, n_leaves, _, _ = compare_grads(m_mesh, m_none)
        bn_err = compare_stats(m_mesh, m_none)
        log(f"  gradients: {n_leaves} leaves, error / max|no mesh| worst "
            f"{worst:.3g} ({leaf}), median {median:.3g} (bound {GRAD_TOL}); "
            f"BatchNorm statistics {bn_err:.3g} (bound 1e-5)")
        check(bn_err <= 1e-5, f"BatchNorm statistics differ: {bn_err}")
        for _ in range(MESH_WARMUP):
            step_none(batch)
            step_mesh(rows)
        times = {"no mesh": [], "mesh": []}
        turns = (("no mesh", step_none, batch), ("mesh", step_mesh, rows))
        for i in range(MESH_STEPS):
            for label, fn, b in turns[::1 if i % 2 == 0 else -1]:
                t = time.perf_counter()         # float() synchronised
                float(fn(b))
                times[label].append((time.perf_counter() - t) * 1e3)
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"  {card or dev}: {MESH_STEPS} steps each after "
            f"{MESH_WARMUP + 1} warm-up, in turns: ms a step median mesh "
            f"{med['mesh']:.3f} (min "
            f"{min(times['mesh']):.3f}), no mesh {med['no mesh']:.3f} (min "
            f"{min(times['no mesh']):.3f})")
        nbytes = param_bytes_of(m_mesh)
        for n in DP_CARDS:
            model_ = dp_step_model(n, nbytes, med["mesh"])
            log(f"  analytic (dp_step_model, NVLink 4 at 450 GB/s a way, "
                f"not measured) {n} cards: all-reduce "
                f"{model_['allreduce_ms']:.4f} ms of "
                f"{model_['grad_mbytes']:.2f} MB, step "
                f"{model_['expected_step_ms_serial']:.3f} ms serial, "
                f"efficiency {model_['scaling_efficiency_serial']:.4f}")
        dist.destroy_process_group()
        del m_mesh, m_none, step_mesh, step_none

        # (b) gloo, world 2, on cuda:0; the reference: one step over the
        # same global batch here, and the control: that step again with
        # pos1 moved by one ulp
        whole = synthetic_batches(1, MESH_BATCH, n_points, SEED + 5, dev)[0]
        ref, control = teacher(), teacher()
        loss_r = float(make_train_step(ref, make_optimizer(ref))(whole))
        nudged = dict(whole, pos1=torch.nextafter(
            whole["pos1"], torch.full_like(whole["pos1"], math.inf)))
        make_train_step(control, make_optimizer(control))(nudged)
        spread, _, _ = leaf_errors(control, ref)
        log(f"  (b) control: the world-1 step on pos1 moved by one ulp, "
            f"gradients worst {max(spread.values()):.3g}, median "
            f"{statistics.median(spread.values()):.3g} of the leaf's max; "
            f"the step's own rounding moves this much")
        for proc in procs:
            proc.join(MESH_TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    check(all(proc.exitcode == 0 for proc in procs),
          f"gloo ranks exited with {[proc.exitcode for proc in procs]}")
    got = [torch.load(f"{tmp}/rank{r}.pt") for r in range(MESH_RANKS)]
    rank_launches = [g["launches"] for g in got]
    log(f"  (b) gloo world of {MESH_RANKS} spawned ranks on {dev}, global "
        f"batch {MESH_BATCH} ({[g['rows'] for g in got]} rows a rank): "
        f"launches a rank {rank_launches}")
    for r, g in enumerate(got):
        check(g["launches"] == want, f"rank {r} launches {g['launches']}")
        holder = teacher()
        for n, p in holder.named_parameters():
            p.grad = g["grads"][n].to(dev)
        with torch.no_grad():
            for n, b in holder.named_buffers():
                b.copy_(g["buffers"][n])
        rels, _, _ = leaf_errors(holder, ref)
        past = sorted(n for n, v in rels.items() if v > GRAD_TOL)
        worst, leaf, median, n_leaves, _, _ = compare_grads(holder, ref,
                                                            allow=spread)
        bn_err = compare_stats(holder, ref)
        within = ", ".join(f"{n} {rels[n]:.3g}, control {spread[n]:.3g}"
                           for n in past) or "none"
        log(f"  rank {r}: loss {g['loss']:.9g} (one device {loss_r:.9g}); "
            f"gradients worst {worst:.3g} ({leaf}), median {median:.3g}; "
            f"{len(past)} of {n_leaves} leaves past {GRAD_TOL}, each within "
            f"it plus the control's error there ({within}); BatchNorm "
            f"statistics {bn_err:.3g}")
        check(abs(g["loss"] - loss_r) <= 1e-5 * abs(loss_r),
              f"rank {r} loss differs")
        check(bn_err <= 1e-5, f"rank {r} BatchNorm statistics: {bn_err}")
    same = all(torch.equal(got[0]["grads"][n], g["grads"][n])
               for g in got[1:] for n in got[0]["grads"]) and all(
        torch.equal(got[0]["buffers"][n], g["buffers"][n])
        for g in got[1:] for n in got[0]["buffers"])
    check(same, "the ranks' gradients or statistics differ")
    log("  every rank holds the same gradients and statistics, bit for bit")
    return dict(launches=launches, rank_launches=rank_launches,
                ms=med["mesh"], no_mesh_ms=med["no mesh"])


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
    from kd_pointcloud_tpu_torch.attic import morton as morton_mod
    from kd_pointcloud_tpu_torch.eval import (evaluate_model,
                                              make_eval_forward,
                                              pairs_loader, synthetic_pairs)
    from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                                Bridge)
    from kd_pointcloud_tpu_torch.nn import ConvGRU
    from kd_pointcloud_tpu_torch.nn import cross as cross_nn
    from kd_pointcloud_tpu_torch.nn import experimental as ex_nn
    from kd_pointcloud_tpu_torch.nn import flowhead as flowhead_nn
    from kd_pointcloud_tpu_torch.ops import gather_points, square_distance
    from kd_pointcloud_tpu_torch.ops import pointnet2_compat as pn2
    from kd_pointcloud_tpu_torch.ops import fps as fps_mod
    from kd_pointcloud_tpu_torch.ops import kernels
    from kd_pointcloud_tpu_torch.ops.kernel_ab import (fps_pruned_skeleton,
                                                       fps_skeleton)
    from kd_pointcloud_tpu_torch.ops import knn as knn_mod
    from kd_pointcloud_tpu_torch.ops import pool_fused as pool_mod
    from kd_pointcloud_tpu_torch.train import (apply_frozen, best_checkpoint,
                                               full_state_tree,
                                               make_bridge_distill_step,
                                               make_distill_step,
                                               make_eval_step,
                                               make_fast_distill_step,
                                               make_named_loss,
                                               make_optimizer,
                                               make_train_step,
                                               restore_train_state,
                                               save_checkpoint)
    from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches
    from kd_pointcloud_tpu_torch import losses as losses_mod
    from kd_pointcloud_tpu_torch.cli import profile as profile_cli
    from kd_pointcloud_tpu_torch.models import tiny_config
    from kd_pointcloud_tpu_torch.perf import annotate, flop_count
    from kd_pointcloud_tpu_torch.perf import trace as perf_trace
    from kd_pointcloud_tpu_torch.perf.trace import (SETTLE_KERNELS,
                                                   TRACE_FILE,
                                                   WARM_UP_KERNELS,
                                                   kernel_records)
    from torch.profiler import ProfilerActivity, profile, schedule

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
    log(f"[1/27 device] {kind}, count {count}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit:")
    log(smi)
    use_full_fp32()
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---------------------------------------------------------------- 2
    kernels.lib()
    info = kernels.BUILD_INFO
    log(f"[2/27 build] {len(kernels.sources())} sources, one nvcc process "
        f"each, all at once, and one link: {info['seconds']:.1f} s"
        f"{' (cached)' if info['cached'] else ''}")
    for line in ptxas_summary(info["log"]):
        log(f"  {line}")
    deadline("build")

    # ---------------------------------------------------------------- 3
    # where the model reaches each kernel: swapped for a recorder or for
    # the plain version (the pool's point carries its backward kernel too)
    points = {"fps": (fps_mod, "_fps_cuda", fps_mod.fps_plain),
              "knn": (knn_mod, "_knn_card", knn_mod.knn_plain),
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

    @contextlib.contextmanager
    def feature_recorder(store):
        """Record every feature-space kNN of the FG cross layers (plain
        PyTorch on both paths): (k, keys, queries, indices)."""
        entry = cross_nn.knn_features

        def run(k, keys, query):
            idx = entry(k, keys, query)
            store.append((k, keys.detach().clone(), query.detach().clone(),
                          idx))
            return idx
        cross_nn.knn_features = run
        try:
            yield
        finally:
            cross_nn.knn_features = entry

    def feature_ms(sites) -> float:
        """ms of the feature kNN summed over its sites (CUDA events)."""
        with torch.inference_mode():
            return sum(cuda_ms(lambda: knn_mod.knn_features(k, keys, q),
                               FEATURE_REPS, 1) for k, keys, q, _ in sites)

    def feature_site(args) -> str:
        k, keys, q = args[:3]
        return (f"k={k} B={q.shape[0]} {q.shape[1]}x{keys.shape[1]} "
                f"D={keys.shape[2]}")

    calls = {n: [] for n in points}
    check(forward_launches(PRESETS["teacher"]) == PER_FORWARD,
          "forward_launches disagrees with the teacher's launches")
    model = BidPointFlowNet(PRESETS["teacher"], device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
    model.eval()
    pairs = synthetic_pairs(N_METRIC_PAIRS + N_TIMED_PAIRS + 1, N_POINTS,
                            seed=SEED)
    dev_pairs = [[torch.from_numpy(a)[None].cuda() for a in p] for p in pairs]
    timed = dev_pairs[N_METRIC_PAIRS + 1:]
    with swapped(recorder(calls)), torch.inference_mode():
        model(*dev_pairs[0][:4])
    torch.cuda.synchronize()
    got = {n: len(c) for n, c in calls.items()}
    want_sites = {n: PER_FORWARD[n] for n in points}
    check(got == want_sites, f"call sites per forward {got}, "
          f"expected {want_sites}")
    log(f"[3/27 kernels vs plain] call sites of one eval forward: {got}")

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

    def ragged_pool(sites):
        """One pool site a width at K = 9 (slots left empty in the
        kernel's tile of 32) and N1 off every pass of queries."""
        return [(u, idx[:, :-5, :9].contiguous(), v[:, :-5].contiguous(), w,
                 b) for u, idx, v, w, b in {
                     a[0].shape[2]: a for a in sites}.values()]

    def hold_pool(sites) -> float:
        """The pool kernel against pool_plain at each site, within 1e-4 x
        max|plain|; the worst error / max|plain|."""
        worst = 0.0
        with torch.inference_mode():
            for args in sites:
                ok_, op = cuda_fns["pool"](*args), plain_fns["pool"](*args)
                err = float((ok_ - op).abs().max())
                scale = float(op.abs().max())
                worst = max(worst, err / scale)
                results["pool"]["max_abs_err"] = max(
                    results["pool"]["max_abs_err"], err)
                log(f"  pool {site('pool', args)}: max abs err {err:.3g}, "
                    f"max |plain| {scale:.3g}")
                check(err <= 1e-4 * scale,
                      f"pool {site('pool', args)}: {err}")
        return worst

    def hold_pool_bwd(cases) -> float:
        """The pool backward kernel against autograd of pool_plain on each
        (label, args) case: d_u, d_v, d_weight, d_bias within POOL_BWD_TOL
        of their max |plain|; the worst ratio."""
        worst = 0.0
        for label, args in cases:
            fwd_err = float((cuda_fns["pool"](*args[:5])
                             - plain_fns["pool"](*args[:5])).abs().max())
            got_k, got_p = cuda_fns["pool_bwd"](*args), pool_bwd_plain(*args)
            ratios = []
            for a_, x in zip(got_k, got_p):
                err = float((a_ - x).abs().max())
                ratios.append(err / max(float(x.abs().max()), 1e-30))
                results["pool_bwd"]["max_abs_err"] = max(
                    results["pool_bwd"]["max_abs_err"], err)
            worst = max(worst, *ratios)
            log(f"  pool_bwd {label}{site('pool_bwd', args)}: "
                + " ".join(f"{r:.3g}" for r in ratios)
                + f" (forward max abs err {fwd_err:.3g})")
            check(max(ratios) <= POOL_BWD_TOL,
                  f"pool_bwd {label}{site('pool_bwd', args)}: {ratios}")
        return worst

    def dv_alone(args) -> None:
        """autograd asks only for the gradients it needs: d_v alone (the
        mask kernel skips d_w and d_bias, the second kernel its scatter
        into d_u) is the full call's d_v, which is summed in a fixed
        order."""
        full = cuda_fns["pool_bwd"](*args)
        part = cuda_fns["pool_bwd"](*args, need=(False, True, False, False))
        check(part[0] is None and part[2] is None and part[3] is None
              and torch.equal(part[1], full[1]), "pool_bwd with d_v alone")

    def hold_flows(model_, label="") -> list:
        """Eval flows through the kernels against the same model on the
        plain versions, every level and iteration: max abs <= 1e-3, median
        <= 1e-5; FPS chains equal; the feature-space kNN's indices equal
        at each of its sites. Returns the kernel run's feature kNN
        sites."""
        f_k, f_p = [], []
        with torch.inference_mode():
            with feature_recorder(f_k):
                out_k = model_(*dev_pairs[0][:4])
            with swapped(lambda n, entry, plain: plain), \
                    feature_recorder(f_p):
                out_p = model_(*dev_pairs[0][:4])
        iters = model_.cfg.iters
        for lvl in range(4):
            fks, fps_ = out_k["flows"][lvl], out_p["flows"][lvl]
            if iters > 1 and lvl < 3:
                check(len(fks) == len(fps_) == iters,
                      f"{label}flow{lvl}: {len(fks)} iterations")
            else:
                fks, fps_ = [fks], [fps_]
            n_lvl = model_.cfg.npoints[lvl]
            for it, (fk, fp) in enumerate(zip(fks, fps_)):
                name = f"{label}flow{lvl}" + (f" iteration {it}"
                                              if len(fks) > 1 else "")
                check(tuple(fk.shape) == (1, n_lvl, 3),
                      f"{name} {fk.shape}")
                check(bool(torch.isfinite(fk).all()), f"{name} not finite")
                diff = (fk - fp).abs()
                mx, med = float(diff.max()), float(diff.median())
                log(f"  {name} {tuple(fk.shape)}: kernels vs plain "
                    f"versions max abs {mx:.3g}, median {med:.3g}")
                check(mx <= 1e-3 and med <= 1e-5, f"{name}: {mx}, {med}")
        for key in ("fps_idx1", "fps_idx2"):
            check(all(torch.equal(a_, b_)
                      for a_, b_ in zip(out_k[key], out_p[key])),
                  f"{label}{key} differs from the plain versions'")
        check(len(f_k) == len(f_p) and all(
            torch.equal(a_[3], b_[3]) for a_, b_ in zip(f_k, f_p)),
              f"{label}feature kNN indices differ between the kernel and "
              f"the plain run")
        if f_k:
            log(f"  {label}feature kNN: indices identical between the "
                f"kernel and the plain run at its {len(f_k)} sites ("
                + ", ".join(feature_site(a_) for a_ in f_k) + ")")
        return f_k

    def time_forward(fwd, what="forward") -> None:
        """fwd over the timed pairs after a warm-up: ms a pair, pairs/s,
        peak memory; then a profile of N_PROFILED_PAIRS."""
        fwd(*dev_pairs[N_METRIC_PAIRS][:4])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_pair = []
        t_all = time.perf_counter()
        for p_ in timed:
            t = time.perf_counter()
            fwd(*p_[:4])
            torch.cuda.synchronize()
            per_pair.append((time.perf_counter() - t) * 1e3)
        total_s = time.perf_counter() - t_all
        peak = torch.cuda.max_memory_allocated()
        log(f"  {what}: {len(timed)} pairs in {total_s:.4f} s: "
            f"{total_s / len(timed) * 1e3:.3f} ms/pair, "
            f"{len(timed) / total_s:.3f} pairs/s (per pair median "
            f"{statistics.median(per_pair):.3f} ms, min "
            f"{min(per_pair):.3f}, max {max(per_pair):.3f}); peak memory "
            f"{peak / 2**20:.1f} MiB")
        profile_device(lambda i: fwd(*timed[i][:4]), N_PROFILED_PAIRS,
                       "pair")

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
    # nested_fps=False samples l2-l4 by FPS again (2048 -> 512 -> 256 ->
    # 64) from the l1 cloud in FPS order, which selects its prefix; a
    # shuffled copy makes the selection real
    with torch.inference_mode():
        order = plain_fns["fps"](xyz0, m0).long()
    l1 = xyz0.gather(1, order[..., None].expand(-1, -1, 3))
    shuffle = torch.randperm(m0, generator=torch.Generator().manual_seed(
        SEED)).cuda()
    for n, m_ in NESTED_FPS:
        fps_identical((l1[:, :n].contiguous(), m_), "nested_fps=False ",
                      every_g=True)
        fps_identical((l1[:, shuffle[shuffle < n]].contiguous(), m_),
                      "nested_fps=False shuffled ", every_g=True)
    results["fps"]["match"] = (
        "bit-identical at every eval, train and KD site, on duplicated "
        "points, at N = 8000 and at l2-l4's N (nested_fps=False), at every "
        "cluster size")

    with torch.inference_mode():

        for args in calls["knn"]:
            knn_identical(args)
        results["knn"]["match"] = ("bit-identical (index order and d2) at "
                                   "every eval, train and KD site")

        worst_ratio = hold_pool(calls["pool"] + ragged_pool(calls["pool"]))
        results["pool"]["match"] = f"max err / max|plain| {worst_ratio:.3g}"
    torch.cuda.synchronize()
    log("  verdict: fps and knn bit-identical, pool within bounds")
    deadline("kernels vs plain")

    # ---------------------------------------------------------------- 4
    kernels.reset_launches()
    metrics = evaluate_model(model, pairs_loader(pairs[:N_METRIC_PAIRS]),
                             with_2d=False)
    torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)
    want = {n: PER_FORWARD.get(n, 0) * N_METRIC_PAIRS for n in eval_launches}
    log(f"[4/27 eval path] evaluate_model over {N_METRIC_PAIRS} pairs of "
        f"{N_POINTS} points: launches {eval_launches} (per forward "
        f"{ {n: c / N_METRIC_PAIRS for n, c in eval_launches.items()} })")
    check(eval_launches == want, f"launches {eval_launches}, expected {want}")
    log("  metrics and eval loss (random weights, sanity only): " + ", ".join(
        f"{k} {v:.6f}" for k, v in metrics.items()))
    check(all(v == v and abs(v) < 1e6 for v in metrics.values()),
          f"metrics not finite: {metrics}")

    hold_flows(model)
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
                   bound_ms=0.0, sites=[])
        for i, args in enumerate(sites):
            ms = cuda_ms(lambda: cuda_fns[name](*args), REPS, 3)
            pms = cuda_ms(lambda: plain_fns[name](*args), PLAIN_REPS, 1)
            ops, nbytes = (kernels.kernel_work(name, *args)
                           if works is None else works[i])
            ops_ms = ops / PEAK_FP32_FLOPS * 1e3
            bytes_ms = nbytes / PEAK_BYTES_S * 1e3
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["ops_ms"] += ops_ms
            tot["bytes_ms"] += bytes_ms
            tot["bound_ms"] += max(ops_ms, bytes_ms)
            tot["sites"].append(dict(
                site=site(name, args), ms=ms, plain_ms=pms, ops_ms=ops_ms,
                bytes_ms=bytes_ms))
            log(f"  {name} {site(name, args)}: {ms:.4f} ms, plain "
                f"{pms:.4f} ms, bound {max(ops_ms, bytes_ms):.5f} ms "
                f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        tot["bound_by"] = ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                           else "bytes")
        return tot

    log(f"[5/27 eval timing] CUDA events, {REPS} launches after warm-up "
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

    time_forward(make_eval_forward(model))
    del model
    deadline("forward timing")

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
    log(f"[6/27 pool backward vs plain] {len(bwd_sites)} pool call sites of "
        f"a batch-{TRAIN_BATCH} and {len(kd_bwd_sites)} of a batch-"
        f"{KD_BATCH} train forward, seeded cotangents; error / max|plain| of "
        f"d_u, d_v, d_weight, d_bias (bound {POOL_BWD_TOL})")
    widths = {}
    for args in bwd_sites:
        widths.setdefault(args[0].shape[2], args)
    cases = ([("", a) for a in bwd_sites + kd_bwd_sites]
             + [("tie case ", tie_case(*a)) for a in widths.values()]
             + [("union case ", union_case(*a)) for a in widths.values()]
             + [("ragged case ", ragged_case(*a)) for a in widths.values()])
    worst_ratio = hold_pool_bwd(cases)
    results["pool_bwd"]["match"] = f"max err / max|plain| {worst_ratio:.3g}"
    for args in (bwd_sites[0], kd_bwd_sites[0]):
        dv_alone(args)
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
    log(f"[7/27 train path] one train step at batch {TRAIN_BATCH}, "
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

    time_steps(step_k, batch, "8/27 train timing", "train step", TRAIN_BATCH)
    train_times = time_path(dict(tcalls, pool_bwd=bwd_sites), "train step")
    del tmodel, opt_k, step_k, batch
    deadline("train timing")

    # ---------------------------------------------------------------- 9
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    clustered = (torch.randn(1, 16, 1, 3, device="cuda", generator=gen) * 20
                 + torch.randn(1, 16, N_POINTS // 16, 3, device="cuda",
                               generator=gen)).reshape(1, N_POINTS, 3)
    # the largest clouds the pruned kernel takes: a pair of the eval
    # pairs' shape at 32768 points
    widest = torch.stack([torch.from_numpy(a) for a in synthetic_pairs(
        1, pruned_mod.MAX_N, seed=SEED + 4)[0][:2]]).cuda()
    m = PRESETS["teacher"].npoints[1]
    fps_sites = {2: calls["fps"][0][0], 6: tcalls["fps"][0][0],
                 16: torch.cat([kd_batch["pos1"], kd_batch["pos2"]]),
                 "clustered": clustered, f"N={pruned_mod.MAX_N}": widest}
    check(all(fps_sites[b].shape[0] == b for b in FPS_PRUNED_BATCHES),
          "the stacked clouds of the three forwards")
    log(f"[9/27 attic kernels vs plain] pruned FPS -> {m}: indices against "
        "fps_plain and the FPS kernel, skipped sub-block updates against the "
        "plain version, the chain (kdpc_fps_pruned_skeleton) beside it; "
        "ptxas:")
    for line in ptxas_summary(info["log"]):
        if line.startswith(("fps_pruned_kernel", "cross_pool_kernel")):
            log(f"  {line}")
    # the student's l0 cost volume (C = 16), recorded from a batch-8
    # train forward; phase 14 holds the pool kernels there
    s_model = BidPointFlowNet(
        PRESETS["student"], device="cuda",
        generator=torch.Generator().manual_seed(STUDENT_SEED))
    s_fwd_calls = {n: [] for n in points}
    rec_student = copy.deepcopy(s_model).train()
    with swapped(recorder(s_fwd_calls)), torch.no_grad():
        rec_student(kd_batch["pos1"], kd_batch["pos2"],
                    kd_batch["norm1"], kd_batch["norm2"])
    del rec_student
    c16 = [a for a in s_fwd_calls["pool"] if a[0].shape[2] == 16]
    check(len(c16) == 3, f"C = 16 pool sites of a student forward: "
          f"{len(c16)}, expected 3 (the l0 cross layer's three pools)")
    attic = {"fps_pruned": {}, "cross_pool": {}}
    with torch.inference_mode():
        for key, xyz in fps_sites.items():
            got, dirty = pruned_mod._fps_pruned_cuda(xyz, m, True)
            plain, p_dirty = pruned_mod.fps_pruned_plain(xyz, m, True)
            bad = [int((got != ref).sum()) for ref in (
                plain, fps_mod.fps_plain(xyz, m), cuda_fns["fps"](xyz, m))]
            rounds = (xyz.shape[0] * (m - 1)
                      * (xyz.shape[1] // pruned_mod.SUB))
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
            lay = pruned_mod.spatial_permutation(xyz)
            chain = cuda_ms(lambda: fps_pruned_skeleton(xyz, m, lay), REPS,
                            3)
            attic["fps_pruned"][key] = dict(
                ms=ms, fps_kernel_ms=row1, chain_ms=chain,
                updates_share=share, work=kernels.kernel_work(
                    "fps_pruned", xyz, m, int(dirty.sum())))
            log(f"    {ms:.4f} ms, the FPS kernel {row1:.4f} ms, the chain "
                f"{chain:.4f} ms (blocks a cloud "
                f"{pruned_mod.fps_pruned_plan(xyz.shape[1])[0]})")
        results["fps_pruned"]["match"] = (
            "bit-identical to fps_plain and the FPS kernel at B = 2, 6, 16, "
            f"a clustered cloud and N = {pruned_mod.MAX_N} (B = 2)")
        kd_site = fps_sites[FPS_PRUNED_BATCHES[-1]]
        fp_times = time_sites("fps_pruned", [(kd_site, m)],
                              [attic["fps_pruned"][16]["work"]])
        fp_times["chain_ms"] = attic["fps_pruned"][16]["chain_ms"]

        log(f"  cross_pool L=1 on the {len(calls['pool'])} pool sites of an "
            f"eval forward and the {len(c16)} C = 16 sites of a student "
            "train forward: against the pool kernel (bit-equal) and "
            f"pool_plain (<= {ATTIC_TOL} x max|plain|)")
        to_cross = lambda sites: [(u, v, idx, [w], [b])   # noqa: E731
                                  for u, idx, v, w, b in sites]
        cp_sites, cp16_sites = to_cross(calls["pool"]), to_cross(c16)
        worst = 0.0
        for args, pargs in zip(cp_sites + cp16_sites, calls["pool"] + c16):
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
        cp16_times = time_sites("cross_pool", cp16_sites)
        log(f"  cross_pool L=1 per eval forward: {cp_times['ms']:.4f} ms "
            f"(the pool kernel {eval_times['pool']['ms']:.4f} ms), plain "
            f"{cp_times['plain_ms']:.4f} ms, bound "
            f"{cp_times['bound_ms']:.5f} ms; at the C = 16 sites "
            f"{cp16_times['ms']:.4f} ms, bound {cp16_times['bound_ms']:.5f}")
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
            f"bit-equal to the pool kernel at L=1 (the eval forward's and "
            f"the student's C = 16 sites); max err / max|plain| {worst:.3g} "
            "at L=1 and 2")

        # the Morton-window kNN (plain torch) against the kNN kernel
        pos1, pos2 = dev_pairs[0][0], dev_pairs[0][1]
        _, m_idx = morton_mod.knn_block_dist(MORTON_K, pos2, pos1,
                                             window=MORTON_WINDOW)
        morton_ms = cuda_ms(lambda: morton_mod.knn_block_dist(
            MORTON_K, pos2, pos1, window=MORTON_WINDOW), 3, 1)
        _, k_idx = cuda_fns["knn"](MORTON_K, pos2, pos1)
        recall = float((m_idx[..., :, None] == k_idx[..., None, :]).any(-1)
                       .float().mean())
        attic["morton"] = dict(recall=recall, ms=morton_ms)
        log(f"  Morton-window kNN (plain torch) k={MORTON_K}, window "
            f"{MORTON_WINDOW}, {pos1.shape[1]}^2: recall {recall:.4f} "
            f"against the kNN kernel; {morton_ms:.3f} ms a call")
        check(0.0 < recall <= 1.0, f"Morton kNN recall {recall}")
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
    log(f"[10/27 KD path] one distill step, teacher -> lighttoken_res, "
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
    time_steps(kd_step, kd_batch, "11/27 KD timing", "KD step", KD_BATCH)
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
    log(f"[12/27 bridge KD step] Bridge({width} -> 512) on the teacher's "
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
    log(f"[13/27 checkpoint] {Path(path).name}: epoch {epoch}, best EPE "
        f"{best_epe:.4f}, best_checkpoint finds it "
        f"{best_checkpoint(str(ckpt_dir)) == path}; restored state equal "
        f"{same_state}, Adam step counts equal {opt_equal}, eval flows "
        f"bit-equal {flows_equal}")
    check(best_checkpoint(str(ckpt_dir)) == path and same_state
          and opt_equal and flows_equal and epoch == N_TRAIN_STEPS,
          "checkpoint round trip")
    shutil.rmtree(ckpt_dir)
    deadline("checkpoint")

    # ---------------------------------------------------------------- 14
    # the student presets: the frozen teacher (seed 1) distils into the
    # halved-width student (seed 0), whose l0 cost volume pools at C = 16
    del student, fresh, fresh_opt, kd_step, kd_opt, eval_step
    # s_model, its recorded train forward and c16 come from phase 9
    log(f"[14/27 pool at C = 16 vs plain] the {len(c16)} C = 16 pool sites "
        f"of a batch-{KD_BATCH} student train forward (cross0), pool "
        f"within 1e-4 x max|plain|, pool_bwd within {POOL_BWD_TOL}; ptxas:")
    for line in ptxas_summary(info["log"]):
        if "<16>" in line:
            log(f"  {line}")
    worst_ratio = hold_pool(c16 + ragged_pool(c16))
    results["pool"]["match"] += (f"; C = 16 (student l0, B = {KD_BATCH}) "
                                 f"{worst_ratio:.3g}")
    c16_bwd = [(*args, torch.randn(args[2].shape, device="cuda",
                                   generator=gen)) for args in c16]
    worst_ratio = hold_pool_bwd([("", a_) for a_ in c16_bwd]
                                + [("tie case ", tie_case(*c16_bwd[0])),
                                   ("union case ", union_case(*c16_bwd[0])),
                                   ("ragged case ",
                                    ragged_case(*c16_bwd[0]))])
    dv_alone(c16_bwd[0])
    log("  pool_bwd at C = 16 asked for d_v alone: equal to the full call's")
    results["pool_bwd"]["match"] += (f"; C = 16 (student l0, ties, union, "
                                     f"ragged) {worst_ratio:.3g}")
    del c16_bwd, c16, s_fwd_calls
    deadline("pool at C = 16")

    # ---------------------------------------------------------------- 15
    s_plain = copy.deepcopy(s_model)
    s_loss = make_named_loss(STUDENT_LOSS, STUDENT_LOSS_ARGS)
    s_opt = make_optimizer(s_model, 1e-3, 1e-4)
    s_step = make_distill_step(teacher, s_model, s_opt, loss_fn=s_loss)
    s_step_p = make_distill_step(teacher, s_plain,
                                 make_optimizer(s_plain, 1e-3, 1e-4),
                                 loss_fn=s_loss)
    kernels.reset_launches()
    loss_k = float(s_step(kd_batch))
    s_launches = dict(kernels.LAUNCHES)
    s_widths = dict(sorted(kernels.WIDTH_LAUNCHES.items()))
    log(f"[15/27 student KD path] one distill step, teacher -> student, "
        f"batch {KD_BATCH}, {N_POINTS} points, {STUDENT_LOSS} "
        f"{STUDENT_LOSS_ARGS}: launches {s_launches}; by width {s_widths}")
    check(s_launches == PER_KD_STEP,
          f"launches {s_launches}, expected {PER_KD_STEP}")
    s_c16 = {k: s_widths.get(k, 0) for k in STUDENT_C16}
    check(s_c16 == STUDENT_C16,
          f"C = 16 launches {s_c16}, expected {STUDENT_C16}")
    for name in ("pool", "pool_bwd"):
        by_width = sum(n for k, n in s_widths.items()
                       if k.startswith(f"{name} C="))
        check(by_width == s_launches[name],
              f"{name}: {by_width} launches by width, {s_launches[name]} "
              f"in all")
    with swapped(lambda n, entry, plain: plain):
        loss_p = float(s_step_p(kd_batch))
    check(kernels.LAUNCHES == s_launches,
          "the plain distill step launched a kernel")
    log(f"  loss kernels {loss_k:.9g}, plain {loss_p:.9g}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "student loss differs")
    worst, leaf, median, n_leaves, zero_leaves, top = compare_grads(
        s_model, s_plain)
    log(f"  student gradients: {n_leaves} leaves, error / max|plain| worst "
        f"{worst:.3g} ({leaf}), median {median:.3g} (bound {GRAD_TOL}); "
        f"{zero_leaves} zero-gradient leaves below 1e-5 of the largest "
        f"gradient {top:.3g}")
    bn_err = compare_stats(s_model, s_plain)
    log(f"  student BatchNorm statistics: error / max|plain| {bn_err:.3g}")
    check(bn_err <= 1e-5, f"BatchNorm statistics differ: {bn_err}")
    t_same = all(torch.equal(v, t_state[k])
                 for k, v in teacher.state_dict().items())
    log(f"  teacher: parameters and statistics bit-unchanged {t_same}")
    check(t_same and all(p.grad is None for p in teacher.parameters()),
          "the teacher moved")
    del s_plain, s_step_p
    deadline("student KD path")

    # ---------------------------------------------------------------- 16
    time_steps(s_step, kd_batch, "16/27 student KD timing", "KD step",
               KD_BATCH)
    s_calls = {n: [] for n in points}
    rec_student = copy.deepcopy(s_model).train()
    with swapped(recorder(s_calls)), torch.no_grad():
        apply_frozen(teacher, kd_batch)
        rec_student(kd_batch["pos1"], kd_batch["pos2"], kd_batch["norm1"],
                    kd_batch["norm2"])
    del rec_student
    got = {n: len(c) for n, c in s_calls.items()}
    check(got == {n: PER_KD_STEP[n] for n in points},
          f"call sites per student KD step {got}")
    s_sites = dict(s_calls, pool_bwd=[
        (*args, torch.randn(args[2].shape, device="cuda", generator=gen))
        for args in s_calls["pool"][PER_FORWARD["pool"]:]])
    s_times = time_path(s_sites, "student KD step")
    c16_times = {}
    for name in ("pool", "pool_bwd"):
        rows = [r for r in s_times[name]["sites"] if r["site"].endswith(
            "C=16")]
        ops_ms = sum(r["ops_ms"] for r in rows)
        bytes_ms = sum(r["bytes_ms"] for r in rows)
        check(len(rows) == s_c16[f"{name} C=16"],
              f"{name}: {len(rows)} C = 16 call sites timed, "
              f"{s_c16[f'{name} C=16']} launched by the KD step")
        c16_times[name] = dict(
            launches=s_c16[f"{name} C=16"], ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(max(r["ops_ms"], r["bytes_ms"]) for r in rows),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            ops_ms=ops_ms, bytes_ms=bytes_ms)
        t = c16_times[name]
        log(f"  {name} at its {t['launches']} C = 16 sites: {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"(operations {ops_ms:.5f}, bytes {bytes_ms:.5f})")
    del s_sites, s_calls, s_step, s_opt, s_model
    deadline("student KD timing")

    # ---------------------------------------------------------------- 17
    log(f"[17/27 student presets' eval forwards] batch 1, {N_POINTS} "
        f"points, through evaluate_model, each against its plain versions; "
        f"{', '.join(TIMED_PRESETS)} timed over {N_TIMED_PAIRS} pairs")
    teacher_knn = sorted(site("knn", args) for args in calls["knn"])
    for name in EVAL_PRESETS:
        pmodel = BidPointFlowNet(
            PRESETS[name], device="cuda",
            generator=torch.Generator().manual_seed(SEED))
        kernels.reset_launches()
        metrics = evaluate_model(pmodel, pairs_loader(pairs[:1]),
                                 with_2d=False)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        widths = dict(sorted(kernels.WIDTH_LAUNCHES.items()))
        check(launches == PER_FORWARD,
              f"{name}: launches {launches}, expected {PER_FORWARD}")
        check(all(v == v and abs(v) < 1e6 for v in metrics.values()),
              f"{name}: metrics not finite: {metrics}")
        p_calls = {n: [] for n in points}
        with swapped(recorder(p_calls)), torch.inference_mode():
            pmodel(*dev_pairs[0][:4])
        knn_sites = sorted(site("knn", args) for args in p_calls["knn"])
        warp0 = f"k=3 B=1 {N_POINTS}x{N_POINTS}"
        if PRESETS[name].coarse_warp:
            coarse = f"k=3 B=1 {PRESETS[name].npoints[1]}x" \
                     f"{PRESETS[name].npoints[1]}"
            want_knn = sorted([s_ for s_ in teacher_knn if s_ != warp0]
                              + [coarse])
            check(knn_sites == want_knn and warp0 not in knn_sites,
                  f"{name}: kNN sites {knn_sites}")
            note = (f"; the l0 warp's {warp0} search is gone, a {coarse} "
                    f"one in its place")
        else:
            check(knn_sites == teacher_knn, f"{name}: kNN sites {knn_sites}")
            note = ""
        c16 = widths.get("pool C=16", 0)
        want_c16 = 3 if PRESETS[name].level_channels[0] == 16 else 0
        check(c16 == want_c16,
              f"{name}: {c16} pool launches at C = 16, expected {want_c16}")
        log(f"  {name}: launches a forward {launches}, by width "
            f"{widths}{note}")
        hold_flows(pmodel, f"{name} ")
        del p_calls
        if name in TIMED_PRESETS:
            time_forward(make_eval_forward(pmodel), f"{name} forward")
        del pmodel
        deadline(f"{name} eval forward")

    # ---------------------------------------------------------------- 18
    log(f"[18/27 FG eval forwards] {', '.join(FG_PRESETS)} at batch 1, "
        f"{N_POINTS} points, through evaluate_model, each against its plain "
        f"versions and timed over {N_TIMED_PAIRS} pairs")
    fg_eval = {}
    for name in FG_PRESETS:
        fmodel = BidPointFlowNet(
            PRESETS[name], device="cuda",
            generator=torch.Generator().manual_seed(SEED))
        kernels.reset_launches()
        metrics = evaluate_model(fmodel, pairs_loader(pairs[:1]),
                                 with_2d=False)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want = forward_launches(PRESETS[name])
        check(launches == want,
              f"{name}: launches {launches}, expected {want}")
        check(all(v == v and abs(v) < 1e6 for v in metrics.values()),
              f"{name}: metrics not finite: {metrics}")
        log(f"  {name}: launches a forward {launches} (from the wiring: "
            f"iters {PRESETS[name].iters}, cross {PRESETS[name].cross}, "
            f"encoder {PRESETS[name].encoder}); metrics (random weights) "
            + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
        f_sites = hold_flows(fmodel, f"{name} ")
        check(len(f_sites) == 4, f"{name}: {len(f_sites)} feature kNN "
              "sites, expected 4 (once a level)")
        p_calls = {n: [] for n in points}
        with swapped(recorder(p_calls)), torch.inference_mode():
            fmodel(*dev_pairs[0][:4])
        for args in p_calls["fps"]:
            fps_identical(args)
        for args in p_calls["knn"]:
            knn_identical(args)
        with torch.inference_mode():
            times = {n: time_sites(n, p_calls[n]) for n in points}
        for n, t in times.items():
            log(f"  {name}: {n} per forward {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms")
        f_ms = feature_ms(f_sites)
        log(f"  {name}: feature kNN {f_ms:.4f} ms a pair over its "
            f"{len(f_sites)} sites (CUDA events, {FEATURE_REPS} launches "
            "after warm-up)")
        time_forward(make_eval_forward(fmodel), f"{name} forward")
        fg_eval[name] = dict(launches=launches, times=times,
                             feature_knn_ms=f_ms,
                             feature_sites=[feature_site(a_)
                                            for a_ in f_sites])
        del fmodel, f_sites, p_calls
        deadline(f"{name} eval forward")

    # ---------------------------------------------------------------- 19
    del teacher
    f_teacher = BidPointFlowNet(
        PRESETS[FAST_TEACHER], device="cuda",
        generator=torch.Generator().manual_seed(TEACHER_SEED))
    f_student = BidPointFlowNet(
        PRESETS[FAST_STUDENT], device="cuda",
        generator=torch.Generator().manual_seed(STUDENT_SEED))
    f_plain = copy.deepcopy(f_student)
    ft_state = {k: v.clone() for k, v in f_teacher.state_dict().items()}
    f_opt = make_optimizer(f_student, 1e-3, 1e-4)
    f_step = make_fast_distill_step(f_teacher, f_student, f_opt,
                                    **FAST_KD_ARGS)
    f_step_p = make_fast_distill_step(f_teacher, f_plain,
                                      make_optimizer(f_plain, 1e-3, 1e-4),
                                      **FAST_KD_ARGS)
    t_fwd = forward_launches(PRESETS[FAST_TEACHER])
    s_fwd = forward_launches(PRESETS[FAST_STUDENT])
    per_fast = {n: t_fwd[n] + s_fwd[n] for n in t_fwd}
    per_fast["pool_bwd"] = s_fwd["pool"]
    kernels.reset_launches()
    loss_k = float(f_step(kd_batch))
    f_launches = dict(kernels.LAUNCHES)
    log(f"[19/27 fast KD path] one make_fast_distill_step, {FAST_TEACHER} "
        f"-> {FAST_STUDENT}, batch {KD_BATCH}, {N_POINTS} points, "
        f"att_iter_loss {FAST_KD_ARGS}: launches {f_launches}")
    check(f_launches == per_fast,
          f"launches {f_launches}, expected {per_fast}")
    with swapped(lambda n, entry, plain: plain):
        loss_p = float(f_step_p(kd_batch))
    check(kernels.LAUNCHES == f_launches,
          "the plain fast KD step launched a kernel")
    log(f"  loss kernels {loss_k:.9g}, plain {loss_p:.9g}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "fast KD loss differs")
    worst, leaf, median, n_leaves, zero_leaves, top = compare_grads(
        f_student, f_plain)
    log(f"  student gradients: {n_leaves} leaves, error / max|plain| worst "
        f"{worst:.3g} ({leaf}), median {median:.3g} (bound {GRAD_TOL}); "
        f"{zero_leaves} zero-gradient leaves below 1e-5 of the largest "
        f"gradient {top:.3g}")
    bn_err = compare_stats(f_student, f_plain)
    log(f"  student BatchNorm statistics: error / max|plain| {bn_err:.3g}")
    check(bn_err <= 1e-5, f"BatchNorm statistics differ: {bn_err}")
    t_same = all(torch.equal(v, ft_state[k])
                 for k, v in f_teacher.state_dict().items())
    log(f"  teacher ({FAST_TEACHER}): parameters and statistics "
        f"bit-unchanged {t_same}, eval mode {not f_teacher.training}")
    check(t_same and not f_teacher.training
          and all(p.grad is None for p in f_teacher.parameters()),
          "the teacher moved")
    del f_plain, f_step_p
    deadline("fast KD path")

    # ---------------------------------------------------------------- 20
    time_steps(f_step, kd_batch, "20/27 fast KD timing", "fast KD step",
               KD_BATCH)
    f_calls, f_feat = {n: [] for n in points}, []
    rec_student = copy.deepcopy(f_student).train()
    with swapped(recorder(f_calls)), feature_recorder(f_feat), \
            torch.no_grad():
        apply_frozen(f_teacher, kd_batch)
        rec_student(kd_batch["pos1"], kd_batch["pos2"], kd_batch["norm1"],
                    kd_batch["norm2"])
    del rec_student
    got = {n: len(c) for n, c in f_calls.items()}
    check(got == {n: per_fast[n] for n in points},
          f"call sites per fast KD step {got}")
    f_sites = dict(f_calls, pool_bwd=[
        (*args, torch.randn(args[2].shape, device="cuda", generator=gen))
        for args in f_calls["pool"][t_fwd["pool"]:]])
    f_times = time_path(f_sites, "fast KD step")
    ff_ms = feature_ms(f_feat)
    log(f"  feature kNN (plain PyTorch: the expansion's matrix product and "
        f"a topk of k + 1, tied rows sorted) per fast KD step: {ff_ms:.4f} "
        f"ms over {len(f_feat)} sites ("
        + ", ".join(feature_site(a_) for a_ in f_feat) + ")")
    # the selection rule against a stable sort of every row, on the first
    # 2048-query chunk of the largest site
    k, keys, q, _ = max(f_feat, key=lambda a_: a_[2].shape[1])
    with torch.inference_mode():
        d = knn_mod.feature_distance(q[:, :2048], keys)
        pick_ms = cuda_ms(lambda: knn_mod.smallest_k(d, k), FEATURE_REPS, 1)
        sort_ms = cuda_ms(lambda: torch.sort(d, dim=-1, stable=True)[1][
            ..., :k].int(), FEATURE_REPS, 1)
        dist_ms = cuda_ms(lambda: knn_mod.feature_distance(q[:, :2048], keys),
                          FEATURE_REPS, 1)
        same = torch.equal(knn_mod.smallest_k(d, k), torch.sort(
            d, dim=-1, stable=True)[1][..., :k].int())
    del d
    log(f"  feature kNN, one chunk of {feature_site((k, keys, q[:, :2048]))}: "
        f"distances {dist_ms:.4f} ms, selection (topk of k + 1, ties "
        f"sorted) {pick_ms:.4f} ms, a stable sort of every row instead "
        f"{sort_ms:.4f} ms; indices equal {same}")
    check(same, "the feature kNN's selection differs from a stable sort")
    fast_feature = dict(ms=ff_ms, sites=[feature_site(a_) for a_ in f_feat],
                        chunk=dict(distance_ms=dist_ms, select_ms=pick_ms,
                                   stable_sort_ms=sort_ms))
    del f_sites, f_calls, f_feat, f_step, f_opt, f_student, f_teacher
    deadline("fast KD timing")

    # ---------------------------------------------------------------- 21
    log(f"[21/27 no_cross and vote eval forwards] batch 1, {N_POINTS} "
        "points, through evaluate_model, each against its plain versions")
    for name in ABLATION_PRESETS:
        amodel = BidPointFlowNet(
            PRESETS[name], device="cuda",
            generator=torch.Generator().manual_seed(SEED))
        kernels.reset_launches()
        metrics = evaluate_model(amodel, pairs_loader(pairs[:1]),
                                 with_2d=False)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want = forward_launches(PRESETS[name])
        check(launches == want,
              f"{name}: launches {launches}, expected {want}")
        check(all(v == v and abs(v) < 1e6 for v in metrics.values()),
              f"{name}: metrics not finite: {metrics}")
        log(f"  {name}: launches a forward {launches}")
        hold_flows(amodel, f"{name} ")
        del amodel
        deadline(f"{name} eval forward")

    # ---------------------------------------------------------------- 22
    t_phase = time.monotonic()
    log(f"[22/27 workflow] the cli entries (train with resume, evaluate, "
        f"the device and host eval paths, distill, distill_bridge, "
        f"fast_distill) at {N_POINTS} points and full width, on seeded "
        f"trees")
    flow = workflow("cuda")
    runs = flow["runs"]
    for label, r in runs.items():
        log(f"  {label}: {r['seconds']:.3f} s, launches "
            f"{ {n: c for n, c in r['launches'].items() if c} }")
    forwards = {"evaluate": len(WORKFLOW_KITTI["mapped"]),
                "eval KITTI device": len(WORKFLOW_KITTI["mapped"]),
                "eval KITTI host": len(WORKFLOW_KITTI["mapped"]),
                "eval FT3D val device": -(-WORKFLOW_FT3D["val"] // 3),
                "eval FT3D val host": -(-WORKFLOW_FT3D["val"] // 3)}
    for label, n in forwards.items():
        want = {k: PER_FORWARD[k] * n for k in PER_FORWARD}
        check(runs[label]["launches"] == want,
              f"{label}: launches {runs[label]['launches']}, expected "
              f"{want}")
    for label in ("train", "resume", "distill", "distill_bridge",
                  "fast_distill"):
        idle = [k for k in PATH_KERNELS if not runs[label]["launches"][k]]
        check(not idle, f"{label}: no launch of {idle}")
    log(f"  verdict: every run went through the path kernels (eval runs "
        f"{PER_FORWARD['fps']} / {PER_FORWARD['knn']} / "
        f"{PER_FORWARD['pool']} fps / knn / pool a forward); device and "
        f"host eval paths agree; phase {time.monotonic() - t_phase:.1f} s")
    deadline("workflow")

    # ---------------------------------------------------------------- 23
    t_phase = time.monotonic()
    log(f"[23/27 tooling] fps_blocks={FPS_BLOCKS}, the self-supervised "
        f"loss through a student, the profile entry, a trace, raw frames to "
        f"the eval; {N_POINTS} points, full width")
    # blocked FPS: l1's 8192 -> 2048 as blocks of 1024 -> 256, the stacked
    # clouds of an eval forward (2) and of a KD step's forward (16)
    m1 = PRESETS["teacher"].npoints[1]
    blocked_sites = []
    for stacked in (calls["fps"][0][0],
                    torch.cat([kd_batch["pos1"], kd_batch["pos2"]])):
        blocked_sites.append((stacked.reshape(
            stacked.shape[0] * FPS_BLOCKS, N_POINTS // FPS_BLOCKS, 3),
            m1 // FPS_BLOCKS))
        fps_identical(blocked_sites[-1], f"fps_blocks={FPS_BLOCKS} ",
                      every_g=True)
    with torch.inference_mode():
        fps_blocked_times = time_sites("fps", blocked_sites)
        fps_blocked_times["chain_ms"] = sum(
            cuda_ms(lambda: fps_skeleton(xyz, m_, fps_mod.fps_plan(
                xyz.shape[0], xyz.shape[1], fps_mod.card_clusters)), REPS, 3)
            for xyz, m_ in blocked_sites)
    log(f"  fps at l1 a pair: blocked {fps_blocked_times['sites'][0]['ms']:.4f}"
        f" ms, exact {eval_times['fps']['ms']:.4f} ms (phase 5); the chain "
        f"(rounds without their distance pass) at both blocked sites "
        f"{fps_blocked_times['chain_ms']:.4f} ms")

    b_model = BidPointFlowNet(
        dataclasses.replace(PRESETS["teacher"], fps_blocks=FPS_BLOCKS),
        device="cuda", generator=torch.Generator().manual_seed(SEED))
    kernels.reset_launches()
    metrics = evaluate_model(b_model, pairs_loader(pairs[:1]), with_2d=False)
    torch.cuda.synchronize()
    b_launches = dict(kernels.LAUNCHES)
    check(b_launches == PER_FORWARD,
          f"fps_blocks={FPS_BLOCKS}: launches {b_launches}")
    check(all(v == v and abs(v) < 1e6 for v in metrics.values()),
          f"fps_blocks={FPS_BLOCKS}: metrics not finite: {metrics}")
    b_calls = {n: [] for n in points}
    with swapped(recorder(b_calls)), torch.inference_mode():
        b_model(*dev_pairs[0][:4])
    b_shapes = [tuple(a[0].shape) + (a[1],) for a in b_calls["fps"]]
    check(b_shapes == [(2 * FPS_BLOCKS, N_POINTS // FPS_BLOCKS, 3,
                        m1 // FPS_BLOCKS)],
          f"fps_blocks={FPS_BLOCKS}: FPS calls {b_shapes}")
    log(f"  teacher, fps_blocks={FPS_BLOCKS}: launches a forward "
        f"{b_launches}; its FPS call {b_shapes[0]}")
    hold_flows(b_model, f"fps_blocks={FPS_BLOCKS} ")
    e_model = BidPointFlowNet(PRESETS["teacher"], device="cuda",
                              generator=torch.Generator().manual_seed(SEED))
    fwds = {"exact": make_eval_forward(e_model),
            "blocked": make_eval_forward(b_model)}
    for fwd in fwds.values():
        fwd(*dev_pairs[N_METRIC_PAIRS][:4])
    torch.cuda.synchronize()
    per_pair = {k: [] for k in fwds}
    for i, p_ in enumerate(timed):
        for key in (("exact", "blocked") if i % 2 == 0
                    else ("blocked", "exact")):
            t = time.perf_counter()
            fwds[key](*p_[:4])
            torch.cuda.synchronize()
            per_pair[key].append((time.perf_counter() - t) * 1e3)
    blocked_fwd = {k: dict(median_ms=statistics.median(v),
                           mean_ms=statistics.fmean(v))
                   for k, v in per_pair.items()}
    log(f"  teacher eval forward in turns over {len(timed)} pairs: "
        + ", ".join(f"{k} {v['median_ms']:.3f} ms a pair median, "
                    f"{v['mean_ms']:.3f} mean" for k, v in
                    blocked_fwd.items()))
    del b_model, b_calls
    deadline("blocked FPS")

    # the self-supervised loss and its backward through a student forward
    ss_batch = synthetic_batches(1, SELFSUP_BATCH, N_POINTS, SEED + 5,
                                 "cuda")[0]
    ss_model = BidPointFlowNet(
        PRESETS["student"], device="cuda",
        generator=torch.Generator().manual_seed(STUDENT_SEED))
    ss_plain = copy.deepcopy(ss_model)

    def selfsup_backward(model_):
        model_.train()
        model_.zero_grad(set_to_none=True)
        out_ = model_(ss_batch["pos1"], ss_batch["pos2"], ss_batch["norm1"],
                      ss_batch["norm2"])
        parts = losses_mod.multi_scale_chamfer_smooth_curvature(
            out_["pc1"], out_["pc2"], out_["flows"])
        parts[0].backward()
        return [float(v.detach()) for v in parts]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.perf_counter()
    ss_k = selfsup_backward(ss_model)
    ss_s = time.perf_counter() - t
    ss_launches = dict(kernels.LAUNCHES)
    log(f"  self-supervised loss, student, batch {SELFSUP_BATCH}: forward, "
        f"loss and backward through the kernels {ss_s * 1e3:.3f} ms (first "
        f"use), peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"MiB; launches {ss_launches}")
    check(ss_launches == PER_SELFSUP_STEP,
          f"launches {ss_launches}, expected {PER_SELFSUP_STEP}")
    with swapped(lambda n, entry, plain: plain):
        ss_p = selfsup_backward(ss_plain)
    check(kernels.LAUNCHES == ss_launches,
          "the plain self-supervised backward launched a kernel")
    log("  total, chamfer, curvature, smoothness: kernels "
        + " ".join(f"{v:.9g}" for v in ss_k) + "; plain "
        + " ".join(f"{v:.9g}" for v in ss_p))
    for name, a_, b_ in zip(("total", "chamfer", "curvature", "smoothness"),
                            ss_k, ss_p):
        check(abs(a_ - b_) <= 1e-5 * abs(b_), f"self-supervised {name}: "
              f"{a_} kernels, {b_} plain")
    worst, leaf, median, n_leaves, zero_leaves, top = compare_grads(
        ss_model, ss_plain)
    log(f"  gradients: {n_leaves} leaves, error / max|plain| worst "
        f"{worst:.3g} ({leaf}), median {median:.3g} (bound {GRAD_TOL}); "
        f"{zero_leaves} zero-gradient leaves below 1e-5 of the largest "
        f"gradient {top:.3g}")
    bn_err = compare_stats(ss_model, ss_plain)
    check(bn_err <= 1e-5, f"BatchNorm statistics differ: {bn_err}")
    ss_calls = {n: [] for n in points}
    with torch.no_grad():
        out = ss_model(ss_batch["pos1"], ss_batch["pos2"], ss_batch["norm1"],
                       ss_batch["norm2"])
        with swapped(recorder(ss_calls)):
            losses_mod.multi_scale_chamfer_smooth_curvature(
                out["pc1"], out["pc2"], out["flows"])
    del out
    check(len(ss_calls["knn"]) == SELFSUP_KNN and not ss_calls["fps"]
          and not ss_calls["pool"], "the loss's kernel sites "
          f"{ {n: len(c) for n, c in ss_calls.items()} }")
    for args in ss_calls["knn"]:
        knn_identical(args)
    with torch.inference_mode():
        ss_knn_times = time_sites("knn", ss_calls["knn"])
    by_k = {}
    for k_ in sorted({a[0] for a in ss_calls["knn"]}):
        rows = [r for r in ss_knn_times["sites"]
                if r["site"].startswith(f"k={k_} ")]
        ops_ms = sum(r["ops_ms"] for r in rows)
        bytes_ms = sum(r["bytes_ms"] for r in rows)
        by_k[f"k={k_}"] = dict(
            launches=len(rows), ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(max(r["ops_ms"], r["bytes_ms"]) for r in rows),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        log(f"  knn at the loss's k={k_} sites: " + ", ".join(
            f"{key} {val:.4f}" if isinstance(val, float) else
            f"{key} {val}" for key, val in by_k[f"k={k_}"].items()))
    ss_knn_times["by_k"] = by_k
    results["knn"]["match"] += ("; k = 5, 9, 10 at the self-supervised "
                                "loss's 16 sites")
    del ss_model, ss_plain, ss_calls, ss_batch
    deadline("self-supervised loss")

    # the profile entry, operation counts on both devices, a trace
    prof = profile_cli.main(list(PROFILE_PRESETS))
    for name, st in prof.items():
        want = forward_launches(PRESETS[name])
        got = {n: v["calls"] for n, v in st["by_kernel"].items()}
        check(got == {n: c for n, c in want.items() if c},
              f"profile {name}: kernel calls {got}, expected {want}")
        log(f"  profile {name}: params {st['params']}, operations "
            f"{st['flops']} (dense {st['dense_flops']}, kernels "
            f"{st['kernel_flops']}, kernel bytes {st['kernel_bytes']}), "
            f"{st['latency_ms']:.3f} ms a pair, {st['pairs_per_sec']:.3f} "
            f"pairs/s")
    tiny = BidPointFlowNet(tiny_config("teacher"), device="cpu",
                           generator=torch.Generator().manual_seed(SEED))
    tiny_in = [torch.from_numpy(a)[None]
               for a in synthetic_pairs(1, 256, seed=SEED)[0][:4]]
    count_cpu = flop_count(make_eval_forward(tiny), *tiny_in)
    count_card = flop_count(make_eval_forward(copy.deepcopy(tiny).cuda()),
                            *(a.cuda() for a in tiny_in))
    log(f"  operations of a tiny_config teacher forward: cpu "
        f"{count_cpu['flops']} (dense {count_cpu['dense_flops']}, kernels "
        f"{count_cpu['kernel_flops']}), cuda {count_card['flops']} (dense "
        f"{count_card['dense_flops']}, kernels {count_card['kernel_flops']})")
    check(count_cpu == count_card, "the operation count depends on the "
          f"device: cpu {count_cpu}, cuda {count_card}")
    # one forward under a bare torch.profiler session, under one whose
    # warm-up step is empty, and under perf.trace, which records after a
    # warm-up step of WARM_UP_KERNELS kernels and raises if it lost a
    # record of a port kernel
    want = {n: PER_FORWARD[n] for n in ("fps", "knn", "pool")}
    with tempfile.TemporaryDirectory(prefix="kdpc_trace_") as tdir:
        bare = {}
        for label, step in (("a bare session", False),
                            ("an empty warm-up step", True)):
            kw = (dict(schedule=schedule(wait=0, warmup=1, active=1))
                  if step else {})
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA], **kw) as prof:
                if step:
                    prof.step()
                fwds["exact"](*dev_pairs[0][:4])
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(Path(tdir) / "bare.json"))
            bare[label] = json.loads((Path(tdir) / "bare.json").read_text(
                ))["traceEvents"]
        with perf_trace(tdir):
            with annotate(TRACED_FORWARD):
                fwds["exact"](*dev_pairs[0][:4])
        events = json.loads((Path(tdir) / TRACE_FILE).read_text())[
            "traceEvents"]
    traced = kernel_records(events)
    for label, ev in bare.items():
        log(f"  {label} of one teacher forward: {unrecorded_launches(ev)} "
            f"launches without a kernel record; the port's kernels "
            f"{kernel_records(ev)}")
    fwd_launches = len(_launches(events, TRACED_FORWARD))
    log(f"  perf.trace ({WARM_UP_KERNELS} warm-up kernels, "
        f"{SETTLE_KERNELS} settle kernels) of one teacher forward: "
        f"{fwd_launches} launches in the forward, "
        f"{unrecorded_launches(events, TRACED_FORWARD)} of them without a "
        f"kernel record ({unrecorded_launches(events)} in the whole trace, "
        f"the settle's included); the port's kernels {traced} (launched "
        f"{want})")
    check(traced == want and fwd_launches > 0
          and not unrecorded_launches(events, TRACED_FORWARD),
          f"the trace of one forward holds {traced}; its launches without "
          f"a kernel record: "
          f"{unrecorded_detail(events, TRACED_FORWARD) or 'none'}")
    del fwds, e_model, tiny
    deadline("profile and trace")

    # raw frames through the preprocessors to the eval
    pre = preprocess_eval("cuda")
    for label, n in pre["scenes"].items():
        want = {k: PER_FORWARD[k] * len(n) for k in PER_FORWARD}
        check(pre["launches"][label] == want,
              f"{label}: launches {pre['launches'][label]}, expected {want}")
        log(f"  {label}: {len(n)} preprocessed scenes of {n} points; eval "
            + ", ".join(f"{k} {v:.6f}" for k, v in
                        pre["metrics"][label].items())
            + f" (random weights: a sanity line); launches "
            f"{pre['launches'][label]}")
    log("  seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                  pre["seconds"].items())
        + f"; Pillow installed: {importlib.util.find_spec('PIL') is not None}"
        f", imported: {'PIL' in sys.modules}")
    log(f"  phase {time.monotonic() - t_phase:.1f} s")
    deadline("tooling")

    # ---------------------------------------------------------------- 24
    t_phase = time.monotonic()
    teacher = PRESETS["teacher"]
    n0, n1 = teacher.npoints[:2]
    c0, c1 = teacher.level_channels[:2]
    fn, xn = teacher.feat_nei, teacher.flow_nei
    log(f"[24/27 inventory] the experimental inventory and the pointnet2 API "
        f"at the teacher's widths: l1 {n1} points a cloud (FPS of the "
        f"{n0}-point pair), C = {c1}, feat_nei {fn}, flow_nei {xn}, heads "
        f"{INVENTORY_HEAD_K} neighbours; down-samplers {n0} -> {n1} at "
        f"C = {c0}; seeded weights and features")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    xyz0, xyz0b = dev_pairs[0][0], dev_pairs[0][1]
    with torch.inference_mode():
        xyz1, xyz1b = (gather_points(p_, fps_mod.furthest_point_sample(
            p_, n1)) for p_ in (xyz0, xyz0b))
    xyz1, xyz1b = xyz1.clone(), xyz1b.clone()
    f0, f0b = randn(1, n0, c0), randn(1, n0, c0)
    f1, f1b, cost1, bid1 = (randn(1, n1, c1) for _ in range(4))
    flow1, occ1, h1 = 0.1 * randn(1, n1, 3), randn(1, n1, 1), randn(
        1, n1, INVENTORY_GRU_HIDDEN)
    pair1 = (xyz1, xyz1b, f1, f1b)
    # PointnetSAModule's radius: the smallest of INVENTORY_RADII at which
    # the median ball around the l1 centres holds nsample / 2 points
    with torch.no_grad():
        d2_ball = square_distance(xyz1, xyz0)
        for radius in INVENTORY_RADII:
            in_ball = (d2_ball < radius * radius).sum(-1).clamp(max=fn)
            median_hits = float(in_ball.float().median())
            if median_hits >= fn / 2:
                break
        del d2_ball
    check(median_hits >= fn / 2, f"no radius of {INVENTORY_RADII} holds "
          f"{fn // 2} points in the median ball")
    log(f"  PointnetSAModule radius {radius} m: the median ball of its "
        f"{n1} centres holds {median_hits:.0f} of nsample {fn} points")
    head = dict(neighbors=INVENTORY_HEAD_K)
    cases = [
        # (a) the PointConv variants and down-samplers
        ("PointConvSVD", lambda g: ex_nn.PointConvSVD(fn, c1, c1,
                                                      generator=g),
         (xyz1, f1)),
        ("PointConvBias", lambda g: ex_nn.PointConvBias(fn, c1, c1,
                                                        generator=g),
         (xyz1, f1)),
        ("PointConvFactor", lambda g: ex_nn.PointConvFactor(fn, c1, c1,
                                                            generator=g),
         (xyz1, f1)),
        ("PointConvK", lambda g: ex_nn.PointConvK(fn, c1, c1, g), (xyz1, f1)),
        ("SepConv", lambda g: ex_nn.SepConv(fn, c1, c1, g), (xyz1, f1)),
        # 3 + C must be whole 3-vectors: the first 30 of the 32 channels
        ("VNNConvD", lambda g: ex_nn.VNNConvD(n1, fn, 30, c1 // 3, g),
         (xyz0, f0[..., :30].contiguous())),
        ("SetAbstract", lambda g: ex_nn.SetAbstract(fn, c1, (c1, c1), g),
         (xyz1, f1)),
        ("SetAbstractD", lambda g: ex_nn.SetAbstractD(n1, fn, c0, (c1, c1),
                                                      g), (xyz0, f0)),
        ("SetAbstractFuse", lambda g: ex_nn.SetAbstractFuse(
            fn, c1, (c1, c1), (c1,), g), (xyz1, f1)),
        ("SetAbstractFuseD", lambda g: ex_nn.SetAbstractFuseD(
            n1, fn, c0, (c1, c1), (c1,), g), (xyz0, f0)),
        ("PointConvW", lambda g: ex_nn.PointConvW(n1, fn, c0, c1, g),
         (xyz0, f0)),
        ("PointConvSVDD", lambda g: ex_nn.PointConvSVDD(n1, fn, c0, c1,
                                                        generator=g),
         (xyz0, f0)),
        ("PointConvWeight", lambda g: ex_nn.PointConvWeight(
            n1, fn, c0, c1, generator=g), (xyz0, f0)),
        ("PointConvDS", lambda g: ex_nn.PointConvDS(n1, fn, c0, c1,
                                                    generator=g),
         (xyz0b, xyz0, f0)),
        ("AdaptiveSampling", lambda g: ex_nn.AdaptiveSampling(xn),
         (xyz1, f1, xyz1b, f1b)),
        ("PointConv4D", lambda g: ex_nn.PointConv4D(fn, c1, c1, generator=g),
         (xyz1b, xyz1, f1)),
        ("LocalFeatureAggregation", lambda g: ex_nn.LocalFeatureAggregation(
            fn, c1, c1, g), (xyz1, f1)),
        # (b) the cross layers
        ("PointConvFlow", lambda g: ex_nn.PointConvFlow(xn, c1, (c1, c1), g),
         pair1),
        ("CrossLayerConcat", lambda g: ex_nn.CrossLayerConcat(
            xn, c1, (c1, c1), (c1, c1), g), pair1),
        ("CrossConvLayer", lambda g: ex_nn.CrossConvLayer(
            xn, c1, c1, c1, generator=g), pair1),
        ("FlowEmbeddingLayer", lambda g: ex_nn.FlowEmbeddingLayer(
            xn, c1, (c1,), g), pair1),
        ("CrossLayerLightUp", lambda g: ex_nn.CrossLayerLightUp(
            xn, c0, c1, (c1, c1), g), (xyz0, xyz1b, f0, f1b)),
        ("CrossTransLayer", lambda g: ex_nn.CrossTransLayer(
            xn, c1, (c1,), (c1,), g), pair1),
        ("CrossLocalTransLayer", lambda g: ex_nn.CrossLocalTransLayer(
            xn, c1, (c1,), (c1,), g), pair1),
        ("CrossLayerPoolLight", lambda g: ex_nn.CrossLayerPoolLight(
            xn, c1, (c1,), (c1,), g), pair1),
        ("CrossLayerLightVoteDouble", lambda g:
         ex_nn.CrossLayerLightVoteDouble(xn, c1, (c1, c1), (c1, c1),
                                         dense_channel=c0, generator=g),
         (*pair1, xyz0b, f0b)),
        ("CrossLayerLightVote1", lambda g: ex_nn.CrossLayerLightVote1(
            xn, c1, (c1, c1), (c1, c1), g), pair1),
        ("CrossLayerLightVote2", lambda g: ex_nn.CrossLayerLightVote2(
            xn, c1, (c1, c1), (c1, c1), g), pair1),
        ("NoCrossLayer", lambda g: ex_nn.NoCrossLayer(xn, c1, (c1, c1), True,
                                                      g), pair1),
        ("CrossAtten", lambda g: ex_nn.CrossAtten(c1, c1, g), pair1),
        ("CrossLayerLightOcc", lambda g: ex_nn.CrossLayerLightOcc(
            xn, c1, (c1, c1), (c1, c1), g), pair1),
        ("CrossLayerLightAttentive", lambda g:
         ex_nn.CrossLayerLightAttentive(xn, c1, (c1, c1), (c1, c1), g),
         pair1),
        ("CrossLayerP2PConvLight2", lambda g: ex_nn.CrossLayerP2PConvLight2(
            xn, c1, (c1, c1), (c1, c1), g), pair1),
        ("CrossLayerLightShift", lambda g: ex_nn.CrossLayerLightShift(
            xn, c1, (c1, c1), (c1, c1), g), pair1),
        # (c) the estimators; (d) the warp
        *((name, lambda g, name=name: getattr(ex_nn, name)(
            c1, c1, generator=g, **head), (xyz1, f1, cost1, flow1))
          for name in ("SceneFlowEstimatorSepResidual",
                       "SceneFlowEstimatorResidualBias",
                       "SceneFlowEstimatorResidualSVD",
                       "SceneFlowEstimatorSetconvResidual",
                       "SceneFlowEstimatorResidualFactor",
                       "SceneFlowEstimatorSetconvFuseResidual")),
        ("SceneFlowEstimatorResidualSmooth", lambda g:
         ex_nn.SceneFlowEstimatorResidualSmooth(c1, c1, c1, generator=g,
                                                **head),
         (xyz1, f1, bid1, cost1, flow1)),
        ("SceneFlowEstimatorResidualOcc", lambda g:
         ex_nn.SceneFlowEstimatorResidualOcc(c1, c1, 1, generator=g, **head),
         (xyz1, f1, cost1, flow1, occ1)),
        ("SceneFlowEstimatorPointConv", lambda g:
         flowhead_nn.SceneFlowEstimatorPointConv(c1, c1, 3, generator=g,
                                                 **head),
         (xyz1, f1, cost1, flow1)),
        ("SceneFlowEstimatorResidualIter", lambda g:
         flowhead_nn.SceneFlowEstimatorResidualIter(c1, c1, generator=g,
                                                    **head),
         (xyz1, f1, cost1, flow1)),
        ("ConvGRU", lambda g: ConvGRU(2 * c1, INVENTORY_GRU_HIDDEN, g),
         (h1, torch.cat([f1, cost1], dim=-1))),
        ("PointWarpingSimple", lambda g: ex_nn.PointWarpingSimple(),
         (xyz1, xyz1b, flow1)),
        # the pointnet2 API
        ("PointnetSAModule", lambda g: pn2.PointnetSAModule(
            n1, radius, fn, c0, (c1, c1), generator=g), (xyz0, f0)),
        ("PointnetFPModule", lambda g: pn2.PointnetFPModule(
            c1 + c0, (c1,), g), (xyz0, xyz1, f0, f1)),
    ]
    mods = []
    for label, make, args in cases:
        mod = make(torch.Generator().manual_seed(SEED))
        if isinstance(mod, torch.nn.Module):
            mod = mod.cuda().eval()
        mods.append((label, mod, copy.deepcopy(mod), args))
    # the main path: every module once through the kernels, the counts set
    # to 0 just before and read just after
    inv_calls = {n: [] for n in points}
    inv_out, inv_mod_launches = [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    with swapped(recorder(inv_calls)), torch.no_grad():
        for label, mod, _, args in mods:
            before = dict(kernels.LAUNCHES)
            inv_out.append(mod(*args))
            inv_mod_launches.append({n: kernels.LAUNCHES[n] - before[n]
                                     for n in ("fps", "knn")})
    torch.cuda.synchronize()
    inv_launches = dict(kernels.LAUNCHES)
    log(f"  the inventory's forwards through the kernels: launches "
        f"{inv_launches} over {len(mods)} modules")
    check(inv_launches["fps"] > 0 and inv_launches["knn"] > 0
          and not any(inv_launches[n] for n in ("pool", "pool_bwd")),
          f"inventory launches {inv_launches}")
    check(inv_launches["fps"] == len(inv_calls["fps"])
          and inv_launches["knn"] == len(inv_calls["knn"]),
          "inventory launches differ from its kernel calls")

    def flat(out):
        return list(out) if isinstance(out, (tuple, list)) else [out]

    inv_rows = []
    for (label, mod, twin, args), out_k, launched in zip(
            mods, inv_out, inv_mod_launches):
        with swapped(lambda n, entry, plain: plain), torch.no_grad():
            out_p = twin(*args)
        mx = med = 0.0
        for a_, b_ in zip(flat(out_k), flat(out_p), strict=True):
            check(a_.shape == b_.shape and bool(torch.isfinite(
                a_.float()).all()), f"{label}: output {tuple(a_.shape)}")
            if a_.is_floating_point():
                diff = (a_ - b_).abs()
                mx = max(mx, float(diff.max()))
                med = max(med, float(diff.median()))
            else:
                check(torch.equal(a_, b_), f"{label}: indices differ")
        check(mx <= 1e-3 and med <= 1e-5, f"{label}: {mx}, {med}")
        ms = cuda_ms(lambda: mod(*args), INVENTORY_REPS, 1)
        inv_rows.append(dict(module=label, launches=launched,
                             max_abs=mx, median_abs=med, ms=ms))
        log(f"  {label}: launches fps {launched['fps']} knn "
            f"{launched['knn']}; kernels vs plain max abs {mx:.3g}, median "
            f"{med:.3g}; forward {ms:.3f} ms; outputs "
            + " ".join(str(tuple(o.shape)) for o in flat(out_k)))
    del inv_out

    # FPS and kNN bit-identical at each distinct site of the inventory
    def distinct(calls_):
        """The distinct sites (shapes and k) of calls_, each with its
        number of calls."""
        seen, count = {}, {}
        for args in calls_:
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a
                        for a in args)
            seen.setdefault(key, args)
            count[key] = count.get(key, 0) + 1
        return list(seen.values()), list(count.values())

    def per_call(t, counts):
        """time_sites' sums over distinct sites, each site's ms, plain ms
        and bound taken as many times as the path called it."""
        out = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, sites=[])
        ops_ms = bytes_ms = 0.0
        for row, n in zip(t["sites"], counts):
            out["ms"] += n * row["ms"]
            out["plain_ms"] += n * row["plain_ms"]
            out["bound_ms"] += n * max(row["ops_ms"], row["bytes_ms"])
            ops_ms += n * row["ops_ms"]
            bytes_ms += n * row["bytes_ms"]
            out["sites"].append(dict(row, launches=n))
        out["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        return out

    (inv_fps_sites, fps_counts), (inv_knn_sites, knn_counts) = (
        distinct(inv_calls["fps"]), distinct(inv_calls["knn"]))
    for args in inv_fps_sites:
        fps_identical(args, "inventory ")
    for args in inv_knn_sites:
        knn_identical(args)
    log(f"  {len(inv_fps_sites)} FPS and {len(inv_knn_sites)} kNN sites "
        f"(distinct B, S, N, k) bit-identical to fps_plain / knn_plain")
    with torch.inference_mode():
        inv_fps_times = per_call(time_sites("fps", inv_fps_sites),
                                 fps_counts)
        inv_knn_times = per_call(time_sites("knn", inv_knn_sites),
                                 knn_counts)
    k64 = [i for i, a in enumerate(inv_knn_sites) if a[0] == knn_mod.MAX_K]
    check(len(k64) == 1, f"k = 64 sites {len(k64)}")
    k64_times = per_call(dict(sites=[inv_knn_times["sites"][k64[0]]]),
                         [knn_counts[k64[0]]])
    k64_launches = knn_counts[k64[0]]
    log(f"  the inventory's {inv_launches['fps']} FPS and "
        f"{inv_launches['knn']} kNN launches: fps {inv_fps_times['ms']:.4f} "
        f"ms, plain {inv_fps_times['plain_ms']:.4f}, bound "
        f"{inv_fps_times['bound_ms']:.5f}; knn {inv_knn_times['ms']:.4f} "
        f"ms, plain {inv_knn_times['plain_ms']:.4f}, bound "
        f"{inv_knn_times['bound_ms']:.5f} (each site's events times its "
        f"calls)")
    log(f"  knn at the k = 64 site (CrossLocalTransLayer), a launch: "
        f"{k64_times['ms'] / k64_launches:.4f} ms, plain "
        f"{k64_times['plain_ms'] / k64_launches:.4f} ms, bound "
        f"{k64_times['bound_ms'] / k64_launches:.5f} ms "
        f"({k64_times['bound_by']}); {k64_launches} launches")
    del inv_calls

    # the kNN kernel alone over every k of the sweep: the l1 pair stacked
    # (2048^2), one l0 cloud (8192^2), and duplicated points: 683 distinct
    # points thrice at indices j, j + 683, j + 1366 (683 = 21 x 32 + 11,
    # so the copies fall in other lanes), ties across lanes and, above
    # k = 32, across the two entries of a lane
    dup = torch.cat([xyz1, xyz1b])[:, torch.arange(n1, device="cuda") % 683]
    sweep = {"l1 pair": torch.cat([xyz1, xyz1b]), "l0": xyz0,
             "duplicated": dup.contiguous()}
    tie_lanes = tie_entries = 0
    for k_ in KNN_SWEEP:
        for label, pts in sweep.items():
            knn_identical((k_, pts, pts))
            if label == "duplicated":
                with torch.inference_mode():
                    d_, i_ = cuda_fns["knn"](k_, pts, pts)
                tie = d_[..., 1:] == d_[..., :-1]
                lanes_ = knn_mod.knn_plan(pts.shape[0], n1, n1, k_)[0]
                tie_lanes += int((tie & (i_[..., 1:] % lanes_
                                         != i_[..., :-1] % lanes_)).sum())
                if k_ > 32:
                    pos = torch.arange(1, k_, device="cuda")
                    tie_entries += int((tie & (pos % 2 == 1)).sum())
    check(tie_lanes > 0 and tie_entries > 0,
          f"the duplicated case has no ties across lanes ({tie_lanes}) or "
          f"across a lane's two entries ({tie_entries})")
    log(f"  kNN sweep k = {list(KNN_SWEEP)} over {', '.join(sweep)}: all "
        f"bit-identical; tied pairs in the duplicated case's lists across "
        f"lanes {tie_lanes}, across a lane's two entries (k > 32) "
        f"{tie_entries}")
    results["knn"]["match"] += (f"; the inventory's {len(inv_knn_sites)} "
                                f"sites and k = {list(KNN_SWEEP)} at "
                                f"2048^2 (B = 2), 8192^2 and on duplicated "
                                f"points")
    del sweep, dup, mods
    log(f"  phase {time.monotonic() - t_phase:.1f} s")
    deadline("inventory")

    # ---------------------------------------------------------------- 25
    t_phase = time.monotonic()
    mesh_dir = tempfile.mkdtemp(prefix="kdpc_mesh_")
    try:
        mesh_res = mesh_phase(mesh_dir, PRESETS["teacher"], card=smi)
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    log(f"  phase {time.monotonic() - t_phase:.1f} s")
    deadline("mesh")

    # ---------------------------------------------------------------- 25
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
            student_kd_step=timing(s_times[name], s_launches[name]),
            fast_kd_step=timing(f_times[name], f_launches[name]),
            fg_eval_forward={
                n: timing(v["times"][name], v["launches"][name])
                if name in v["times"] else None
                for n, v in fg_eval.items()},
            **({"c16_sites": c16_times[name]} if name in c16_times else {}),
            eval_forward=None if e is None else timing(
                e, eval_launches[name] // N_METRIC_PAIRS),
            workflow_launches={label: r["launches"][name]
                               for label, r in runs.items()},
            **({"fps_blocks": dict(
                eval_forward=dict(launches=b_launches[name],
                                  per_pair_ms=blocked_fwd),
                sites=fps_blocked_times["sites"])}
               if name == "fps" else {}),
            **({"selfsup_sites": dict(
                timing(ss_knn_times,
                       ss_launches[name] - PER_FORWARD[name]),
                by_k=ss_knn_times["by_k"])}
               if name == "knn" else {}),
            mesh_train_step_launches=dict(
                nccl_world_1=mesh_res["launches"][name],
                gloo_world_2_per_rank=[r[name] for r in
                                       mesh_res["rank_launches"]]),
            **({"inventory": dict(
                timing(inv_knn_times if name == "knn" else inv_fps_times,
                       inv_launches[name]),
                sites=[r["site"] for r in (
                    inv_knn_times if name == "knn" else inv_fps_times)[
                        "sites"]],
                **({"k64": timing(k64_times, k64_launches)}
                   if name == "knn" else {}))}
               if name in ("fps", "knn") else {})))
    kernel_rows.append(dict(
        name="fps_pruned", route="cuda", **KERNEL_META["fps_pruned"],
        **timing(fp_times, kd_launches["fps_pruned"]),
        max_abs_err=0.0, library_ms=None,
        match=results["fps_pruned"]["match"],
        per=f"one call at B=16 (the KD forward's stacked clouds), "
            f"{N_POINTS} -> {m}; on no path",
        by_batch={str(k): dict(ms=v["ms"], fps_kernel_ms=v["fps_kernel_ms"],
                               chain_ms=v["chain_ms"],
                               updates_share=v["updates_share"])
                  for k, v in attic["fps_pruned"].items()}))
    kernel_rows.append(dict(
        name="cross_pool", route="cuda", **KERNEL_META["cross_pool"],
        **timing(cp_times, kd_launches["cross_pool"]),
        max_abs_err=results["cross_pool"]["max_abs_err"], library_ms=None,
        match=results["cross_pool"]["match"],
        per=f"L=1 at the {len(cp_sites)} pool sites of an eval forward; on "
            "no path",
        two_layers=timing(cp2_times, 0),
        c16_sites=timing(cp16_times, 0)))
    plain_ops = [dict(
        name="knn_features", route="torch",
        source="kd_pointcloud_tpu_torch/ops/knn.py",
        replaces="kd_pointcloud_tpu/ops/knn.py:142 knn_point_dist (XLA, no Pallas kernel)",
        fast_kd_step=fast_feature,
        eval_forward={n: dict(ms=v["feature_knn_ms"],
                              sites=v["feature_sites"])
                      for n, v in fg_eval.items()}), dict(
        name="inventory", route="torch",
        source="kd_pointcloud_tpu_torch/nn/experimental.py",
        replaces="kd_pointcloud_tpu/nn/experimental.py (XLA around the "
                 "FPS and kNN kernels)",
        per="one forward a module, batch 1, l1 = 2048 points",
        modules=inv_rows), dict(
        name="morton_knn", route="torch",
        source="kd_pointcloud_tpu_torch/attic/morton.py",
        replaces="attic/morton.py knn_block_dist (XLA, no Pallas kernel)",
        per=f"k={MORTON_K}, window {MORTON_WINDOW}, {N_POINTS}^2, batch 1, "
            "recall against the kNN kernel; ms a call (CUDA events)",
        **attic["morton"])]
    log("[26/27 kernels]")
    log(json.dumps({"kernels": kernel_rows, "plain_ops": plain_ops}))
    log(f"[27/27 done] {time.monotonic() - t0:.1f} s wall; nvidia-smi:")
    log(smi)
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
