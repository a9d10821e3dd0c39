"""The benchmark's frozen operation and byte counts, and the H100's peaks.

Every count here is a function of a configuration's sizes and the batch,
so it reads the same whatever the measured program runs:

* kernel formulas (operations, bytes) of one call at its shapes, each
  input read once and each output written once: the 3-D kNN, FPS, the
  cost-volume pool and its backward. The pool backward counts what the
  gradient needs (the max mask's entries, one a query and output channel),
  not a recompute of the forward;
* the model's operations a pair: the matrix products of the reference
  forward (torch.utils.flop_counter on the meta device, 2 a multiply-add;
  the feature kNN's cross term among them), plus the 3-D kNN and FPS
  formulas at the forward's call sites, which FlopCounterMode cannot see.
  Elementwise work is not counted. A forward with a backward (a student's
  in training) counts its differentiable products three times (forward,
  and the gradients of inputs and weights) and its searches once: the 3-D
  kNN, FPS and the feature kNN's product run without autograd.

The call sites come from the reference forward itself (reference/ops.py
sites()), run on meta tensors at the workload's batch and points.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.model import NetConfig, PointFlowNet
from .reference.ops import sites

# NVIDIA H100 SXM data sheet, dense: float32 without tensor cores (the
# port runs with TF32 off) and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def knn_work(B, S, N, k):
    """Per (query, key) pair: 3 mul + 2 add (q.k), 1 mul, 1 sub, 1 add,
    1 compare; reads queries and keys, writes k indices and distances."""
    return B * S * N * 9, (B * S + B * N) * 12 + B * S * k * 8


def fps_work(B, N, m):
    """Per point and round: 3 sub, 3 mul, 2 add, 1 min, 1 compare."""
    return B * (m - 1) * N * 10, B * N * 12 + B * m * 4


def pool_work(B, N1, N2, K, C):
    """Per (query, neighbour): C add + C leaky, C x C multiply-add, C bias,
    C leaky, C max; reads u, v, idx, weight, bias, writes the output."""
    return (B * N1 * K * (2 * C * C + 5 * C),
            (B * N2 * C + 2 * B * N1 * C + C * C + C + B * N1 * K) * 4)


def pool_bwd_work(B, N1, N2, K, C):
    """What the gradient needs: per (query, neighbour) d_g = d_h0 leaky',
    d_v and d_u (3 C); per mask entry, one a (query, output channel),
    d_h0 += d_p w and d_w += d_p h0 (2 C each) and d_bias (1). Reads u,
    idx, v, weight, bias and the cotangent, writes d_u, d_v, d_weight,
    d_bias."""
    return (B * N1 * K * 3 * C + B * N1 * C * (4 * C + 1),
            (2 * B * N2 * C + B * N1 * K + 3 * B * N1 * C + 2 * C * C
             + 2 * C) * 4)


def bound_s(ops, nbytes) -> float:
    """The least time of a call on the H100: operations over the float32
    peak or bytes over the memory bandwidth, whichever is larger."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def forward_sites(cfg: dict, batch: int, points: int, grad: bool):
    """(dense flops, sites) of one reference forward of batch pairs of
    points points, on meta tensors; grad runs it as a student in training
    (the pools then have a backward)."""
    net_cfg = NetConfig.from_dict(cfg)
    with torch.device("meta"):
        model = PointFlowNet(net_cfg)
        x = [torch.empty(batch, points, 3) for _ in range(4)]
    model.train(grad)
    with torch.set_grad_enabled(grad), sites() as calls, \
            FlopCounterMode(display=False) as dense:
        model(*x)
    return int(dense.get_total_flops()), calls


def kernel_totals(calls) -> dict:
    """(ops, bytes, bound seconds) by kernel over recorded call sites:
    knn, fps, pool and pool_bwd (the pools with a backward)."""
    out = {name: [0, 0, 0.0] for name in ("knn", "fps", "pool", "pool_bwd")}

    def add(name, work):
        out[name][0] += work[0]
        out[name][1] += work[1]
        out[name][2] += bound_s(*work)

    for site in calls["knn"]:
        add("knn", knn_work(*site))
    for site in calls["fps"]:
        add("fps", fps_work(*site))
    for *shape, grad in calls["pool"]:
        add("pool", pool_work(*shape))
        if grad:
            add("pool_bwd", pool_bwd_work(*shape))
    return {k: tuple(v) for k, v in out.items()}


def feature_knn_flops(calls) -> int:
    """The feature kNN's cross-term products at the recorded sites (among
    the dense count; they run without autograd)."""
    return sum(2 * B * S * N * D for B, S, N, D, _ in calls["feature_knn"])


def model_flops(dense: int, calls, grad: bool = False) -> int:
    """A forward's counted operations: the dense products plus the 3-D kNN
    and FPS formulas (the pool's products are among the dense ones); with
    grad, its backward too: the differentiable products twice more."""
    totals = kernel_totals(calls)
    searches = totals["knn"][0] + totals["fps"][0]
    if not grad:
        return dense + searches
    nograd = feature_knn_flops(calls)
    return 3 * (dense - nograd) + nograd + searches


def cell_work(runs: list, workload: dict) -> dict:
    """The frozen counts of a cell, a pair: flops (the model's operations),
    and for each kernel its (ops, bytes, bound seconds). runs: (model
    sizes, with a backward) of each forward a pair runs (the entry's
    runs(cell))."""
    B, N = workload["batch"], workload["points"]
    flops = 0
    kern = {name: [0, 0, 0.0] for name in ("knn", "fps", "pool", "pool_bwd")}
    for cfg, grad in runs:
        dense, calls = forward_sites(cfg, B, N, grad)
        totals = kernel_totals(calls)
        flops += model_flops(dense, calls, grad)
        for name, (o, b, s) in totals.items():
            kern[name][0] += o
            kern[name][1] += b
            kern[name][2] += s
    return dict(flops=flops / B,
                kernels={k: (o / B, b / B, s / B)
                         for k, (o, b, s) in kern.items()})
